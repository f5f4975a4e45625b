"""The port's DTMF, RED and header-extension engines against the JAX
package's, on the CPU.

- DTMF (RFC 4733): `encode_event` / `decode_event` over every event,
  end bit, volume and duration drawn from a seed; `DtmfTransformEngine`
  over a run of multi-stream batches with tones started and stopped
  (the marker, the event timestamp, growing durations, the three end
  packets) and the receive side's consumed events and mask.
- RED (RFC 2198): `encode_red` / `decode_red` of seeded blocks and the
  field-limit refusals; `RedTransformEngine` at distances 1 and 2 over
  multi-stream batches, unwrapped back, a truncated RED payload refused.
- Header extensions: `TransportCCEngine` (masked rows take no seq, the
  16-bit fold across the wrap, `lookup_send_time`),
  `PayloadTypeTransformEngine`, `SsrcRewriteEngine`,
  `AbsSendTimeEngine` and `CsrcAudioLevelEngine` on the same batch.

Batches come from each package's `rtp.header.build` on the same seeded
inputs.  Tolerance: exact equality of bytes, lengths, stream ids,
masks and events.
"""

import numpy as np
import pytest

from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform import dtmf as j_dtmf
from libjitsi_tpu.transform import header_ext as j_ext
from libjitsi_tpu.transform import red as j_red
from libjitsi_tpu_torch.rtp import header as p_header
from libjitsi_tpu_torch.transform import dtmf as p_dtmf
from libjitsi_tpu_torch.transform import header_ext as p_ext
from libjitsi_tpu_torch.transform import red as p_red

CAP = 8


def _batches(seed, n=6, ext=False, every_stream=False):
    """A seeded multi-stream batch built by both packages' builders
    (`every_stream`: rows of streams 0..CAP-1 in turn)."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, int(rng.integers(20, 200)),
                             np.uint8).tobytes() for _ in range(n)]
    seqs = rng.integers(0, 1 << 16, n)
    tss = rng.integers(0, 1 << 32, n, dtype=np.int64)
    ssrcs = rng.integers(1, 1 << 32, n, dtype=np.int64)
    streams = np.arange(n) % CAP if every_stream else rng.integers(0, CAP, n)
    pts = rng.integers(0, 128, n)
    kw = {}
    if ext:
        kw["ext"] = [(0xBEDE, bytes([0x10, 0x55, 0, 0])) if i % 2 else None
                     for i in range(n)]
    out = []
    for mod in (p_header, j_header):
        b = mod.build(payloads, seqs, tss, ssrcs, pts, stream=streams, **kw)
        out.append(b)
    return out


def _same(pb, jb):
    assert np.array_equal(pb.data, np.asarray(jb.data))
    assert np.array_equal(pb.length, np.asarray(jb.length))
    assert np.array_equal(pb.stream, np.asarray(jb.stream))


@pytest.mark.parametrize("seed", (0, 1))
def test_dtmf_event_codec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        args = (int(rng.integers(0, 16)), bool(rng.integers(0, 2)),
                int(rng.integers(0, 64)), int(rng.integers(0, 1 << 16)))
        blob = p_dtmf.encode_event(p_dtmf.DtmfEvent(*args))
        assert blob == j_dtmf.encode_event(j_dtmf.DtmfEvent(*args))
        assert p_dtmf.decode_event(blob + b"xx").__dict__ == \
            j_dtmf.decode_event(blob + b"xx").__dict__
    for mod in (p_dtmf, j_dtmf):
        with pytest.raises(ValueError):
            mod.decode_event(b"\x01\x02")


def test_dtmf_engine_matches_jax_over_tones():
    got = {"p": [], "j": []}
    engines = {
        "p": p_dtmf.DtmfTransformEngine(
            101, CAP, on_event=lambda s, e: got["p"].append((s, e.__dict__))),
        "j": j_dtmf.DtmfTransformEngine(
            101, CAP, on_event=lambda s, e: got["j"].append((s, e.__dict__)))}
    plan = {1: [("start", 2, "5")], 3: [("start", 5, "#"), ("stop", 2)],
            4: [("stop", 5)], 5: [("stop", 2)], 7: [("start", 2, "D")],
            8: [("stop", 2), ("start", 1, "0"), ("stop", 1)]}
    for step in range(12):
        for op in plan.get(step, ()):
            for e in engines.values():
                if op[0] == "start":
                    e.start_tone(op[1], op[2])
                else:
                    e.stop_tone(op[1])
        pb, jb = _batches(100 + step, n=CAP + 2, every_stream=True)
        outs = {k: e.rtp_transformer.transform(b)
                for (k, e), b in zip(engines.items(), (pb, jb))}
        _same(outs["p"][0], outs["j"][0])
        assert np.array_equal(outs["p"][1], outs["j"][1])
        mask = np.arange(pb.batch_size) != 3
        backs = {k: e.rtp_transformer.reverse_transform(outs[k][0], mask)
                 for k, e in engines.items()}
        _same(backs["p"][0], backs["j"][0])
        assert np.array_equal(backs["p"][1], backs["j"][1])
    assert got["p"] == got["j"] and len(got["p"]) > 10
    assert [e.__dict__ for e in engines["p"].received] == \
        [e.__dict__ for e in engines["j"].received]


@pytest.mark.parametrize("seed", (0, 1))
def test_red_codec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        red = [(int(rng.integers(0, 128)), int(rng.integers(0, 1 << 14)),
                rng.integers(0, 256, int(rng.integers(0, 300)),
                             np.uint8).tobytes())
               for _ in range(int(rng.integers(0, 4)))]
        prim = rng.integers(0, 256, int(rng.integers(0, 200)),
                            np.uint8).tobytes()
        pt = int(rng.integers(0, 128))
        blob = p_red.encode_red(prim, pt, red)
        assert blob == j_red.encode_red(prim, pt, red)
        assert p_red.decode_red(blob) == j_red.decode_red(blob)
    for mod in (p_red, j_red):
        with pytest.raises(ValueError):
            mod.encode_red(b"", 0, [(0, 1 << 14, b"")])
        with pytest.raises(ValueError):
            mod.encode_red(b"", 0, [(0, 0, b"x" * 1024)])
        with pytest.raises(ValueError):
            mod.decode_red(b"\x80\x01")


@pytest.mark.parametrize("distance", (1, 2))
def test_red_engine_matches_jax(distance):
    pe = p_red.RedTransformEngine(121, distance, CAP)
    je = j_red.RedTransformEngine(121, distance, CAP)
    for step in range(5):
        pb, jb = _batches(200 + step)
        po, pm = pe.rtp_transformer.transform(pb)
        jo, jm = je.rtp_transformer.transform(jb)
        _same(po, jo)
        assert np.array_equal(pm, jm)
        if step == 4:       # a RED payload cut inside its block header
            for b in (po, jo):
                b.length[0] = 13
                b.data[0, 12] = 0x80
        pr, pok = pe.rtp_transformer.reverse_transform(po)
        jr, jok = je.rtp_transformer.reverse_transform(jo)
        _same(pr, jr)
        assert np.array_equal(pok, jok)
        assert pok.sum() == pb.batch_size - (step == 4)
        # the primary block comes back as the packet that was sent
        for i in np.nonzero(pok)[0]:
            assert pr.to_bytes(int(i)) == pb.to_bytes(int(i))


def test_header_ext_engines_match_jax_on_one_batch():
    clocks = [float(t) for t in np.linspace(1000.0, 1001.0, 40)]
    mk = {"p": p_ext, "j": j_ext}
    tcc = {k: m.TransportCCEngine(5, clock=iter(clocks).__next__)
           for k, m in mk.items()}
    ast = {k: m.AbsSendTimeEngine(3, clock=iter(clocks).__next__)
           for k, m in mk.items()}
    pt = {k: m.PayloadTypeTransformEngine(CAP) for k, m in mk.items()}
    ss = {k: m.SsrcRewriteEngine(CAP) for k, m in mk.items()}
    lv = {k: m.CsrcAudioLevelEngine(1, CAP, level_of=lambda s: 3 * s + 1)
          for k, m in mk.items()}
    for k in mk:
        tcc[k].next_seq_ext = 65_530       # the 16-bit fold wraps
        for sid in range(CAP):
            pt[k].add_mapping(sid, sid * 7 % 128, (sid * 13 + 5) % 128)
        ss[k].set_mapping(2, 0xCAFE0002)
        ss[k].set_mapping(5, 0xCAFE0005)
    for step in range(4):
        batches = dict(zip(mk, _batches(300 + step, n=9, ext=step % 2 == 1)))
        mask = np.random.default_rng(step).random(9) > 0.3
        for engines in (tcc, ast, pt, ss, lv):
            for k in mk:
                out, m = engines[k].rtp_transformer.transform(
                    batches[k], None if step == 0 else mask)
                batches[k] = out
                assert np.array_equal(m, np.ones(9, bool) if step == 0
                                      else mask)
            _same(batches["p"], batches["j"])
        for k in mk:
            lv[k].rtp_transformer.reverse_transform(batches[k])
        assert np.array_equal(lv["p"].last_levels, lv["j"].last_levels)
    assert tcc["p"].next_seq_ext == tcc["j"].next_seq_ext > 65_536
    assert np.array_equal(tcc["p"].sent_seq, tcc["j"].sent_seq)
    assert np.array_equal(tcc["p"].sent_time, tcc["j"].sent_time)
    for tw in list(range(65_525, 65_536)) + list(range(0, 40)) + [30_000]:
        assert tcc["p"].lookup_send_time(tw) == tcc["j"].lookup_send_time(tw)
    fresh = {k: m.TransportCCEngine(5) for k, m in mk.items()}
    assert fresh["p"].lookup_send_time(0) is fresh["j"].lookup_send_time(0)
