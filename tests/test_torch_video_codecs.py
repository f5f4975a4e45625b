"""The port's video-plane host modules against the JAX package's.

`rtp/header.byte_at`, `codecs/vp8.py`, `codecs/vp9.py`, `codecs/h264.py`,
`sfu/rtx.py`, `sfu/simulcast.py`, `sfu/svc.py` and `recording/webm.py` are
NumPy / Python on both sides: the same seeded inputs (made with numpy) go
through each package and every output field, packet and file is compared.
The descriptor sets cover what `tests/test_vp9.py` and
`tests/test_video_e2e.py` cover (truncated, padded, flexible-mode and
scalability-structure descriptors, 7- and 15-bit picture ids), the
assembly traces are reordered and lossy and cross the 32-bit timestamp
wrap, and the forwarder traces hold layer switches, keyframes, loss and
redelivery, the forwarder's state compared after every step.
Tolerance: exact (integer and byte paths).
"""

import dataclasses

import numpy as np
import pytest

import libjitsi_tpu.codecs.h264 as j_h264
import libjitsi_tpu.codecs.vp8 as j_vp8
import libjitsi_tpu.codecs.vp9 as j_vp9
import libjitsi_tpu.core.packet as j_packet
import libjitsi_tpu.recording.webm as j_webm
import libjitsi_tpu.rtp.header as j_header
import libjitsi_tpu.sfu.cache as j_cache
import libjitsi_tpu.sfu.rtx as j_rtx
import libjitsi_tpu.sfu.simulcast as j_simulcast
import libjitsi_tpu.sfu.svc as j_svc
import libjitsi_tpu_torch.codecs.h264 as p_h264
import libjitsi_tpu_torch.codecs.vp8 as p_vp8
import libjitsi_tpu_torch.codecs.vp9 as p_vp9
import libjitsi_tpu_torch.core.packet as p_packet
import libjitsi_tpu_torch.recording.webm as p_webm
import libjitsi_tpu_torch.rtp.header as p_header
import libjitsi_tpu_torch.sfu.cache as p_cache
import libjitsi_tpu_torch.sfu.rtx as p_rtx
import libjitsi_tpu_torch.sfu.simulcast as p_simulcast
import libjitsi_tpu_torch.sfu.svc as p_svc


def _fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), (what, f.name)


def _both_batches(datagrams):
    """One list of datagrams as each package's PacketBatch."""
    return (j_packet.PacketBatch.from_payloads(datagrams),
            p_packet.PacketBatch.from_payloads(datagrams))


def _rtp(payloads, seqs, ts, ssrc, marker=None, pt=96):
    """Datagrams made by the JAX package's `rtp_header.build`, checked
    equal to the port's."""
    n = len(payloads)
    args = (payloads, seqs, ts, [ssrc] * n if np.isscalar(ssrc) else ssrc,
            [pt] * n)
    kw = dict(marker=marker, stream=[0] * n)
    j = j_header.build(*args, **kw).to_payloads()
    assert p_header.build(*args, **kw).to_payloads() == j
    return j


def _pad(datagram: bytes, n: int) -> bytes:
    """The datagram with RFC 3550 padding of n bytes (P bit set)."""
    return bytes([datagram[0] | 0x20]) + datagram[1:] + bytes(n - 1) + \
        bytes([n])


def test_byte_at_follows_jax():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (40, 24), np.uint8)
    pos = rng.integers(-5, 30, 40)
    assert np.array_equal(p_header.byte_at(data, pos),
                          j_header.byte_at(data, pos))
    assert p_header.byte_at(data, pos).dtype == np.int64


def _vp8_datagrams(rng, n=160):
    """Seeded VP8 descriptors: every extension mix, 7/15-bit picture ids,
    keyframe and delta bodies, truncated descriptors, padded packets and
    random payloads."""
    out = []
    for k in range(n):
        pid = int(rng.choice([-1, int(rng.integers(0, 0x80)),
                              int(rng.integers(0x80, 0x8000))]))
        kw = dict(
            start=bool(rng.integers(0, 2)), picture_id=pid,
            tl0picidx=int(rng.choice([-1, int(rng.integers(0, 256))])),
            tid=int(rng.choice([-1, int(rng.integers(0, 4))])),
            keyidx=int(rng.choice([-1, int(rng.integers(0, 32))])))
        desc = j_vp8.build_descriptor(**kw)
        assert p_vp8.build_descriptor(**kw) == desc
        body = rng.integers(0, 256, int(rng.integers(1, 60)),
                            np.uint8).tobytes()
        kind = k % 5
        if kind == 1:
            payload = desc[:int(rng.integers(0, len(desc)))]   # truncated
        elif kind == 2:
            payload = rng.integers(0, 256, int(rng.integers(1, 8)),
                                   np.uint8).tobytes()         # garbage
        else:
            payload = desc + body
        pkt = _rtp([payload], [k], [k * 3000], 0xA0 + k % 3)[0]
        if kind == 3:
            pkt = _pad(pkt, int(rng.integers(1, 9)))
        out.append(pkt)
    return out


def test_vp8_descriptors_follow_jax():
    rng = np.random.default_rng(2)
    for args in ((True, 5, -1, -1, -1), (False, 300, 7, 2, 9),
                 (True, -1, -1, 1, -1), (False, -1, 200, -1, 3)):
        assert p_vp8.build_descriptor(*args) == j_vp8.build_descriptor(*args)
    jb, pb = _both_batches(_vp8_datagrams(rng))
    jd, pd = j_vp8.parse_descriptors(jb), p_vp8.parse_descriptors(pb)
    _fields_equal(jd, pd, "vp8")
    assert pd.valid.any() and not pd.valid.all()
    assert (pd.picture_id > 0x7F).any() and pd.is_keyframe.any()


def _vp9_datagrams(rng, n=160):
    out = []
    for k in range(n):
        flexible = bool(rng.integers(0, 2))
        inter = bool(rng.integers(0, 2))
        layered = bool(rng.integers(0, 2))
        kw = dict(
            begin=bool(rng.integers(0, 2)), end=bool(rng.integers(0, 2)),
            picture_id=int(rng.choice([-1, int(rng.integers(0, 0x80)),
                                       int(rng.integers(0x80, 0x8000))])),
            tid=int(rng.integers(0, 8)) if layered else -1,
            sid=int(rng.integers(0, 3)),
            tl0picidx=int(rng.integers(-1, 256)),
            inter_predicted=inter, flexible=flexible,
            pdiffs=[int(x) for x in rng.integers(1, 128,
                                                 int(rng.integers(1, 4)))]
            if flexible and inter else None,
            ss_sizes=[(320 << s, 180 << s)
                      for s in range(int(rng.integers(1, 4)))]
            if k % 7 == 0 else None)
        desc = j_vp9.build_descriptor(**kw)
        assert p_vp9.build_descriptor(**kw) == desc
        body = rng.integers(0, 256, int(rng.integers(1, 60)),
                            np.uint8).tobytes()
        kind = k % 5
        if kind == 1:
            payload = desc[:int(rng.integers(0, len(desc)))]
        elif kind == 2:
            payload = rng.integers(0, 256, int(rng.integers(1, 8)),
                                   np.uint8).tobytes()
        else:
            payload = desc + body
        pkt = _rtp([payload], [k], [k * 3000], 0xB0)[0]
        if kind == 3:
            pkt = _pad(pkt, int(rng.integers(1, 9)))
        out.append(pkt)
    return out


def test_vp9_descriptors_follow_jax():
    rng = np.random.default_rng(3)
    jb, pb = _both_batches(_vp9_datagrams(rng))
    jd, pd = j_vp9.parse_descriptors(jb), p_vp9.parse_descriptors(pb)
    _fields_equal(jd, pd, "vp9")
    assert pd.valid.any() and not pd.valid.all()
    assert pd.flexible.any() and pd.has_ss.any() and pd.is_keyframe.any()
    with pytest.raises(ValueError):
        p_vp9.build_descriptor(begin=True, flexible=True)


def _assembler_state(fa):
    return (fa._ts_high, fa._ts_last, fa._delivered_ts,
            fa.dropped_incomplete, fa.dropped_backlog, fa.dropped_late,
            fa.dropped_corrupt, sorted(fa._pending))


def test_vp8_packetize_and_assembly_follow_jax():
    """Frames packetized by both, sent reordered with loss and
    redelivery across the timestamp wrap, assembled by both: the same
    frames and counters after every push."""
    rng = np.random.default_rng(4)
    pkts, seq, ts = [], 65500, 0xFFFFFFFF - 5 * 3000
    for f in range(24):
        size = int(rng.integers(100, 5000))
        frame = bytes([int(rng.integers(0, 256)) & 0xFE | (f % 6 != 0)]) + \
            rng.integers(0, 256, size - 1, np.uint8).tobytes()
        pid = (120 + f) & 0x7FFF
        pls = j_vp8.packetize(frame, picture_id=pid, max_payload=1000,
                              tl0picidx=f & 0xFF, tid=f % 2)
        assert p_vp8.packetize(frame, picture_id=pid, max_payload=1000,
                               tl0picidx=f & 0xFF, tid=f % 2) == pls
        n = len(pls)
        pkts += _rtp(pls, [(seq + i) & 0xFFFF for i in range(n)],
                     [ts & 0xFFFFFFFF] * n, 0xC0,
                     marker=[0] * (n - 1) + [1])
        seq, ts = seq + n, ts + 3000
    order = np.arange(len(pkts))
    for lo in range(0, len(order), 6):        # reorder within windows
        rng.shuffle(order[lo:lo + 6])
    keep = [int(i) for i in order if rng.random() > 0.08]
    keep += [int(i) for i in rng.choice(keep, 10)]        # redelivery
    ja, pa = j_vp8.FrameAssembler(max_pending=6), \
        p_vp8.FrameAssembler(max_pending=6)
    got = 0
    for lo in range(0, len(keep), 5):
        chunk = [pkts[i] for i in keep[lo:lo + 5]]
        jb, pb = _both_batches(chunk)
        ja.push_batch(jb)
        pa.push_batch(pb)
        assert _assembler_state(pa) == _assembler_state(ja)
        frames = pa.pop_frames()
        assert frames == ja.pop_frames()
        got += len(frames)
    assert got > 0 and pa._ts_high == 1 << 32


def test_vp9_assembler_follows_jax():
    rng = np.random.default_rng(5)
    pkts = []
    for p in range(20):
        for s in range(3):
            parts = int(rng.integers(1, 4))
            for q in range(parts):
                desc = j_vp9.build_descriptor(
                    begin=q == 0, end=q == parts - 1, picture_id=300 + p,
                    tid=p % 2, sid=s, tl0picidx=p, inter_predicted=p > 0)
                body = rng.integers(0, 256, int(rng.integers(5, 50)),
                                    np.uint8).tobytes()
                pkts.append(desc + body)
    dgs = _rtp(pkts, list(range(len(pkts))), 0, 0xD0)
    dgs = [d for d in dgs if rng.random() > 0.1]          # loss
    jb, pb = _both_batches(dgs)
    jd, pd = j_vp9.parse_descriptors(jb), p_vp9.parse_descriptors(pb)
    ja, pa = j_vp9.Vp9FrameAssembler(), p_vp9.Vp9FrameAssembler()
    outs = [(ja.push(jd, jb, r), pa.push(pd, pb, r))
            for r in range(pb.batch_size)]
    assert all(a == b for a, b in outs)
    assert sum(b is not None for _, b in outs) > 10
    assert sorted(pa._partial) == sorted(ja._partial)


def test_h264_follows_jax():
    """Annex-B split, RFC 6184 packetize (single NAL, STAP-A, FU-A),
    depacketize and keyframe detection."""
    rng = np.random.default_rng(6)
    for trial in range(6):
        nals = []
        for k in range(int(rng.integers(1, 9))):
            typ = int(rng.choice([1, 5, 7, 8, 6]))
            size = int(rng.choice([int(rng.integers(2, 60)),
                                   int(rng.integers(1200, 4000))]))
            nals.append(bytes([0x60 | typ]) + rng.integers(
                1, 256, size - 1, np.uint8).tobytes())
        au = b"".join((b"\x00\x00\x00\x01" if k % 2 else b"\x00\x00\x01")
                      + n for k, n in enumerate(nals))
        assert p_h264.split_annexb(au) == j_h264.split_annexb(au)
        for mtu in (1200, 300):
            pls = j_h264.packetize(nals, mtu=mtu)
            assert p_h264.packetize(nals, mtu=mtu) == pls
            assert [p_h264.is_keyframe_payload(p) for p in pls] == \
                [j_h264.is_keyframe_payload(p) for p in pls]
            jd, pd = j_h264.H264Depacketizer(), p_h264.H264Depacketizer()
            for p in pls:
                assert pd.push(p) == jd.push(p)
            assert pd.keyframe_seen == jd.keyframe_seen
    # both refuse the same malformed payload
    for bad in (b"", bytes([24, 0, 9]), bytes([28])):
        outs = []
        for m in (j_h264, p_h264):
            try:
                outs.append(m.H264Depacketizer().push(bad))
            except Exception as e:           # noqa: BLE001
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], bad


def test_rtx_follows_jax():
    rng = np.random.default_rng(7)
    pls = [rng.integers(0, 256, int(k), np.uint8).tobytes()
           for k in rng.integers(0, 200, 12)]
    dgs = _rtp(pls, [65530 + i for i in range(12)], 9000, 0x1111)
    jb, pb = _both_batches(dgs)
    je = j_rtx.encapsulate_batch(jb, 0x2222, 97, 65533)
    pe = p_rtx.encapsulate_batch(pb, 0x2222, 97, 65533)
    assert pe.to_payloads() == je.to_payloads()
    jdb, jo = j_rtx.decapsulate_batch(je, 0x1111, 96)
    pdb, po = p_rtx.decapsulate_batch(pe, 0x1111, 96)
    assert pdb.to_payloads() == jdb.to_payloads()
    assert np.array_equal(po, jo) and pdb.to_payloads() == dgs
    # a short RTX packet (no OSN) decapsulates alike
    short = _rtp([b"\x01"], [5], 0, 0x2222, pt=97)
    for m, pk in ((j_rtx, j_packet), (p_rtx, p_packet)):
        short_out = m.decapsulate_batch(pk.PacketBatch.from_payloads(short),
                                        0x1111, 96)
        if m is j_rtx:
            want = (short_out[0].to_payloads(), list(short_out[1]))
        else:
            assert (short_out[0].to_payloads(), list(short_out[1])) == want
    # sender over a cache, receiver restoring the originals
    outs = []
    for m, c, pk in ((j_rtx, j_cache, j_packet), (p_rtx, p_cache,
                                                  p_packet)):
        cache = c.PacketCache()
        for i, d in enumerate(dgs):
            cache.insert(0x1111, (65530 + i) & 0xFFFF, d, now=1.0)
        snd = m.RtxSender(cache, 0x1111, 0x2222, 97)
        got = snd.on_nack([65531, 2, 3, 40])
        recv = m.RtxReceiver()
        recv.add_association(0x2222, 0x1111, 96)
        outs.append((got.to_payloads(), snd.served,
                     recv.restore(got), recv.recovered,
                     snd.on_nack([999])))
    assert outs[1] == outs[0]


# ------------------------------------------------------------ forwarders

def _simulcast_trace(rng, steps=40):
    """(batch datagrams, layer request or None) a step: three layers of
    VP8 with their own seq/ts/picture-id bases, keyframes every 8 frames
    and at random, loss, and redelivered packets."""
    ssrcs = [0x100, 0x101, 0x102]
    seq = [int(x) for x in rng.integers(0, 1 << 16, 3)]
    seq[1] = 65534                        # wraps early
    ts = [int(x) for x in rng.integers(0, 1 << 32, 3)]
    pid = [5, 0x7F0, 0x7FFE]
    sent, trace = [], []
    for step in range(steps):
        dgs = []
        for layer in range(3):
            key = step % 8 == 0 or rng.random() < 0.1
            size = 300 * (layer + 1) + int(rng.integers(0, 600))
            frame = bytes([0x00 if key else 0x01]) + \
                bytes([layer, step & 0xFF]) + rng.integers(
                    0, 256, size, np.uint8).tobytes()
            pls = j_vp8.packetize(frame, picture_id=pid[layer] & 0x7FFF,
                                  max_payload=700)
            n = len(pls)
            dgs += _rtp(pls, [(seq[layer] + i) & 0xFFFF for i in range(n)],
                        [ts[layer] & 0xFFFFFFFF] * n, ssrcs[layer],
                        marker=[0] * (n - 1) + [1])
            seq[layer] += n
            ts[layer] += 3000
            pid[layer] += 1
        kept = [d for d in dgs if rng.random() > 0.05]
        if sent and rng.random() < 0.3:
            kept += [sent[int(i)] for i in rng.integers(0, len(sent), 2)]
        sent += dgs
        req = int(rng.integers(0, 3)) if rng.random() < 0.2 else None
        trace.append((kept, req))
    return ssrcs, trace


def _simulcast_state(f):
    return (f.current_layer, f.target_layer, f._seq_delta, f._ts_delta,
            f._pic_id_delta, f._last_out_seq, f._last_out_ts,
            f._last_out_pid, f.forwarded, f.switches,
            f.tracker.last_picture_id.tolist(), f.tracker.last_tl0.tolist(),
            f.tracker.keyframe_seen.tolist(), f.tracker.frames.tolist())


def test_simulcast_forwarder_follows_jax():
    rng = np.random.default_rng(8)
    ssrcs, trace = _simulcast_trace(rng)
    jf = j_simulcast.SimulcastForwarder(ssrcs, out_ssrc=0xFEED)
    pf = p_simulcast.SimulcastForwarder(ssrcs, out_ssrc=0xFEED)
    out = 0
    for dgs, req in trace:
        if req is not None:
            assert pf.request_layer(req) == jf.request_layer(req)
        assert pf.awaiting_keyframe == jf.awaiting_keyframe
        jb, pb = _both_batches(dgs)
        got = pf.forward(pb)
        assert got == jf.forward(jb)
        assert _simulcast_state(pf) == _simulcast_state(jf)
        out += len(got)
    assert out > 0 and pf.switches > 1
    with pytest.raises(IndexError):
        pf.request_layer(3)


def _svc_trace(rng, steps=60):
    """VP9 SVC pictures (3 spatial x temporal 0/1 with U bits), keyframes,
    loss, redelivery and late first arrivals; a layer request now and
    then."""
    pkts, seq, trace, sent = [], 400, [], []
    for p in range(steps):
        key = p % 10 == 0 or rng.random() < 0.05
        tid = 0 if key else p % 2
        dgs = []
        for s in range(3):
            parts = int(rng.integers(1, 3))
            for q in range(parts):
                desc = j_vp9.build_descriptor(
                    begin=q == 0, end=q == parts - 1,
                    picture_id=(0x7FF0 + p) & 0x7FFF, tid=tid, sid=s,
                    tl0picidx=p & 0xFF, inter_predicted=not (key and s == 0))
                if rng.random() < 0.2:
                    desc = bytes([desc[0]]) + desc[1:3] + bytes(
                        [desc[3] | 0x10]) + desc[4:]       # U bit
                body = bytes([0x80 | s, p & 0xFF]) * 12
                dgs += _rtp([desc + body], [seq & 0xFFFF], p * 3000, 0xC0DE,
                            marker=[int(q == parts - 1 and s == 2)])
                seq += 1
        kept = [d for d in dgs if rng.random() > 0.07]
        if sent and rng.random() < 0.3:
            kept += [sent[int(i)] for i in rng.integers(0, len(sent), 2)]
        if len(kept) > 2 and rng.random() < 0.2:
            kept[0], kept[-1] = kept[-1], kept[0]
        sent += dgs
        req = None
        if rng.random() < 0.2:
            req = (int(rng.integers(0, 3)), int(rng.integers(0, 3)))
        trace.append((kept, req))
    return trace


def _svc_state(f):
    return (f.current_sid, f.target_sid, f.current_tid, f.target_tid,
            list(f._seq_map.items()), f._next_out, f._max_orig, f._cur_pid,
            f._pic_max_sid, f._prev_pic_max_sid, f.forwarded, f.dropped,
            f.late_dropped, f.switches)


def test_svc_forwarder_follows_jax():
    rng = np.random.default_rng(9)
    trace = _svc_trace(rng)
    jf, pf = j_svc.Vp9SvcForwarder(), p_svc.Vp9SvcForwarder()
    out = 0
    for dgs, req in trace:
        if req is not None:
            assert pf.request_layers(*req) == jf.request_layers(*req)
        assert pf.awaiting_keyframe == jf.awaiting_keyframe
        jb, pb = _both_batches(dgs)
        got = pf.forward(pb)
        assert got == jf.forward(jb)
        assert _svc_state(pf) == _svc_state(jf)
        out += len(got)
    assert out > 0 and pf.switches > 0 and pf.dropped > 0


def test_webm_writer_follows_jax(tmp_path):
    rng = np.random.default_rng(10)
    frames = [(rng.integers(0, 256, int(rng.integers(50, 4000)),
                            np.uint8).tobytes(), k * 33, k % 30 == 0)
              for k in range(70)]
    blobs = []
    for m, name in ((j_webm, "j.webm"), (p_webm, "p.webm")):
        w = m.WebmWriter(str(tmp_path / name), width=1280, height=720)
        for f, ts, key in frames:
            w.write_frame(f, ts, keyframe=key)
        w.close()
        blobs.append((tmp_path / name).read_bytes())
    assert blobs[1] == blobs[0] and len(blobs[0]) > sum(
        len(f) for f, _, _ in frames)
