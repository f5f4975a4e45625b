"""The port's mixed-rate conference bridge against the JAX bridge, on the CPU.

A bridge whose first joiner speaks G.722 (so the bridge clock is 16 kHz)
with two PCMU legs at 8 kHz, and one whose first joiner speaks Opus
(48 kHz), each beside the JAX `ConferenceBridge` given the port's CPU SRTP
tables (as `test_torch_conference._jax_bridge(False)` does), fed the same
wire at the same `now`: per tick the wire bytes and levels must be
identical, and at the end `lost_frames`.  The PCMU legs go through the
resampler on deposit and on egress (the plain version of kernel R, two
calls a tick).  Then a JAX bridge's `snapshot()` restored by the port and
by JAX runs three more ticks with equal bytes; a port snapshot has JAX's
keys, resumes on its recorded clock with its G.722 leg degraded, and a
sharded snapshot is refused.  The Opus case runs where the system libopus
loads.  Tolerance: exact equality.
"""

import time

import numpy as np
import pytest
import torch

import libjitsi_tpu
from libjitsi_tpu.codecs.opus import opus_available
from libjitsi_tpu.io.udp import UdpEngine as JaxUdp
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.service import pump as jpump
from libjitsi_tpu.service.bridge import ConferenceBridge as JaxBridge
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.service import pump
from libjitsi_tpu_torch.service.bridge import ConferenceBridge
from libjitsi_tpu_torch.transform.engine import TransformEngineChain
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from test_torch_conference import _drain, _jax_bridge, _keys
from test_torch_threads import one_torch_thread  # noqa: F401

needs_opus = pytest.mark.skipif(not opus_available(),
                                reason="system libopus not available")

# the first joiner (wideband) and two PCMU parties; party 2 loses tick 3
TONES = (1800.0, 500.0, 900.0)
SSRCS = (0x5010, 0x5020, 0x5030)


def _legs(first: str, pkg: str):
    """The three parties' codec legs for one package's bridge."""
    mod = jpump if pkg == "jax" else pump
    wide = mod.g722_codec() if first == "G722" else mod.opus_codec()
    pcmu = [jpump.g711_codec(True) if pkg == "jax"
            else pump.g711_codec(True, device="cpu") for _ in range(2)]
    return [wide] + pcmu


def _wires(first: str, ticks: int):
    """Each tick's protected wire of the three parties: tones with their
    RFC 6464 levels, the first party's coded by its own (stateful) leg."""
    up = SrtpStreamTable(3, device="cpu")
    for i in range(3):
        up.add_stream(i, *_keys(i)[0])
    sender = pump.g722_codec() if first == "G722" else pump.opus_codec()
    out = []
    for tick in range(ticks):
        rows = []
        for i, freq in enumerate(TONES):
            if i == 2 and tick == 3:
                continue
            rate, step = ((sender.sample_rate, sender.ts_step) if i == 0
                          else (8000, 160))
            n = rate // 50
            t = tick * n + np.arange(n)
            amp = 7000 if i == 0 else 3000 + 2000 * i
            pcm = (amp * np.sin(2 * np.pi * freq * t / rate)).astype(np.int16)
            code = (sender.encode(pcm) if i == 0 else g711.ulaw_encode(
                torch.from_numpy(pcm)).numpy().tobytes())
            rows.append((i, code, tick * step, 20 + 15 * i))
        batch = j_header.build(
            [r[1] for r in rows], [100 * (r[0] + 1) + tick for r in rows],
            [r[2] for r in rows], [SSRCS[r[0]] for r in rows],
            [sender.pt if r[0] == 0 else 0 for r in rows],
            stream=[r[0] for r in rows],
            ext=[(0xBEDE, bytes([0x10, r[3], 0, 0])) for r in rows])
        out.append(up.protect_rtp(batch))
    return out


def _join(bridge, legs):
    for i, codec in enumerate(legs):
        rx, tx = _keys(i)
        assert bridge.add_participant(SSRCS[i], rx, tx, codec=codec) == i


def _run(bridge, client, wires, now, counts=None):
    """Send each wire, tick, and return each tick's (levels, sorted wire
    bytes it sent back)."""
    out = []
    for k, wire in enumerate(wires):
        client.send_batch(wire, "127.0.0.1", bridge.port)
        time.sleep(0.005)
        kbuild.reset_counts()
        stats = bridge.tick(now=now + 0.02 * k)
        if counts is not None:
            counts.append(kbuild.plain_calls["resample"])
        assert stats["rx"] == wire.batch_size and stats["tx"] == 3
        back = sorted(_drain(client, 3))
        assert len(back) == 3
        out.append((np.asarray(stats["levels"]).copy(), back))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (la, wa), (lb, wb) in zip(a, b):
        assert np.array_equal(la, lb)
        assert wa == wb


def _port_tables(jb, snap=None):
    """Give a JAX bridge the port's CPU SRTP tables (fresh, or restored
    from a snapshot), as `_jax_bridge(False)` does."""
    mk = ((lambda k: SrtpStreamTable(8, device="cpu")) if snap is None else
          (lambda k: SrtpStreamTable.restore(snap[k], "cpu")))
    jb.rx_table, jb.tx_table = mk("rx_table"), mk("tx_table")
    jb.chain = TransformEngineChain(
        [jb.levels_engine, SrtpTransformEngine(jb.tx_table, jb.rx_table)])
    jb.loop.chain = jb.chain


@pytest.mark.parametrize("first", ["G722",
                                   pytest.param("OPUS", marks=needs_opus)])
def test_off_rate_bridge_follows_jax_bridge_tick_by_tick(first):
    jbridge = _jax_bridge(False)
    pbridge = ConferenceBridge(port=0, capacity=8, device="cpu")
    _join(jbridge, _legs(first, "jax"))
    _join(pbridge, _legs(first, "port"))
    rate = 16000 if first == "G722" else 48000
    assert jbridge._rate == pbridge._rate == rate
    for f in ("_tx_seq", "_tx_ts", "_tx_ssrc"):
        getattr(pbridge, f)[:] = getattr(jbridge, f)
    wires = _wires(first, 6)
    clients = [JaxUdp(port=0, max_batch=64), JaxUdp(port=0, max_batch=64)]
    counts = []
    try:
        got = {name: _run(b, c, wires, 400.0, counts if name == "port"
                          else None)
               for name, b, c in (("jax", jbridge, clients[0]),
                                  ("port", pbridge, clients[1]))}
    finally:
        for c in clients:
            c.close()
        jbridge.close()
        pbridge.close()
    _same(got["jax"], got["port"])
    # one deposit group (the PCMU rows) and one egress kind (PCMU)
    assert counts == [2] * 6
    assert np.array_equal(jbridge.bank.lost_frames, pbridge.bank.lost_frames)
    assert pbridge.bank.lost_frames[2] >= 1
    assert np.array_equal(jbridge.bank.decode_errors,
                          pbridge.bank.decode_errors)
    # the wideband party hears the PCMU parties (resampled up and mixed)
    # and they hear it (mixed and resampled down): every reply opens
    down = SrtpStreamTable(8, device="cpu")
    for i in range(3):
        down.add_stream(i, *_keys(i)[1])
    batch = PacketBatch.from_payloads([p for _l, w in got["port"] for p in w])
    batch.stream[:] = j_header.parse(batch).ssrc - 0x42000000
    _dec, ok = down.unprotect_rtp(batch)
    assert ok.all() and len(ok) == 18


def _jax_g722_bridge(client, wires):
    """A JAX bridge (the port's tables) with the G.722-first conference,
    three ticks run."""
    jb = _jax_bridge(False)
    _join(jb, _legs("G722", "jax"))
    _run(jb, client, wires[:3], 500.0)
    return jb


def test_jax_snapshot_restored_by_port_and_by_jax_runs_alike():
    wires = _wires("G722", 6)
    client = JaxUdp(port=0, max_batch=64)
    bridges = []
    try:
        jb = _jax_g722_bridge(client, wires)
        bridges.append(jb)
        snap = jb.snapshot()
        jb.close()
        assert snap["rate"] == 16000 and snap["degraded_rows"] == [0]
        pb = ConferenceBridge.restore(snap, device="cpu")
        bridges.append(pb)
        jr = JaxBridge.restore(libjitsi_tpu.configuration_service(), snap)
        _port_tables(jr, snap)
        bridges.append(jr)
        assert pb._rate == jr._rate == 16000
        assert pb.bank.frame_samples[:3].tolist() == [320, 160, 160]
        assert [pb._codec[s].name for s in range(3)] == ["G722", "PCMU",
                                                         "PCMU"]
        got = [_run(b, client, wires[3:], 500.06) for b in (pb, jr)]
    finally:
        client.close()
        for b in bridges:
            b.close()
    _same(got[0], got[1])
    assert np.array_equal(pb.bank.jb.next_seq, jr.bank.jb.next_seq)
    assert np.array_equal(pb._tx_seq, jr._tx_seq)


def test_port_snapshot_has_jax_keys_and_resumes_its_clock():
    wires = _wires("G722", 4)
    client = JaxUdp(port=0, max_batch=64)
    bridges = []
    try:
        jb = _jax_g722_bridge(client, wires)
        bridges.append(jb)
        pb = ConferenceBridge(port=0, capacity=8, device="cpu")
        bridges.append(pb)
        _join(pb, _legs("G722", "port"))
        _run(pb, client, wires[:2], 600.0)
        psnap, jsnap = pb.snapshot(), jb.snapshot()
        assert sorted(psnap) == sorted(jsnap)
        assert sorted(psnap["speaker"]) == sorted(jsnap["speaker"])
        for k in ("rx_table", "tx_table", "jb"):
            assert sorted(psnap[k]) == sorted(jsnap[k]), k
        for k in ("rate", "frame_samples", "degraded_rows", "codec_name",
                  "ssrc_of", "sharded", "ptime_ms", "level_ext_id"):
            assert psnap[k] == jsnap[k], k
        pb.close()
        back = ConferenceBridge.restore(psnap, device="cpu")
        bridges.append(back)
        assert (back._rate, back._frame_samples) == (16000, 320)
        assert back.snapshot()["degraded_rows"] == [0]
        _run(back, client, wires[2:], 600.04)
        assert back.bank.decoded_frames[:3].tolist() == [2, 2, 1]
        with pytest.raises(ValueError, match="item 12"):
            ConferenceBridge.restore(dict(psnap, sharded=True),
                                     device="cpu")
    finally:
        client.close()
        for b in bridges:
            b.close()
