"""The port's pipelined tick on the CPU: `MediaLoop(pipeline_depth=N)`,
`drain`, `send_media_async` / `flush_sends`, the UDP engine's arena
views, and `SfuBridge(pipelined=True)`.

Twins of the JAX package's cases (`tests/test_pipeline_depth.py`,
`test_loop.py`, `test_sfu_bridge.py`), held against JAX where bytes are
made: the echo replies of the port's loop at depths 1-3 equal, as a set
and in each stream's order, the replies of the JAX loop at depth 1 on
the same datagrams (run once, over the port's CPU tables, its wire held
against one eager protect of the JAX table under `jax.disable_jit`: a
compiled JAX table costs ~20 s cold here), and the pipelined send path
equals the sync one.  The twin of
`test_depth3_journey_p99_inside_tick_budget` asserts the journey
accounting the bound rests on, not a wall-clock p99 (which
`chip_smoke.py` prints from the card): every packet's journey is charged
to the tick it arrived on, and no dispatch gets older than
`pipeline_depth - 1` ticks.  The pipelined SFU delivers every copy once,
equal on the wire and in NACK service to the serial SFU's.  Client
tables are the port's CPU tables.  Tolerance: exact bytes.
"""

import socket
import struct
import time

import jax
import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.io.loop import MediaLoop as JaxLoop
from libjitsi_tpu.service.media_stream import StreamRegistry as JaxRegistry
from libjitsi_tpu.transform import SrtpTransformEngine as JaxSrtpEngine
from libjitsi_tpu.transform import TransformEngineChain as JaxChain
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu.utils.metrics import count_exemplars, validate_exposition
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import ARENAS, UdpEngine
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
from libjitsi_tpu_torch.transform.engine import TransformEngineChain
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from libjitsi_tpu_torch.utils.flight import FlightRecorder
from test_torch_sfu_bridge import _Endpoint, _mesh

LOCALHOST = struct.unpack("!I", socket.inet_aton("127.0.0.1"))[0]
SSRCS = (0x1111, 0x2222)
MK, MS = bytes(range(16)), bytes(range(14))
MK2, MS2 = bytes(range(100, 116)), bytes(range(60, 74))
N_TICKS, PER_STREAM = 12, 2


def _table(cls=SrtpStreamTable, key=(MK, MS), **kw):
    t = cls(8, **kw)
    for sid in range(len(SSRCS)):
        t.add_stream(sid, *key)
    return t


def _rtp(ssrc, seq, payload=b"x" * 40):
    return struct.pack("!BBHII", 0x80, 96, seq & 0xFFFF, seq, ssrc) + payload


def _echo(batch, ok):
    rows = np.nonzero(ok)[0]
    if len(rows) == 0:
        return None
    return PacketBatch(batch.data[rows].copy(),
                       np.asarray(batch.length)[rows].copy(),
                       np.asarray(batch.stream)[rows].copy())


def _registry(cls=StreamRegistry, **kw):
    reg = cls(capacity=8, **kw)
    for i, ssrc in enumerate(SSRCS):
        reg.map_ssrc(ssrc, i)
    return reg


def _loop(engine, depth, **kw):
    chain = TransformEngineChain([SrtpTransformEngine(
        _table(key=(MK2, MS2), device="cpu"), _table(device="cpu"))])
    return MediaLoop(engine, _registry(device="cpu"), on_media=_echo,
                     chain=chain, recv_window_ms=1, pipeline_depth=depth,
                     **kw)


def _client_wire():
    """Each tick's datagrams: PER_STREAM packets of each stream, from the
    client's table (the bridge's rx keys)."""
    tx = _table(device="cpu")
    # the first stream's seqs wrap
    seq = {s: 65530 - i * 1000 for i, s in enumerate(SSRCS)}
    ticks = []
    for _ in range(N_TICKS):
        pkts, sids = [], []
        for sid, ssrc in enumerate(SSRCS):
            for _ in range(PER_STREAM):
                pkts.append(_rtp(ssrc, seq[ssrc]))
                seq[ssrc] += 1
                sids.append(sid)
        ticks.append(tx.protect_rtp(PacketBatch.from_payloads(
            pkts, stream=sids)).to_payloads())
    return ticks


@pytest.fixture(scope="module")
def wire():
    return _client_wire()


class _StubEngine:
    """The JAX loop's engine: each tick's datagrams from a list, the
    sends captured."""

    port = 0

    def __init__(self, ticks):
        self.ticks = list(ticks)
        self.sent = []

    def recv_batch(self, timeout_ms):
        pkts = self.ticks.pop(0) if self.ticks else []
        n = len(pkts)
        return (JaxBatch.from_payloads(pkts), np.full(n, LOCALHOST,
                                                     np.uint32),
                np.full(n, 5004, np.uint16))

    def send_batch(self, batch, ip, port):
        self.sent += [batch.to_bytes(i) for i in range(batch.batch_size)]
        return batch.batch_size


@pytest.fixture(scope="module")
def jax_echo(wire):
    """The JAX loop's depth-1 echo of every tick, in send order.  The
    loop's chain holds the port's CPU tables (a JAX table runs ~1 s a
    call eagerly here, ~20 s to compile), and the echo is held against
    one eager protect by the JAX table of the replies it sent."""
    import libjitsi_tpu

    libjitsi_tpu.stop()
    libjitsi_tpu.init()
    reg = JaxRegistry(libjitsi_tpu.configuration_service(), capacity=8)
    for i, ssrc in enumerate(SSRCS):
        reg.map_ssrc(ssrc, i)
    chain = JaxChain([JaxSrtpEngine(_table(key=(MK2, MS2), device="cpu"),
                                    _table(device="cpu"))])
    eng = _StubEngine(wire)
    plain = []

    def on_media(batch, ok):
        rows = np.nonzero(ok)[0]
        plain.extend(batch.to_bytes(int(i)) for i in rows)
        return JaxBatch(batch.data[rows].copy(),
                        np.asarray(batch.length)[rows].copy(),
                        np.asarray(batch.stream)[rows].copy())

    loop = JaxLoop(eng, reg, on_media=on_media, chain=chain,
                   pipeline_depth=1)
    for _ in range(N_TICKS):
        loop.tick()
    assert len(eng.sent) == N_TICKS * PER_STREAM * len(SSRCS)
    ref = _table(JaxTable, (MK2, MS2))
    with jax.disable_jit():
        want = ref.protect_rtp(JaxBatch.from_payloads(
            plain, stream=[(struct.unpack("!I", p[8:12])[0] == SSRCS[1])
                           * 1 for p in plain]))
    assert eng.sent == [want.to_bytes(i) for i in range(want.batch_size)]
    return eng.sent


def _collect(engine, want, timeout_s=2.0):
    out = []
    deadline = time.time() + timeout_s
    while time.time() < deadline and len(out) < want:
        rb, _, _ = engine.recv_batch(timeout_ms=20)
        out += rb.to_payloads()
    return out


def _stream_seqs(replies):
    return [(struct.unpack("!I", r[8:12])[0], struct.unpack("!H", r[2:4])[0])
            for r in replies]


def _drive(loop, peer, engine, wire, each_tick=None):
    """Send each tick's datagrams and tick until the loop took them."""
    sent = 0
    for t, pkts in enumerate(wire):
        peer.send_batch(PacketBatch.from_payloads(pkts), LOCALHOST,
                        engine.port)
        got = 0
        for _ in range(200):
            got += loop.tick()
            if each_tick is not None:
                each_tick(loop)
            if got >= len(pkts):
                break
        assert got == len(pkts)
        sent += got
    return sent


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_delivers_every_packet_once_in_stream_order(depth, wire,
                                                          jax_echo):
    """No drop, no duplicate, no reorder within a stream at any depth, and
    the replies are the JAX depth-1 loop's, byte for byte."""
    with UdpEngine(port=0) as peer, UdpEngine(port=0) as engine:
        loop = _loop(engine, depth)
        sent = _drive(loop, peer, engine, wire)
        for _ in range(depth + 2):          # idle ticks drain
            loop.tick()
        loop.drain()
        assert not loop._rx_inflight and not loop._inflight
        replies = _collect(peer, sent)
    assert len(replies) == sent == len(jax_echo)
    got = _stream_seqs(replies)
    assert len(set(got)) == sent, "duplicate (ssrc, seq) delivered"
    for ssrc in SSRCS:
        seqs = [s for ss, s in got if ss == ssrc]
        assert seqs == [s for ss, s in _stream_seqs(jax_echo) if ss == ssrc]
    assert sorted(replies) == sorted(jax_echo)
    assert loop.journey_hist.count == sent
    assert engine.arena_grows == 0 and all(a.pins == 0
                                           for a in engine._ring)


def test_depth3_journeys_charge_the_arrival_tick(wire):
    """The journey accounting under depth 3: every reply's journey is
    observed against the trace of the tick its request arrived on, each
    packet once, and no dispatch is older than pipeline_depth - 1 ticks
    at any tick (the pipeline does reach that depth)."""
    depth = 3
    notes = []
    ages = []
    arrived = {}
    with UdpEngine(port=0) as peer, UdpEngine(port=0) as engine:
        flight = FlightRecorder()
        loop = _loop(engine, depth, flight=flight)
        orig = loop.note_journey_at

        def note(origin, n, sids=None):
            notes.append((origin[0], n))
            return orig(origin, n, sids=sids)

        loop.note_journey_at = note

        def each_tick(lp):
            ages.append(lp.dispatch_inflight_ticks)
            assert lp._inflight_age() <= depth - 1

        rx0 = [0]

        def record(lp):
            each_tick(lp)
            if lp.rx_packets > rx0[0]:
                arrived[lp.trace_id] = lp.rx_packets - rx0[0]
                rx0[0] = lp.rx_packets

        sent = _drive(loop, peer, engine, wire, record)
        loop.drain()
        replies = _collect(peer, sent)
    assert len(replies) == sent
    assert max(ages) == depth - 1 and all(a <= depth - 1 for a in ages)
    charged = {}
    for trace, n in notes:
        charged[trace] = charged.get(trace, 0) + n
    assert charged == arrived
    assert loop.journey_hist.count == sent
    # every tick's headers were sampled under its trace
    hdr = [e for e in flight.dump(0)["events"] if e["kind"] == "hdr"]
    assert {e["trace"] for e in hdr} <= set(arrived)
    # the registry's exposition passes the JAX package's validator, and
    # the OpenMetrics one carries the journeys' trace-id exemplars
    text = loop.metrics.render()
    assert validate_exposition(text) == []
    assert 'libjitsi_tpu_packet_journey_seconds_count{hop="local"}' in text
    om = loop.metrics.render(openmetrics=True)
    assert validate_exposition(om, openmetrics=True) == []
    assert count_exemplars(om) >= 1
    assert loop.perf.sampled_ticks >= 1 and loop.perf.d2h_bytes > 0
    assert set(loop.perf.last_phases) == {
        "host_python", "dispatch", "h2d_transfer", "device_compute",
        "d2h_transfer", "idle"}
    assert loop.tracer.take_ledger().keys() >= {"ingress", "reverse_chain",
                                                "forward_chain", "egress"}


def test_checkpoint_mid_pipeline_drains_then_delivers_exactly_once(wire):
    """`drain()` is the barrier a checkpoint runs behind: with work in
    flight at depth 3 it materializes everything, the receive table's
    snapshot then holds every packet received so far, and nothing is
    lost or sent twice across it."""
    with UdpEngine(port=0) as peer, UdpEngine(port=0) as engine:
        loop = _loop(engine, 3)
        rx = loop.chain.engines[0].rx
        snap = {}

        def checkpoint(lp):
            if lp.rx_packets == 8 * len(wire[0]) and not snap:
                assert lp._rx_inflight or lp._inflight
                lp.drain()
                assert not lp._rx_inflight and not lp._inflight
                snap.update(rx.snapshot())

        sent = _drive(loop, peer, engine, wire, checkpoint)
        for _ in range(5):
            loop.tick()
        loop.drain()
        replies = _collect(peer, sent)
    assert snap, "the checkpoint never ran"
    assert len(replies) == sent
    assert len(set(_stream_seqs(replies))) == sent
    # the snapshot saw the 8 ticks before it: each stream's highest index
    for sid in range(len(SSRCS)):
        assert snap["rx_max"][sid] == (65530 - sid * 1000
                                       + 8 * PER_STREAM - 1)


def test_arena_views_survive_pinning_and_ring_growth():
    """A pinned view's bytes are never overwritten by later windows, even
    when every arena is pinned and the ring must grow; a double release
    steals no pin."""
    with UdpEngine(port=0) as tx_eng, \
            UdpEngine(port=0, max_batch=8) as rx:
        rows = rx._rows
        views = []
        # one window more than the ring holds
        for tag in range(0xA1, 0xA1 + ARENAS + 1):
            tx_eng.send_batch(PacketBatch.from_payloads(
                [bytes([tag]) * 60] * rows), LOCALHOST, rx.port)
            got, batches = 0, []
            for _ in range(100):
                batch, _sip, _sport = rx.recv_batch_view(timeout_ms=20)
                if batch.batch_size:
                    batches.append(batch)
                got += batch.batch_size
                if got >= rows:
                    break
            assert got == rows
            views.append((tag, batches))
        assert rx.arena_grows >= 1, "the ring should have grown"
        for tag, batches in views:
            for batch in batches:
                assert (batch.data[:, :60] == tag).all()
        for _tag, batches in views:
            for batch in batches:
                rx.release_arena(batch.arena_token)
                rx.release_arena(batch.arena_token)
        assert all(a.pins == 0 for a in rx._ring)
        # a copying receive pins nothing
        tx_eng.send_batch(PacketBatch.from_payloads([b"\x80" * 20]),
                          LOCALHOST, rx.port)
        batch, _, _ = rx.recv_batch(timeout_ms=200)
        assert batch.batch_size == 1 and all(a.pins == 0 for a in rx._ring)


def test_raising_rtcp_handler_leaves_no_arena_pinned(wire):
    """Under the deep pipeline a handler that raises mid-window drops the
    window's arena pin on its way out, and the RTP dispatched in that
    window keeps its own until it materializes: the ring never grows."""
    def on_rtcp(batch, ok):
        raise RuntimeError("handler failed")

    rr = struct.pack("!BBHI", 0x80, 201, 1, SSRCS[0])
    srtcp = _table(device="cpu").protect_rtcp(PacketBatch.from_payloads(
        [rr], stream=[0])).to_payloads()
    with UdpEngine(port=0) as peer, UdpEngine(port=0) as engine:
        loop = _loop(engine, 3, on_rtcp=on_rtcp)
        for pkts in (srtcp, wire[0] + srtcp, srtcp, wire[1] + srtcp):
            peer.send_batch(PacketBatch.from_payloads(pkts), LOCALHOST,
                            engine.port)
            with pytest.raises(RuntimeError, match="handler failed"):
                for _ in range(200):
                    loop.tick()
        loop.drain()
        assert not loop._rx_inflight
        assert engine.arena_grows == 0
        assert all(a.pins == 0 for a in engine._ring)


class _CaptureEngine:
    port = 0

    def __init__(self):
        self.sent = []

    def recv_batch(self, timeout_ms):
        return (PacketBatch.from_payloads([]), np.zeros(0, np.uint32),
                np.zeros(0, np.uint16))

    def send_rows(self, batch, rows, ip, port):
        self.sent += [batch.to_bytes(int(i)) for i in rows]
        return len(rows)


def _send_loop(pipelined):
    reg = StreamRegistry(capacity=4, device="cpu")
    tx = SrtpStreamTable(4, device="cpu")
    tx.add_stream(2, MK, MS)
    rx = SrtpStreamTable(4, device="cpu")
    rx.add_stream(2, MK, MS)
    eng = _CaptureEngine()
    loop = MediaLoop(eng, reg, chain=TransformEngineChain(
        [SrtpTransformEngine(tx, rx)]), pipelined=pipelined)
    loop.addr_ip[2] = 0x7F000001
    loop.addr_port[2] = 4444
    return loop, eng


def test_send_media_async_flush_matches_sync():
    """Dispatch-only protect and the next tick's flush send the same
    datagrams as the sync path (whose bytes `tests/test_torch_loop.py`
    holds against the JAX table)."""
    batch = rtp_header.build([b"pipelined-%d" % i for i in range(5)],
                             [800 + i for i in range(5)], [0] * 5,
                             [0xF00D] * 5, [96] * 5, stream=[2] * 5)
    sync_loop, sync_eng = _send_loop(False)
    sync_loop.send_media(batch.copy())
    pipe_loop, pipe_eng = _send_loop(True)
    assert pipe_loop.send_media_async(batch.copy()) == 5
    assert pipe_eng.sent == [], "async sent before the flush"
    pipe_loop.tick()                 # the next tick flushes
    assert pipe_eng.sent == sync_eng.sent and len(pipe_eng.sent) == 5
    assert pipe_loop.flush_sends() == 0


def test_scrape_sees_live_inflight_age_not_last_tick_note():
    """The age gauge is read live: a scrape between ticks sees the
    dispatch aging, and zero right after a flush."""
    loop, _eng = _send_loop(True)
    batch = rtp_header.build([b"inflight-x"], [1], [0], [0xF00D], [96],
                             stream=[2])
    assert loop.send_media_async(batch) == 1
    loop.ticks += 3                  # ticks pass, no flush, no note
    assert loop._inflight_age() == 3
    assert loop.dispatch_inflight_ticks == 0
    assert "libjitsi_tpu_dispatch_inflight_ticks 3" in loop.metrics.render()
    loop.flush_sends()
    assert "libjitsi_tpu_dispatch_inflight_ticks 0" in loop.metrics.render()


def _sfu_run(pipelined):
    """Three endpoints, four rounds of media, then a NACK from the first
    for a seq of the second; returns (bridge counters, every datagram the
    bridge sent, what the victim got back)."""
    sfu = SfuBridge(port=0, capacity=8, recv_window_ms=0,
                    pipelined=pipelined, device="cpu")
    sent = []
    orig = sfu.loop.engine.send_batch
    sfu.loop.engine.send_batch = lambda b, ip, port: (
        sent.extend(b.to_bytes(i) for i in range(b.batch_size)),
        orig(b, ip, port))[1]
    eps = [_Endpoint(0x300 + 5 * k, sfu.port) for k in range(3)]
    for e in eps:
        sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    for rnd in range(4):
        for e in eps:
            e.send_media()
        for _ in range(12):           # the flush rides a later tick
            sfu.tick(now=70.0 + rnd * 0.02)
        for e in eps:
            for _ in range(3):
                e.drain()
    pending = len(sfu._pending_fanout)
    got = [dict(e.got) for e in eps]
    victim = eps[0]
    victim.got.clear()
    for ssrc, row in victim.row_of.items():
        victim.open.add_stream(row, *victim.tx_key)
    victim.send_nack(eps[1].ssrc, [501])
    for _ in range(12):
        sfu.tick(now=70.2)
    for _ in range(3):
        victim.drain()
    out = dict(forwarded=sfu.forwarded, retransmitted=sfu.retransmitted,
               pending=pending, journeys=sfu.loop.journey_hist.count)
    sfu.close()
    for e in eps:
        e.engine.close()
    return out, sent, got, dict(victim.got), eps


def test_sfu_pipelined_fanout_delivers_everything():
    """Pipelined SfuBridge: the fan-out dispatched in one tick ships in a
    later one; every endpoint hears every other's media once and not its
    own, the bridge sends the serial bridge's datagrams, and NACK service
    against the flushed cache returns the serial bridge's copy."""
    kbuild.reset_counts()
    serial, s_sent, s_got, s_nack, _ = _sfu_run(False)
    pipe, p_sent, p_got, p_nack, eps = _sfu_run(True)
    assert pipe["pending"] == 0, "a pending fan-out was never flushed"
    assert pipe["forwarded"] == serial["forwarded"] == 4 * 3 * 4 * 2
    assert pipe["journeys"] == pipe["forwarded"]
    assert kbuild.plain_calls["srtp_fanout_cm"] > 0
    for e, got in zip(eps, p_got):
        assert len(got) == 4 * 4 * 2
        for (ssrc, seq), payload in got.items():
            assert ssrc != e.ssrc and payload == b"m-%08x-%d" % (ssrc, seq)
    assert p_got == s_got
    assert sorted(p_sent) == sorted(s_sent)
    assert pipe["retransmitted"] == serial["retransmitted"] == 1
    assert list(p_nack) == [(eps[1].ssrc, 501)] and p_nack == s_nack
