"""The port's host I/O plane against the JAX package, on the CPU.

- pcap and rtpdump: the same datagrams and stamps give byte-equal files
  from both packages' writers, and each package's reader reads the
  other's file.
- The UDP engine: kernel arrival stamps (`recv_batch_ts`, `_view`) are
  int64, row-aligned, non-decreasing and inside the receive's host
  window, and the view pins its arena like `recv_batch_view`; two
  SO_REUSEPORT engines on one port receive what was sent between them;
  `create_with_retry` backs off as the JAX engine does; io_uring is
  refused.
- `MediaLoop` against the JAX `MediaLoop` (chain=None): the same
  datagrams and masks (inbound drop, fanout-only rows, shard-major
  order) give the same rows to `on_media` in the same order, the same
  RTCP rows and the same counters.  A sink ring's datagrams never reach
  `on_media`; `last_rtp_arrival_ns` lines up with `on_media`'s rows at
  depths 1 and 2 (the port's CPU SRTP chain); the pcap tap writes each
  ingress batch.
- `AdaptiveBatcher`: both packages' batchers on fake two-ring loops,
  over seeded sequences of rx counts, SLO states and clamps, give the
  same window, caps and counters at every step.
- The metrics registry: one registration script on both registries
  renders identical text, plain and OpenMetrics, with and without
  `active`; the parser, validator and `count_exemplars` agree on good
  and broken expositions (those of `tests/test_observability.py`).

Tolerance: exact equality.
"""

import socket
import time

import numpy as np
import pytest

import libjitsi_tpu
from libjitsi_tpu.io import batching as j_batching
from libjitsi_tpu.io import pcap as j_pcap
from libjitsi_tpu.io.loop import MediaLoop as JaxLoop
from libjitsi_tpu.io.udp import UdpEngine as JaxUdp
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.service.media_stream import StreamRegistry as JaxRegistry
from libjitsi_tpu.utils import metrics as j_metrics
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io import batching as p_batching
from libjitsi_tpu_torch.io import pcap as p_pcap
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.utils import metrics as p_metrics
from test_torch_threads import one_torch_thread  # noqa: F401

CAP = 16
LO = "127.0.0.1"


def _datagrams(rng, n=7):
    return [rng.integers(0, 256, int(rng.integers(12, 200)),
                         np.uint8).tobytes() for _ in range(n)]


# ------------------------------------------------------------ pcap, rtpdump

@pytest.mark.parametrize("fmt", ["pcap", "rtpdump"])
def test_capture_files_are_byte_equal_and_cross_read(tmp_path, fmt):
    rng = np.random.default_rng(4)
    grams = _datagrams(rng)
    stamps = 1_700_000_000.0 + np.cumsum(rng.random(len(grams)) * 0.02)
    paths = {}
    for name, mod in (("jax", j_pcap), ("port", p_pcap)):
        path = str(tmp_path / f"{name}.{fmt}")
        if fmt == "pcap":
            w = mod.PcapWriter(path)
            for i, g in enumerate(grams[:-2]):
                w.write(g, ts=float(stamps[i]), src_ip=0x0A000001 + i,
                        dst_ip=0x7F000001, src_port=5000 + i, dst_port=6000)
            batch = PacketBatch.from_payloads(grams[-2:])
            w.write_batch(batch, ts=float(stamps[-1]), src_port=7, dst_port=9)
        else:
            w = mod.RtpdumpWriter(path, start=float(stamps[0]) - 0.5)
            for i, g in enumerate(grams):
                w.write(g, ts=float(stamps[i]))
        w.close()
        paths[name] = path
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    # each package's reader reads the other's file
    for reader_mod, path in ((p_pcap, paths["jax"]), (j_pcap, paths["port"])):
        if fmt == "pcap":
            r = reader_mod.PcapReader(path)
            recs = list(r)
            assert [p for _t, p, _s, _d in recs] == grams
            assert [s for _t, _p, s, _d in recs][:2] == [5000, 5001]
            assert [s for _t, _p, s, _d in recs][-2:] == [7, 7]
            assert abs(recs[0][0] - stamps[0]) < 1e-5
        else:
            r = reader_mod.RtpdumpReader(path)
            recs = list(r)
            assert [p for _o, p in recs] == grams
            assert recs[0][0] == 500
        r.close()


# ------------------------------------------------------------- UDP engine

def _send_indexed(port, n, gap_s=0.0):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(n):
            s.sendto(bytes([0x80, 96]) + i.to_bytes(2, "big") + bytes(20),
                     (LO, port))
            if gap_s:
                time.sleep(gap_s)


def _warm_stamps(eng):
    """The kernel turns its receive stamps on a moment after the first
    socket asks (a deferred static key): a datagram queued before that is
    stamped when it is read.  Let a few through first."""
    for _ in range(20):
        _send_indexed(eng.port, 1)
        eng.recv_batch_ts(50)
        time.sleep(0.005)


@pytest.mark.parametrize("view", [False, True])
def test_kernel_stamps_are_row_aligned_and_inside_the_window(view):
    n = 12
    with UdpEngine(port=0, max_batch=64, kernel_timestamps=True) as eng:
        assert eng.kernel_timestamps is True
        _warm_stamps(eng)
        t0 = time.time_ns()
        _send_indexed(eng.port, n, gap_s=0.0005)
        time.sleep(0.01)
        recv = eng.recv_batch_ts_view if view else eng.recv_batch_ts
        batch, sip, sport, ats = recv(50)
        t1 = time.time_ns()
        assert batch.batch_size == n and len(ats) == n
        assert ats.dtype == np.int64
        assert ((ats >= t0 - 10 ** 9) & (ats <= t1 + 10 ** 9)).all()
        # row i is datagram i, stamped in send order
        idx = (batch.data[:, 2].astype(int) << 8) | batch.data[:, 3]
        assert idx.tolist() == list(range(n))
        assert (np.diff(ats) >= 0).all() and ats[-1] > ats[0]
        assert (sip == 0x7F000001).all()
        token = getattr(batch, "arena_token", None)
        if not view:
            assert token is None
            return
        # the view pins its arena until the one release; a second
        # release does nothing
        arena = token.arena
        assert arena.pins == 1 and ats.base is not None
        eng.release_arena(token)
        assert arena.pins == 0
        eng.release_arena(token)
        assert arena.pins == 0
        # and an empty window pins nothing
        b2, _, _, a2 = eng.recv_batch_ts_view(0)
        assert b2.batch_size == 0 and len(a2) == 0
        assert getattr(b2, "arena_token", None) is None


def test_reuseport_engines_share_a_port():
    with UdpEngine(port=0, reuseport=True, max_batch=256) as a:
        with UdpEngine(port=a.port, reuseport=True, max_batch=256) as b:
            socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                     for _ in range(16)]
            try:
                for s in socks:
                    for i in range(8):
                        s.sendto(bytes([0x80, 96, 0, i]) + bytes(12),
                                 (LO, a.port))
                time.sleep(0.02)
                got = [0, 0]
                for _ in range(10):
                    for k, eng in enumerate((a, b)):
                        got[k] += eng.recv_batch(1)[0].batch_size
            finally:
                for s in socks:
                    s.close()
            assert sum(got) == 16 * 8
            assert a.syscall_enters == b.syscall_enters == 10
            assert a.ring_reaps == b.ring_reaps == 0


def test_engine_modes_and_retry_follow_jax():
    with pytest.raises(NotImplementedError, match="item 4"):
        UdpEngine(engine_mode="io_uring")
    with pytest.raises(ValueError):
        UdpEngine(engine_mode="epoll")
    with UdpEngine(engine_mode="recvmmsg") as e:
        assert e.engine_mode == "recvmmsg"
    # a socket bound without SO_REUSEADDR holds the port
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as taken:
        taken.bind(("0.0.0.0", 0))
        sleeps = {"jax": [], "port": []}
        for name, cls in (("jax", JaxUdp), ("port", UdpEngine)):
            with pytest.raises(OSError):
                cls.create_with_retry(retries=4, backoff_s=0.5,
                                      sleep=sleeps[name].append,
                                      port=taken.getsockname()[1])
        assert sleeps["port"] == sleeps["jax"] == [0.5, 1.0, 2.0]
    eng = UdpEngine.create_with_retry(port=0, sleep=sleeps["port"].append)
    assert eng.port > 0
    eng.close()


# ------------------------------------------------------------ media loop

def _rtp(ssrc, seq, n=10):
    return j_header.build([bytes([seq & 0xFF]) * n], [seq], 0, ssrc,
                          96).to_bytes(0)


def _rr(ssrc):
    return bytes([0x80, 201, 0, 1]) + ssrc.to_bytes(4, "big")


def _loops(**kw):
    """A JAX loop and a port loop (chain None) over registries that map
    SSRC 0x100 + k to row k, k < 10, and record what their sinks see."""
    libjitsi_tpu.init()
    jreg = JaxRegistry(libjitsi_tpu.configuration_service(), capacity=CAP)
    preg = StreamRegistry(CAP, device="cpu")
    for k in range(10):
        jreg.map_ssrc(0x100 + k, k)
        preg.map_ssrc(0x100 + k, k)
    seen = {}
    loops = {}
    for name, loop_cls, eng_cls, reg in (
            ("jax", JaxLoop, JaxUdp, jreg),
            ("port", MediaLoop, UdpEngine, preg)):
        got = seen[name] = {"media": [], "rtcp": []}

        def on_media(b, ok, got=got):
            got["media"] += [(int(s), b.to_bytes(i))
                             for i, s in enumerate(np.asarray(b.stream))]

        def on_rtcp(b, ok, got=got):
            got["rtcp"] += [int(s) for s in np.asarray(b.stream)]

        loops[name] = loop_cls(eng_cls(port=0, max_batch=64), reg,
                               on_media=on_media, on_rtcp=on_rtcp,
                               recv_window_ms=5, **kw)
    return loops, seen


def _send(loops, grams):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for lp in loops.values():
            for g in grams:
                s.sendto(g, (LO, lp.engine.port))
    time.sleep(0.02)


@pytest.mark.parametrize("shard_major", [False, True])
def test_loop_masks_follow_jax_loop(shard_major):
    loops, seen = _loops()
    try:
        for lp in loops.values():
            lp.set_fanout_only(3)
            lp.set_fanout_only(7)
            lp.set_fanout_only(7, False)
            lp.set_fanout_only(8)
            lp.inbound_drop[5] = True
            if shard_major:
                lp.enable_shard_major(4)
        order = [9, 2, 5, 3, 0, 7, 6, 1, 8, 4, 5, 2, 9, 0]
        grams = [_rtp(0x100 + k, 50 + i) for i, k in enumerate(order)]
        grams[4:4] = [_rr(0x103), _rr(0x105), _rr(0x108),
                      _rtp(0x999, 1), b"\x16\xfe\xfd" + bytes(20)]
        _send(loops, grams)
        for _ in range(3):
            for lp in loops.values():
                lp.tick()
        j, p = loops["jax"], loops["port"]
        assert seen["jax"] == seen["port"]
        assert [s for s, _ in seen["port"]["media"]] == (
            [2, 0, 1, 2, 0, 7, 6, 4, 9, 9] if shard_major
            else [9, 2, 0, 7, 6, 1, 4, 2, 9, 0])
        # RTCP passes the fanout-only rows, not the dropped one
        assert seen["port"]["rtcp"] == [3, 8]
        for f in ("fanout_rtp_dropped", "shard_major_reorders",
                  "inbound_dropped_total", "unknown_ssrc_dropped",
                  "rx_packets"):
            assert getattr(j, f) == getattr(p, f), f
        assert p.fanout_rtp_dropped == 2
        assert p.shard_major_reorders == (1 if shard_major else 0)
        assert np.array_equal(j.inbound_dropped, p.inbound_dropped)
        assert p.inbound_dropped[5] == 3 and p.inbound_dropped_total == 3
        assert p.addr_port[5] == 0 and p.addr_port[3] != 0   # no latch
        assert p.ingest_syscalls == 3 == j.ingest_syscalls
    finally:
        for lp in loops.values():
            lp.engine.close()


def test_loop_rings_sink_and_pcap_tap(tmp_path):
    preg = StreamRegistry(CAP, device="cpu")
    for k in range(10):
        preg.map_ssrc(0x100 + k, k)
    media, sunk = [], []
    tap = p_pcap.PcapWriter(str(tmp_path / "tap.pcap"))
    prim = UdpEngine(port=0, reuseport=True, max_batch=64)
    sib = UdpEngine(port=prim.port, reuseport=True, max_batch=64)
    ctl = UdpEngine(port=0, max_batch=64)
    loop = MediaLoop(prim, preg, recv_window_ms=2, pcap_tap=tap,
                     on_media=lambda b, ok: media.extend(b.to_payloads()))
    loop.add_ring(sib)
    loop.add_ring(ctl, sink=lambda b, sip, sport: sunk.extend(
        b.to_payloads()))
    assert loop.metrics.sample_total("loop_ingest_rings") == 3
    grams = [_rtp(0x100 + (i % 10), i) for i in range(48)]
    control = [b"\x80\xc8trunk-%d" % i for i in range(5)]
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(16)]
    try:
        for i, g in enumerate(grams):
            socks[i % 16].sendto(g, (LO, prim.port))
        for c in control:
            socks[0].sendto(c, (LO, ctl.port))
        time.sleep(0.02)
        for _ in range(4):
            loop.tick()
    finally:
        for s in socks:
            s.close()
        for e in loop.rings:
            e.close()
    tap.close()
    assert sorted(media) == sorted(grams) and loop.rx_packets == 48
    assert sunk == control            # never the RTP body
    assert loop.ingest_syscalls == 4 * 3
    # the tap wrote every ingress batch, sink rings' not among them
    taped = [p for _t, p, _s, _d in j_pcap.PcapReader(
        str(tmp_path / "tap.pcap"))]
    assert sorted(taped) == sorted(grams)


@pytest.mark.parametrize("depth", [1, 2])
def test_arrival_stamps_follow_on_media_rows(depth):
    """Arrival stamps ride with on_media's rows, shard-major reordered
    at depth 1 and through the deep pipeline's in-flight entries at
    depth 2 (the port's CPU SRTP chain)."""
    from libjitsi_tpu_torch.transform.engine import TransformEngineChain
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    reg = StreamRegistry(CAP, device="cpu")
    tx, rx = reg.srtp_tables(SrtpProfile.AES_CM_128_HMAC_SHA1_80)
    up = SrtpStreamTable(CAP, device="cpu")
    key = (bytes(range(16)), bytes(range(14)))
    for k in range(8):
        reg.map_ssrc(0x100 + k, k)
        rx.add_stream(k, *key)
        up.add_stream(k, *key)
    seen = []

    def on_media(b, ok):
        hdr = j_header.parse(b)
        ats = loop.last_rtp_arrival_ns
        assert ats is not None and len(ats) == b.batch_size
        seen.extend(zip(hdr.seq.tolist(), np.asarray(b.stream).tolist(),
                        ats.tolist()))

    eng = UdpEngine(port=0, max_batch=64, kernel_timestamps=True)
    _warm_stamps(eng)
    loop = MediaLoop(eng, reg, on_media=on_media, recv_window_ms=5,
                     chain=TransformEngineChain(
                         [SrtpTransformEngine(tx, rx)]),
                     pipeline_depth=depth)
    loop.enable_shard_major(2)
    order = [7, 1, 6, 0, 5, 3, 4, 2]
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for rnd in range(2):
                plain = j_header.build([b"x" * 20] * 8,
                                       [10 * rnd + i for i in range(8)], 0,
                                       [0x100 + k for k in order], 96,
                                       stream=order)
                wire = up.protect_rtp(PacketBatch(plain.data, plain.length,
                                                  plain.stream))
                for i in range(8):
                    s.sendto(wire.to_bytes(i), (LO, eng.port))
                    time.sleep(0.0003)
                time.sleep(0.01)
                loop.tick()
        loop.drain()
    finally:
        eng.close()
    assert len(seen) == 16
    seen.sort()
    # in send order (the seqs), every row's stamp grows
    assert all(b[2] > a[2] for a, b in zip(seen, seen[1:]))
    assert sorted(s for _q, s, _t in seen) == sorted(list(range(8)) * 2)


# ---------------------------------------------------------- the batcher

class _Eng:
    def __init__(self, cap):
        self.max_batch = cap


class _Loop:
    def __init__(self):
        self.engine = _Eng(64)
        self.rings = [self.engine, _Eng(32)]
        self.recv_window_ms = 2
        self.rx_packets = 0


class _Slo:
    def __init__(self):
        self.s = "ok"

    def state(self):
        return self.s


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adaptive_batcher_follows_jax(seed):
    rng = np.random.default_rng(seed)
    pair = {}
    for name, mod in (("jax", j_batching), ("port", p_batching)):
        loop, slo = _Loop(), _Slo()
        pair[name] = (loop, slo, mod.AdaptiveBatcher(loop, slo=slo,
                                                     min_batch=4 + seed))
    states = ("ok", "ok", "ok", "slow_burn", "fast_burn")
    for _step in range(60):
        rx = int(rng.integers(0, 80)) if rng.random() < 0.5 else \
            int(rng.integers(0, 8))
        state = states[int(rng.integers(0, len(states)))]
        clamp = rng.random() < 0.15
        snap = []
        for loop, slo, b in pair.values():
            loop.rx_packets += rx
            slo.s = state
            if clamp:
                b.clamp_window(not b.window_clamped)
            b.on_tick()
            snap.append((loop.recv_window_ms, loop.engine.max_batch,
                         loop.rings[1].max_batch, b.backlog_polls,
                         b.burn_shrinks, b.recoveries, b.window_clamped))
        assert snap[0] == snap[1]
    b = pair["port"][2]
    assert b.backlog_polls and b.burn_shrinks and b.recoveries
    regs = {"jax": j_metrics.MetricsRegistry(),
            "port": p_metrics.MetricsRegistry()}
    for name, reg in regs.items():
        pair[name][2].register_metrics(reg)
    assert regs["jax"].render() == regs["port"].render()


# ------------------------------------------------------------ the registry

def _register(reg, mod):
    """One registration script, run on either package's registry."""
    rng = np.random.default_rng(11)
    reg.register_array("rx_packets", rng.integers(0, 1000, 6),
                       help_="per stream\nrx", kind="counter")
    live = {"a": rng.random(6)}
    reg.register_array("jitter", lambda: live["a"], by="stream")
    reg.register_array("legs", np.arange(6) * 2, by="leg")
    reg.register_scalar("up", lambda: 1, help_="1 when \\ up")

    class C:
        nacks_sent = 7
        rtx_cache_miss = 3
    reg.register_counters(C(), ["nacks_sent", ("rtx_cache_miss", "misses")],
                          prefix="rec")
    reg.register_multi("burn", lambda: [({"slo": "p99", "window": "5m"},
                                         1.5),
                                        ({"slo": 'a"b', "window": "1h"},
                                         0.25)], help_="burn")
    h = mod.Histogram((0.01, 0.1, 1.0))
    h.observe_array(rng.random(20))
    reg.register_histogram("delay_seconds", h, help_="delay")
    reg.histogram("sizes", (64, 512), exemplars=True).observe(
        700, exemplar={"trace_id": "9"})
    vec = reg.histogram_vec("journey_seconds", (0.001, 0.02), "hop",
                            help_="journey", exemplars=True)
    vec.labels("local").observe(0.005, exemplar={"trace_id": "3"})
    vec.labels('b0-"b1"').observe_same(0.5, 4, exemplar={"trace_id": "4"})
    ring = reg.timing("stage_ingress")
    for v in (0.001, 0.002, 0.004):
        ring.record(v)
    reg.set_stream_name(1, 'bob"\n} evil{="x"')
    reg.set_stream_name(4, "alice\\")
    reg.set_stream_name(4, "carol # not an exemplar")
    reg.set_stream_name(2, None)
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("active", [False, True])
def test_registry_renders_like_jax(openmetrics, active):
    regs = [_register(j_metrics.MetricsRegistry(), j_metrics),
            _register(p_metrics.MetricsRegistry(), p_metrics)]
    mask = np.array([1, 1, 0, 0, 1, 0], bool) if active else None
    texts = [r.render(active=mask, openmetrics=openmetrics) for r in regs]
    assert texts[0] == texts[1]
    assert p_metrics.validate_exposition(texts[1],
                                         openmetrics=openmetrics) == []
    assert p_metrics.count_exemplars(texts[1]) == (3 if openmetrics else 0)
    assert regs[0].families() == regs[1].families()
    for name in ("rx_packets", "up", "sizes", "journey_seconds",
                 "rec_nacks_sent"):
        assert regs[0].sample_total(name) == regs[1].sample_total(name)
        assert regs[1].has_metric(name)
    assert not regs[1].has_metric("nope")
    assert regs[1].get_histogram("sizes").count == 1
    assert regs[1].get_histogram_vec("journey_seconds").count == 5
    assert (p_metrics.process_families_text(0.002, start_time_s=1.7e9)
            == j_metrics.process_families_text(0.002, start_time_s=1.7e9))


BROKEN = [
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_bucket{le="+Inf"} 1\n'
     'h_sum 1\nh_count 1 # {t="1"} 0.5\n# EOF\n'),
    ('# TYPE h histogram\nh_bucket{le="1"} 1 # {t="' + "x" * 140
     + '"} 0.5\nh_bucket{le="+Inf"} 1\nh_sum 1\nh_count 1\n# EOF\n'),
    ('# TYPE h histogram\nh_bucket{le="1"} 1 # {t="1"} oops\n'
     'h_bucket{le="+Inf"} 1\nh_sum 1\nh_count 1\n# EOF\n'),
    '# TYPE g gauge\ng 1\n',
    ('# TYPE h histogram\nh_bucket{le="1"} 1 # {t="1"} 0.5\n'
     'h_bucket{le="+Inf"} 1\nh_sum 1\nh_count 1\n'),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n'
     'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n'),
    '# TYPE h histogram\nh_bucket{le="1"} 2\nh_sum 1\nh_count 2\n',
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_bucket{le="+Inf"} 2\n'
     'h_sum 1\nh_count 3\n'),
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_bucket{le="+Inf"} 1\n'
     'h_count 1\n'),
    '# TYPE g gauge\n# TYPE g gauge\ng 1\n',
    'untyped_metric 4\n',
    '# TYPE s summary\ns{quantile="p99"} 1\ns_sum 1\ns_count 1\n',
    '# TYPE g gauge\ng{a="unterminated} 1\n',
    '# TYPE g gauge\ng{a="x"} notanumber\n',
    j_metrics.process_families_text(0.002, start_time_s=0.0),
    j_metrics.process_families_text(-0.5),
]


@pytest.mark.parametrize("case", range(len(BROKEN) + 2))
def test_exposition_parser_and_validator_follow_jax(case):
    if case < len(BROKEN):
        text = BROKEN[case]
    else:
        text = _register(j_metrics.MetricsRegistry(), j_metrics).render(
            openmetrics=case == len(BROKEN) + 1)
    assert (p_metrics.parse_exposition_full(text)
            == j_metrics.parse_exposition_full(text))
    assert p_metrics.parse_exposition(text) == j_metrics.parse_exposition(text)
    for om in (False, True):
        want = j_metrics.validate_exposition(text, openmetrics=om)
        assert p_metrics.validate_exposition(text, openmetrics=om) == want
    assert p_metrics.count_exemplars(text) == j_metrics.count_exemplars(text)
    if case < len(BROKEN):
        assert p_metrics.validate_exposition(text, openmetrics=True)
