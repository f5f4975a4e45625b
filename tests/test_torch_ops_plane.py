"""The port's operations-plane utilities against the JAX package's.

Each case drives one seeded script through both packages' classes and
compares what comes out exactly: the health primitives (`Watchdog`,
`SlidingWindowCounter`, `ExponentialBackoff`, `retrying`), the fault
models' fates (`GilbertElliott`, `FaultInjectionEngine` on each
package's transform chain, `TalkSpurtModel`, `ChurnModel`,
`DiurnalProfile`), the SLO engine (tick rings, burn rates, states, its
`slo_alert` events and rendered families, sliced SLOs), the capacity
model's fits over a scripted supervisor, `classify_bound` /
`host_share`, and the logging levels and `configure`.  The port's own
`compile_cache` (the kernel library's build and each kernel instance's
first launch), `profiling` (a torch.profiler trace, `record_function`,
the allocator's stats under the JAX keys) and the phase ledger the
`PhaseProfiler` hands its tracer have no JAX twin to compare with and
are checked on their own.  Everything runs on the CPU.  Tolerance:
exact.
"""

import io
import json
import logging
import os
import types

import numpy as np
import pytest
import torch

import libjitsi_tpu.core.packet as j_packet
import libjitsi_tpu.transform.engine as j_engine
import libjitsi_tpu.utils.capacity as j_capacity
import libjitsi_tpu.utils.faults as j_faults
import libjitsi_tpu.utils.health as j_health
import libjitsi_tpu.utils.logging as j_logging
import libjitsi_tpu.utils.metrics as j_metrics
import libjitsi_tpu.utils.perf as j_perf
import libjitsi_tpu.utils.slo as j_slo
import libjitsi_tpu_torch.core.packet as p_packet
import libjitsi_tpu_torch.transform.engine as p_engine
import libjitsi_tpu_torch.utils.capacity as p_capacity
import libjitsi_tpu_torch.utils.faults as p_faults
import libjitsi_tpu_torch.utils.health as p_health
import libjitsi_tpu_torch.utils.logging as p_logging
import libjitsi_tpu_torch.utils.metrics as p_metrics
import libjitsi_tpu_torch.utils.perf as p_perf
import libjitsi_tpu_torch.utils.slo as p_slo
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.utils import compile_cache, profiling
from libjitsi_tpu_torch.utils.flight import FlightRecorder
from libjitsi_tpu_torch.utils.tracing import PipelineTracer
from test_torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(health=j_health, faults=j_faults,
                                 slo=j_slo, capacity=j_capacity,
                                 metrics=j_metrics, perf=j_perf,
                                 packet=j_packet, engine=j_engine),
    "port": types.SimpleNamespace(health=p_health, faults=p_faults,
                                  slo=p_slo, capacity=p_capacity,
                                  metrics=p_metrics, perf=p_perf,
                                  packet=p_packet, engine=p_engine),
}


def both(fn):
    """fn(pkg) for the JAX package and the port."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


def _events(flight):
    """A recorder's events without their clock stamps."""
    d = flight.dump_all()
    evs = list(d["global"]) + [e for r in d["streams"].values() for e in r]
    return sorted(({k: v for k, v in e.items() if k != "t"} for e in evs),
                  key=lambda e: e["seq"])


# ------------------------------------------------------------- health

def test_watchdog_and_window_counter_follow_jax():
    rng = np.random.default_rng(3)
    durs = rng.uniform(0.0, 0.03, 200)
    deltas = rng.integers(0, 4, (60, 12))

    def run(pkg):
        wd = pkg.health.Watchdog(0.02, overload_after=3, stall_after=6)
        states = [(wd.observe(d), wd.state, wd.consecutive) for d in durs]
        win = pkg.health.SlidingWindowCounter(12, 7)
        sums = []
        for i, d in enumerate(deltas):
            win.push(d)
            if i % 9 == 4:
                win.reset_rows([i % 12, (i + 5) % 12])
            sums.append(win.sums().copy())
        codes = [pkg.health.state_code(s) for s in
                 ("healthy", "overloaded", "stalled")]
        return (states, wd.overruns, wd.max_consecutive, wd.worst_s,
                np.stack(sums), codes)

    j, p = both(run)
    assert j[:4] == p[:4] and j[5] == p[5]
    np.testing.assert_array_equal(j[4], p[4])


def test_backoff_and_retrying_follow_jax():
    def run(pkg):
        bo = pkg.health.ExponentialBackoff(0.05, factor=2.0, cap=0.3)
        delays = [bo.delay(a) for a in range(-1, 8)]
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise OSError("port busy")
            return "bound"

        out = pkg.health.retrying(flaky, retries=5, backoff_s=0.01,
                                  sleep=slept.append)
        slept2 = []
        with pytest.raises(OSError):
            pkg.health.retrying(lambda: (_ for _ in ()).throw(OSError()),
                                retries=3, backoff_s=0.02,
                                sleep=slept2.append)
        return delays, out, slept, slept2

    assert both(run)[0] == both(run)[1]


# ------------------------------------------------------------- faults

@pytest.mark.parametrize("p_gb,p_bg,loss_bad,loss_good", [
    (0.05, 0.3, 1.0, 0.0), (0.2, 0.5, 0.7, 0.02), (0.0, 0.4, 1.0, 0.0),
    (1.0, 0.0, 0.9, 0.0)])
def test_gilbert_elliott_fates_follow_jax(p_gb, p_bg, loss_bad, loss_good):
    splits = (1, 7, 64, 3, 250, 0, 33)

    def run(pkg):
        ge = pkg.faults.GilbertElliott(p_gb, p_bg, loss_bad, loss_good)
        rng = np.random.default_rng(11)
        return np.concatenate([ge.losses(n, rng) for n in splits])

    j, p = both(run)
    np.testing.assert_array_equal(j, p)


def _wire(pkg, n, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 120, n)
    pls = [rng.integers(0, 256, int(k), np.uint8).tobytes() for k in lens]
    return pkg.packet.PacketBatch.from_payloads(pls,
                                                stream=list(range(n)))


@pytest.mark.parametrize("kw", [
    dict(loss=0.1, duplicate=0.05, corrupt=0.05, reorder=0.1, seed=4),
    dict(loss=0.02, burst=(0.05, 0.3), tx=True, seed=9),
    dict(duplicate=0.3, reorder=0.5, corrupt=0.2, tx=True, seed=1)])
def test_fault_injection_engine_follows_jax(kw):
    """Same fates batch for batch, through each package's chain in both
    directions (the chain takes the duplicating engine's new shape)."""
    sizes = (17, 1, 64, 40)

    def run(pkg):
        eng = pkg.faults.FaultInjectionEngine(**kw)
        chain = pkg.engine.TransformEngineChain([eng])
        out = []
        for i, n in enumerate(sizes):
            for d in ("rx", "tx"):
                b = _wire(pkg, n, 100 * i + len(d))
                if d == "rx":
                    got, mask = chain.rtp_transformer.reverse_transform(b)
                else:
                    got, mask = chain.rtp_transformer.transform(b)
                out.append((got.data.copy(), np.asarray(got.length).copy(),
                            np.asarray(got.stream).copy(), mask.copy()))
        reg = pkg.metrics.MetricsRegistry()
        eng.register_metrics(reg)
        return out, reg.render()

    (jo, jr), (po, pr) = both(run)
    assert jr == pr
    for a, b in zip(jo, po):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_talk_spurts_churn_and_diurnal_follow_jax():
    def run(pkg):
        ts = pkg.faults.TalkSpurtModel(64, seed=5)
        masks = []
        for i in range(80):
            masks.append(ts.advance(0.02 if i % 10 else 0.9).copy())
            if i == 40:
                ts.reset_rows([1, 2, 30])
        di = pkg.faults.DiurnalProfile(period_s=10.0, depth=0.6, peak_t=2.0)
        ch = pkg.faults.ChurnModel(300.0, 0.6, seed=8, diurnal=di)
        pop, steps = 0, []
        for t in range(200):
            j, lv = ch.step(0.02, 0.02 * t, pop)
            pop = max(0, pop + j - lv)
            steps.append((j, lv))
        return (np.stack(masks), steps, ch.joins_offered,
                ch.leaves_offered, [di.factor(0.37 * t) for t in range(30)])

    j, p = both(run)
    np.testing.assert_array_equal(j[0], p[0])
    assert j[1:] == p[1:]


# ---------------------------------------------------------------- SLO

def _slo_script(pkg, with_slices: bool):
    """A registry whose journey histogram, forwarded and auth-fail
    counters move by a seeded schedule; the engine ticks on it."""
    reg = pkg.metrics.MetricsRegistry()
    hist = reg.histogram("packet_journey_seconds",
                         [0.005, 0.01, 0.02, 0.05, 0.1])
    state = {"fwd": 0, "abandoned": 0, "auth": np.zeros(4, np.int64),
             "sizes": 0}
    reg.register_scalar("bridge_forwarded", lambda: state["fwd"],
                        kind="counter")
    reg.register_scalar("recovery_nacks_abandoned",
                        lambda: state["abandoned"], kind="counter")
    reg.register_array("srtp_auth_fail", lambda: state["auth"],
                       kind="counter")
    size = reg.histogram("packet_size_bytes", [100, 500, 1500])
    flight = FlightRecorder() if pkg is PKGS["port"] else \
        __import__("libjitsi_tpu.utils.flight",
                   fromlist=["FlightRecorder"]).FlightRecorder()
    eng = pkg.slo.SloEngine(reg, pkg.slo.default_slos(), flight=flight,
                            windows=(("1m", 0.2), ("5m", 1.0),
                                     ("30m", 2.0), ("6h", 4.0)),
                            window_buckets=8)
    cum = {"a": [0.0, 0.0], "b": [0.0, 0.0]}
    if with_slices:
        def reader():
            for k, (g, b) in sorted(cum.items()):
                yield k, g, b
        eng.add_sliced(pkg.slo.SlicedSloSpec("shard_media", 0.99,
                                             "shard", reader))
    rng = np.random.default_rng(17)
    trace = []
    for t in range(260):
        bad = 80 <= t < 140
        for v in rng.uniform(0.0, 0.08 if bad else 0.015, 30):
            hist.observe(float(v))
        for v in rng.integers(60, 1400, 30):
            size.observe(float(v))
        state["fwd"] += 300
        state["abandoned"] += int(bad) * 4
        state["auth"][t % 4] += int(150 <= t < 170) * 3
        cum["a"][0] += 10
        if "b" in cum:
            cum["b"][0] += 10
            cum["b"][1] += 5 if 100 <= t < 150 else 0
        if t == 200:
            cum.pop("b")
            if with_slices:
                eng.drop_slice("shard_media", "b")
        eng.on_tick()
        trace.append((eng.state(), {s.name: eng.state(s.name)
                                    for s in eng.specs},
                      {s.name: eng.burn_rates(s.name) for s in eng.specs},
                      [eng.burning_slices(s.name) for s in eng.sliced],
                      [eng.slice_state(s.name, "b") for s in eng.sliced]))
    out = reg.__class__()
    eng.register_metrics(out)
    status = eng.status()
    return trace, _events(flight), out.render(), status, eng.alerts_total


@pytest.mark.parametrize("with_slices", [False, True])
def test_slo_engine_follows_jax(with_slices):
    j, p = both(lambda pkg: _slo_script(pkg, with_slices))
    assert j[0] == p[0]
    assert j[1] == p[1] and j[4] == p[4]
    assert j[2] == p[2]
    assert json.dumps(j[3], sort_keys=True) == json.dumps(p[3],
                                                          sort_keys=True)
    assert any(st[0] == "fast_burn" for st in p[0])


def test_tick_window_ring_and_spec_checks_follow_jax():
    def run(pkg):
        ring = pkg.slo.TickWindowRing(100, buckets=8)
        tot = []
        for i in range(250):
            ring.push(float(i % 7), float(i % 3 == 0))
            tot.append(ring.totals())
        errs = []
        for kw in (dict(objective=1.0), dict(objective=0.9, kind="x")):
            try:
                pkg.slo.SloSpec("s", **kw)
            except ValueError as e:
                errs.append(str(e))
        return ring.bucket_ticks, ring.n_buckets, tot, errs

    assert both(run)[0] == both(run)[1]


def test_adaptive_batcher_reads_the_slo_engine():
    """`io/batching.AdaptiveBatcher` takes the engine as its `slo`."""
    from libjitsi_tpu_torch.io.batching import AdaptiveBatcher

    reg = p_metrics.MetricsRegistry()
    eng = p_slo.SloEngine(reg, p_slo.default_slos())
    loop = types.SimpleNamespace(recv_window_ms=2, rx_packets=0,
                                 engine=types.SimpleNamespace(max_batch=64))
    bat = AdaptiveBatcher(loop, slo=eng)
    assert bat.slo is eng and eng.state() == "ok"


# ----------------------------------------------------------- capacity

def _cap_script(pkg):
    """A stub supervisor whose population, tick time, phase split, row
    use, backlog, keystream misses and SLO burn move by a seeded
    schedule; the model attaches, ticks and is asked to admit."""
    rng = np.random.default_rng(23)
    cap = 512
    reg = types.SimpleNamespace(capacity=cap, free_slots=cap)
    cache = types.SimpleNamespace(hits=0, misses=0)
    lc = types.SimpleNamespace(_join_q=[], _staged=[],
                               cfg=types.SimpleNamespace(max_pending=64),
                               _keystream_caches=lambda: [cache],
                               placer=None)
    slo_reg = pkg.metrics.MetricsRegistry()
    slo = pkg.slo.SloEngine(slo_reg, ())
    sup = types.SimpleNamespace(
        cfg=types.SimpleNamespace(deadline_ms=20.0), last_tick_s=0.0,
        last_phases={}, bridge=types.SimpleNamespace(registry=reg),
        lifecycle=lc, slo=slo, capacity=None)
    model = pkg.capacity.CapacityModel(fit_every=4)
    out_reg = pkg.metrics.MetricsRegistry()
    model.attach(sup, registry=out_reg)
    trace = []
    for t in range(300):
        pop = min(cap, 10 + t)
        reg.free_slots = cap - pop
        sup.last_tick_s = 0.002 + pop * 4e-5 + float(rng.normal(0, 1e-4))
        host = 0.001 + pop * 3e-6
        sup.last_phases = {"host_python": host, "dispatch": host / 4,
                           "device_compute": 0.003, "idle": 0.001}
        lc._join_q = [0] * int(rng.integers(0, 5))
        cache.hits += 50
        cache.misses += int(rng.integers(0, 3))
        model.on_tick()
        if t % 10 == 9:
            trace.append((model.should_refuse(), model.retry_after(),
                          model.headroom_users(), model.bottleneck(),
                          model.confidence()))
    return (trace, json.dumps(model.status(), sort_keys=True),
            pkg.capacity.predicted_saturation(model), out_reg.render(),
            model.forecast_refusals)


def test_capacity_model_follows_jax():
    j, p = both(_cap_script)
    assert j == p
    assert p[2] is not None and p[0][-1][3] is not None


@pytest.mark.parametrize("phases", [
    {}, {"idle": 0.0}, {"host_python": 0.01, "dispatch": 0.002,
                        "device_compute": 0.004, "idle": 0.001},
    {"h2d_transfer": 0.01, "device_compute": 0.02, "host_python": 0.003},
    {"idle": 0.5, "host_python": 0.1}])
def test_classify_bound_and_host_share_follow_jax(phases):
    assert (j_perf.classify_bound(phases), j_perf.host_share(phases)) \
        == (p_perf.classify_bound(phases), p_perf.host_share(phases))
    assert p_perf.HOST_PHASES == j_perf.HOST_PHASES
    assert p_perf.DEVICE_PHASES == j_perf.DEVICE_PHASES


# ------------------------------------------------------------ logging

def test_logging_levels_and_configure_follow_jax():
    def run(mod, root):
        buf = io.StringIO()
        lg = logging.getLogger(root)
        saved = (lg.level, list(lg.handlers), lg.propagate)
        lg.handlers = []
        try:
            mod.configure(logging.DEBUG, stream=buf)
            log = mod.get_logger("ops_test", rate_hz=1.0, burst=2)
            flags = (log.debug_enabled, log.info_enabled)
            log.debug("d", sid=1)
            log.info("i", sid=2)
            log.warn("w", sid=3)
            log.error("e", sid=4)
            for _ in range(4):                    # rate-limited site
                log.info("flood", n=1)
            lg.setLevel(logging.WARNING)
            quiet = (log.debug_enabled, log.info_enabled)
            log.info("hidden")
            return flags, quiet, [ln.split(" ", 2)[2]
                                  for ln in buf.getvalue().splitlines()]
        finally:
            lg.level, lg.handlers, lg.propagate = saved

    j = run(j_logging, "libjitsi_tpu")
    p = run(p_logging, "libjitsi_tpu_torch")
    assert j[:2] == p[:2] == ((True, True), (False, False))
    assert [ln.replace("libjitsi_tpu_torch.", "libjitsi_tpu.")
            for ln in p[2]] == j[2]


def test_recovery_rungs_log_at_info():
    from libjitsi_tpu_torch.sfu.recovery import RecoveryController

    buf = io.StringIO()
    lg = logging.getLogger("libjitsi_tpu_torch")
    saved = (lg.level, list(lg.handlers), lg.propagate)
    lg.handlers = []
    try:
        p_logging.configure(logging.INFO, stream=buf)
        rc = RecoveryController()
        rc.shed_fec(True)
        rc.throttle_rtx(True)
    finally:
        lg.level, lg.handlers, lg.propagate = saved
    text = buf.getvalue()
    assert "sfu.recovery recovery_fec_shed shed=True" in text
    assert "sfu.recovery recovery_rtx_throttle throttled=True" in text


# ---------------------------------------------- compile cache (port only)

def test_compile_stats_count_builds_and_first_launches(tmp_path):
    st = compile_cache.compile_stats()
    assert st is compile_cache.compile_stats()      # process singleton
    ev, hits, misses = st.compile_events, st.hits, st.misses
    st.on_build(False)
    st.on_build(True, 2.5)
    assert (st.hits, st.misses) == (hits + 1, misses + 1)
    name = "mix_minus"
    before = kbuild.launches[name]
    seen = name in st.instances
    kbuild.launches[name] += 1          # what a wrapper does at a launch
    kbuild.launches[name] += 1
    kbuild.count_instance("srtp_protect_cm", 77)
    kbuild.count_instance("srtp_protect_cm", 77)
    assert st.compile_events == ev + (0 if seen else 1) + 1
    kbuild.reset_counts()               # counts go, first sights stay
    kbuild.launches[name] += 1
    assert st.compile_events == ev + (0 if seen else 1) + 1
    assert kbuild.instance_launches == {}
    kbuild.launches[name] = before
    old = kbuild.BUILD_DIR
    try:
        got = compile_cache.enable_compile_cache(str(tmp_path / "kc"))
        assert got == kbuild.BUILD_DIR == str(tmp_path / "kc")
        assert os.path.isdir(got)
    finally:
        kbuild.BUILD_DIR = old


def test_phase_profiler_feeds_the_tracer_and_compile_families():
    reg = p_metrics.MetricsRegistry()
    tr = PipelineTracer(reg)
    prof = p_perf.PhaseProfiler(reg, sample_every=1, tracer=tr)
    for _ in range(2):
        prof.begin_tick()
        with prof.phase("dispatch"):
            pass
        prof.end_tick()
    led = tr.take_phase_ledger()
    assert set(led) == set(p_perf.PHASES) and tr.take_phase_ledger() == {}
    assert tr.last_phase_ledger == led
    with tr.span("egress"):
        pass
    assert PipelineTracer.dominant(tr.ledger())[0] == "egress"
    assert PipelineTracer.dominant({}) == (None, 0.0)
    text = reg.render()
    for fam in ("compile_cache_hits", "compile_cache_misses",
                "compile_events", "compile_seconds_total"):
        assert f"# TYPE libjitsi_tpu_{fam} counter" in text


# --------------------------------------------------- profiling (port only)

def test_profiling_trace_annotate_and_device_memory(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as d:
        with profiling.annotate("ops_plane_span"):
            torch.ones(64).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "ops_plane_span" in f.read()
    mem = profiling.device_memory("cpu")
    assert mem == {"device": "cpu", "bytes_in_use": None,
                   "peak_bytes_in_use": None, "num_allocs": None,
                   "num_alloc_retries": None}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            profiling.device_memory(None)


def test_default_slos_read_families_the_sfu_registers():
    """Every family `default_slos` names exists in a supervised port
    SfuBridge's registry, so each spec reads totals from the first tick
    (the JAX engine's `_read` returns None for a missing family)."""
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.service.supervisor import BridgeSupervisor

    b = SfuBridge(port=0, capacity=4, recv_window_ms=0, device="cpu")
    try:
        reg = b.loop.metrics
        eng = p_slo.SloEngine(reg, p_slo.default_slos())
        BridgeSupervisor(b, metrics=reg, slo=eng)
        assert all(eng._read(spec) is not None for spec in eng.specs)
    finally:
        b.close()
