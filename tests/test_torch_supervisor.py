"""The port's BridgeSupervisor against the JAX package's, and a port
bridge killed and recovered from its checkpoint.

Each scripted case drives the JAX supervisor and the port's over the
stub bridge the JAX tests use (`tests/test_supervisor.py`'s
`DummyLoop`, `DummyBridge`, `FakeClock`, copied here, with a stage and
phase ledger and a recovery stub where a case needs them) through the
same tick durations, auth-failure storms and priorities, and compares
tick for tick: the watchdog state, the ladder's level and rungs, the
shed and quarantined sets, the ingress drop mask, the recv window and
`degraded`, `admission_decision()`, every flight event (kind and
fields; the clock stamp aside), the post-mortems, the recovery rungs'
calls and the rendered metric families.  Checkpoint files carry the
same magic, version and blob keys: a JAX checkpoint loads with the
port's `load_checkpoint` in a child with `jax`, `jaxlib` and
`libjitsi_tpu` blocked, and the port's file loads with the JAX one.  A
port `SfuBridge(device="cpu")` under the port supervisor, checkpointed,
closed and recovered on a fresh socket, accepts exactly what an
uninterrupted run accepts (a replayed packet included).  The `slow`
case recovers a JAX `SfuBridge`'s checkpoint with the port supervisor
and holds its next ticks against the JAX recovered bridge's, byte for
byte (the JAX tables' compile costs minutes here).  Tolerance: exact.
"""

import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from libjitsi_tpu.service import supervisor as j_sup
from libjitsi_tpu.utils import metrics as j_metrics
from libjitsi_tpu_torch.service import supervisor as p_sup
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
from libjitsi_tpu_torch.utils import metrics as p_metrics
from test_torch_sfu_bridge import _Capture, _Endpoint, _mesh
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 8
PKGS = {"jax": (j_sup, j_metrics), "port": (p_sup, p_metrics)}


class DummyLoop:
    def __init__(self):
        self.registry = types.SimpleNamespace(capacity=CAP)
        self.recv_window_ms = 1
        self.inbound_drop = np.zeros(CAP, dtype=bool)
        self.inbound_dropped = np.zeros(CAP, dtype=np.int64)
        self.inbound_dropped_total = 0


class DummyBridge:
    def __init__(self):
        self.loop = DummyLoop()
        self.degraded = False
        self._ssrc_of = {0: 100, 1: 101, 2: 102, 3: 103}
        self.rx_table = types.SimpleNamespace(
            auth_fail=np.zeros(CAP, dtype=np.int64),
            replay_reject=np.zeros(CAP, dtype=np.int64))
        self.speaker = types.SimpleNamespace(dominant=0)
        self.ticked = 0

    def tick(self, now=None):
        self.ticked += 1
        return {"rx": 0}

    def snapshot(self):
        return {"auth_fail": self.rx_table.auth_fail.copy(),
                "ssrc_of": dict(self._ssrc_of), "ticked": self.ticked}


class FakeClock:
    """Scripted tick durations: each supervisor tick reads the clock
    twice (t0/t1); the second read advances by the next duration."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.t = 0.0
        self.half = False

    def __call__(self):
        if self.half:
            self.t += self.durations.pop(0) if self.durations else 0.0
        self.half = not self.half
        return self.t


def _untimed(obj):
    """Events and dumps without their clock stamps."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "t"}
    if isinstance(obj, (list, tuple)):
        return [_untimed(v) for v in obj]
    return obj


#: name -> (supervisor config, tick durations, stage ledger, phase
#: ledger, with a recovery stub, priorities, {tick: {sid: auth fails}},
#: {tick: {sid: replay rejects}}, SLO state)
SCRIPTS = {
    "ladder": (dict(overload_after=2, overload_exit=3, shed_step=2),
               [0.05] * 12 + [0.001] * 30, None, None, False, {}, {}, {},
               None),
    "stage_forward_chain": (
        dict(overload_after=1, overload_exit=2),
        [0.05] * 6 + [0.001] * 14,
        {"ingress": 0.0004, "forward_chain": 0.009, "egress": 0.0006},
        None, True, {}, {}, {}, None),
    "stage_ingress": (
        dict(overload_after=1, overload_exit=2),
        [0.05, 0.05] + [0.001] * 10,
        {"ingress": 0.008, "forward_chain": 0.001, "egress": 0.001},
        None, False, {}, {}, {}, None),
    "balanced_ledger": (
        dict(overload_after=1), [0.05] * 3,
        {"ingress": 0.003, "forward_chain": 0.004, "egress": 0.003},
        None, True, {}, {}, {}, None),
    "host_bound": (
        dict(overload_after=1), [0.05] * 4,
        {"ingress": 0.008, "forward_chain": 0.001},
        {"host_python": 0.016, "dispatch": 0.002,
         "device_compute": 0.001, "idle": 0.001}, False, {}, {}, {},
        None),
    "device_bound": (
        dict(overload_after=1), [0.05] * 2,
        {"forward_chain": 0.009, "ingress": 0.001},
        {"host_python": 0.001, "dispatch": 0.001,
         "device_compute": 0.015, "d2h_transfer": 0.002}, True, {}, {},
        {}, "fast_burn"),
    "priority_shed": (
        dict(overload_after=1, overload_exit=2, shed_step=1),
        [0.05] * 6 + [0.001] * 12, None, None, False,
        {1: 5, 2: 0, 3: 1}, {}, {}, None),
    "quarantine": (
        dict(deadline_ms=1000.0, quarantine_window=5,
             quarantine_auth_threshold=5, quarantine_replay_threshold=9,
             quarantine_backoff_ticks=3, quarantine_backoff_cap=6),
        [0.001] * 40, None, None, False, {},
        {2: {1: 6}, 3: {2: 2}, 4: {2: 2}, 12: {1: 6}, 20: {1: 9},
         25: {3: 4}},
        {6: {3: 10}, 30: {2: 3}}, None),
}


def _drive(pkg: str, name: str):
    sup_mod, met_mod = PKGS[pkg]
    (cfg_kw, durs, ledger, phases, with_rec, prios, auth, replay,
     slo_state) = SCRIPTS[name]
    cfg = sup_mod.SupervisorConfig(**{"deadline_ms": 10.0, **cfg_kw})
    bridge = DummyBridge()
    if ledger is not None:
        bridge.loop.tracer = types.SimpleNamespace(
            take_ledger=lambda: dict(ledger))
        if phases is not None:
            bridge.loop.tracer.take_phase_ledger = lambda: dict(phases)
    calls = []
    if with_rec:
        bridge.recovery = types.SimpleNamespace(
            shed_fec=lambda on: calls.append(("shed_fec", on)),
            throttle_rtx=lambda on: calls.append(("throttle_rtx", on)),
            register_metrics=lambda reg: None)
    slo = None
    if slo_state is not None:
        slo = types.SimpleNamespace(state=lambda *a: slo_state,
                                    on_tick=lambda: None,
                                    register_metrics=lambda reg: None)
    reg = met_mod.MetricsRegistry()
    sup = sup_mod.BridgeSupervisor(bridge, cfg, metrics=reg,
                                   priorities=dict(prios),
                                   clock=FakeClock(durs), slo=slo)
    ticks = []
    for t in range(len(durs)):
        for sid, n in auth.get(t, {}).items():
            bridge.rx_table.auth_fail[sid] += n
        for sid, n in replay.get(t, {}).items():
            bridge.rx_table.replay_reject[sid] += n
        assert sup.tick(now=float(t)) == {"rx": 0}
        h = sup.health()
        ticks.append((h, sup.level, list(sup._rungs), sorted(sup._shed_set),
                      sorted(sup._quarantined.items()),
                      bridge.loop.inbound_drop.tolist(),
                      bridge.loop.recv_window_ms, bridge.degraded,
                      sup.admission_decision(),
                      sup.phase_attribution()))
    return dict(ticks=ticks, flight=_untimed(sup.flight.dump_all()),
                postmortems=_untimed(list(sup.postmortems)), calls=calls,
                render=reg.render(), quarantine_total=sup.quarantine_total)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_script_follows_jax(name):
    j, p = _drive("jax", name), _drive("port", name)
    for k in ("ticks", "flight", "postmortems", "calls", "render",
              "quarantine_total"):
        assert j[k] == p[k], k
    if name == "ladder":
        assert max(t[1] for t in p["ticks"]) >= 3 and p["ticks"][-1][1] == 0
    if name == "quarantine":
        kinds = [e["kind"] for e in p["flight"]["streams"][1]]
        assert kinds.count("quarantine") == 3
        assert "quarantine_release" in kinds


def test_lifecycle_bookkeeping_follows_jax():
    """note_evicted / note_admitted around a shed: the unwind never
    restores a departed stream, in both packages."""
    def run(pkg):
        sup_mod, _ = PKGS[pkg]
        cfg = sup_mod.SupervisorConfig(deadline_ms=10.0, overload_after=1,
                                       overload_exit=1, shed_step=2)
        bridge = DummyBridge()
        sup = sup_mod.BridgeSupervisor(
            bridge, cfg, clock=FakeClock([0.05] * 4 + [0.001] * 8))
        out = []
        for t in range(12):
            if t == 4:
                sup.note_evicted(sorted(sup._shed_set)[:1])
            if t == 6:
                sup.note_admitted([3])
            sup.tick()
            out.append((sorted(sup._shed_set), sorted(sup._evicted),
                        sup.level, sup.admission_decision()))
        return out, _untimed(sup.flight.dump_all())

    assert run("jax") == run("port")


def test_checkpoint_format_is_shared(tmp_path):
    assert (p_sup.CKPT_MAGIC, p_sup.CKPT_VERSION) \
        == (j_sup.CKPT_MAGIC, j_sup.CKPT_VERSION)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps({"magic": "other", "version": 1}))
    for mod in (j_sup, p_sup):
        with pytest.raises(ValueError, match="not a libjitsi_tpu"):
            mod.BridgeSupervisor.load_checkpoint(str(bad))
    fut = tmp_path / "future.ckpt"
    fut.write_bytes(pickle.dumps({"magic": p_sup.CKPT_MAGIC,
                                  "version": p_sup.CKPT_VERSION + 1}))
    with pytest.raises(ValueError, match="version"):
        p_sup.BridgeSupervisor.load_checkpoint(str(fut))


_LOAD_CHILD = r"""
import importlib.abc, json, sys
BLOCKED = ("jax", "jaxlib", "libjitsi_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
from libjitsi_tpu_torch.service.supervisor import BridgeSupervisor
blob = BridgeSupervisor.load_checkpoint(sys.argv[1])
snap = blob["snap"]
print(json.dumps({"keys": sorted(blob), "bridge": blob["bridge"],
                  "ticks": blob["ticks"],
                  "auth": snap["auth_fail"].tolist(),
                  "lifecycle": sorted(blob.get("lifecycle", {}))}))
"""


def _checkpointed(mod, path):
    cfg = mod.SupervisorConfig(deadline_ms=1000.0, checkpoint_every=3,
                               checkpoint_path=path)
    bridge = DummyBridge()
    sup = mod.BridgeSupervisor(bridge, cfg)
    sup.lifecycle = types.SimpleNamespace(
        snapshot=lambda: {"queued": [(5, (b"k", b"s"), (b"k", b"s"),
                                      None)], "staged": [(3, 103)]},
        tick_begin=lambda: None, tick_end=lambda: None,
        run_between_ticks=lambda now=None: None)
    bridge.rx_table.auth_fail[2] = 7
    for t in range(7):
        sup.tick(now=float(t))
    return sup


def test_jax_checkpoint_loads_in_the_port_without_jax(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    sup = _checkpointed(j_sup, path)
    assert sup.checkpoints_written == 2
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _LOAD_CHILD, path],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got == {"keys": ["bridge", "lifecycle", "magic", "snap",
                            "ticks", "version"],
                   "bridge": "DummyBridge", "ticks": 6,
                   "auth": [0, 0, 7, 0, 0, 0, 0, 0],
                   "lifecycle": ["queued", "staged"]}


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    path = str(tmp_path / "port.ckpt")
    _checkpointed(p_sup, path)
    blob = j_sup.BridgeSupervisor.load_checkpoint(path)
    assert sorted(blob) == ["bridge", "lifecycle", "magic", "snap",
                            "ticks", "version"]
    assert blob["ticks"] == 6 and blob["snap"]["auth_fail"][2] == 7
    assert blob["lifecycle"]["staged"] == [(3, 103)]


def test_cascade_supervisor_names_item_12():
    with pytest.raises(NotImplementedError, match="item 12"):
        p_sup.CascadeSupervisor(DummyBridge(), trunk=None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_recover_takes_the_card_by_default(tmp_path):
    """`recover` without a device restores on the card; with none it
    raises rather than restoring on the CPU."""
    b = SfuBridge(port=0, capacity=4, recv_window_ms=0, device="cpu")
    sup = p_sup.BridgeSupervisor(b)
    path = sup.save_checkpoint(str(tmp_path / "c.ckpt"))
    b.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_sup.BridgeSupervisor.recover(path, SfuBridge, retries=1)


# ------------------------------------------- a bridge killed mid-call

def _conference(n=3, base=0x5100):
    return [_Endpoint(base + 7 * k, 0) for k in range(n)]


def _run_bridge(tmp_path, kill: bool):
    """3 endpoints over loopback: 3 ticks, then (with `kill`) checkpoint,
    close and recover on a fresh socket, then 3 more ticks with a
    replayed packet; returns what each endpoint accepted after tick 3
    and the bridge's counters."""
    eps = _conference()
    b = SfuBridge(port=0, capacity=8, recv_window_ms=0, device="cpu")
    sup = p_sup.BridgeSupervisor(b, p_sup.SupervisorConfig(
        deadline_ms=10_000.0))
    for e in eps:
        e.bridge_port = b.port
        b.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    old = None
    for t in range(6):
        if t == 3:
            for e in eps:
                e.drain()
                e.got.clear()
            if kill:
                path = sup.save_checkpoint(str(tmp_path / "sfu.ckpt"))
                b.close()
                sup = p_sup.BridgeSupervisor.recover(
                    path, SfuBridge, device="cpu", recv_window_ms=0)
                b = sup.bridge
                for e in eps:
                    e.bridge_port = b.port
        wires = [e.media(2) for e in eps]
        if t == 2:
            old = wires[0]
        for e, w in zip(eps, wires):
            e.engine.send_batch(w, "127.0.0.1", b.port)
        if t == 4:                       # a replay of tick 2's packets
            eps[0].engine.send_batch(old, "127.0.0.1", b.port)
        for _ in range(6):
            sup.tick(now=50.0 + 0.02 * t)
        for e in eps:
            e.drain()
    for e in eps:
        e.drain()
    out = dict(got={e.ssrc: dict(e.got) for e in eps},
               replay=int(b.rx_table.replay_reject.sum()),
               auth=int(b.rx_table.auth_fail.sum()), forwarded=b.forwarded,
               ticks=sup.ticks,
               roc=b.rx_table.rx_max.copy(), mask=b.rx_table.rx_mask.copy())
    b.close()
    for e in eps:
        e.engine.close()
    return out


def test_recovered_bridge_accepts_what_an_uninterrupted_run_accepts(
        tmp_path):
    ref = _run_bridge(tmp_path, kill=False)
    got = _run_bridge(tmp_path, kill=True)
    assert got["got"] == ref["got"]
    assert all(len(v) == 2 * 2 * 3 for v in got["got"].values())
    assert got["replay"] == ref["replay"] > 0, (got["replay"], ref["replay"])
    assert got["auth"] == ref["auth"] == 0
    np.testing.assert_array_equal(got["roc"], ref["roc"])
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert got["ticks"] == ref["ticks"] == 36


@pytest.mark.slow          # the JAX bridge's SRTP tables compile: minutes
def test_jax_checkpoint_recovers_into_the_port_bridge(tmp_path):
    """A JAX SfuBridge under the JAX supervisor writes a checkpoint; the
    JAX supervisor and the port's recover it (the port on the CPU); the
    same input for six ticks gives the same datagrams, in order."""
    import libjitsi_tpu
    from libjitsi_tpu.service.sfu_bridge import SfuBridge as JaxBridge

    libjitsi_tpu.stop()
    libjitsi_tpu.init()
    cfg = libjitsi_tpu.configuration_service()
    eps = _conference(3, 0x6200)
    jb = JaxBridge(cfg, port=0, capacity=8, recv_window_ms=0)
    jsup = j_sup.BridgeSupervisor(jb)
    for e in eps:
        jb.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    for t in range(2):
        for e in eps:
            e.engine.send_batch(e.media(), "127.0.0.1", jb.port)
        for _ in range(6):
            jsup.tick(now=30.0 + 0.02 * t)
    path = jsup.save_checkpoint(str(tmp_path / "jax.ckpt"))
    jb.close()
    jrec = j_sup.BridgeSupervisor.recover(cfg, path, JaxBridge,
                                          recv_window_ms=0)
    prec = p_sup.BridgeSupervisor.recover(path, SfuBridge, device="cpu",
                                          recv_window_ms=0)
    assert prec.ticks == jrec.ticks == 12
    caps = [_Capture(jrec.bridge), _Capture(prec.bridge)]
    for t in range(6):
        wires = [e.media() for e in eps]
        for sup in (jrec, prec):
            for w in wires:
                eps[0].engine.send_batch(w, "127.0.0.1", sup.bridge.port)
            for _ in range(6):
                sup.tick(now=40.0 + 0.02 * t)
    assert caps[0].sent and [b for _, b in caps[1].sent] \
        == [b for _, b in caps[0].sent]
    jrec.bridge.close()
    prec.bridge.close()
    for e in eps:
        e.engine.close()
