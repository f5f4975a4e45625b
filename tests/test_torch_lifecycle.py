"""The port's StreamLifecycleManager against the JAX package's, and its
warm-ups, handshake queue and keystream fill on port bridges.

The scripted cases drive the JAX manager and the port's over the stub
bridges the JAX tests use (`tests/test_lifecycle.py`'s `WarmTable`,
`LcBridge`, `DummyLoop`, `DummyBridge`, `FakeClock`, copied here) through
the same joins, leaves, refusals, barriers, warm-up boundaries, tick
brackets and reconciliations, and compare: what each bridge was asked
to stage, commit and remove, the warm-up calls (row classes), the
counters, the typed refusals, every flight event (kind and fields; the
clock stamp aside), the lifecycle's rendered families and
`key_installs_pending`.  The port's own pieces: `warmup_rtp`,
`warmup_rtcp` and `warmup_fanout` on port tables (the plain versions
they run, counted before and after, the live table's state untouched),
the tick bracket on the port's compile counter (a first launch inside a
tick), the deferred DTLS handshake queue on a port `SfuBridge(device=
"cpu")` with the stub endpoint (no OpenSSL call on the tick thread, keys
landing only through the commit barrier), `fill_keystream` between ticks,
and item 12's refusals.  The `slow` case runs
`scripts/torch_churn_soak.py --smoke --device cpu`.  Tolerance: exact.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from libjitsi_tpu.service import lifecycle as j_lc
from libjitsi_tpu.service import supervisor as j_sup
from libjitsi_tpu.utils import metrics as j_metrics
from libjitsi_tpu_torch.control.dtls import StubDtlsEndpoint
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.service import lifecycle as p_lc
from libjitsi_tpu_torch.service import supervisor as p_sup
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
from libjitsi_tpu_torch.sfu.translator import RtpTranslator
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from libjitsi_tpu_torch.utils import compile_cache
from libjitsi_tpu_torch.utils import metrics as p_metrics
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (j_lc, j_sup, j_metrics), "port": (p_lc, p_sup, p_metrics)}


class WarmTable:
    """Records warm-up calls: the cadence is the (row class) sequence."""

    def __init__(self):
        self.rtp_warms = []
        self.rtcp_warms = []
        self.active = np.zeros(64, dtype=bool)

    def warmup_rtp(self, rows, payload_len=160):
        self.rtp_warms.append(rows)

    def warmup_rtcp(self, batch_size=1):
        self.rtcp_warms.append(batch_size)


class LcBridge:
    """Host-side stand-in with exactly the surface the manager drives."""

    def __init__(self, capacity=8):
        self.capacity = capacity
        self._free = list(range(capacity))
        self._ssrc_of = {}
        self._tx_keys = {}
        self._staged = set()
        self.rx_table = WarmTable()
        self.tx_table = WarmTable()
        self.calls = []
        bridge = self

        class _Reg:
            @property
            def free_slots(self):
                return len(bridge._free)

        self.registry = _Reg()

    def stage_endpoints(self, specs):
        sids = []
        for ssrc, rx, tx, _name in specs:
            sid = self._free.pop(0)
            self._ssrc_of[sid] = ssrc
            self._tx_keys[sid] = tuple(tx)
            self._staged.add(sid)
            sids.append(sid)
        self.calls.append(("stage", tuple(sids)))
        return sids

    def commit_endpoints(self, sids):
        for sid in sids:
            self._staged.discard(int(sid))
        self.calls.append(("commit", tuple(int(s) for s in sids)))

    def remove_endpoints(self, sids):
        for sid in sids:
            sid = int(sid)
            self._ssrc_of.pop(sid, None)
            self._tx_keys.pop(sid, None)
            self._staged.discard(sid)
            self._free.append(sid)
        self.calls.append(("remove", tuple(int(s) for s in sids)))


class DummyLoop:
    def __init__(self, cap):
        self.registry = types.SimpleNamespace(capacity=cap)
        self.recv_window_ms = 1
        self.inbound_drop = np.zeros(cap, dtype=bool)
        self.inbound_dropped = np.zeros(cap, dtype=np.int64)
        self.inbound_dropped_total = 0


class DummyBridge:
    def __init__(self, cap=8, sids=(0, 1, 2, 3)):
        self.loop = DummyLoop(cap)
        self.degraded = False
        self._ssrc_of = {s: 100 + s for s in sids}
        self.rx_table = types.SimpleNamespace(
            auth_fail=np.zeros(cap, dtype=np.int64),
            replay_reject=np.zeros(cap, dtype=np.int64))
        self.speaker = types.SimpleNamespace(dominant=0)

    def tick(self, now=None):
        return {"rx": 0}


class FakeClock:
    def __init__(self, durations):
        self.durations = list(durations)
        self.t = 0.0
        self.half = False

    def __call__(self):
        if self.half:
            self.t += self.durations.pop(0) if self.durations else 0.0
        self.half = not self.half
        return self.t


def _keys(b):
    return (bytes([b]) * 16, bytes([b + 1]) * 14)


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "t"}
    if isinstance(obj, (list, tuple)):
        return [_untimed(v) for v in obj]
    return obj


def _state(lc, bridge, reg):
    return dict(calls=list(bridge.calls),
                rtp=list(bridge.rx_table.rtp_warms),
                txrtp=list(bridge.tx_table.rtp_warms),
                rtcp=list(bridge.rx_table.rtcp_warms),
                counters=(lc.admits, lc.evicts, lc.key_installs,
                          lc.datapath_recompiles, lc.key_installs_pending,
                          lc._warm_bucket, dict(lc.admit_rejected)),
                flight=_untimed(lc.flight.dump_all()),
                render=reg.render(),
                ssrc_of=dict(bridge._ssrc_of), free=list(bridge._free))


# ------------------------------------------------------ scripted parity

def _s_admit_pipeline(lc, bridge, out):
    out.append(lc.request_join(0x10, _keys(2), _keys(4)))
    lc.run_between_ticks()
    lc.run_between_ticks()
    for i in range(5):
        out.append(lc.request_join(0x100 + i, _keys(2), _keys(4)))
    for _ in range(4):
        lc.run_between_ticks()


def _s_leave_and_evict(lc, bridge, out):
    lc.request_join(0x42, _keys(2), _keys(4))
    out.append(lc.request_leave(ssrc=0x42))
    out.append(lc.request_leave(ssrc=0xDEAD))
    lc.request_join(0x21, _keys(2), _keys(4))
    lc.request_join(0x22, _keys(6), _keys(8))
    lc.run_between_ticks()
    lc.run_between_ticks()
    out.append(lc.request_leave(ssrc=0x21))
    lc.run_between_ticks()
    lc.request_leave(sid=1)
    lc.request_leave(sid=1)
    lc.run_between_ticks()
    out.append(lc.request_join(0x23, _keys(10), _keys(12)))
    lc.run_between_ticks()
    lc.run_between_ticks()
    with pytest.raises(ValueError):
        lc.request_leave()


def _s_refusals(lc, bridge, out):
    for ssrc in (0x31, 0x31, 0x32, 0x33, 0x34, 0x35, 0x36, 0x37, 0x38,
                 0x39, 0x3A):
        out.append(lc.request_join(ssrc, _keys(2), _keys(4)))
    lc.run_between_ticks()
    lc.run_between_ticks()
    out.append(lc.request_join(0x31, _keys(2), _keys(4)))


def _s_warm_boundaries(lc, bridge, out):
    lc.request_join(0x80, _keys(2), _keys(4))
    lc.run_between_ticks()
    for i in range(3):
        lc.request_join(0x81 + i, _keys(2), _keys(4))
    lc.run_between_ticks()
    for i in range(10):
        lc.request_join(0x90 + i, _keys(2), _keys(4))
    lc.run_between_ticks()
    lc.run_between_ticks()


def _s_reconcile(lc, bridge, out):
    bridge._ssrc_of[3] = 0xA1
    bridge._tx_keys[3] = _keys(4)
    bridge._free.remove(3)
    bridge._ssrc_of[5] = 0xA2
    bridge._free.remove(5)
    lc._reconcile({"staged": [(3, 0xA1), (5, 0xA2), (6, 0xA3)],
                   "queued": [(0xB1, _keys(2), _keys(4), None)]})
    out.append(lc.snapshot())
    lc.run_between_ticks()
    out.append(lc.snapshot())
    lc.run_between_ticks()


def _s_supervised(lc, bridge, out):
    """Joins under a supervisor walking its ladder: refused `shedding`
    while streams are shed, admitted again once it unwinds."""
    sup = lc.supervisor
    for t in range(14):
        out.append(lc.request_join(0x200 + t, _keys(t), _keys(t + 1)))
        sup.tick()
        out.append((sup.level, sorted(sup._shed_set)))


SCRIPTS = {
    "admit_pipeline": (_s_admit_pipeline, dict(install_batch=2), 8, False),
    "leave_and_evict": (_s_leave_and_evict, {}, 2, False),
    "refusals": (_s_refusals, dict(max_pending=8), 6, False),
    "warm_boundaries": (_s_warm_boundaries,
                        dict(min_bucket=4, pkts_per_stream=4,
                             install_batch=64, max_pending=512), 64, False),
    "reconcile": (_s_reconcile, {}, 8, False),
    "supervised": (_s_supervised, dict(install_batch=1), 16, True),
}


def _drive(pkg, name):
    lc_mod, sup_mod, met_mod = PKGS[pkg]
    script, cfg, cap, supervised = SCRIPTS[name]
    bridge = LcBridge(capacity=cap)
    sup = None
    if supervised:
        stub = DummyBridge(cap=cap)
        stub._ssrc_of = bridge._ssrc_of      # the manager's view is live
        sup = sup_mod.BridgeSupervisor(
            stub, sup_mod.SupervisorConfig(deadline_ms=10.0,
                                           overload_after=1,
                                           overload_exit=2, shed_step=1),
            clock=FakeClock([0.05] * 4 + [0.001] * 20))
    reg = met_mod.MetricsRegistry()
    lc = lc_mod.StreamLifecycleManager(bridge, supervisor=sup,
                                       config=lc_mod.LifecycleConfig(**cfg),
                                       metrics=reg)
    out = []
    script(lc, bridge, out)
    return _state(lc, bridge, reg), out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_lifecycle_script_follows_jax(name):
    (js, jo), (ps, po) = _drive("jax", name), _drive("port", name)
    assert jo == po
    for k in js:
        assert js[k] == ps[k], k
    if name == "refusals":
        assert set(ps["counters"][6]) == {"duplicate", "capacity"}
    if name == "warm_boundaries":
        assert ps["rtp"] == [16, 64, 256] and ps["counters"][5] == 16


def test_admit_reasons_and_burn_pass_through_follow_jax():
    assert p_lc.ADMIT_REASONS == j_lc.ADMIT_REASONS
    for reason in ("fast_burn", "stalled", "shedding", "host_bound",
                   "capacity_forecast"):
        got = []
        for lc_mod in (j_lc, p_lc):
            sup = types.SimpleNamespace(
                ticks=7, flight=None, pending_lifecycle=None,
                admission_decision=lambda r=reason: (False, r))
            lc = lc_mod.StreamLifecycleManager(LcBridge())
            lc.supervisor = sup
            got.append((lc.request_join(0x70, _keys(2), _keys(4)),
                        _untimed(lc.flight.dump_all())))
        assert got[0] == got[1]
        assert got[1][0] == (False, reason)


def test_tick_bracket_counts_first_launches_inside_ticks():
    lc = p_lc.StreamLifecycleManager(LcBridge())
    st = compile_cache.compile_stats()
    lc.tick_begin()
    lc.tick_end()
    lc.assert_datapath_clean()
    st.on_launch("lifecycle_test_kernel nr=10")     # off-tick: free
    lc.tick_begin()
    st.on_launch("lifecycle_test_kernel nr=10")     # seen: free
    st.on_launch("lifecycle_test_kernel nr=14")     # first, in a tick
    lc.tick_end()
    assert lc.datapath_recompiles == 1
    with pytest.raises(AssertionError, match="1 compile event"):
        lc.assert_datapath_clean()
    kinds = [e["kind"] for e in lc.flight.dump_all()["global"]]
    assert "datapath_recompile" in kinds


def test_fill_keystream_runs_between_ticks_after_the_commit():
    order = []
    cache = types.SimpleNamespace(fill=lambda: order.append("fill"),
                                  hits=3, misses=1, evictions=0,
                                  fill_seconds=0.5, filled_slots=64)
    bridge = LcBridge()
    bridge.rx_table._ks_cache = cache
    commit = bridge.commit_endpoints
    bridge.commit_endpoints = lambda s: (order.append("commit"), commit(s))
    reg = p_metrics.MetricsRegistry()
    lc = p_lc.StreamLifecycleManager(bridge, metrics=reg)
    lc.request_join(0x10, _keys(2), _keys(4))
    lc.run_between_ticks()
    lc.run_between_ticks()
    assert order == ["fill", "commit", "fill"]
    text = reg.render()
    assert "libjitsi_tpu_srtp_keystream_hits 3" in text
    assert "libjitsi_tpu_srtp_keystream_fill_seconds 0.5" in text


@pytest.mark.parametrize("call,args", [
    ("enable_placement", (2,)), ("declare_broadcast", (5,)),
    ("promote_speaker", (5, 1)), ("demote_speaker", (5, 1)),
    ("mark_remote_conference", (5, None)),
    ("promote_remote_conference", (5,))])
def test_placement_broadcast_and_cascade_name_item_12(call, args):
    lc = p_lc.StreamLifecycleManager(LcBridge())
    with pytest.raises(NotImplementedError, match="item 12"):
        getattr(lc, call)(*args)


def test_retry_after_hint_calls_the_queue():
    """The JAX method hands back the queue's bound method for a
    handshake refusal; the port returns its seconds."""
    lc = p_lc.StreamLifecycleManager(LcBridge())
    lc.handshakes = types.SimpleNamespace(retry_after=lambda: 0.06)
    assert lc.retry_after_hint("handshake_backlog") == 0.06
    assert lc.retry_after_hint("backlog") == lc.cfg.handshake_retry_tick_s


# ------------------------------------------------ warm-ups (port tables)

def _plain_delta(fn):
    """The SRTP / SRTCP / GCM plain versions `fn` ran (theirs call the
    AES and SHA-1 plain versions inside, not counted here)."""
    before = dict(kbuild.plain_calls)
    fn()
    return {k: v - before[k] for k, v in kbuild.plain_calls.items()
            if v != before[k] and k not in ("aes_encrypt", "hmac_sha1")}


@pytest.mark.parametrize("profile", ["AES_CM_128_HMAC_SHA1_80",
                                     "NULL_HMAC_SHA1_80"])
def test_table_warmups_run_on_a_scratch_table(profile):
    prof = SrtpProfile[profile]
    live = SrtpStreamTable(8, prof, device="cpu")
    live.add_stream(2, b"\x11" * 16, b"\x22" * 14)
    live.tx_ext[2] = 77
    live.rx_max[2] = 99
    live.rx_mask[2] = 5
    snap = {k: np.array(getattr(live, k)) for k in (
        "tx_ext", "rx_max", "rx_mask", "rtcp_tx_index", "rtcp_rx_max",
        "auth_fail", "replay_reject", "active")}
    cipher = {"AES_CM_128_HMAC_SHA1_80": "cm",
              "NULL_HMAC_SHA1_80": "null"}[profile]
    assert _plain_delta(lambda: live.warmup_rtp(16, payload_len=40)) \
        == {f"srtp_protect_{cipher}": 1, f"srtp_unprotect_{cipher}": 1}
    assert _plain_delta(lambda: live.warmup_rtcp(4)) \
        == {f"srtcp_protect_{cipher}": 1, f"srtcp_unprotect_{cipher}": 1}
    for k, v in snap.items():
        np.testing.assert_array_equal(getattr(live, k), v)


def test_translator_warmup_launches_the_fanout():
    tr = RtpTranslator(4, device="cpu")
    tr.add_receiver(0, b"\x01" * 16, b"\x02" * 14)
    assert _plain_delta(lambda: tr.warmup_fanout(16, payload_len=40)) \
        == {"srtp_fanout_cm": 4}


def test_gcm_warmup_runs_the_cached_twin():
    prof = SrtpProfile.AEAD_AES_128_GCM
    live = SrtpStreamTable(4, prof, device="cpu")
    live.enable_keystream_cache(window=8, ks_bytes=64, pool=4)
    got = _plain_delta(lambda: live.warmup_rtp(4, packets_per_stream=4,
                                               payload_len=40))
    assert got == {"srtp_gcm_seal": 1, "srtp_gcm_open": 1,
                   "srtp_gcm_seal_cached": 1, "srtp_gcm_open_cached": 1,
                   "gcm_ks_fill": 2}
    assert live._ks_cache.hits == 0 and live._ks_cache.filled_slots == 0


# ------------------------------------------- a port bridge's lifecycle

def _dtls_lc(**cfg):
    bridge = SfuBridge(port=0, capacity=8, recv_window_ms=0, device="cpu")
    bridge._dtls.endpoint_factory = StubDtlsEndpoint
    sup = p_sup.BridgeSupervisor(bridge, p_sup.SupervisorConfig(
        deadline_ms=1000.0))
    lc = p_lc.StreamLifecycleManager(bridge, supervisor=sup,
                                     config=p_lc.LifecycleConfig(**cfg))
    lc._warm_bucket = 1 << 30          # the warm-ups have their own cases
    return lc, bridge, sup


def test_handshake_keys_land_only_via_the_commit_barrier():
    lc, bridge, sup = _dtls_lc()
    eng = UdpEngine(port=0, max_batch=32)
    try:
        caddr = (0x7F000001, eng.port)
        assert lc.request_handshake(0x60, remote_addr=caddr) \
            == (True, "queued", 0.0)
        sid = next(s for s, v in bridge._ssrc_of.items() if v == 0x60)
        fp = bridge._dtls.pending[sid].local_fingerprint
        client = StubDtlsEndpoint("client", remote_fingerprint=fp)
        lc.tick_begin()
        for d in client.handshake_packets():
            bridge._dtls.on_dtls(d, caddr)
        lc.tick_end()
        assert bridge._dtls.feeds_total == 0
        for _ in range(80):
            lc.handshakes.drain()
            if sid in bridge._staged:
                break
            back, _, _ = eng.recv_batch(timeout_ms=20)
            lc.tick_begin()
            for i in range(back.batch_size):
                for out in client.feed(back.to_bytes(i)):
                    bridge._dtls.on_dtls(out, caddr)
            lc.tick_end()
        assert sid in bridge._staged and sid in bridge._tx_keys
        assert lc.key_installs == 1 and lc.handshakes.completed == 1
        assert lc.admits == 0 and bridge._dtls.feeds_total > 0
        assert lc.tick_thread_handshake_feeds == 0
        lc.commit()
        assert sid not in bridge._staged and lc.admits == 1
        kinds = [e["kind"] for e in sup.flight.dump(sid)["events"]
                 + sup.flight.dump_all()["global"]]
        assert "handshake_queued" in kinds and "admit_commit" in kinds
        back, _, _ = eng.recv_batch(timeout_ms=100)
        for i in range(back.batch_size):
            client.feed(back.to_bytes(i))
        assert client.complete
        assert bridge._tx_keys[sid] == client.srtp_keys()[3:5]
        assert sup.phase_attribution()["off_tick"][
            "handshake_tick_thread_feeds"] == 0
    finally:
        eng.close()
        bridge.close()


def test_handshake_backpressure_is_typed_with_retry_hint():
    lc, bridge, sup = _dtls_lc(max_handshakes=2)
    try:
        assert lc.request_handshake(0x61)[0]
        assert lc.request_handshake(0x62)[0]
        ok, reason, retry = lc.request_handshake(0x63)
        assert (ok, reason) == (False, "handshake_backlog")
        assert retry > 0.0 and retry == lc.handshakes.retry_after()
        assert lc.retry_after_hint(reason) == retry
        assert lc.request_handshake(0x61) == (False, "duplicate", 0.0)
        snap = lc.snapshot()
        assert [h["ssrc"] for h in snap["handshakes"]] == [0x61, 0x62]
    finally:
        bridge.close()


def test_request_handshake_requires_a_dtls_table():
    lc = p_lc.StreamLifecycleManager(LcBridge())
    with pytest.raises(RuntimeError, match="no DTLS association table"):
        lc.request_handshake(0x10)


# --------------------------------------------------------------- soak

@pytest.mark.slow
def test_churn_soak_smoke_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_churn_soak.py"),
         "--smoke", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=1200,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
