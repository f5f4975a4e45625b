"""The port's ObservabilityServer against the JAX package's.

Both servers run over the same scripted state: a supervisor of each
package over the stub bridge of `tests/test_torch_supervisor.py`,
driven through an overload and a quarantine, with each package's SLO
engine and capacity model attached and a journey histogram with
exemplars in each package's registry.  Every route is scraped over
HTTP from both and compared: `/metrics` in the Prometheus and the
negotiated OpenMetrics formats (the process families aside, whose
values are clocks) and each passing the port's `validate_exposition`,
`/healthz`, `/debug/slo`, `/debug/capacity`, `/debug/postmortems`,
`/debug/streams` and `/debug/streams/<sid>` (clock stamps aside), and
the 404s.  `/debug/fleet` on the port's server stitches a trace id
across itself and a JAX server registered as its peer, and
`stitch_journeys` gives the JAX function's result on the same scrapes.
`/debug/device` reports the CPU under the JAX keys, holding None.
Tolerance: exact.
"""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from libjitsi_tpu.service import obs_server as j_obs
from libjitsi_tpu.service import supervisor as j_sup
from libjitsi_tpu.utils import capacity as j_cap
from libjitsi_tpu.utils import flight as j_flight
from libjitsi_tpu.utils import metrics as j_metrics
from libjitsi_tpu.utils import slo as j_slo
from libjitsi_tpu_torch.service import obs_server as p_obs
from libjitsi_tpu_torch.service import supervisor as p_sup
from libjitsi_tpu_torch.utils import capacity as p_cap
from libjitsi_tpu_torch.utils import flight as p_flight
from libjitsi_tpu_torch.utils import metrics as p_metrics
from libjitsi_tpu_torch.utils import slo as p_slo
from libjitsi_tpu_torch.utils.metrics import validate_exposition
from test_torch_supervisor import DummyBridge, FakeClock, _untimed
from test_torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(obs=j_obs, sup=j_sup, cap=j_cap,
                                 flight=j_flight, metrics=j_metrics,
                                 slo=j_slo),
    "port": types.SimpleNamespace(obs=p_obs, sup=p_sup, cap=p_cap,
                                  flight=p_flight, metrics=p_metrics,
                                  slo=p_slo),
}
OM = {"Accept": "application/openmetrics-text"}


def _build(pkg_name: str, name: str):
    """A supervised stub bridge with an SLO engine, a capacity model and
    a registry holding a hop-labeled journey histogram with exemplars,
    driven 30 ticks (an overload, then an auth storm on sid 2)."""
    pkg = PKGS[pkg_name]
    reg = pkg.metrics.MetricsRegistry()
    vec = reg.histogram_vec("packet_journey_seconds",
                            [0.005, 0.01, 0.02, 0.05], "hop",
                            help_="ingress-arrival to egress-send",
                            exemplars=True)
    rng = np.random.default_rng(5)
    for i, v in enumerate(rng.uniform(0.0, 0.04, 40)):
        vec.labels("local").observe(float(v), exemplar={
            "trace_id": str(100 + i % 7)})
    reg.register_scalar("bridge_forwarded", lambda: 400, kind="counter")
    flight = pkg.flight.FlightRecorder()
    slo = pkg.slo.SloEngine(reg, pkg.slo.default_slos(), flight=flight)
    bridge = DummyBridge()
    sup = pkg.sup.BridgeSupervisor(
        bridge, pkg.sup.SupervisorConfig(deadline_ms=10.0, overload_after=2,
                                         quarantine_window=5,
                                         quarantine_auth_threshold=5),
        metrics=reg, clock=FakeClock([0.05] * 8 + [0.001] * 22),
        flight=flight, slo=slo)
    pkg.cap.CapacityModel().attach(sup, registry=reg)
    for t in range(30):
        if t == 12:
            bridge.rx_table.auth_fail[2] += 6
        sup.tick(now=float(t))
    srv = pkg.obs.ObservabilityServer(reg, supervisor=sup, name=name)
    return srv.start(), sup


def _get(srv, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _no_process(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if "process_start_time" not in ln
                     and "scrape_duration" not in ln)


@pytest.fixture(scope="module")
def servers():
    js, jsup = _build("jax", "b0")
    ps, psup = _build("port", "b1")
    yield js, ps
    js.stop()
    ps.stop()


@pytest.mark.parametrize("om", [False, True])
def test_metrics_scrape_follows_jax(servers, om):
    js, ps = servers
    (jc, jt, jb), (pc, pt, pb) = (_get(s, "/metrics", OM if om else None)
                                  for s in servers)
    assert (jc, jt) == (pc, pt) == (200, jt)
    text = pb.decode()
    assert validate_exposition(text, openmetrics=om) == []
    assert _no_process(jb.decode()) == _no_process(text)
    assert ("# EOF" in text) == om and ("trace_id" in text) == om
    assert "libjitsi_tpu_supervisor_quarantine_total 1" in text
    assert "libjitsi_tpu_slo_burn_rate" in text
    assert "libjitsi_tpu_capacity_headroom_users" in text


@pytest.mark.parametrize("path", [
    "/healthz", "/debug/slo", "/debug/capacity", "/debug/postmortems",
    "/debug/streams", "/debug/streams/2", "/debug/streams/x", "/nowhere"])
def test_json_routes_follow_jax(servers, path):
    (jc, jt, jb), (pc, pt, pb) = (_get(s, path) for s in servers)
    assert (jc, jt) == (pc, pt)
    assert _untimed(json.loads(jb)) == _untimed(json.loads(pb))
    if path == "/healthz":
        assert pc == 200 and json.loads(pb)["quarantined"] == [2]
    if path == "/debug/postmortems":
        assert {p["trigger"] for p in json.loads(pb)} \
            >= {"quarantine", "overload_shed"}


def test_debug_device_reports_the_cpu_under_the_jax_keys():
    bridge = DummyBridge()
    bridge.device = "cpu"
    sup = p_sup.BridgeSupervisor(bridge)
    srv = p_obs.ObservabilityServer(p_metrics.MetricsRegistry(),
                                    supervisor=sup).start()
    try:
        code, _t, body = _get(srv, "/debug/device")
    finally:
        srv.stop()
    assert code == 200
    (dev,) = json.loads(body)["devices"]
    assert dev == {"device": "cpu", "bytes_in_use": None,
                   "peak_bytes_in_use": None, "num_allocs": None,
                   "num_alloc_retries": None}


def test_fleet_view_stitches_across_packages(servers):
    js, ps = servers
    ps.add_peer("b0", f"http://127.0.0.1:{js.port}")
    try:
        code, _t, body = _get(ps, "/debug/fleet")
    finally:
        ps.peers.clear()
    doc = json.loads(body)
    assert code == 200 and doc["errors"] == {} and doc["self"] == "b1"
    # each bucket keeps its last exemplar: both bridges saw the same ids
    assert doc["stitched_trace_ids"] and set(doc["stitched_trace_ids"]) \
        <= {str(100 + i) for i in range(7)}
    scrapes = {"b1": ps._metrics_text(openmetrics=True),
               "b0": js._metrics_text(openmetrics=True)}
    assert p_obs.stitch_journeys(scrapes) == j_obs.stitch_journeys(scrapes)
