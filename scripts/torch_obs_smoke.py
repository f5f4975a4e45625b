#!/usr/bin/env python
"""Observability-plane smoke of the PyTorch port: a real SfuBridge over
loopback UDP with a BridgeSupervisor, an SLO engine, a capacity model
and an ObservabilityServer attached, scraped over HTTP.

The port's twin of `scripts/obs_smoke.py`.  Drives media and a NACK
through the bridge for N ticks, then asserts:

- /metrics parses under the exposition validator with zero errors;
- the five pipeline-stage summaries (ingress, reverse_chain, recovery,
  forward_chain, egress) are present with p50/p99 quantiles;
- real histogram families expose cumulative buckets ending in +Inf;
- an OpenMetrics scrape (Accept negotiation) carries at least one valid
  exemplar on packet_journey_seconds buckets plus the `# EOF`
  terminator, and the default scrape stays exemplar-free;
- packet_journey_seconds is hop-labeled (`hop="local"`), and
  /debug/fleet on two peered ObservabilityServers stitches one of this
  bridge's trace ids recorded under a hop label by the second bridge's
  registry (the trunk that carries it between bridges is
  `mesh/cascade.py`, ROADMAP Queue 1 item 12 in the port);
- the SLO engine exports slo_burn_rate gauges and serves /debug/slo;
- a hostile stream name round-trips escaped, not raw;
- /healthz reports ok and /debug/streams serves a flight dump;
- the phase profiler's tick_phase_seconds histogram carries sampled
  ticks, dispatch_inflight_ticks and the h2d/d2h byte counters are
  live, and /debug/device serves the bridge's device memory (bytes in
  use on the card);
- the capacity model exports its gauges and serves /debug/capacity;
  process_start_time_seconds and scrape_duration_seconds ride every
  scrape un-namespaced;
- a synthetic host-dominant overload escalates with the host phase
  named on the ladder_escalate event and /debug/slo attribution.

Usage: `python3 scripts/torch_obs_smoke.py [--ticks N] [--device cpu]`
(the card by default).  Prints OBS_SMOKE_OK on success; any failure
raises (exit != 0).
"""

import argparse
import json
import os
import sys
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HOSTILE_NAME = 'evil "name\nwith\\slashes'
STAGES = ("ingress", "reverse_chain", "recovery", "forward_chain",
          "egress")
ACCEPT_OM = "application/openmetrics-text; version=1.0.0"


def _get(port, path, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if accept is not None:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, r.read().decode("utf-8"), \
            r.headers.get("Content-Type", "")


def _fleet_smoke(srv_a, om_a: str, exemplar_line: str) -> None:
    """Stand up bridge B as a second registry and ObservabilityServer,
    record one of A's trace ids on B under the hop label `b0-b1` (what a
    cascade trunk's receiving end records), and assert the peered
    /debug/fleet stitches that id across both bridges."""
    import re

    from libjitsi_tpu_torch.io.loop import JOURNEY_BUCKETS
    from libjitsi_tpu_torch.service.obs_server import ObservabilityServer
    from libjitsi_tpu_torch.utils.metrics import MetricsRegistry

    m = re.search(r'trace_id="(\d+)"', exemplar_line)
    assert m, f"unparseable exemplar line: {exemplar_line}"
    tid = int(m.group(1))
    reg_b = MetricsRegistry()
    vec_b = reg_b.histogram_vec("packet_journey_seconds",
                                JOURNEY_BUCKETS, "hop",
                                help_="journey latency", exemplars=True)
    vec_b.labels("b0-b1").observe(
        0.004, exemplar={"trace_id": str(tid), "origin": "0"})
    srv_b = ObservabilityServer(metrics=reg_b, name="bridge-b").start()
    try:
        srv_a.name = "bridge-a"
        srv_a.add_peer("bridge-b", f"http://127.0.0.1:{srv_b.port}")
        srv_b.add_peer("bridge-a", f"http://127.0.0.1:{srv_a.port}")
        for port in (srv_a.port, srv_b.port):
            code, body, _ = _get(port, "/debug/fleet")
            assert code == 200, f"/debug/fleet -> {code}"
            fleet = json.loads(body)
            assert not fleet["errors"], f"peer scrape failed: {fleet}"
            assert str(tid) in fleet["stitched_trace_ids"], \
                (f"trace {tid} not stitched across bridges: "
                 f"{fleet['stitched_trace_ids']}")
            spans = [j for j in fleet["journeys"]
                     if j["trace_id"] == str(tid)][0]["spans"]
            hops = {s["hop"] for s in spans}
            assert "local" in hops and "b0-b1" in hops, \
                f"journey lacks origin+remote spans: {spans}"
    finally:
        srv_a.peers.clear()
        srv_b.stop()


def run(ticks: int = 40, device=None) -> None:
    from libjitsi_tpu_torch.service.obs_server import ObservabilityServer
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.service.supervisor import (BridgeSupervisor,
                                                       SupervisorConfig)
    from libjitsi_tpu_torch.utils.capacity import CapacityModel
    from libjitsi_tpu_torch.utils.metrics import (count_exemplars,
                                                  validate_exposition)
    from libjitsi_tpu_torch.utils.slo import SloEngine, default_slos

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_sfu_bridge import _Endpoint

    sfu = SfuBridge(port=0, capacity=8, recv_window_ms=0, device=device)
    slo = SloEngine(sfu.loop.metrics, default_slos())
    sup = BridgeSupervisor(sfu, SupervisorConfig(deadline_ms=1000.0),
                           metrics=sfu.loop.metrics, slo=slo)
    CapacityModel().attach(sup, registry=sfu.loop.metrics)
    srv = ObservabilityServer(metrics=sfu.loop.metrics,
                              supervisor=sup).start()
    try:
        eps = [_Endpoint(0x200 + 9 * k, sfu.port) for k in range(3)]
        names = [HOSTILE_NAME, "alice", None]
        for e, name in zip(eps, names):
            sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key, name=name)
        for e in eps:
            for other in eps:
                if other is not e:
                    e.expect_sender(other.ssrc)

        now = 100.0
        for t in range(ticks):
            if t % 4 == 0:
                for e in eps:
                    e.send_media()
            sup.tick(now=now)
            now += 0.02
            for e in eps:
                e.drain()
        assert sfu.forwarded > 0, "no media forwarded"
        # exercise the RTX path (egress span + rtx_served flight event)
        eps[0].send_nack(eps[1].ssrc, [501])
        for _ in range(10):
            sup.tick(now=now)
        sfu.emit_feedback(now=now)

        code, text, ctype = _get(srv.port, "/metrics")
        assert code == 200, f"/metrics -> {code}"
        assert "text/plain" in ctype, f"default scrape ctype: {ctype}"
        errors = validate_exposition(text)
        assert not errors, "exposition invalid:\n" + "\n".join(errors)
        ns = sfu.loop.metrics.ns
        for stage in STAGES:
            fam = f"{ns}_stage_{stage}_seconds"
            assert f"# TYPE {fam} summary" in text, f"missing {fam}"
            for q in ('quantile="0.5"', 'quantile="0.99"'):
                assert f"{fam}{{{q}}}" in text, f"missing {fam}{{{q}}}"
        assert f"# TYPE {ns}_packet_size_bytes histogram" in text
        assert f'{ns}_packet_size_bytes_bucket{{le="+Inf"}}' in text
        assert HOSTILE_NAME not in text, "raw hostile name leaked"
        assert 'evil \\"name\\nwith\\\\slashes' in text, \
            "escaped stream name missing"

        # OpenMetrics negotiation: exemplars + # EOF, validator-clean
        code, om, ctype = _get(srv.port, "/metrics", accept=ACCEPT_OM)
        assert code == 200, f"/metrics (OM) -> {code}"
        assert "application/openmetrics-text" in ctype, \
            f"OM scrape ctype: {ctype}"
        om_errors = validate_exposition(om, openmetrics=True)
        assert not om_errors, \
            "OpenMetrics exposition invalid:\n" + "\n".join(om_errors)
        journey = f"{ns}_packet_journey_seconds"
        assert f"# TYPE {journey} histogram" in om, f"missing {journey}"
        n_ex = count_exemplars(om)
        assert n_ex >= 1, "no exemplars in the OpenMetrics scrape"
        ex_lines = [ln for ln in om.splitlines()
                    if ln.startswith(f"{journey}_bucket") and " # " in ln]
        assert ex_lines, "no exemplar on packet_journey_seconds buckets"
        assert 'trace_id="' in ex_lines[0], \
            f"exemplar lacks trace_id: {ex_lines[0]}"
        assert count_exemplars(text) == 0, \
            "default (non-OpenMetrics) scrape leaked exemplars"
        # the journey family is hop-labeled: local journeys land under
        # hop="local"; cross-bridge ingests add hop="bX-bY" children
        assert f'{journey}_count{{hop="local"}}' in om, \
            "packet_journey_seconds lost its hop label axis"

        # ---- cross-bridge fleet view: a second bridge's registry
        # records one of this bridge's real trace ids (from its own
        # exemplars) under a hop label; the peered /debug/fleet must
        # stitch that id across both scrapes
        _fleet_smoke(srv, om, ex_lines[0])

        # SLO engine: burn-rate gauges in the scrape + /debug/slo JSON
        assert f"# TYPE {ns}_slo_burn_rate gauge" in text, \
            "slo_burn_rate family missing"
        assert f'{ns}_slo_burn_rate{{slo="journey_p99",window="1m"}}' \
            in text, "journey_p99 1m burn-rate sample missing"
        code, body, _ = _get(srv.port, "/debug/slo")
        slo_doc = json.loads(body)
        assert code == 200, f"/debug/slo -> {code}"
        assert slo_doc["ticks"] > 0, "SLO engine never ticked"
        names = {s["name"] for s in slo_doc["slos"]}
        assert {"journey_p99", "residual_loss", "auth_fail"} <= names, \
            f"missing stock SLOs: {names}"
        for s in slo_doc["slos"]:
            assert set(s["burn"]) == {"1m", "5m", "30m", "6h"}, \
                f"bad windows on {s['name']}: {set(s['burn'])}"

        code, body, _ = _get(srv.port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"], f"unhealthy: {health}"

        code, body, _ = _get(srv.port, "/debug/streams")
        sids = json.loads(body)["streams"]
        assert sids, "flight recorder saw no streams"
        code, body, _ = _get(srv.port, "/debug/streams/%d" % sids[0])
        dump = json.loads(body)
        assert code == 200 and dump["events"], "empty flight dump"
        kinds = {e["kind"] for e in dump["events"]}
        assert "hdr" in kinds, f"no header samples in dump: {kinds}"

        # phase profiler: with the default sample_every=16 at least
        # ticks 1/17/33 were fenced over 40 ticks, so the phase
        # histogram family must carry samples and the dispatch-depth
        # gauge must be present (0 on the sync path is fine)
        code, text, _ = _get(srv.port, "/metrics")
        phase_fam = f"{ns}_tick_phase_seconds"
        assert f"# TYPE {phase_fam} histogram" in text, \
            "tick_phase_seconds family missing"
        for ph in ("host_python", "dispatch", "device_compute", "idle"):
            assert f'{phase_fam}_bucket{{phase="{ph}",le="+Inf"}}' \
                in text, f"phase {ph} missing from scrape"
        assert f'{phase_fam}_count{{phase="host_python"}} 0' not in \
            text, "no sampled ticks reached the phase histogram"
        assert f"# TYPE {ns}_dispatch_inflight_ticks gauge" in text, \
            "dispatch_inflight_ticks gauge missing"
        assert f"# TYPE {ns}_h2d_bytes_total counter" in text
        h2d = [ln for ln in text.splitlines()
               if ln.startswith(f"{ns}_h2d_bytes_total ")]
        assert h2d and float(h2d[0].split()[1]) > 0, \
            f"h2d byte accounting never ran: {h2d}"

        # /debug/device: live device-memory stats JSON (the bridge's
        # device; on the card the caching allocator holds its tables)
        code, body, _ = _get(srv.port, "/debug/device")
        assert code == 200, f"/debug/device -> {code}"
        devices = json.loads(body)["devices"]
        assert devices and devices[0]["device"] == str(sfu.device), \
            f"bad /debug/device doc: {devices}"
        if sfu.device.type == "cuda":
            assert devices[0]["bytes_in_use"] > 0, devices

        # capacity model: headroom/bottleneck/confidence gauges in the
        # scrape and the /debug/capacity JSON document
        assert f"# TYPE {ns}_capacity_headroom_users gauge" in text, \
            "capacity_headroom_users gauge missing"
        assert f'{ns}_capacity_bottleneck{{resource="rows"}}' in text, \
            "capacity_bottleneck resource axis missing"
        assert f"# TYPE {ns}_capacity_estimate_confidence gauge" \
            in text, "capacity_estimate_confidence gauge missing"
        code, body, _ = _get(srv.port, "/debug/capacity")
        assert code == 200, f"/debug/capacity -> {code}"
        cap_doc = json.loads(body)
        assert cap_doc["ticks"] > 0, "capacity model never ticked"
        assert set(cap_doc["resources"]) >= {"rows", "host",
                                             "tick_budget"}, \
            f"capacity resources missing: {set(cap_doc['resources'])}"

        # process-level families ride every scrape UN-namespaced (the
        # Prometheus convention) and the validator vouches for them
        start_lines = [ln for ln in text.splitlines()
                       if ln.startswith("process_start_time_seconds ")]
        assert start_lines and float(start_lines[0].split()[1]) > 1e9, \
            f"process_start_time_seconds missing/bogus: {start_lines}"
        dur = [ln for ln in text.splitlines()
               if ln.startswith("scrape_duration_seconds ")]
        assert dur and float(dur[0].split()[1]) >= 0, \
            f"scrape_duration_seconds missing: {dur}"
        assert "# TYPE process_start_time_seconds gauge" in text
        assert "# TYPE scrape_duration_seconds gauge" in text

        # host-bound overload drill: feed the supervisor a synthetic
        # host-dominant phase ledger while the watchdog is overrun —
        # the resulting ladder_escalate event must NAME the host phase
        sup.watchdog.deadline_s = 1e-9
        for _ in range(sup.cfg.overload_after):
            sfu.loop.tracer.merge_phases(
                {"host_python": 0.018, "dispatch": 0.001,
                 "device_compute": 0.0005, "idle": 0.0005})
            sup.tick(now=now)
            now += 0.02
        evs = [e for e in sup.flight.dump_all()["global"]
               if e.get("kind") == "ladder_escalate"]
        assert evs, "overrun ticks produced no ladder_escalate"
        ev = evs[-1]
        assert ev.get("phase") == "host_python", \
            f"escalation did not name the host phase: {ev}"
        assert ev.get("bound") == "host", \
            f"escalation not attributed host-bound: {ev}"
        code, body, _ = _get(srv.port, "/debug/slo")
        attr = json.loads(body).get("attribution", {})
        assert attr.get("bound") == "host", \
            f"/debug/slo attribution missing host bound: {attr}"
    finally:
        srv.stop()
        sfu.close()
    print("OBS_SMOKE_OK")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    run(ticks=args.ticks, device=args.device)


if __name__ == "__main__":
    main()
