"""ObservabilityServer: a stdlib HTTP surface for the metrics plane.

Counterpart: `libjitsi_tpu/service/obs_server.py`, copied (host only) on
the port's `utils/metrics.py`.  A threaded `http.server` (no framework)
serving:

  /metrics              Prometheus text exposition (the registry's
                        render); negotiates OpenMetrics through the
                        Accept header, which adds exemplars on histogram
                        buckets (trace ids linking tail latency to
                        flight-recorder `hdr` events) and the `# EOF`
                        terminator
  /healthz              the supervisor's health JSON; 503 when stalled
  /debug/slo            SloEngine status (burn rates over the four
                        windows, states, thresholds) and the
                        supervisor's host/device phase attribution
  /debug/capacity       CapacityModel status (utils/capacity.py)
  /debug/device         the caching allocator's live and peak bytes per
                        device (utils/profiling.device_memory): the
                        supervised bridge's device, or every card
  /debug/streams/<sid>  flight-recorder dump for one stream
  /debug/postmortems    the supervisor's bounded post-mortem list
  /debug/fleet          cross-bridge journey view: scrapes every
                        registered peer's /metrics (OpenMetrics) and
                        stitches hop-labeled packet_journey_seconds
                        exemplars by trace id (`stitch_journeys`, plain
                        text over the peers' scrapes)

The server binds an ephemeral port by default (`port=0`; read `.port`
after `start()`), runs on a daemon thread, and never touches the data
path: `/metrics` renders from the arrays the tick already maintains.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

import torch

from libjitsi_tpu_torch.utils.logging import get_logger
from libjitsi_tpu_torch.utils.metrics import (CONTENT_TYPE_OPENMETRICS,
                                              CONTENT_TYPE_PROM,
                                              _parse_labels, _split_exemplar,
                                              parse_exposition,
                                              process_families_text)
from libjitsi_tpu_torch.utils.profiling import device_memory

_log = get_logger("service.obs")

CONTENT_TYPE_METRICS = CONTENT_TYPE_PROM


def _jsonable(obj):
    """json.dumps default= hook: numpy scalars/arrays -> python."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


JOURNEY_FAMILY = "packet_journey_seconds"


def _journey_exemplars(text: str) -> List[dict]:
    """Hop-labeled journey exemplars out of one OpenMetrics scrape:
    `{trace_id, hop, seconds, origin}` per `_bucket` exemplar.  The
    trace id is the stitch key — the origin bridge stamps it on the
    trunk trace extension, so the SAME id shows up under `hop="local"`
    on the origin and `hop="bX-bY"` on the destination."""
    out: List[dict] = []
    seen = set()
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        sample, ex = _split_exemplar(line)
        if ex is None or not ex.startswith("{"):
            continue
        brace, close = sample.find("{"), sample.rfind("}")
        name = sample[:brace] if brace >= 0 else sample.split()[0]
        # family names carry the registry namespace prefix
        if not name.endswith(f"{JOURNEY_FAMILY}_bucket"):
            continue
        labels = (_parse_labels(sample[brace + 1: close])
                  if 0 <= brace < close else None) or {}
        eclose = ex.rfind("}")
        elabels = (_parse_labels(ex[1:eclose])
                   if eclose > 0 else None) or {}
        tail = ex[eclose + 1:].split()
        tid = elabels.get("trace_id")
        if tid is None or not tail:
            continue
        try:
            seconds = float(tail[0])
        except ValueError:
            continue
        hop = labels.get("hop", "")
        key = (tid, hop, seconds)
        if key in seen:                 # same exemplar, +Inf slot
            continue
        seen.add(key)
        out.append({"trace_id": tid, "hop": hop, "seconds": seconds,
                    "origin": elabels.get("origin")})
    return out


def stitch_journeys(scrapes: Dict[str, str]) -> dict:
    """Merge several bridges' OpenMetrics scrapes into one fleet
    journey view.  `scrapes` maps bridge name -> exposition text; the
    result groups hop-labeled journey exemplars by trace id and marks
    the ids observed on more than one bridge as STITCHED — the packet
    demonstrably crossed the trunk and kept its trace.  `/debug/fleet`
    serves it over live peer scrapes."""
    bridges: Dict[str, dict] = {}
    journeys: Dict[str, dict] = {}
    for name, text in sorted(scrapes.items()):
        _types, samples, _errs = parse_exposition(text)
        hops = {
            labels["hop"]: value
            for sname, labels, value in samples
            if sname.endswith(f"{JOURNEY_FAMILY}_count")
            and "hop" in labels}
        exs = _journey_exemplars(text)
        bridges[name] = {"hops": hops, "exemplars": len(exs)}
        for e in exs:
            j = journeys.setdefault(e["trace_id"], {
                "trace_id": e["trace_id"], "spans": []})
            j["spans"].append({"bridge": name, "hop": e["hop"],
                               "seconds": e["seconds"],
                               "origin": e["origin"]})
    for j in journeys.values():
        j["bridges"] = sorted({s["bridge"] for s in j["spans"]})
        j["stitched"] = len(j["bridges"]) > 1
    stitched = sorted(t for t, j in journeys.items() if j["stitched"])
    return {
        "bridges": bridges,
        "journeys": sorted(journeys.values(),
                           key=lambda j: (-len(j["bridges"]),
                                          j["trace_id"])),
        "stitched_trace_ids": stitched,
    }


def fetch_metrics(base_url: str, timeout: float = 1.0) -> str:
    """One peer scrape, OpenMetrics negotiated (exemplars ride only on
    the OM content type)."""
    req = urllib.request.Request(
        base_url.rstrip("/") + "/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


class ObservabilityServer:
    """Serve /metrics, /healthz and flight-recorder debug dumps.
    /debug/device reports the supervised bridge's device, else every
    card."""

    def __init__(self, metrics=None, supervisor=None, flight=None,
                 slo=None, capacity=None, host: str = "127.0.0.1",
                 port: int = 0, name: str = "local",
                 peers: Optional[Dict[str, str]] = None):
        self.metrics = metrics
        self.supervisor = supervisor
        # explicit flight wins; else follow the supervisor's recorder
        self._flight = flight
        # explicit slo engine wins; else follow the supervisor's
        self._slo = slo
        # explicit capacity model wins; else follow the supervisor's
        self._capacity = capacity
        self.host = host
        self.port = int(port)
        # fleet axis: this bridge's name plus peer name -> base URL,
        # scraped (OpenMetrics) by /debug/fleet for journey stitching
        self.name = str(name)
        self.peers: Dict[str, str] = dict(peers or {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def add_peer(self, name: str, base_url: str) -> None:
        self.peers[str(name)] = str(base_url)

    @property
    def flight(self):
        if self._flight is not None:
            return self._flight
        return getattr(self.supervisor, "flight", None)

    @property
    def slo(self):
        if self._slo is not None:
            return self._slo
        return getattr(self.supervisor, "slo", None)

    @property
    def capacity(self):
        if self._capacity is not None:
            return self._capacity
        return getattr(self.supervisor, "capacity", None)

    def _devices(self) -> list:
        dev = getattr(getattr(self.supervisor, "bridge", None), "device",
                      None)
        if dev is not None:
            return [dev]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    # ---------------------------------------------------------- handlers
    def _metrics_text(self, openmetrics: bool = False) -> str:
        if self.metrics is None:
            return "# EOF\n" if openmetrics else "\n"
        # standard process families ride every scrape, un-namespaced
        # (stock Prometheus `up`/restart detection); scrape_duration is
        # THIS response's registry render wall time.  The OpenMetrics
        # `# EOF` terminator must stay last, so splice before it.
        t0 = time.perf_counter()
        text = self.metrics.render(openmetrics=openmetrics)
        extra = process_families_text(time.perf_counter() - t0)
        if openmetrics and text.endswith("# EOF\n"):
            return text[:-len("# EOF\n")] + extra + "# EOF\n"
        return text + extra

    def _health(self) -> dict:
        if self.supervisor is None:
            return {"ok": True, "state": "unknown"}
        h = dict(self.supervisor.health())
        h["ok"] = h.get("state") != "stalled"
        return h

    def _route(self, path: str, accept: str = ""):
        """-> (status, content_type, body_bytes)"""
        if path == "/metrics":
            # content negotiation the way Prometheus does it: the
            # scraper opts into OpenMetrics explicitly; default stays
            # the 0.0.4 text format (exemplar-free)
            om = "application/openmetrics-text" in (accept or "")
            ctype = CONTENT_TYPE_OPENMETRICS if om \
                else CONTENT_TYPE_METRICS
            return (200, ctype,
                    self._metrics_text(openmetrics=om).encode("utf-8"))
        if path == "/debug/slo":
            slo = self.slo
            if slo is None:
                return (404, "application/json",
                        b'{"error": "no slo engine attached"}')
            doc = slo.status()
            # host/device attribution rides along: a burning SLO plus
            # `bound: host` names the fix (ingress path), not just the
            # symptom
            sup = self.supervisor
            if sup is not None and hasattr(sup, "phase_attribution"):
                doc["attribution"] = sup.phase_attribution()
            return (200, "application/json",
                    json.dumps(doc,
                               default=_jsonable).encode("utf-8"))
        if path == "/debug/capacity":
            cap = self.capacity
            if cap is None:
                return (404, "application/json",
                        b'{"error": "no capacity model attached"}')
            return (200, "application/json",
                    json.dumps(cap.status(),
                               default=_jsonable).encode("utf-8"))
        if path == "/debug/device":
            # live device-memory stats: leak-shaped growth is visible
            # without attaching a profiler
            try:
                devices = [device_memory(d) for d in self._devices()]
                return (200, "application/json",
                        json.dumps({"devices": devices},
                                   default=_jsonable).encode("utf-8"))
            except Exception as exc:
                return (500, "application/json",
                        json.dumps({"error": repr(exc)})
                        .encode("utf-8"))
        if path == "/healthz":
            h = self._health()
            code = 200 if h.get("ok") else 503
            return (code, "application/json",
                    json.dumps(h, default=_jsonable).encode("utf-8"))
        if path.startswith("/debug/streams/"):
            flight = self.flight
            sid_s = path[len("/debug/streams/"):]
            if flight is None or not sid_s.lstrip("-").isdigit():
                return (404, "application/json", b'{"error": "no such '
                        b'stream or no flight recorder"}')
            body = json.dumps(flight.dump(int(sid_s)),
                              default=_jsonable)
            return (200, "application/json", body.encode("utf-8"))
        if path == "/debug/streams":
            flight = self.flight
            streams = flight.streams() if flight is not None else []
            return (200, "application/json",
                    json.dumps({"streams": streams}).encode("utf-8"))
        if path == "/debug/postmortems":
            pms = list(getattr(self.supervisor, "postmortems", ()))
            return (200, "application/json",
                    json.dumps(pms, default=_jsonable).encode("utf-8"))
        if path == "/debug/fleet":
            # own registry renders in-process (no self-scrape over
            # HTTP); peers are scraped best-effort — a dead peer shows
            # up under `errors`, it doesn't 500 the fleet view
            scrapes = {self.name: self._metrics_text(openmetrics=True)}
            errors: Dict[str, str] = {}
            for pname, base in sorted(self.peers.items()):
                try:
                    scrapes[pname] = fetch_metrics(base)
                except Exception as exc:
                    errors[pname] = repr(exc)
            doc = stitch_journeys(scrapes)
            doc["self"] = self.name
            doc["peers"] = sorted(self.peers)
            doc["errors"] = errors
            sup = self.supervisor
            if sup is not None and hasattr(sup, "trunk_owd_s"):
                doc["trunk_owd_s"] = float(sup.trunk_owd_s)
            return (200, "application/json",
                    json.dumps(doc, default=_jsonable).encode("utf-8"))
        return (404, "application/json", b'{"error": "not found"}')

    # ----------------------------------------------------------- control
    def start(self) -> "ObservabilityServer":
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                path = self.path.split("?", 1)[0]
                accept = self.headers.get("Accept", "")
                try:
                    status, ctype, body = outer._route(path, accept)
                except Exception as exc:   # render must never kill scrape
                    status, ctype = 500, "application/json"
                    body = json.dumps(
                        {"error": repr(exc)}).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                _log.debug("http", line=(fmt % args))

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-server", daemon=True)
        self._thread.start()
        _log.info("obs_server_started", host=self.host, port=self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
