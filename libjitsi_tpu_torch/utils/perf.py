"""Host/device phase attribution for the media-loop tick.

Counterpart: `libjitsi_tpu/utils/perf.py` `PhaseProfiler`.  It splits a
tick's wall time into six phases:

  idle            socket wait inside the recv batching window
  host_python     everything else the host does (the residual)
  dispatch        a kernel wrapper's call until the launch returns
  h2d_transfer    staging batch arrays host -> device (fenced probe)
  device_compute  a fenced wait on dispatched device work
  d2h_transfer    materializing device results back to host memory

Fencing serializes the pipeline, so it is sampled: every
`sample_every`-th tick pays the probes (their cost is accounted in
`probe_overhead_s`); other ticks run fence-free and only bump the byte
counters.  On a sampled tick the phases sum to the tick's wall time,
`host_python` being the residual.

The fences are CUDA events on the device's current stream, the stream
every kernel wrapper launches on: `fence` records one after the work
dispatched so far and waits for it (and for the pending's own event,
`block_until_ready`), `probe_h2d` copies the arrays to the card and
waits on an event recorded after the copies.  On the CPU the same calls
are plain host timings of the copies and of `block_until_ready`.

Results feed a `tick_phase_seconds{phase=...}` histogram family,
`last_phases` / `phase_totals`, and the `PipelineTracer`'s phase ledger
(`tracer=`; drained by the supervisor, so an escalation says host-bound
or device-bound).  `classify_bound` and `host_share` read one split.
The compile counters of `utils/compile_cache.py` ride on the same
registry (`compile_cache_hits` / `_misses`: the kernel library reused or
built; `compile_events`: first launches of kernel instances, a step
mid-run means one landed on the data path).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from libjitsi_tpu_torch.utils.compile_cache import compile_stats
from libjitsi_tpu_torch.utils.metrics import (MetricsRegistry,
                                              exponential_buckets)

#: the phase taxonomy; `host_python` is the residual, so the six sum to
#: a sampled tick's wall time
PHASES = ("host_python", "dispatch", "h2d_transfer", "device_compute",
          "d2h_transfer", "idle")

#: phases owned by the host interpreter vs the device pipeline (the
#: supervisor's host-bound vs device-bound classification)
HOST_PHASES = ("host_python", "dispatch")
DEVICE_PHASES = ("h2d_transfer", "device_compute", "d2h_transfer")

#: 10 µs .. ~2.6 s per phase per tick
PHASE_BUCKETS = tuple(exponential_buckets(1e-5, 4.0, 10))


def classify_bound(phases: Dict[str, float]) -> str:
    """"host" / "device" / "idle" / "unknown" for one phase split."""
    if not phases:
        return "unknown"
    host = sum(phases.get(p, 0.0) for p in HOST_PHASES)
    device = sum(phases.get(p, 0.0) for p in DEVICE_PHASES)
    idle = phases.get("idle", 0.0)
    total = host + device + idle
    if total <= 0.0:
        return "unknown"
    return max((("host", host), ("device", device), ("idle", idle)),
               key=lambda kv: kv[1])[0]


def host_share(phases: Dict[str, float]) -> float:
    """Fraction of the non-idle tick owned by the host (host_python +
    dispatch over everything but idle)."""
    host = sum(phases.get(p, 0.0) for p in HOST_PHASES)
    busy = host + sum(phases.get(p, 0.0) for p in DEVICE_PHASES)
    return host / busy if busy > 0.0 else 0.0


class _PhaseSpan:
    """Times one phase region into the profiler's current tick."""

    __slots__ = ("_prof", "_phase", "_t0")

    def __init__(self, prof: "PhaseProfiler", phase: str):
        self._prof = prof
        self._phase = phase
        self._t0 = 0.0

    def __enter__(self) -> "_PhaseSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.add_phase(self._phase, time.perf_counter() - self._t0)


class _NullSpan:
    """Fence-free tick: a phase region costs one attribute lookup."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class PhaseProfiler:
    """Per-tick host/device phase splitter (see the module docstring).

    `begin_tick()` / `end_tick()` bracket a tick; `phase(name)` marks a
    region; `probe_h2d(arrays)` and `fence(pending)` are the fenced
    probes of sampled ticks; `note_h2d` / `note_d2h` count transfer bytes
    every tick.  `device` is where the probes fence (None: the CPU);
    `sample_every=0` disables fencing (byte counters stay live);
    `tracer` receives each sampled split (`merge_phases`)."""

    def __init__(self, metrics: MetricsRegistry, sample_every: int = 16,
                 inflight_fn: Optional[Callable[[], int]] = None,
                 device: Optional[torch.device] = None, tracer=None):
        self.metrics = metrics
        self.tracer = tracer
        self.stats = compile_stats()
        self.sample_every = int(sample_every)
        self.device = torch.device("cpu") if device is None else device
        self.sampled = False
        self.ticks_seen = 0
        self.sampled_ticks = 0
        self.probe_overhead_s = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.last_phases: Dict[str, float] = {}
        self.phase_totals: Dict[str, float] = {}
        self._phases: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self.phase_hist = metrics.histogram_vec(
            "tick_phase_seconds", PHASE_BUCKETS, "phase",
            help_="sampled per-tick wall time split by host/device phase")
        for p in PHASES:
            self.phase_hist.labels(p)
        self.register_metrics(metrics, inflight_fn=inflight_fn)

    # -------------------------------------------------------- registry
    def register_metrics(self, metrics: MetricsRegistry,
                         inflight_fn: Optional[Callable[[], int]] = None
                         ) -> None:
        metrics.register_scalar(
            "phase_sampled_ticks", lambda: self.sampled_ticks,
            help_="ticks that paid the fencing probes", kind="counter")
        metrics.register_scalar(
            "phase_probe_overhead_seconds", lambda: self.probe_overhead_s,
            help_="total wall time spent inside fencing probes",
            kind="counter")
        metrics.register_scalar(
            "h2d_bytes_total", lambda: self.h2d_bytes,
            help_="bytes staged host->device at the loop's staging points",
            kind="counter")
        metrics.register_scalar(
            "d2h_bytes_total", lambda: self.d2h_bytes,
            help_="bytes materialized device->host at the loop's egress "
                  "points", kind="counter")
        metrics.register_scalar(
            "compile_cache_hits", lambda: self.stats.hits,
            help_="kernel-library builds found already built",
            kind="counter")
        metrics.register_scalar(
            "compile_cache_misses", lambda: self.stats.misses,
            help_="kernel-library builds compiled by nvcc",
            kind="counter")
        metrics.register_scalar(
            "compile_events", lambda: self.stats.compile_events,
            help_="first launches of kernel instances (a step here mid-run "
                  "means one landed on the data path)", kind="counter")
        metrics.register_scalar(
            "compile_seconds_total", lambda: self.stats.compile_seconds,
            help_="total seconds spent building the kernel library",
            kind="counter")
        metrics.register_scalar(
            "dispatch_inflight_ticks",
            inflight_fn if inflight_fn is not None else (lambda: 0),
            help_="age in ticks of the oldest un-flushed async dispatch "
                  "(pipelined loop depth)")
        metrics.register_scalar(
            "device_live_bytes", self._device_live_bytes,
            help_="bytes the caching allocator holds in live tensors on "
                  "the device (0 on the CPU)")

    def _device_live_bytes(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return float(torch.cuda.memory_allocated(self.device))

    # ------------------------------------------------------ tick hooks
    def begin_tick(self) -> None:
        self.ticks_seen += 1
        self.sampled = (self.sample_every > 0 and
                        (self.ticks_seen - 1) % self.sample_every == 0)
        self._phases = {}
        self._t0 = time.perf_counter()

    def phase(self, name: str):
        """Context manager attributing the region to `name` on sampled
        ticks; a shared no-op otherwise."""
        if not self.sampled:
            return _NULL_SPAN
        return _PhaseSpan(self, name)

    def add_phase(self, name: str, seconds: float) -> None:
        self._phases[name] = self._phases.get(name, 0.0) + float(seconds)

    def _event_fence(self) -> None:
        """Wait on a CUDA event recorded after everything dispatched so
        far on the device's current stream (nothing on the CPU)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()

    def probe_h2d(self, arrays: Iterable) -> None:
        """Fenced host->device staging probe: copies `arrays` to the
        device and waits for the copies, as `h2d_transfer` (its cost is
        also `probe_overhead_s`)."""
        if not self.sampled:
            return
        t0 = time.perf_counter()
        staged = [torch.as_tensor(np.ascontiguousarray(a)).to(
            self.device, copy=True) for a in arrays if a is not None]
        self._event_fence()
        del staged
        dt = time.perf_counter() - t0
        self.add_phase("h2d_transfer", dt)
        self.probe_overhead_s += dt

    def fence(self, pending, phase: str = "device_compute") -> None:
        """Wait for a dispatched result's device work, as `phase` (the
        launch itself was `dispatch`)."""
        if not self.sampled:
            return
        t0 = time.perf_counter()
        self._event_fence()
        block = getattr(pending, "block_until_ready", None)
        if block is not None:
            block()
        dt = time.perf_counter() - t0
        self.add_phase(phase, dt)
        self.probe_overhead_s += dt

    def note_h2d(self, nbytes: int) -> None:
        self.h2d_bytes += int(nbytes)

    def note_d2h(self, nbytes: int) -> None:
        self.d2h_bytes += int(nbytes)

    def end_tick(self) -> None:
        if self._t0 is None:
            return
        wall = time.perf_counter() - self._t0
        self._t0 = None
        if not self.sampled:
            return
        self.sampled = False
        measured = sum(self._phases.values())
        self.add_phase("host_python", max(0.0, wall - measured))
        for p in PHASES:
            self._phases.setdefault(p, 0.0)
        self.last_phases = dict(self._phases)
        for p, secs in self._phases.items():
            self.phase_totals[p] = self.phase_totals.get(p, 0.0) + secs
        self.sampled_ticks += 1
        for p in PHASES:
            self.phase_hist.labels(p).observe(self._phases[p])
        if self.tracer is not None:
            self.tracer.merge_phases(self._phases)
