"""Pipeline stage tracing: nested timed spans per tick stage.

Counterpart: `libjitsi_tpu/utils/tracing.py` `PipelineTracer`.  Each
stage of a tick (ingress, reverse chain, recovery, decode, mixer,
forward chain, egress) runs in a span that feeds three sinks:

  1. a per-stage `TimingRing` in the `MetricsRegistry`
     (`stage_<name>_seconds{quantile=...}` on a scrape);
  2. a budget ledger (stage -> seconds) that `take_ledger()` drains;
  3. a `torch.profiler.record_function` range named after the stage, so
     a profiler trace of a tick shows the stages on the host timeline
     beside the kernels on the card.  (The JAX tracer emits
     `jax.profiler.TraceAnnotation`s named `<prefix>:<stage>`; the port
     keeps the bare stage names its profiles have always keyed on.)

The JAX tracer's `prefix` and `annotate` options have no reader in the
port and are not kept.  Its phase ledger is: the `PhaseProfiler` merges
each sampled tick's split into it (`merge_phases`) and the supervisor
drains it with `take_phase_ledger()` beside the stage ledger, so an
escalation names both the dominant stage and the dominant phase.

Spans are `SpanTimer` tokens, each with its own t0, so nested and
overlapping spans (a pipelined dispatch) record correctly; the ledger is
per-stage inclusive time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from torch.profiler import record_function

from libjitsi_tpu_torch.utils.metrics import MetricsRegistry, SpanTimer


class _StageSpan:
    """Context manager for one stage entry; an independent token per
    entry, safe to nest and overlap."""

    __slots__ = ("_tracer", "stage", "_timer", "_ann")

    def __init__(self, tracer: "PipelineTracer", stage: str):
        self._tracer = tracer
        self.stage = stage
        self._timer: Optional[SpanTimer] = None
        self._ann = record_function(stage)

    def __enter__(self) -> "_StageSpan":
        self._ann.__enter__()
        self._timer = self._tracer.metrics.timing(
            f"stage_{self.stage}").span()
        return self

    def __exit__(self, *exc) -> None:
        seconds = self._timer.stop()
        self._ann.__exit__(*exc)
        led = self._tracer._ledger
        led[self.stage] = led.get(self.stage, 0.0) + seconds


class PipelineTracer:
    """Per-stage span timing and budget ledger; share one across the
    pieces of a pipeline (loop, SFU) so their stages land in the same
    ledger."""

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics
        self._ledger: Dict[str, float] = {}
        self.last_ledger: Dict[str, float] = {}
        # host/device phase ledger (utils/perf.PhaseProfiler), kept apart
        # from the stage ledger so phases never outrank stages in the
        # supervisor's rung choice, but drained on the same cadence
        self._phase_ledger: Dict[str, float] = {}
        self.last_phase_ledger: Dict[str, float] = {}

    def span(self, stage: str) -> _StageSpan:
        return _StageSpan(self, stage)

    def merge_phases(self, phases: Dict[str, float]) -> None:
        """Add a sampled tick's phase split (phase -> seconds) to the
        phase ledger."""
        led = self._phase_ledger
        for phase, seconds in phases.items():
            led[phase] = led.get(phase, 0.0) + float(seconds)

    def take_phase_ledger(self) -> Dict[str, float]:
        """Drain and return the phase ledger (kept as
        `last_phase_ledger` when it was not empty)."""
        led, self._phase_ledger = self._phase_ledger, {}
        if led:
            self.last_phase_ledger = led
        return led

    def ledger(self) -> Dict[str, float]:
        """The stage ledger accumulated so far, not drained."""
        return dict(self._ledger)

    def take_ledger(self) -> Dict[str, float]:
        """Drain and return the stage -> seconds ledger (also kept as
        `last_ledger`)."""
        led, self._ledger = self._ledger, {}
        self.last_ledger = led
        return led

    @staticmethod
    def dominant(ledger: Dict[str, float]
                 ) -> Tuple[Optional[str], float]:
        """(stage, seconds) of the ledger's costliest entry."""
        if not ledger:
            return None, 0.0
        stage = max(ledger, key=ledger.get)
        return stage, ledger[stage]
