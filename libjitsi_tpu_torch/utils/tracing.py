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

The JAX tracer's `prefix` and `annotate` options, its phase ledger and
its `last_ledger` have no reader in the port and are not kept.

Spans are `SpanTimer` tokens, each with its own t0, so nested and
overlapping spans (a pipelined dispatch) record correctly; the ledger is
per-stage inclusive time.
"""

from __future__ import annotations

from typing import Dict, Optional

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

    def span(self, stage: str) -> _StageSpan:
        return _StageSpan(self, stage)

    def take_ledger(self) -> Dict[str, float]:
        """Drain and return the stage -> seconds ledger."""
        led, self._ledger = self._ledger, {}
        return led
