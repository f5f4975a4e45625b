"""Host utilities: array-state checkpointing, metrics, pipeline tracing,
phase profiling, the flight recorder, logging, and the operations
plane's health, fault-injection, SLO, capacity, compile-counter and
profiling helpers."""

from libjitsi_tpu_torch.utils.metrics import (  # noqa: F401
    Histogram, MetricsRegistry, TimingRing, exponential_buckets,
    validate_exposition)
from libjitsi_tpu_torch.utils.tracing import PipelineTracer  # noqa: F401
from libjitsi_tpu_torch.utils.flight import FlightRecorder  # noqa: F401
from libjitsi_tpu_torch.utils.faults import (  # noqa: F401
    FaultInjectionEngine, GilbertElliott)
from libjitsi_tpu_torch.utils.health import (  # noqa: F401
    ExponentialBackoff, SlidingWindowCounter, Watchdog, retrying)
