"""Observability: timing rings, histograms, scalars and their Prometheus
text exposition.

Counterpart: `libjitsi_tpu/utils/metrics.py`, the part the media loop,
the phase profiler and the pipeline tracer use: `SpanTimer`,
`TimingRing` (a stage's durations, rendered as a summary with p50 and
p99), fixed-bucket `Histogram`s filled with one `np.searchsorted` per
batch, with optional OpenMetrics exemplars (the journey tracer stores
the packet trace id in them), one-label `HistogramVec` families,
callable scalars, and `MetricsRegistry.render`, the Prometheus 0.0.4 text
(or the OpenMetrics text with exemplars and `# EOF`).  Pure NumPy, copied
so the port imports nothing of the JAX package.  Not copied yet: the
per-stream array families, multi-sample families, stream display names
and the exposition parser and validator (ROADMAP Queue 1, item 10,
the operations plane).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def escape_label_value(value: object) -> str:
    """Escape a label value per the Prometheus text format: backslash,
    double quote and newline, so a hostile value cannot break out of the
    label."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(text: str) -> str:
    """# HELP text: escape backslash and newline (quotes are legal)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    return f"{float(value):.6g}"


def _fmt_le(upper: float) -> str:
    if math.isinf(upper):
        return "+Inf"
    f = float(upper)
    return str(int(f)) if f == int(f) else repr(f)


class SpanTimer:
    """Per-entry timer token: holds its own t0, so overlapping and nested
    timers over the same ring never clobber each other."""

    __slots__ = ("_ring", "_t0", "seconds")

    def __init__(self, ring: "TimingRing"):
        self._ring = ring
        self._t0 = time.perf_counter()
        self.seconds: Optional[float] = None

    def stop(self) -> float:
        if self.seconds is None:           # idempotent
            self.seconds = time.perf_counter() - self._t0
            self._ring.record(self.seconds)
        return self.seconds

    def __enter__(self) -> "SpanTimer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class TimingRing:
    """Fixed-size ring of durations (seconds) -> percentiles; rendered as
    a summary (quantiles over the ring, lifetime `_sum`/`_count`)."""

    def __init__(self, size: int = 4096):
        self._buf = np.zeros(size, dtype=np.float64)
        self._n = 0
        self._i = 0
        self.sum = 0.0
        self.count = 0

    def record(self, seconds: float) -> None:
        self._buf[self._i] = seconds
        self._i = (self._i + 1) % len(self._buf)
        self._n = min(self._n + 1, len(self._buf))
        self.sum += seconds
        self.count += 1

    def percentile(self, q: float) -> float:
        if self._n == 0:
            return 0.0
        return float(np.percentile(self._buf[: self._n], q))

    def span(self) -> SpanTimer:
        return SpanTimer(self)


def exponential_buckets(start: float, factor: float, count: int
                        ) -> List[float]:
    """`count` bucket upper bounds from `start`, each `factor` times the
    previous (+Inf is implicit)."""
    return [start * factor ** i for i in range(count)]


class Histogram:
    """Array-backed fixed-bucket histogram (inclusive `le` upper bounds,
    counts kept per bucket and rendered cumulative).  With
    `exemplars=True` each bucket keeps the label set and value of the
    last observation that landed in it."""

    def __init__(self, buckets: Sequence[float], exemplars: bool = False):
        if len(buckets) == 0:
            raise ValueError("histogram needs at least one finite bucket")
        uppers = np.asarray(sorted(float(b) for b in buckets),
                            dtype=np.float64)
        if not np.isfinite(uppers).all():
            raise ValueError("bucket bounds must be finite; +Inf is "
                             "implicit")
        self.uppers = uppers
        self.bucket_counts = np.zeros(len(uppers) + 1, dtype=np.int64)
        self.sum = 0.0
        self.count = 0
        self.exemplars: Optional[
            List[Optional[Tuple[Dict[str, str], float]]]] = (
                [None] * (len(uppers) + 1) if exemplars else None)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> bool:
        return self.observe_same(value, 1, exemplar=exemplar)

    def observe_same(self, value: float, n: int,
                     exemplar: Optional[Dict[str, str]] = None) -> bool:
        """Observe `value` `n` times in O(1); True when it overflowed into
        the +Inf bucket."""
        if n <= 0:
            return False
        v = float(value)
        idx = int(np.searchsorted(self.uppers, v, side="left"))
        self.bucket_counts[idx] += int(n)
        self.sum += v * int(n)
        self.count += int(n)
        if exemplar is not None and self.exemplars is not None:
            self.exemplars[idx] = (dict(exemplar), v)
        return idx >= len(self.uppers)

    def observe_array(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.uppers, v, side="left")
        self.bucket_counts += np.bincount(
            idx, minlength=len(self.bucket_counts))
        self.sum += float(v.sum())
        self.count += int(v.size)

    def cumulative(self) -> np.ndarray:
        """Cumulative counts, one per finite bucket plus +Inf."""
        return np.cumsum(self.bucket_counts)


class HistogramVec:
    """One histogram family over a single label: each label value owns a
    child `Histogram` over the same buckets."""

    def __init__(self, buckets: Sequence[float], label: str,
                 exemplars: bool = False):
        self.buckets = tuple(buckets)
        self.label = label
        self.exemplars = exemplars
        self._children: Dict[str, Histogram] = {}

    def labels(self, value: str) -> Histogram:
        key = str(value)
        if key not in self._children:
            self._children[key] = Histogram(self.buckets,
                                            exemplars=self.exemplars)
        return self._children[key]

    def children(self) -> List[Tuple[str, Histogram]]:
        return sorted(self._children.items())


class MetricsRegistry:
    """Callable scalars, histograms and timing rings under one namespace,
    rendered on demand; a scalar's callable is read at every render, so
    a scrape sees the live value."""

    def __init__(self, namespace: str = "libjitsi_tpu"):
        self.ns = namespace
        self._scalars: Dict[str, Tuple[Callable[[], float], str, str]] = {}
        self._hists: Dict[str, Tuple[Histogram, str]] = {}
        self._hist_vecs: Dict[str, Tuple[HistogramVec, str]] = {}
        self.timings: Dict[str, TimingRing] = {}

    def register_scalar(self, name: str, fn: Callable[[], float],
                        help_: str = "", kind: str = "gauge") -> None:
        self._scalars[name] = (fn, help_, kind)

    def histogram(self, name: str, buckets: Sequence[float],
                  help_: str = "", exemplars: bool = False) -> Histogram:
        """Create-or-get a registered histogram."""
        if name not in self._hists:
            self._hists[name] = (Histogram(buckets, exemplars=exemplars),
                                 help_)
        return self._hists[name][0]

    def histogram_vec(self, name: str, buckets: Sequence[float],
                      label: str, help_: str = "",
                      exemplars: bool = False) -> HistogramVec:
        """Create-or-get a registered one-label histogram family."""
        if name not in self._hist_vecs:
            self._hist_vecs[name] = (
                HistogramVec(buckets, label, exemplars=exemplars), help_)
        return self._hist_vecs[name][0]

    def timing(self, name: str) -> TimingRing:
        if name not in self.timings:
            self.timings[name] = TimingRing()
        return self.timings[name]

    @staticmethod
    def _fmt_exemplar(labels: Dict[str, str], value: float) -> str:
        block = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return f" # {{{block}}} {_fmt(value)}"

    def _hist_lines(self, full: str, hist: Histogram, pre: str,
                    tail: str, openmetrics: bool) -> List[str]:
        out = []
        cum = hist.cumulative()
        ex = hist.exemplars if openmetrics else None
        for i, (upper, c) in enumerate(zip(hist.uppers, cum[:-1])):
            line = f'{full}_bucket{{{pre}le="{_fmt_le(upper)}"}} {int(c)}'
            if ex is not None and ex[i] is not None:
                line += self._fmt_exemplar(*ex[i])
            out.append(line)
        line = f'{full}_bucket{{{pre}le="+Inf"}} {hist.count}'
        if ex is not None and ex[-1] is not None:
            line += self._fmt_exemplar(*ex[-1])
        out.append(line)
        out.append(f"{full}_sum{tail} {_fmt(hist.sum)}")
        out.append(f"{full}_count{tail} {hist.count}")
        return out

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text format; `openmetrics=True` adds the histograms'
        exemplars and the closing `# EOF`."""
        out: List[str] = []

        def head(full, help_, kind):
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} {kind}")

        for name, (fn, help_, kind) in self._scalars.items():
            full = f"{self.ns}_{name}"
            head(full, help_, kind)
            out.append(f"{full} {fn()}")
        for name, (hist, help_) in self._hists.items():
            full = f"{self.ns}_{name}"
            head(full, help_, "histogram")
            out += self._hist_lines(full, hist, "", "", openmetrics)
        for name, (vec, help_) in self._hist_vecs.items():
            full = f"{self.ns}_{name}"
            head(full, help_, "histogram")
            for lv, hist in vec.children():
                lbl = f'{vec.label}="{escape_label_value(lv)}"'
                out += self._hist_lines(full, hist, lbl + ",", f"{{{lbl}}}",
                                        openmetrics)
        for name, ring in self.timings.items():
            full = f"{self.ns}_{name}_seconds"
            out.append(f"# TYPE {full} summary")
            for q, label in ((50, "0.5"), (99, "0.99")):
                out.append(f'{full}{{quantile="{label}"}} '
                           f"{_fmt(ring.percentile(q))}")
            out.append(f"{full}_sum {_fmt(ring.sum)}")
            out.append(f"{full}_count {ring.count}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"
