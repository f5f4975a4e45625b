"""Observability: timing rings, histograms, per-stream arrays, scalars
and their Prometheus text exposition, with its parser and validator.

Counterpart: `libjitsi_tpu/utils/metrics.py`, the whole registry, copied
so the port imports nothing of the JAX package; pure NumPy.  Metrics
stay dense arrays across streams and render on demand:

- `MetricsRegistry.register_array` exposes a whole per-stream array (an
  ndarray, or a zero-arg callable re-read at every render, so a restore
  that rebinds the array keeps the scrape live), one sample a row
  labelled `by`; `render(active=...)` masks the rows, and
  `set_stream_name` adds a `name` label, escaped at render (stream names
  are hostile input).
- `register_scalar`, `register_counters` (plain int attributes),
  `register_multi` (a family of labelled samples), `register_histogram`
  and the create-or-get `histogram` / `histogram_vec`; fixed-bucket
  `Histogram`s fill with one `np.searchsorted` a batch and may keep
  OpenMetrics exemplars (the journey tracer stores the packet trace id
  in them); `TimingRing`s render as summaries with p50 and p99.
- `render(openmetrics=True)` adds the exemplars and the closing `# EOF`.
- `parse_exposition(_full)`, `validate_exposition` (every family typed
  once, histogram buckets cumulative with `le="+Inf"` equal to
  `_count`, summaries with numeric quantiles, exemplar syntax on an
  OpenMetrics scrape), `count_exemplars` and `process_families_text`
  (the standard process families a metrics server appends).
"""

from __future__ import annotations

import math
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

ArraySource = Union[np.ndarray, Callable[[], np.ndarray]]
#: zero-arg callable yielding (labels, value) rows for one family —
#: the shape of `register_multi` sources (e.g. burn-rate gauges keyed
#: by slo + window)
MultiSource = Callable[[], Iterable[Tuple[Dict[str, str], float]]]

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

#: OpenMetrics spec: the combined length of an exemplar's label names
#: and values MUST NOT exceed 128 UTF-8 characters
EXEMPLAR_RUNES_MAX = 128


def escape_label_value(value: object) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped so a hostile
    SDES stream name cannot break out of the label and corrupt (or
    forge) the rest of the scrape."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(text: str) -> str:
    """# HELP text: escape backslash and newline (quotes are legal)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Float sample value without exponent noise ('0.001', not '1e-03'
    for bucket bounds; samples keep %g compactness)."""
    return f"{float(value):.6g}"


def _fmt_le(upper: float) -> str:
    if math.isinf(upper):
        return "+Inf"
    f = float(upper)
    return str(int(f)) if f == int(f) else repr(f)


class SpanTimer:
    """Per-entry timer token: holds its own t0, so overlapping and
    nested timers over the same ring never clobber each other (the
    reentrancy bug of storing t0 on the shared ring)."""

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
    """Fixed-size ring of durations (seconds) -> percentiles.

    Rendered as a Prometheus `summary`: quantile samples from the ring
    window plus lifetime `_sum`/`_count`.  As a context manager it
    keeps a LIFO stack of start times, so `with ring:` nests correctly;
    `span()` hands out an independent `SpanTimer` token for overlapping
    (non-LIFO) measurement."""

    def __init__(self, size: int = 4096):
        self._buf = np.zeros(size, dtype=np.float64)
        self._n = 0
        self._i = 0
        self._stack: List[SpanTimer] = []
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

    def __enter__(self) -> "TimingRing":
        self._stack.append(SpanTimer(self))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.pop().stop()


def exponential_buckets(start: float, factor: float, count: int
                        ) -> List[float]:
    """`count` bucket upper bounds starting at `start`, each `factor`
    times the previous (the +Inf bucket is implicit)."""
    return [start * factor ** i for i in range(count)]


class Histogram:
    """Array-backed fixed-bucket histogram with vectorized fill.

    `observe_array` buckets a whole dense array with one
    `np.searchsorted` + `np.bincount` — the idiom for per-batch packet
    sizes / per-stream jitter where a Python loop per sample would eat
    the tick budget.  Bucket upper bounds are inclusive (`le`
    semantics); counts are kept per-bucket and rendered cumulative.

    With `exemplars=True` the histogram keeps one exemplar slot per
    bucket (+Inf included): `observe(value, exemplar={...})` stores
    the label set alongside the observed value, and the registry
    renders it after the matching `_bucket` line on OpenMetrics
    scrapes only."""

    def __init__(self, buckets: Sequence[float], exemplars: bool = False):
        if len(buckets) == 0:
            raise ValueError("histogram needs at least one finite bucket")
        uppers = np.asarray(sorted(float(b) for b in buckets),
                            dtype=np.float64)
        if not np.isfinite(uppers).all():
            raise ValueError("bucket bounds must be finite; +Inf is "
                             "implicit")
        self.uppers = uppers
        # one slot per finite bucket + the +Inf overflow slot
        self.bucket_counts = np.zeros(len(uppers) + 1, dtype=np.int64)
        self.sum = 0.0
        self.count = 0
        # last-exemplar-wins per bucket slot: (labels, observed value)
        self.exemplars: Optional[
            List[Optional[Tuple[Dict[str, str], float]]]] = (
                [None] * (len(uppers) + 1) if exemplars else None)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> bool:
        return self.observe_same(value, 1, exemplar=exemplar)

    def observe_same(self, value: float, n: int,
                     exemplar: Optional[Dict[str, str]] = None) -> bool:
        """Observe `value` `n` times (one egress batch = n packets with
        one shared journey latency) in O(1); returns True when the
        value overflowed into the top (+Inf) bucket — the signal the
        adaptive flight sampler keys tail bias from."""
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
        # first bucket whose (inclusive) upper bound >= value
        idx = np.searchsorted(self.uppers, v, side="left")
        self.bucket_counts += np.bincount(
            idx, minlength=len(self.bucket_counts))
        self.sum += float(v.sum())
        self.count += int(v.size)

    def cumulative(self) -> np.ndarray:
        """Cumulative counts, one per finite bucket plus +Inf (last
        element always equals `count`)."""
        return np.cumsum(self.bucket_counts)


class HistogramVec:
    """One histogram family fanned out over a single label (e.g.
    `tick_phase_seconds{phase=...}`): each label value owns a child
    `Histogram` over the same buckets, rendered under ONE `# TYPE`
    line with the label on every `_bucket`/`_sum`/`_count` sample.

    Children are created on first `labels(value)` call (or eagerly by
    the caller, so a scrape never sees an empty family)."""

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

    @property
    def count(self) -> int:
        return sum(h.count for h in self._children.values())


class MetricsRegistry:
    """Array-backed gauges/counters with Prometheus text rendering.

    register_array("rtp_rx_packets", stats.rx_packets, by="stream")
    exposes a whole per-stream array; a zero-arg callable source
    (``lambda: self.table.rx_packets``) re-resolves on every render, so
    a checkpoint restore that rebinds the array never leaves the
    exporter reporting pre-restore values.  Scalar callables work for
    totals; `histogram()` / `register_histogram()` expose `Histogram`s;
    timing rings render as summaries."""

    def __init__(self, namespace: str = "libjitsi_tpu"):
        self.ns = namespace
        self._arrays: Dict[str, Tuple[ArraySource, str, str, str]] = {}
        self._scalars: Dict[str, Tuple[Callable[[], float], str, str]] = {}
        self._hists: Dict[str, Tuple[Histogram, str]] = {}
        self._hist_vecs: Dict[str, Tuple[HistogramVec, str]] = {}
        self._multi: Dict[str, Tuple[MultiSource, str, str]] = {}
        self.timings: Dict[str, TimingRing] = {}
        # per-row display names for `by="stream"` arrays (SDES CNAMEs);
        # values are hostile input and are escaped at render time
        self.stream_names: Dict[int, str] = {}

    def register_array(self, name: str, arr: ArraySource,
                       by: str = "stream", help_: str = "",
                       kind: str = "gauge") -> None:
        """`arr` is an ndarray or a zero-arg callable returning one
        (callables survive checkpoint-restore rebinds).  `kind` is the
        Prometheus metric type for the # TYPE line — "gauge" (default)
        or "counter" for monotonic totals."""
        self._arrays[name] = (arr, by, help_, kind)

    def register_scalar(self, name: str, fn: Callable[[], float],
                        help_: str = "", kind: str = "gauge") -> None:
        self._scalars[name] = (fn, help_, kind)

    def register_counters(self, obj, names, prefix: str = "",
                          kind: str = "counter") -> None:
        """Register monotonic int attributes of `obj` as counters.

        `names` is an iterable of attribute names, or of
        (attribute, help) pairs.  Each becomes a scalar
        `{prefix}_{attr}` reading the attribute live — the idiom for
        the recovery ladder's Python-side counters (`nacks_sent`,
        `rtx_cache_miss`, ...), which are plain ints rather than the
        data path's dense arrays.
        """
        for entry in names:
            if isinstance(entry, str):
                attr, help_ = entry, ""
            else:
                attr, help_ = entry
            name = f"{prefix}_{attr}" if prefix else attr
            self.register_scalar(
                name, (lambda o=obj, a=attr: getattr(o, a)),
                help_=help_, kind=kind)

    def register_multi(self, name: str, fn: MultiSource,
                       help_: str = "", kind: str = "gauge") -> None:
        """One family, many labeled samples: `fn` returns (labels,
        value) rows resolved at render time — the shape of the SLO
        engine's `slo_burn_rate{slo=...,window=...}` gauges."""
        self._multi[name] = (fn, help_, kind)

    def register_histogram(self, name: str, hist: Histogram,
                           help_: str = "") -> None:
        self._hists[name] = (hist, help_)

    def histogram(self, name: str, buckets: Sequence[float],
                  help_: str = "", exemplars: bool = False) -> Histogram:
        """Create-or-get a registered histogram (factory form: the
        returned object is already exported, so there is no
        observed-but-never-registered drift window)."""
        if name not in self._hists:
            self._hists[name] = (Histogram(buckets, exemplars=exemplars),
                                 help_)
        return self._hists[name][0]

    def histogram_vec(self, name: str, buckets: Sequence[float],
                      label: str, help_: str = "",
                      exemplars: bool = False) -> HistogramVec:
        """Create-or-get a labeled histogram family (one label axis,
        e.g. `tick_phase_seconds{phase=...}`).  Same factory contract
        as `histogram()`: the returned vec is already exported."""
        if name not in self._hist_vecs:
            self._hist_vecs[name] = (
                HistogramVec(buckets, label, exemplars=exemplars), help_)
        return self._hist_vecs[name][0]

    def get_histogram(self, name: str) -> Optional[Histogram]:
        entry = self._hists.get(name)
        return entry[0] if entry is not None else None

    def get_histogram_vec(self, name: str) -> Optional[HistogramVec]:
        entry = self._hist_vecs.get(name)
        return entry[0] if entry is not None else None

    def sample_total(self, name: str) -> float:
        """Current scalar total of a registered family, whatever its
        shape: scalars read live, per-stream arrays sum across rows,
        histograms report their observation count."""
        if name in self._scalars:
            return float(self._scalars[name][0]())
        if name in self._hists:
            return float(self._hists[name][0].count)
        if name in self._hist_vecs:
            return float(self._hist_vecs[name][0].count)
        if name in self._arrays:
            src = self._arrays[name][0]
            arr = src() if callable(src) else src
            return float(np.asarray(arr).sum())
        raise KeyError(f"no registered metric family `{name}`")

    def has_metric(self, name: str) -> bool:
        return (name in self._scalars or name in self._hists
                or name in self._hist_vecs or name in self._arrays
                or name in self._multi)

    def families(self) -> List[Tuple[str, str]]:
        """(full_name, kind) of every registered family, sorted."""
        fams: List[Tuple[str, str]] = []
        for name, (_src, _by, _help, kind) in self._arrays.items():
            fams.append((f"{self.ns}_{name}", kind))
        for name, (_fn, _help, kind) in self._scalars.items():
            fams.append((f"{self.ns}_{name}", kind))
        for name in self._hists:
            fams.append((f"{self.ns}_{name}", "histogram"))
        for name in self._hist_vecs:
            fams.append((f"{self.ns}_{name}", "histogram"))
        for name, (_fn, _help, kind) in self._multi.items():
            fams.append((f"{self.ns}_{name}", kind))
        for name in self.timings:
            fams.append((f"{self.ns}_{name}_seconds", "summary"))
        return sorted(fams)

    def set_stream_name(self, sid: int, name: Optional[str]) -> None:
        """Attach a display name (e.g. SDES CNAME) to a stream row;
        None clears.  Escaped on render — hostile names are expected."""
        if name is None:
            self.stream_names.pop(int(sid), None)
        else:
            self.stream_names[int(sid)] = str(name)

    def timing(self, name: str) -> TimingRing:
        if name not in self.timings:
            self.timings[name] = TimingRing()
        return self.timings[name]

    @staticmethod
    def _fmt_exemplar(labels: Dict[str, str], value: float) -> str:
        """OpenMetrics exemplar suffix: ` # {labels} value`."""
        block = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return f" # {{{block}}} {_fmt(value)}"

    def render(self, active: Optional[np.ndarray] = None,
               openmetrics: bool = False) -> str:
        """Prometheus text format.  `active` masks which rows of the
        per-stream arrays are exported (10k idle rows would be noise).
        `openmetrics=True` switches to the OpenMetrics rendering:
        histogram buckets carry their exemplars and the exposition ends
        with the mandatory `# EOF` terminator."""
        out: List[str] = []
        for name, (src, by, help_, kind) in self._arrays.items():
            arr = src() if callable(src) else src
            full = f"{self.ns}_{name}"
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} {kind}")
            rows = np.nonzero(active)[0] if active is not None \
                else range(len(arr))
            for i in rows:
                labels = f'{by}="{int(i)}"'
                sname = self.stream_names.get(int(i)) \
                    if by == "stream" else None
                if sname is not None:
                    labels += f',name="{escape_label_value(sname)}"'
                out.append(f"{full}{{{labels}}} {arr[i]}")
        for name, (fn, help_, kind) in self._scalars.items():
            full = f"{self.ns}_{name}"
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} {kind}")
            out.append(f"{full} {fn()}")
        for name, (fn, help_, kind) in self._multi.items():
            full = f"{self.ns}_{name}"
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} {kind}")
            for labels, value in fn():
                block = ",".join(f'{k}="{escape_label_value(v)}"'
                                 for k, v in labels.items())
                out.append(f"{full}{{{block}}} {_fmt(value)}")
        for name, (hist, help_) in self._hists.items():
            full = f"{self.ns}_{name}"
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} histogram")
            cum = hist.cumulative()
            ex = hist.exemplars if (openmetrics and
                                    hist.exemplars is not None) else None
            for i, (upper, c) in enumerate(zip(hist.uppers, cum[:-1])):
                line = (f'{full}_bucket{{le="{_fmt_le(upper)}"}} '
                        f"{int(c)}")
                if ex is not None and ex[i] is not None:
                    line += self._fmt_exemplar(*ex[i])
                out.append(line)
            line = f'{full}_bucket{{le="+Inf"}} {hist.count}'
            if ex is not None and ex[-1] is not None:
                line += self._fmt_exemplar(*ex[-1])
            out.append(line)
            out.append(f"{full}_sum {_fmt(hist.sum)}")
            out.append(f"{full}_count {hist.count}")
        for name, (vec, help_) in self._hist_vecs.items():
            full = f"{self.ns}_{name}"
            if help_:
                out.append(f"# HELP {full} {escape_help(help_)}")
            out.append(f"# TYPE {full} histogram")
            for lv, hist in vec.children():
                pre = f'{vec.label}="{escape_label_value(lv)}",'
                cum = hist.cumulative()
                ex = hist.exemplars if (openmetrics and
                                        hist.exemplars is not None) \
                    else None
                for i, (upper, c) in enumerate(zip(hist.uppers,
                                                   cum[:-1])):
                    line = (f'{full}_bucket{{{pre}le='
                            f'"{_fmt_le(upper)}"}} {int(c)}')
                    if ex is not None and ex[i] is not None:
                        line += self._fmt_exemplar(*ex[i])
                    out.append(line)
                line = (f'{full}_bucket{{{pre}le="+Inf"}} '
                        f"{hist.count}")
                if ex is not None and ex[-1] is not None:
                    line += self._fmt_exemplar(*ex[-1])
                out.append(line)
                lbl = f'{vec.label}="{escape_label_value(lv)}"'
                out.append(f"{full}_sum{{{lbl}}} {_fmt(hist.sum)}")
                out.append(f"{full}_count{{{lbl}}} {hist.count}")
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


# ------------------------------------------------- exposition validation

_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_labels(block: str) -> Optional[Dict[str, str]]:
    """Parse `a="b",c="d"` honoring \\\\ \\n \\" escapes; None on a
    malformed block."""
    labels: Dict[str, str] = {}
    i, n = 0, len(block)
    while i < n:
        j = block.find("=", i)
        if j < 0:
            return None
        key = block[i:j].strip()
        if not key or block[j + 1: j + 2] != '"':
            return None
        i = j + 2
        val: List[str] = []
        while i < n:
            ch = block[i]
            if ch == "\\":
                if i + 1 >= n:
                    return None
                esc = block[i + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(esc))
                if val[-1] is None:
                    return None
                i += 2
            elif ch == '"':
                break
            elif ch == "\n":
                return None
            else:
                val.append(ch)
                i += 1
        if i >= n or block[i] != '"':
            return None
        labels[key] = "".join(val)
        i += 1
        if i < n and block[i] == ",":
            i += 1
    return labels


def _split_exemplar(line: str) -> Tuple[str, Optional[str]]:
    """Split a sample line at the exemplar separator `#`, quote-aware:
    a `#` inside a quoted label value (hostile stream names) is data,
    not a separator.  Returns (sample_part, exemplar_part_or_None)."""
    in_quote = False
    i, n = 0, len(line)
    while i < n:
        ch = line[i]
        if ch == "\\" and in_quote:
            i += 2
            continue
        if ch == '"':
            in_quote = not in_quote
        elif ch == "#" and not in_quote:
            return line[:i].rstrip(), line[i + 1:].strip()
        i += 1
    return line, None


def parse_exposition_full(text: str) -> Tuple[
        Dict[str, str], List[Tuple[str, Dict[str, str], float]],
        List[Tuple[int, str, str]], List[str]]:
    """Parse Prometheus/OpenMetrics text -> (types, samples, exemplars,
    errors).  types maps family name -> metric type; samples are
    (sample_name, labels, value); exemplars are (lineno, sample_name,
    raw exemplar text after `#`) — validated by
    `validate_exposition(openmetrics=True)`."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    exemplars: List[Tuple[int, str, str]] = []
    errors: List[str] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                errors.append(f"line {lineno}: malformed TYPE line")
                continue
            fam, mtype = parts[2], parts[3].strip()
            if mtype not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                errors.append(f"line {lineno}: unknown type "
                              f"`{mtype}` for {fam}")
            if fam in types:
                errors.append(f"line {lineno}: duplicate TYPE for {fam}")
            types[fam] = mtype
            continue
        if line.startswith("#"):
            continue                        # HELP / EOF / comments
        # sample: name{labels} value [# {exemplar-labels} value [ts]]
        sample_part, exemplar_part = _split_exemplar(line)
        name, labels, rest = sample_part, {}, ""
        brace = sample_part.find("{")
        if brace >= 0:
            close = sample_part.rfind("}")
            if close < brace:
                errors.append(f"line {lineno}: unbalanced braces")
                continue
            name = sample_part[:brace]
            parsed = _parse_labels(sample_part[brace + 1: close])
            if parsed is None:
                errors.append(f"line {lineno}: malformed labels in "
                              f"`{line}`")
                continue
            labels = parsed
            rest = sample_part[close + 1:]
        else:
            parts = sample_part.split(None, 1)
            if len(parts) != 2:
                errors.append(f"line {lineno}: malformed sample `{line}`")
                continue
            name, rest = parts
        try:
            value = float(rest.strip().split()[0])
        except (ValueError, IndexError):
            errors.append(f"line {lineno}: unparseable value in `{line}`")
            continue
        samples.append((name, labels, value))
        if exemplar_part is not None:
            exemplars.append((lineno, name, exemplar_part))
    return types, samples, exemplars, errors


def parse_exposition(text: str) -> Tuple[
        Dict[str, str], List[Tuple[str, Dict[str, str], float]],
        List[str]]:
    """Back-compat 3-tuple view of `parse_exposition_full`."""
    types, samples, _exemplars, errors = parse_exposition_full(text)
    return types, samples, errors


def _family_of(sample_name: str, types: Dict[str, str]) -> Optional[str]:
    if sample_name in types:
        return sample_name
    for suf in _SUFFIXES:
        if sample_name.endswith(suf):
            base = sample_name[: -len(suf)]
            if base in types and types[base] in ("histogram", "summary"):
                return base
    return None


def _validate_exemplar(lineno: int, sample_name: str, raw: str
                       ) -> List[str]:
    """OpenMetrics exemplar contract: attached to a `_bucket` sample,
    `{labels} value [timestamp]`, combined label runes <= 128."""
    errs: List[str] = []
    if not sample_name.endswith("_bucket"):
        errs.append(f"line {lineno}: exemplar on `{sample_name}` — "
                    "only histogram _bucket samples carry exemplars")
    if not raw.startswith("{"):
        errs.append(f"line {lineno}: exemplar must start with a "
                    "label set")
        return errs
    close = raw.rfind("}")
    if close < 0:
        errs.append(f"line {lineno}: unbalanced exemplar braces")
        return errs
    labels = _parse_labels(raw[1:close])
    if labels is None:
        errs.append(f"line {lineno}: malformed exemplar labels")
        return errs
    runes = sum(len(k) + len(v) for k, v in labels.items())
    if runes > EXEMPLAR_RUNES_MAX:
        errs.append(f"line {lineno}: exemplar label set is {runes} "
                    f"runes (limit {EXEMPLAR_RUNES_MAX})")
    tail = raw[close + 1:].split()
    if not tail or len(tail) > 2:
        errs.append(f"line {lineno}: exemplar needs a value and at "
                    "most a timestamp")
        return errs
    for tok in tail:
        try:
            float(tok)
        except ValueError:
            errs.append(f"line {lineno}: non-numeric exemplar "
                        f"field `{tok}`")
    return errs


def count_exemplars(text: str) -> int:
    """Number of syntactically valid exemplars in an exposition (the
    obs smoke's 'at least one exemplar made it to the wire' check)."""
    _types, _samples, exemplars, _errors = parse_exposition_full(text)
    return sum(1 for lineno, name, raw in exemplars
               if not _validate_exemplar(lineno, name, raw))


#: unix time this process imported the metrics plane — the standard
#: `process_start_time_seconds` export (stock Prometheus compares it
#: across scrapes for restart detection; import time is within
#: milliseconds of exec for any real bridge process)
_PROCESS_START_S = time.time()


def process_families_text(scrape_duration_s: float,
                          start_time_s: Optional[float] = None) -> str:
    """Exposition text for the standard (un-namespaced) Prometheus
    process families a metrics server appends to every `/metrics`
    response: `process_start_time_seconds` (restart
    detection) and `scrape_duration_seconds` (this scrape's render
    wall time).  Appended BEFORE the OpenMetrics `# EOF` terminator by
    the caller."""
    start = _PROCESS_START_S if start_time_s is None else start_time_s
    return (
        "# HELP process_start_time_seconds unix time the exporting "
        "process started\n"
        "# TYPE process_start_time_seconds gauge\n"
        f"process_start_time_seconds {float(start):.3f}\n"
        "# HELP scrape_duration_seconds wall time spent rendering "
        "this scrape\n"
        "# TYPE scrape_duration_seconds gauge\n"
        f"scrape_duration_seconds {_fmt(float(scrape_duration_s))}\n")


def validate_exposition(text: str, openmetrics: bool = False
                        ) -> List[str]:
    """Return a list of format violations (empty == valid): every
    sample family typed exactly once, histogram buckets cumulative
    with `le="+Inf"` == `_count` and a `_sum`, summaries with numeric
    quantile labels plus `_sum`/`_count`.  With `openmetrics=True`,
    additionally require the `# EOF` terminator and validate exemplar
    syntax; exemplars on a non-OpenMetrics exposition are violations
    (they are rendered only on the negotiated content type)."""
    types, samples, exemplars, errors = parse_exposition_full(text)
    if openmetrics:
        tail = [ln.strip() for ln in text.splitlines() if ln.strip()]
        if not tail or tail[-1] != "# EOF":
            errors.append("openmetrics: missing `# EOF` terminator")
        for lineno, name, raw in exemplars:
            errors.extend(_validate_exemplar(lineno, name, raw))
    elif exemplars:
        errors.append(f"{len(exemplars)} exemplar(s) present on a "
                      "non-OpenMetrics exposition")
    by_family: Dict[str, List[Tuple[str, Dict[str, str], float]]] = {}
    for name, labels, value in samples:
        fam = _family_of(name, types)
        if fam is None:
            errors.append(f"sample `{name}` has no # TYPE line")
            continue
        by_family.setdefault(fam, []).append((name, labels, value))

    for fam, mtype in types.items():
        fam_samples = by_family.get(fam, [])
        if mtype == "histogram":
            # group by non-`le` label series: a labeled family (e.g.
            # tick_phase_seconds{phase=...}) is N independent
            # bucket/sum/count triples sharing one TYPE line
            series: Dict[Tuple[Tuple[str, str], ...],
                         Dict[str, list]] = {}
            for sname, labels, value in fam_samples:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "le"))
                s = series.setdefault(
                    key, {"buckets": [], "counts": [], "sums": []})
                if sname == fam + "_bucket":
                    s["buckets"].append((labels.get("le"), value))
                elif sname == fam + "_count":
                    s["counts"].append(value)
                elif sname == fam + "_sum":
                    s["sums"].append(value)
            if not any(s["buckets"] for s in series.values()):
                errors.append(f"histogram {fam}: no _bucket samples")
                continue
            for key, s in series.items():
                tag = fam if not key else (
                    fam + "{" + ",".join(f'{k}="{v}"' for k, v in key)
                    + "}")
                buckets = s["buckets"]
                counts = s["counts"]
                sums = s["sums"]
                if not buckets:
                    errors.append(f"histogram {tag}: no _bucket samples")
                    continue
                les = []
                for le, _v in buckets:
                    if le is None:
                        errors.append(f"histogram {tag}: bucket "
                                      "missing le")
                        continue
                    les.append(math.inf if le == "+Inf" else float(le))
                if les != sorted(les):
                    errors.append(f"histogram {tag}: buckets not in "
                                  "ascending le order")
                vals = [v for _le, v in buckets]
                if any(b > a for a, b in zip(vals[1:], vals)):
                    errors.append(f"histogram {tag}: bucket counts not "
                                  "cumulative")
                if not les or not math.isinf(les[-1]):
                    errors.append(f'histogram {tag}: missing le="+Inf" '
                                  "bucket")
                if not counts:
                    errors.append(f"histogram {tag}: missing _count")
                elif les and math.isinf(les[-1]) \
                        and vals[-1] != counts[0]:
                    errors.append(
                        f'histogram {tag}: le="+Inf" bucket '
                        f"({vals[-1]:g}) != _count ({counts[0]:g})")
                if not sums:
                    errors.append(f"histogram {tag}: missing _sum")
        elif mtype == "summary":
            quantiles = [s for s in fam_samples if s[0] == fam]
            for _name, labels, _v in quantiles:
                q = labels.get("quantile")
                try:
                    qf = float(q)
                except (TypeError, ValueError):
                    errors.append(f"summary {fam}: non-numeric quantile "
                                  f"label {q!r}")
                    continue
                if not 0.0 <= qf <= 1.0:
                    errors.append(f"summary {fam}: quantile {qf} "
                                  "outside [0, 1]")
            if not any(s[0] == fam + "_sum" for s in fam_samples):
                errors.append(f"summary {fam}: missing _sum")
            if not any(s[0] == fam + "_count" for s in fam_samples):
                errors.append(f"summary {fam}: missing _count")
    # standard process families (un-namespaced, appended by a metrics
    # server): stock Prometheus derives `up`/restart
    # detection from these, so nonsense values are format violations
    for _n, _l, value in by_family.get("process_start_time_seconds", ()):
        if value <= 0.0:
            errors.append("process_start_time_seconds must be a "
                          f"positive unix time, got {value:g}")
    for _n, _l, value in by_family.get("scrape_duration_seconds", ()):
        if value < 0.0:
            errors.append("scrape_duration_seconds must be "
                          f">= 0, got {value:g}")
    return errors
