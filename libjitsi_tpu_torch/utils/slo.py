"""Declarative SLOs with Google-SRE multi-window burn-rate alerting.

Counterpart: `libjitsi_tpu/utils/slo.py`, copied whole (host only).  An
`SloSpec` names an objective over metric families already registered
in the `MetricsRegistry`, and the `SloEngine` evaluates every spec
in-process once per supervisor tick.  `default_slos` names families the
port's bridges register: `packet_journey_seconds` (the loop),
`recovery_nacks_abandoned` (the recovery controller),
`bridge_forwarded` and `srtp_auth_fail` (the supervisor) and
`packet_size_bytes` (the loop).  `io/batching.AdaptiveBatcher` takes the
engine (`slo=`) and reads its `state()`.

Burn rate is the SRE-workbook quantity: the rate at which the error
budget is being consumed, `bad_fraction / (1 - objective)` — 1.0 means
"exactly on budget", 14.4 means "the 30-day budget is gone in 2 days".
Each spec is tracked over four sliding windows (fast 1m/5m, slow
30m/6h); an alert state requires BOTH windows of a pair to burn, which
is what makes the scheme robust to blips (short window resets fast)
without being blind to slow leaks (long window remembers).

All windows are **tick rings**: the engine counts supervisor ticks and
converts window lengths with the configured tick period — there is no
wall-clock read anywhere near the data path, and tests drive time by
calling `on_tick`.  State transitions emit `slo_alert` events into the
global flight ring; current burn rates export as
`slo_burn_rate{slo=...,window=...}` gauges and serve as JSON at
`/debug/slo` on the ObservabilityServer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.utils.metrics import MetricsRegistry

#: (label, seconds) of the four standard burn windows; the first two
#: form the fast pair, the last two the slow pair
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0), ("5m", 300.0), ("30m", 1800.0), ("6h", 21600.0))

_STATE_CODE = {"ok": 0, "slow_burn": 1, "fast_burn": 2}
_STATE_RANK = ("ok", "slow_burn", "fast_burn")


class TickWindowRing:
    """Fixed-bucket ring accumulating (good, bad) totals over the last
    `window_ticks` ticks in O(1) per tick and O(buckets) memory — a 6h
    window at 20 ms ticks is 1.08M ticks but only 64 buckets."""

    def __init__(self, window_ticks: int, buckets: int = 64):
        window_ticks = max(1, int(window_ticks))
        self.bucket_ticks = max(1, -(-window_ticks // int(buckets)))
        self.n_buckets = -(-window_ticks // self.bucket_ticks)
        self.good = np.zeros(self.n_buckets, dtype=np.float64)
        self.bad = np.zeros(self.n_buckets, dtype=np.float64)
        self._i = 0
        self._ticks_in_bucket = 0

    def push(self, good: float, bad: float) -> None:
        if self._ticks_in_bucket >= self.bucket_ticks:
            self._i = (self._i + 1) % self.n_buckets
            self.good[self._i] = 0.0
            self.bad[self._i] = 0.0
            self._ticks_in_bucket = 0
        self.good[self._i] += good
        self.bad[self._i] += bad
        self._ticks_in_bucket += 1

    def totals(self) -> Tuple[float, float]:
        return float(self.good.sum()), float(self.bad.sum())


@dataclass(frozen=True)
class SloSpec:
    """One objective over registered metric families.

    kind="ratio": `bad_metric` / `total_metric` name counter families
    (scalars, per-stream arrays, or histogram counts — the registry's
    `sample_total` flattens all three).  kind="latency": `metric` names
    a histogram family and `budget_s` the bound; an observation is good
    when it lands in a bucket whose upper bound <= budget (align the
    budget with a bucket bound or it is effectively rounded down).
    """

    name: str
    objective: float
    kind: str = "ratio"
    metric: str = ""
    budget_s: float = 0.0
    bad_metric: str = ""
    total_metric: str = ""
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("ratio", "latency"):
            raise ValueError(f"unknown SloSpec kind `{self.kind}`")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")


def default_slos(tick_budget_s: float = 0.02) -> List[SloSpec]:
    """The bridge's stock objectives: journey tail vs the tick budget,
    residual (unrecovered) loss, and SRTP auth integrity."""
    return [
        SloSpec("journey_p99", objective=0.99, kind="latency",
                metric="packet_journey_seconds", budget_s=tick_budget_s,
                description="99% of packets leave within the tick "
                            "budget"),
        SloSpec("residual_loss", objective=0.999, kind="ratio",
                bad_metric="recovery_nacks_abandoned",
                total_metric="bridge_forwarded",
                description="losses the NACK/RTX/FEC ladder gave up on "
                            "vs packets forwarded"),
        SloSpec("auth_fail", objective=0.999, kind="ratio",
                bad_metric="srtp_auth_fail",
                total_metric="packet_size_bytes",
                description="SRTP auth failures vs datagrams received"),
    ]


@dataclass(frozen=True)
class SlicedSloSpec:
    """One objective evaluated PER SLICE — per shard, per conference,
    per bridge — instead of fleet-wide: "shard 3 is burning" is an
    actionable statement once conference-affinity placement exists,
    and `label="bridge"` does the same for a cascade's bridges (both
    are ROADMAP Queue 1 item 12 in the port).

    `reader` yields ``(slice_key, good_cum, bad_cum)`` cumulative
    totals each tick; slices appear lazily on first report and decay
    back to `ok` when they stop reporting (windows fill with zeros).
    `label` names the metric label axis ("shard", "conference") the
    burn gauges export under.
    """

    name: str
    objective: float
    label: str
    reader: Callable[[], Iterable[Tuple[str, float, float]]]
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if not self.label:
            raise ValueError("sliced SLO needs a label axis")


class SloEngine:
    """Evaluates SloSpecs over tick-ring windows; call `on_tick()` once
    per supervisor tick (the supervisor does when wired)."""

    def __init__(self, registry: MetricsRegistry,
                 specs: Iterable[SloSpec] = (),
                 tick_period_s: float = 0.02,
                 flight=None,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 windows: Tuple[Tuple[str, float], ...] = WINDOWS,
                 window_buckets: int = 64):
        self.registry = registry
        self.tick_period_s = float(tick_period_s)
        self.flight = flight
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.windows = tuple(windows)
        self.window_buckets = int(window_buckets)
        self.specs: List[SloSpec] = []
        self._rings: Dict[str, Dict[str, TickWindowRing]] = {}
        self._last: Dict[str, Tuple[float, float]] = {}
        self._state: Dict[str, str] = {}
        # sliced specs: per-(spec, slice) rings/state, slices lazy
        self.sliced: List[SlicedSloSpec] = []
        self._srings: Dict[str, Dict[str, Dict[str, TickWindowRing]]] = {}
        self._slast: Dict[str, Dict[str, Tuple[float, float]]] = {}
        self._sstate: Dict[str, Dict[str, str]] = {}
        self.ticks = 0
        self.alerts_total = 0
        for spec in specs:
            self.add(spec)

    def add(self, spec: SloSpec) -> None:
        if spec.name in self._rings:
            raise ValueError(f"duplicate SLO `{spec.name}`")
        self.specs.append(spec)
        self._rings[spec.name] = {
            label: TickWindowRing(seconds / self.tick_period_s,
                                  buckets=self.window_buckets)
            for label, seconds in self.windows}
        self._state[spec.name] = "ok"

    def add_sliced(self, spec: SlicedSloSpec) -> None:
        if (spec.name in self._srings
                or spec.name in self._rings):
            raise ValueError(f"duplicate SLO `{spec.name}`")
        self.sliced.append(spec)
        self._srings[spec.name] = {}
        self._slast[spec.name] = {}
        self._sstate[spec.name] = {}

    def drop_slice(self, name: str, key: str) -> None:
        """Forget one slice entirely (a conference ended, a shard
        drained): its rings, state and baseline totals go — otherwise
        slice state grows monotonically under churn."""
        self._srings.get(name, {}).pop(key, None)
        self._slast.get(name, {}).pop(key, None)
        self._sstate.get(name, {}).pop(key, None)

    def _slice_rings(self, name: str, key: str) -> Dict[str, TickWindowRing]:
        rings = self._srings[name].get(key)
        if rings is None:
            rings = {
                label: TickWindowRing(seconds / self.tick_period_s,
                                      buckets=self.window_buckets)
                for label, seconds in self.windows}
            self._srings[name][key] = rings
            self._sstate[name][key] = "ok"
        return rings

    # ------------------------------------------------------------ reads

    def _read(self, spec: SloSpec) -> Optional[Tuple[float, float]]:
        """Cumulative (good, bad) totals for one spec; None while a
        referenced family is not (yet) registered — a spec may name
        metrics a later-attached component registers."""
        try:
            if spec.kind == "latency":
                hist = self.registry.get_histogram(spec.metric)
                if hist is None:
                    # hop-labeled families (HistogramVec): the
                    # fleet-wide objective aggregates all children —
                    # per-slice burn is SlicedSloSpec territory
                    vec = self.registry.get_histogram_vec(spec.metric)
                    if vec is None:
                        return None
                    good = total = 0.0
                    for _lv, h in vec.children():
                        j = int(np.searchsorted(h.uppers, spec.budget_s,
                                                side="right")) - 1
                        good += float(h.cumulative()[j]) if j >= 0 \
                            else 0.0
                        total += float(h.count)
                    return good, total - good
                j = int(np.searchsorted(hist.uppers, spec.budget_s,
                                        side="right")) - 1
                good = float(hist.cumulative()[j]) if j >= 0 else 0.0
                return good, float(hist.count) - good
            bad = self.registry.sample_total(spec.bad_metric)
            total = self.registry.sample_total(spec.total_metric)
            return max(total - bad, 0.0), bad
        except KeyError:
            return None

    # ------------------------------------------------------------- tick

    def on_tick(self) -> None:
        self.ticks += 1
        for spec in self.specs:
            cum = self._read(spec)
            rings = self._rings[spec.name]
            if cum is None:
                for ring in rings.values():
                    ring.push(0.0, 0.0)
                continue
            last = self._last.get(spec.name, (0.0, 0.0))
            # clamp at 0: a checkpoint restore can rewind counters
            d_good = max(cum[0] - last[0], 0.0)
            d_bad = max(cum[1] - last[1], 0.0)
            self._last[spec.name] = cum
            for ring in rings.values():
                ring.push(d_good, d_bad)
            self._evaluate(spec)
        for spec in self.sliced:
            self._tick_sliced(spec)

    def _tick_sliced(self, spec: SlicedSloSpec) -> None:
        seen = set()
        for key, good, bad in spec.reader():
            key = str(key)
            seen.add(key)
            rings = self._slice_rings(spec.name, key)
            last = self._slast[spec.name].get(key, (0.0, 0.0))
            d_good = max(float(good) - last[0], 0.0)
            d_bad = max(float(bad) - last[1], 0.0)
            self._slast[spec.name][key] = (float(good), float(bad))
            for ring in rings.values():
                ring.push(d_good, d_bad)
            self._evaluate_slice(spec, key)
        # slices the reader stopped reporting decay toward ok instead
        # of freezing at their last burn
        for key in self._srings[spec.name].keys() - seen:
            for ring in self._srings[spec.name][key].values():
                ring.push(0.0, 0.0)
            self._evaluate_slice(spec, key)

    def _evaluate_slice(self, spec: SlicedSloSpec, key: str) -> None:
        burns = self.slice_burn_rates(spec.name, key)
        if (burns["1m"] >= self.fast_burn
                and burns["5m"] >= self.fast_burn):
            new = "fast_burn"
        elif (burns["30m"] >= self.slow_burn
                and burns["6h"] >= self.slow_burn):
            new = "slow_burn"
        else:
            new = "ok"
        old = self._sstate[spec.name][key]
        if new != old:
            self._sstate[spec.name][key] = new
            self.alerts_total += 1
            if self.flight is not None:
                self.flight.record(
                    "slo_alert", tick=self.ticks, slo=spec.name,
                    state=new, prev=old, **{spec.label: key},
                    burn={w: round(b, 3) for w, b in burns.items()})

    def _evaluate(self, spec: SloSpec) -> None:
        burns = self.burn_rates(spec.name)
        if (burns["1m"] >= self.fast_burn
                and burns["5m"] >= self.fast_burn):
            new = "fast_burn"
        elif (burns["30m"] >= self.slow_burn
                and burns["6h"] >= self.slow_burn):
            new = "slow_burn"
        else:
            new = "ok"
        old = self._state[spec.name]
        if new != old:
            self._state[spec.name] = new
            self.alerts_total += 1
            if self.flight is not None:
                self.flight.record(
                    "slo_alert", tick=self.ticks, slo=spec.name,
                    state=new, prev=old,
                    burn={w: round(b, 3) for w, b in burns.items()})

    # ------------------------------------------------------- inspection

    def burn_rates(self, name: str) -> Dict[str, float]:
        budget = 1.0 - next(s.objective for s in self.specs
                            if s.name == name)
        out: Dict[str, float] = {}
        for label, ring in self._rings[name].items():
            good, bad = ring.totals()
            total = good + bad
            out[label] = (bad / total) / budget if total > 0 else 0.0
        return out

    def slice_burn_rates(self, name: str, key: str) -> Dict[str, float]:
        budget = 1.0 - next(s.objective for s in self.sliced
                            if s.name == name)
        out: Dict[str, float] = {}
        for label, ring in self._srings[name][key].items():
            good, bad = ring.totals()
            total = good + bad
            out[label] = (bad / total) / budget if total > 0 else 0.0
        return out

    def slice_state(self, name: str, key) -> str:
        """One slice's burn state ("ok" for a never-seen slice: a brand
        new conference/shard has no burn history to hold against it)."""
        return self._sstate.get(name, {}).get(str(key), "ok")

    def burning_slices(self, name: str,
                       level: str = "fast_burn") -> List[str]:
        """Slice keys at or above `level` — the admission/overload
        query: which shard (conference) is actually burning."""
        rank = _STATE_RANK.index(level)
        return sorted(k for k, st in self._sstate.get(name, {}).items()
                      if _STATE_RANK.index(st) >= rank)

    def state(self, name: Optional[str] = None) -> str:
        """One SLO's state, or the worst across all (the supervisor
        stamps this on every ladder_escalate event)."""
        if name is not None:
            return self._state[name]
        if not self._state:
            return "ok"
        return max(self._state.values(), key=_STATE_RANK.index)

    def status(self) -> dict:
        """JSON-ready summary served at /debug/slo."""
        return {
            "ticks": self.ticks,
            "tick_period_s": self.tick_period_s,
            "thresholds": {"fast_burn": self.fast_burn,
                           "slow_burn": self.slow_burn},
            "state": self.state(),
            "slos": [{
                "name": s.name,
                "kind": s.kind,
                "objective": s.objective,
                "description": s.description,
                "state": self._state[s.name],
                "burn": self.burn_rates(s.name),
                "totals": {label: dict(zip(("good", "bad"),
                                           ring.totals()))
                           for label, ring in
                           self._rings[s.name].items()},
            } for s in self.specs],
            "sliced": [{
                "name": s.name,
                "label": s.label,
                "objective": s.objective,
                "description": s.description,
                "slices": {key: {
                    "state": self._sstate[s.name][key],
                    "burn": self.slice_burn_rates(s.name, key),
                } for key in sorted(self._srings[s.name])},
            } for s in self.sliced],
        }

    # ---------------------------------------------------- observability

    def _burn_samples(self):
        for spec in self.specs:
            for label, rate in self.burn_rates(spec.name).items():
                yield {"slo": spec.name, "window": label}, rate

    def _state_samples(self):
        for spec in self.specs:
            yield ({"slo": spec.name},
                   float(_STATE_CODE[self._state[spec.name]]))

    def _slice_burn_samples(self):
        for spec in self.sliced:
            for key in sorted(self._srings[spec.name]):
                for label, rate in self.slice_burn_rates(
                        spec.name, key).items():
                    yield ({"slo": spec.name, "window": label,
                            spec.label: key}, rate)

    def _slice_state_samples(self):
        for spec in self.sliced:
            for key, st in sorted(self._sstate[spec.name].items()):
                yield ({"slo": spec.name, spec.label: key},
                       float(_STATE_CODE[st]))

    def register_metrics(self, registry: MetricsRegistry) -> None:
        registry.register_multi(
            "slo_burn_rate", self._burn_samples,
            help_="error-budget burn rate per SLO per window")
        registry.register_multi(
            "slo_state", self._state_samples,
            help_="0 ok, 1 slow_burn, 2 fast_burn")
        registry.register_scalar(
            "slo_alerts_total", lambda: self.alerts_total,
            help_="SLO state transitions emitted as slo_alert events",
            kind="counter")
        registry.register_multi(
            "slo_slice_burn_rate", self._slice_burn_samples,
            help_="error-budget burn rate per sliced SLO per "
                  "shard/conference per window")
        registry.register_multi(
            "slo_slice_state", self._slice_state_samples,
            help_="per-slice burn state: 0 ok, 1 slow_burn, 2 fast_burn")
