"""Live users-per-device headroom estimation (the capacity plane).

Counterpart: `libjitsi_tpu/utils/capacity.py`, copied whole (host
only).  The other observability surfaces answer "is the bridge healthy
now"; this one answers how many more users fit on this device before an
SLO burns.  `CapacityModel` does so by continuously fitting
a per-resource utilization model from signals that are already
flowing, with no new instrumentation on the data path:

  tick_budget   watchdog-observed tick wall time over the deadline
  host          PhaseProfiler host share of the non-idle tick
                (host_python + dispatch), from the supervisor's
                drained phase ledger
  rows          SRTP registry row occupancy (hard per-device slots)
  backlog       lifecycle admit queue depth over `max_pending`
  keystream     GCM keystream cache miss rate, from the
                `transform/srtp/keystream.py` caches' hits and misses
                (cache outrun = the stock GCM path runs in the tick)
  slo_burn      worst fast-window burn rate over the fast threshold

Each resource keeps an EWMA utilization in [0, 1] against its ceiling
and a sliding ring of `(population, utilization)` samples; an online
least-squares fit per resource yields utilization-per-user, and

    headroom_r = (ceiling_r - utilization_r) / slope_r

The device's `headroom_users` is the min over resources, the
`bottleneck` is the resource that minimum belongs to, and
`confidence` in [0, 1] summarizes whether the fit is trustworthy
(sample count, population spread, fit quality).  Deterministic
resources fit exactly (rows: slope = 1/capacity); noisy ones (host
share) converge as load actually moves.

Consumers:

- `BridgeSupervisor.admission_decision` refuses `capacity_forecast`
  (typed, with a retry-after hint) when a confident forecast says the
  join won't fit — *before* any hard overload signal fires, which is
  the whole point: the refusal arrives while the bridge is still
  healthy instead of after an SLO is already burning.
- `StreamLifecycleManager` steers the ConferencePlacer away from
  forecast-exhausted shards the same way `shard_burn` steering works.
- `capacity_headroom_users`, `capacity_bottleneck{resource}` and
  `capacity_estimate_confidence` gauges export via
  `register_metrics`; `status()` serves `/debug/capacity` on the
  ObservabilityServer.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from libjitsi_tpu_torch.utils.metrics import MetricsRegistry
from libjitsi_tpu_torch.utils.perf import host_share

#: resource taxonomy, in render order (drift fixtures cross-check the
#: `capacity_bottleneck{resource=...}` label set against this tuple)
RESOURCES = ("tick_budget", "host", "rows", "backlog", "keystream",
             "slo_burn")


@dataclass
class CapacityConfig:
    """Knobs for the headroom estimator."""

    #: per-resource utilization ceilings headroom is measured against.
    #: tick_budget/rows/backlog saturate at 1.0 by construction; host
    #: mirrors `stage_share_threshold` (past it admission would refuse
    #: host_bound anyway); keystream miss rate past 0.5 means the
    #: pregeneration window is outrun; slo_burn 1.0 = fast threshold.
    ceilings: Dict[str, float] = field(default_factory=lambda: {
        "tick_budget": 1.0, "host": 0.6, "rows": 1.0,
        "backlog": 1.0, "keystream": 0.5, "slo_burn": 1.0})
    ewma_alpha: float = 0.2      # utilization smoothing
    fit_window: int = 512        # (population, utilization) samples kept
    min_samples: int = 24        # fit refuses below this
    min_pop_spread: float = 4.0  # users of population range for a fit
    #: forecast refusal: headroom below this many users (plus the join
    #: itself) refuses `capacity_forecast`; requires min_confidence
    guard_users: float = 1.0
    min_confidence: float = 0.5
    #: retry-after hint base; doubles per consecutive refusal (capped)
    retry_base_s: float = 0.1
    retry_cap_doublings: int = 4
    #: shard steering: a shard whose row range is this full is
    #: forecast-exhausted (refused/steered before it is actually full)
    shard_exhaust_frac: float = 0.9


class _ResourceTrack:
    """One resource's EWMA utilization + (population, u) fit ring."""

    __slots__ = ("ceiling", "u", "_samples", "_alpha", "slope",
                 "intercept", "r2", "fitted")

    def __init__(self, ceiling: float, alpha: float, window: int):
        self.ceiling = float(ceiling)
        self.u: Optional[float] = None      # EWMA utilization
        self._alpha = float(alpha)
        self._samples: deque = deque(maxlen=int(window))
        self.slope = 0.0                    # utilization per user
        self.intercept = 0.0
        self.r2 = 0.0
        self.fitted = False

    def observe(self, population: float, raw_u: float) -> None:
        raw_u = float(max(0.0, raw_u))
        self.u = raw_u if self.u is None else (
            self._alpha * raw_u + (1.0 - self._alpha) * self.u)
        self._samples.append((float(population), self.u))

    def fit(self, min_samples: int, min_spread: float) -> None:
        """Least-squares utilization-per-user over the sample ring."""
        self.fitted = False
        if len(self._samples) < min_samples:
            return
        pop = np.fromiter((p for p, _ in self._samples), dtype=np.float64)
        u = np.fromiter((v for _, v in self._samples), dtype=np.float64)
        if pop.max() - pop.min() < min_spread:
            return                       # population never moved enough
        pc = pop - pop.mean()
        var = float(pc @ pc)
        if var <= 0.0:
            return
        self.slope = float(pc @ (u - u.mean())) / var
        self.intercept = float(u.mean() - self.slope * pop.mean())
        pred = self.intercept + self.slope * pop
        ss_res = float(((u - pred) ** 2).sum())
        ss_tot = float(((u - u.mean()) ** 2).sum())
        self.r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else 1.0
        self.fitted = True

    def headroom_users(self) -> float:
        """Users until this resource hits its ceiling (inf when the
        fit says load does not move it, or no fit yet)."""
        if not self.fitted or self.slope <= 1e-9 or self.u is None:
            return float("inf")
        return max(0.0, (self.ceiling - self.u) / self.slope)

    @property
    def samples(self) -> int:
        return len(self._samples)

    def spread(self) -> float:
        if not self._samples:
            return 0.0
        pops = [p for p, _ in self._samples]
        return max(pops) - min(pops)


class CapacityModel:
    """Fits users-per-device headroom from the supervisor's live signals
    (module docstring).  Wire-up::

        model = CapacityModel()
        model.attach(sup, registry=reg)   # sup.capacity = model

    The supervisor calls `on_tick()` each tick; `admission_decision`
    consults `should_refuse()`; the lifecycle plane's retry-after
    surface consults `retry_after()` and placement steering
    `exhausted_shards()`."""

    def __init__(self, config: Optional[CapacityConfig] = None,
                 fit_every: int = 8):
        self.cfg = config or CapacityConfig()
        self.fit_every = max(1, int(fit_every))
        self.tracks: Dict[str, _ResourceTrack] = {
            r: _ResourceTrack(self.cfg.ceilings.get(r, 1.0),
                              self.cfg.ewma_alpha, self.cfg.fit_window)
            for r in RESOURCES}
        self.supervisor = None
        self.ticks = 0
        self.population = 0
        self.forecast_refusals = 0
        self._refusal_streak = 0

    # ---------------------------------------------------------- wiring

    def attach(self, supervisor, registry=None) -> "CapacityModel":
        """Hang the model off a BridgeSupervisor: `sup.capacity = self`
        makes admission, steering and /debug/capacity all find it."""
        self.supervisor = supervisor
        supervisor.capacity = self
        if registry is not None:
            self.register_metrics(registry)
        return self

    # ------------------------------------------------------ tick update

    def _signals(self, sup) -> Dict[str, float]:
        """Raw per-resource utilizations pulled from surfaces that
        already exist — nothing here touches the data path."""
        out: Dict[str, float] = {}
        deadline_s = sup.cfg.deadline_ms / 1000.0
        tick_s = float(getattr(sup, "last_tick_s", 0.0))
        out["tick_budget"] = (tick_s / deadline_s) if deadline_s > 0 \
            else 0.0
        out["host"] = host_share(sup.last_phases)
        reg = getattr(sup.bridge, "registry", None)
        if reg is not None and reg.capacity:
            out["rows"] = 1.0 - reg.free_slots / reg.capacity
        lc = sup.lifecycle
        if lc is not None:
            pending = len(lc._join_q) + len(lc._staged)
            out["backlog"] = pending / max(1, lc.cfg.max_pending)
            hits = misses = 0
            for c in lc._keystream_caches():
                hits += c.hits
                misses += c.misses
            if hits + misses:
                out["keystream"] = misses / (hits + misses)
        if sup.slo is not None and sup.slo.specs:
            worst = max(
                max(sup.slo.burn_rates(s.name)[w] for w in ("1m", "5m"))
                for s in sup.slo.specs)
            out["slo_burn"] = worst / sup.slo.fast_burn
        return out

    def on_tick(self, supervisor=None) -> None:
        sup = supervisor if supervisor is not None else self.supervisor
        if sup is None:
            return
        reg = getattr(sup.bridge, "registry", None)
        self.population = (int(reg.capacity - reg.free_slots)
                          if reg is not None else 0)
        for name, raw in self._signals(sup).items():
            self.tracks[name].observe(self.population, raw)
        self.ticks += 1
        if self.ticks % self.fit_every == 0:
            for t in self.tracks.values():
                t.fit(self.cfg.min_samples, self.cfg.min_pop_spread)

    # -------------------------------------------------------- estimates

    def headroom_users(self) -> float:
        """Users until the FIRST resource hits its ceiling (min over
        fitted resources; inf while nothing fits)."""
        return min((t.headroom_users() for t in self.tracks.values()),
                   default=float("inf"))

    def bottleneck(self) -> Optional[str]:
        """The resource the headroom minimum belongs to (None while no
        resource has a usable fit)."""
        best, best_h = None, float("inf")
        for name in RESOURCES:
            h = self.tracks[name].headroom_users()
            if h < best_h:
                best, best_h = name, h
        return best

    def confidence(self) -> float:
        """[0, 1]: is the headroom estimate trustworthy?  Gated on the
        bottleneck resource's fit — enough samples, enough population
        spread to identify a slope, and the fit actually explaining
        the samples (R^2)."""
        name = self.bottleneck()
        if name is None:
            return 0.0
        t = self.tracks[name]
        fill = min(1.0, t.samples / (2.0 * self.cfg.min_samples))
        spread = min(1.0, t.spread() / (2.0 * self.cfg.min_pop_spread))
        quality = max(0.0, min(1.0, t.r2))
        return fill * spread * quality

    # -------------------------------------------------------- admission

    def should_refuse(self, shard=None, joining: int = 1) -> bool:
        """True when a confident forecast says `joining` more users do
        not fit — globally, or on the targeted `shard` (its row range
        is forecast-exhausted).  Side effect: maintains the refusal
        streak that backs `retry_after()`."""
        refuse = False
        if self.confidence() >= self.cfg.min_confidence and \
                self.headroom_users() < self.cfg.guard_users + joining:
            refuse = True
        if not refuse and shard is not None and \
                int(shard) in self.exhausted_shards():
            refuse = True
        if refuse:
            self.forecast_refusals += 1
            self._refusal_streak += 1
        else:
            self._refusal_streak = 0
        return refuse

    def retry_after(self) -> float:
        """Hint for refused callers: exponential in the consecutive
        refusal streak (the longer the forecast has been saying no,
        the longer the caller should stay away)."""
        doublings = min(max(0, self._refusal_streak - 1),
                        self.cfg.retry_cap_doublings)
        return float(self.cfg.retry_base_s * (2 ** doublings))

    def exhausted_shards(self) -> List[int]:
        """Shards whose row range is `shard_exhaust_frac` full — the
        placement plane steers new conferences around them (and
        refuses joins targeting them) BEFORE they are actually full,
        mirroring shard_burn steering."""
        sup = self.supervisor
        lc = getattr(sup, "lifecycle", None) if sup is not None else None
        placer = getattr(lc, "placer", None) if lc is not None else None
        if placer is None or not getattr(placer, "rows_per_shard", 0):
            return []
        frac = self.cfg.shard_exhaust_frac
        return [s for s, u in enumerate(placer.shard_utilization())
                if u >= frac]

    # ---------------------------------------------------- observability

    def _bottleneck_samples(self):
        """capacity_bottleneck{resource=...}: each resource's modeled
        utilization over its ceiling (1.0 = at ceiling); the bottleneck
        is the labeled max.  Fit-less resources report their EWMA so
        the family is complete from the first scrape."""
        for name in RESOURCES:
            t = self.tracks[name]
            u = t.u if t.u is not None else 0.0
            yield {"resource": name}, float(u / t.ceiling)

    def register_metrics(self, registry: MetricsRegistry) -> None:
        registry.register_scalar(
            "capacity_headroom_users",
            lambda: min(self.headroom_users(), 1e9),
            help_="forecast users until the first resource ceiling "
                  "(1e9 = no fitted constraint)")
        registry.register_multi(
            "capacity_bottleneck", self._bottleneck_samples,
            help_="per-resource utilization over its ceiling; the "
                  "bottleneck is the labeled max")
        registry.register_scalar(
            "capacity_estimate_confidence", self.confidence,
            help_="0..1 trust in the headroom fit (samples, population "
                  "spread, fit quality)")
        registry.register_scalar(
            "capacity_forecast_refusals", lambda: self.forecast_refusals,
            help_="joins refused on the capacity forecast alone",
            kind="counter")

    def status(self) -> dict:
        """JSON-ready summary served at /debug/capacity."""
        return {
            "ticks": self.ticks,
            "population": self.population,
            "headroom_users": (None if self.headroom_users() == float("inf")
                               else round(self.headroom_users(), 2)),
            "bottleneck": self.bottleneck(),
            "confidence": round(self.confidence(), 4),
            "forecast_refusals": self.forecast_refusals,
            "retry_after_s": round(self.retry_after(), 4),
            "exhausted_shards": self.exhausted_shards(),
            "resources": {
                name: {
                    "utilization": (None if t.u is None
                                    else round(t.u, 4)),
                    "ceiling": t.ceiling,
                    "slope_per_user": (round(t.slope, 6) if t.fitted
                                       else None),
                    "r2": round(t.r2, 4) if t.fitted else None,
                    "headroom_users": (None
                                       if t.headroom_users()
                                       == float("inf")
                                       else round(t.headroom_users(), 2)),
                    "samples": t.samples,
                } for name, t in self.tracks.items()},
        }


def predicted_saturation(model: CapacityModel) -> Optional[float]:
    """Population at which the bottleneck resource hits its ceiling —
    the users-per-device prediction to grade against measured
    saturation.  None while the model has no confident fit."""
    h = model.headroom_users()
    if h == float("inf"):
        return None
    return float(model.population + h)
