"""Health primitives for the supervised runtime.

Counterpart: `libjitsi_tpu/utils/health.py`, copied whole (host only).

Small, dependency-free building blocks the supervisor composes:

- `Watchdog`           tick-deadline timing -> liveness state machine
- `SlidingWindowCounter` dense per-stream event counters over the last
                       W ticks (quarantine decisions are *rate* based,
                       so one ancient auth failure never convicts)
- `ExponentialBackoff` deterministic delay ladder (quarantine
                       re-admission, UDP reopen) — no jitter, so failing
                       runs replay exactly, like utils/faults.py
- `retrying`           bounded-retry-with-backoff call wrapper

Everything here is host-side and allocation-free per tick: the
supervisor runs inside the 20 ms tick budget, so its own bookkeeping
must cost microseconds.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

# liveness states (ordered by severity; exported as a metric gauge)
HEALTHY, OVERLOADED, STALLED = "healthy", "overloaded", "stalled"
_STATE_CODE = {HEALTHY: 0, OVERLOADED: 1, STALLED: 2}


def state_code(state: str) -> int:
    """Numeric encoding for Prometheus gauges (0/1/2)."""
    return _STATE_CODE[state]


class Watchdog:
    """Times every tick against a deadline and classifies liveness.

    One `observe(duration_s)` call per tick.  `overload_after`
    consecutive overruns flips the state to OVERLOADED (the supervisor
    starts shedding); `stall_after` consecutive overruns means the
    process is not keeping up at all — STALLED is the "restart me"
    signal a health endpoint exports.
    """

    def __init__(self, deadline_s: float, overload_after: int = 3,
                 stall_after: int = 25):
        if deadline_s <= 0:
            raise ValueError("deadline must be positive")
        self.deadline_s = deadline_s
        self.overload_after = overload_after
        self.stall_after = stall_after
        self.ticks = 0
        self.overruns = 0                # total ticks over deadline
        self.consecutive = 0             # current overrun run length
        self.max_consecutive = 0
        self.last_s = 0.0
        self.worst_s = 0.0

    def observe(self, duration_s: float) -> bool:
        """Record one tick's duration; returns True when it overran."""
        self.ticks += 1
        self.last_s = duration_s
        self.worst_s = max(self.worst_s, duration_s)
        over = duration_s > self.deadline_s
        if over:
            self.overruns += 1
            self.consecutive += 1
            self.max_consecutive = max(self.max_consecutive,
                                       self.consecutive)
        else:
            self.consecutive = 0
        return over

    @property
    def state(self) -> str:
        if self.consecutive >= self.stall_after:
            return STALLED
        if self.consecutive >= self.overload_after:
            return OVERLOADED
        return HEALTHY


class SlidingWindowCounter:
    """Per-stream event counts over the last `window` ticks, dense.

    A [window, capacity] ring of per-tick deltas plus a running sum:
    `push` is O(capacity) (two vector ops), `sums` is O(1).  This is the
    quarantine detector's memory — auth-failure *rate*, not lifetime
    total.
    """

    def __init__(self, capacity: int, window: int):
        if window <= 0:
            raise ValueError("window must be positive")
        self.capacity = capacity
        self.window = window
        self._buf = np.zeros((window, capacity), dtype=np.int64)
        self._i = 0
        self._sum = np.zeros(capacity, dtype=np.int64)

    def push(self, delta: np.ndarray) -> None:
        """Advance one tick with this tick's per-stream event counts."""
        delta = np.asarray(delta, dtype=np.int64)
        self._sum -= self._buf[self._i]
        self._buf[self._i] = delta
        self._sum += delta
        self._i = (self._i + 1) % self.window

    def sums(self) -> np.ndarray:
        """Window totals per stream (live view — do not mutate)."""
        return self._sum

    def reset_rows(self, rows) -> None:
        """Forget a stream's history (quarantine release starts clean)."""
        rows = np.asarray(rows, dtype=np.int64)
        self._buf[:, rows] = 0
        self._sum[rows] = 0


class ExponentialBackoff:
    """Deterministic exponential delay ladder: base * factor**attempt,
    capped.  Used in SECONDS by `retrying` and in TICKS by the stream
    quarantine (same math, different unit)."""

    def __init__(self, base: float, factor: float = 2.0,
                 cap: Optional[float] = None):
        if base <= 0 or factor < 1.0:
            raise ValueError("need base > 0 and factor >= 1")
        self.base = base
        self.factor = factor
        self.cap = cap

    def delay(self, attempt: int) -> float:
        d = self.base * (self.factor ** max(0, attempt))
        return d if self.cap is None else min(d, self.cap)


def retrying(fn: Callable, retries: int = 5, backoff_s: float = 0.05,
             backoff_cap_s: float = 2.0,
             retry_on: Tuple[type, ...] = (OSError,),
             sleep: Callable[[float], None] = time.sleep):
    """Call `fn` with bounded retry + exponential backoff.

    The crash-restart path uses this around the UDP engine reopen: the
    old process's socket may linger briefly (or an init race holds the
    port), and a restarted worker must ride that out instead of dying —
    but boundedly, so a genuinely-taken port still fails loudly.
    """
    if retries < 1:
        raise ValueError("retries must be >= 1")
    bo = ExponentialBackoff(backoff_s, cap=backoff_cap_s)
    last = None
    for attempt in range(retries):
        try:
            return fn()
        except retry_on as e:          # noqa: PERF203 (bounded loop)
            last = e
            if attempt + 1 < retries:
                sleep(bo.delay(attempt))
    raise last
