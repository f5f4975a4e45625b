"""Adaptive per-tick batching: the receive window and the batch cap
become live knobs, retuned every tick from two signals.

Counterpart: `libjitsi_tpu/io/batching.py` `AdaptiveBatcher`, copied so
the port imports nothing of the JAX package.

- **Backlog**: the window filled to the current cap, so the socket's
  queue is deeper than one window.  Waiting is then pure added latency:
  the window drops to poll mode (0 ms) and the cap opens to its base.
- **SLO burn state**, read from any object with `.state()` (the
  `utils/slo.SloEngine`): `fast_burn` drops the window and
  halves the cap, so batches leave sooner; `slow_burn` holds the cap and
  halves the window.

Pressure moves the knobs multiplicatively and calm ticks walk them back
additively toward the configured base (AIMD), so one calm tick inside a
storm cannot re-widen the window it just escaped.  `clamp_window(True)`
hands the window to another controller (a supervisor's ladder) and
keeps the cap adaptive.
"""

from __future__ import annotations

from typing import Optional


class AdaptiveBatcher:
    """Retunes `loop.recv_window_ms` and every drain ring's `max_batch`
    each tick: call `on_tick()` after each `loop.tick()`."""

    def __init__(self, loop, slo=None, min_batch: int = 8):
        self.loop = loop
        self.engine = loop.engine
        self.slo = slo
        self._baselines = {}  # per-ring construction-time batch caps
        self.base_window_ms = loop.recv_window_ms
        base = int(getattr(self.engine, "max_batch", 0) or 0)
        self.base_batch = base
        self.min_batch = max(1, min(int(min_batch), base) if base
                             else int(min_batch))
        self.window_clamped = False
        self._prev_rx = int(loop.rx_packets)
        # observability: how often each pressure source moved a knob
        self.backlog_polls = 0
        self.burn_shrinks = 0
        self.recoveries = 0

    # ---------------------------------------------------------- signals
    def clamp_window(self, clamped: bool) -> None:
        """Ladder handoff: while the supervisor's recv_window rung is
        held, the window belongs to the ladder — stop writing it."""
        self.window_clamped = bool(clamped)

    def _state(self) -> str:
        return self.slo.state() if self.slo is not None else "ok"

    # ------------------------------------------------------------- tick
    def on_tick(self) -> None:
        n = int(self.loop.rx_packets) - self._prev_rx
        self._prev_rx = int(self.loop.rx_packets)
        cur = int(getattr(self.engine, "max_batch", 0) or 0)
        if cur <= 0:
            return                       # engine without a batch cap
        state = self._state()
        saturated = n >= cur
        if state == "fast_burn":
            # latency emergency: smaller batches finish sooner
            batch = max(self.min_batch, cur // 2)
            window: Optional[float] = 0
            self.burn_shrinks += 1
        elif saturated:
            # backlog: the queue outruns the window — stop waiting,
            # drain at full width
            batch = self.base_batch
            window = 0
            self.backlog_polls += 1
        elif state == "slow_burn":
            batch = cur
            window = (self.base_window_ms / 2
                      if self.base_window_ms else 0)
        else:
            # calm: additive recovery toward the configured baseline
            step = max(1, self.base_batch // 8)
            batch = min(self.base_batch, cur + step)
            window = self.base_window_ms
            if batch != cur or self.loop.recv_window_ms != window:
                self.recoveries += 1
        self._set_caps(batch)
        if window is not None and not self.window_clamped:
            self.loop.recv_window_ms = window

    def _set_caps(self, batch: int) -> None:
        """Write the retuned cap to EVERY drain ring, scaled to each
        ring's own baseline (SO_REUSEPORT siblings may be sized
        differently from the primary).  The per-ring window itself is
        structural — sibling rings always poll (0 ms, io/loop.py), so
        the cap is the knob that bounds their drain width."""
        self.engine.max_batch = batch
        for eng in getattr(self.loop, "rings", ())[1:]:
            base = self._baselines.setdefault(
                id(eng), int(getattr(eng, "max_batch", 0) or 0))
            if base and self.base_batch:
                scaled = max(1, (batch * base) // self.base_batch)
                eng.max_batch = min(base, scaled)

    # ---------------------------------------------------- observability
    def register_metrics(self, registry, prefix: str = "batcher") -> None:
        registry.register_scalar(
            f"{prefix}_batch_cap",
            lambda: int(getattr(self.engine, "max_batch", 0) or 0),
            help_="current adaptive recv batch cap")
        registry.register_scalar(
            f"{prefix}_recv_window_ms",
            lambda: float(self.loop.recv_window_ms),
            help_="current adaptive recv window")
        registry.register_scalar(
            f"{prefix}_backlog_polls", lambda: self.backlog_polls,
            help_="ticks the backlog signal forced poll mode",
            kind="counter")
        registry.register_scalar(
            f"{prefix}_burn_shrinks", lambda: self.burn_shrinks,
            help_="ticks SLO fast-burn shrank the batch cap",
            kind="counter")
