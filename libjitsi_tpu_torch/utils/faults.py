"""Fault injection: loss, burst loss, duplication, reordering and
corruption as a chain engine, and the churn soak's traffic models.

Counterpart: `libjitsi_tpu/utils/faults.py`, copied whole (host only):
the same seeded `numpy.random.Generator` draws in the same order, so
both packages give the same fates for a seed and a batch split.

Deterministic per-seed, so failing runs replay exactly.  Note the RNG
is consumed batch-by-batch: the same packets partitioned into different
batches draw different fates — chaos tests that need IDENTICAL faulted
bytes across two runs must fault a pre-generated wire stream offline
and feed the same bytes to both (as the chaos tests do).

Two loss processes compose:
- independent per-packet `loss` (classic Bernoulli), and
- `burst` — a Gilbert–Elliott two-state Markov channel (good/bad with
  per-state loss rates), the standard model for the CORRELATED loss
  bursts real networks show, which independent loss cannot reproduce
  (a jitter buffer that survives 5% random loss can still die to the
  same 5% arriving as 10-packet bursts).

The engine applies on both directions: `reverse_transform` simulates
the network on receive, and (with `tx=True`) `transform` on send —
install it AFTER SrtpTransformEngine in the chain list so both paths
see ciphertext, exactly like a lossy wire.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.transform.engine import (PacketTransformer,
                                               TransformEngine)


class GilbertElliott:
    """Two-state Markov loss channel (Gilbert–Elliott).

    State GOOD drops with `loss_good` (usually 0), state BAD with
    `loss_bad` (usually 1).  Transitions per packet: GOOD->BAD with
    `p_gb`, BAD->GOOD with `p_bg`; mean burst length = 1/p_bg, long-run
    loss rate ≈ p_gb/(p_gb+p_bg) · loss_bad (for loss_good=0).

    Vectorized by sojourn segments: instead of stepping the chain per
    packet, the time spent in each state is drawn geometrically and a
    whole segment's losses are filled with one vector op.  State (and a
    partially-consumed sojourn) persists across batches, so bursts span
    batch boundaries like they span ticks on a real wire.
    """

    GOOD, BAD = 0, 1

    def __init__(self, p_gb: float, p_bg: float, loss_bad: float = 1.0,
                 loss_good: float = 0.0):
        if not (0.0 <= p_gb <= 1.0 and 0.0 <= p_bg <= 1.0):
            raise ValueError("transition probabilities must be in [0, 1]")
        self.p_gb = p_gb
        self.p_bg = p_bg
        self.loss_bad = loss_bad
        self.loss_good = loss_good
        self.state = self.GOOD
        self._left = 0          # packets remaining in current sojourn
        self._absorbing = False  # sojourn came from a 0-probability exit

    def losses(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Drop mask for the next `n` packets, advancing the chain."""
        out = np.empty(n, dtype=bool)
        i = 0
        while i < n:
            if self._left == 0:
                p_exit = self.p_gb if self.state == self.GOOD else self.p_bg
                if p_exit <= 0.0:        # absorbing: never leaves
                    self._left = n - i
                    self._absorbing = True
                else:
                    self._left = int(rng.geometric(p_exit))
                    self._absorbing = False
            seg = min(self._left, n - i)
            p = self.loss_good if self.state == self.GOOD else self.loss_bad
            if p <= 0.0:
                out[i:i + seg] = False
            elif p >= 1.0:
                out[i:i + seg] = True
            else:
                out[i:i + seg] = rng.random(seg) < p
            self._left -= seg
            i += seg
            if self._left == 0 and not self._absorbing:
                self.state ^= 1
        return out


class FaultInjectionEngine(TransformEngine):
    """Drops / duplicates / reorders / corrupts rows of each batch.

    Installed like any other engine (after SRTP in the list, so it runs
    first on receive and last on send — the network simulator sits on
    the wire side of the crypto).  Rates are per-packet probabilities;
    reordering shuffles a window at the batch level; `burst` adds a
    Gilbert–Elliott correlated-loss channel (independent chains per
    direction — a real path's two directions fade independently).
    `tx=True` also faults the send path (counters split per direction).
    """

    def __init__(self, loss: float = 0.0, duplicate: float = 0.0,
                 corrupt: float = 0.0, reorder: float = 0.0,
                 seed: int = 0,
                 burst: Optional[Tuple[float, ...]] = None,
                 tx: bool = False):
        self.loss = loss
        self.duplicate = duplicate
        self.corrupt = corrupt
        self.reorder = reorder
        self.tx = tx
        self.rng = np.random.default_rng(seed)
        self._ge_rx = GilbertElliott(*burst) if burst else None
        self._ge_tx = GilbertElliott(*burst) if burst and tx else None
        self.dropped = 0
        self.duplicated = 0
        self.corrupted = 0
        self.tx_dropped = 0
        self.tx_duplicated = 0
        self.tx_corrupted = 0
        eng = self

        class _T(PacketTransformer):
            def reverse_transform(self, batch, mask=None):
                return eng._apply(batch, mask, eng._ge_rx, "")

            def transform(self, batch, mask=None):
                if not eng.tx:
                    n = batch.batch_size
                    return batch, (np.ones(n, bool) if mask is None
                                   else mask)
                return eng._apply(batch, mask, eng._ge_tx, "tx_")

        self._rtp = _T()

    def _apply(self, batch: PacketBatch, mask, ge, prefix: str):
        n = batch.batch_size
        keep = np.ones(n, bool) if mask is None else mask.copy()
        if n == 0:
            return batch, keep
        r = self.rng
        data = batch.data.copy()
        length = np.asarray(batch.length).copy()
        stream = np.asarray(batch.stream).copy()

        drop = r.random(n) < self.loss
        if ge is not None:
            drop |= ge.losses(n, r)
        self._bump(prefix + "dropped", int((drop & keep).sum()))
        keep &= ~drop

        cor = (r.random(n) < self.corrupt) & keep
        rows = np.nonzero(cor & (length > 0))[0]
        if len(rows):
            # one flipped byte per corrupted packet, position uniform in
            # the packet — vectorized (Generator.integers broadcasts the
            # per-row exclusive upper bound)
            cols = r.integers(0, length[rows])
            data[rows, cols] ^= 0xFF
        self._bump(prefix + "corrupted", len(rows))

        order = np.arange(n)
        if self.reorder > 0 and n > 1:
            swaps = np.nonzero(r.random(n - 1) < self.reorder)[0]
            for i in swaps:
                order[i], order[i + 1] = order[i + 1], order[i]

        dup_rows = np.nonzero((r.random(n) < self.duplicate) & keep)[0]
        self._bump(prefix + "duplicated", len(dup_rows))
        if len(dup_rows):
            order = np.concatenate([order, dup_rows])

        out = PacketBatch(data[order], length[order], stream[order])
        return out, keep[order]

    def _bump(self, counter: str, by: int) -> None:
        setattr(self, counter, getattr(self, counter) + by)

    def register_metrics(self, registry, prefix: str = "fault") -> None:
        """Expose the per-direction fault counters on a MetricsRegistry
        (Prometheus counters, rendered by `registry.render()`)."""
        for name, help_ in (
                ("dropped", "packets dropped by injected loss (rx)"),
                ("corrupted", "packets bit-flipped (rx)"),
                ("duplicated", "packets duplicated (rx)"),
                ("tx_dropped", "packets dropped by injected loss (tx)"),
                ("tx_corrupted", "packets bit-flipped (tx)"),
                ("tx_duplicated", "packets duplicated (tx)")):
            registry.register_scalar(
                f"{prefix}_{name}",
                (lambda n=name: getattr(self, n)),
                help_=help_, kind="counter")

    @property
    def rtp_transformer(self):
        return self._rtp


class DiurnalProfile:
    """Sinusoidal day-curve rate modulation for churn models.

    `factor(t)` swings between `1 - depth` (trough) and 1.0 (peak) over
    one `period_s`; real conference load follows the working day, and a
    churn soak compressed to seconds still exercises the ramp-up /
    ramp-down regimes by shrinking the period."""

    def __init__(self, period_s: float = 86400.0, depth: float = 0.5,
                 peak_t: float = 0.0):
        if not 0.0 <= depth <= 1.0:
            raise ValueError("depth must be in [0, 1]")
        self.period_s = period_s
        self.depth = depth
        self.peak_t = peak_t

    def factor(self, t: float) -> float:
        phase = 2.0 * np.pi * (t - self.peak_t) / self.period_s
        return 1.0 - self.depth * 0.5 * (1.0 - np.cos(phase + np.pi))


class TalkSpurtModel:
    """Vectorized per-stream on/off voice-activity source (ITU-T P.59
    style: exponential talk-spurt and pause holding times).

    `advance(dt)` moves every stream's two-state chain forward and
    returns the boolean "speaking" mask — the churn soak uses it so
    admitted streams offer realistic bursty traffic instead of a
    constant packet wall.  Deterministic per seed."""

    def __init__(self, n: int, spurt_s: float = 1.004,
                 pause_s: float = 1.587, seed: int = 0):
        self.spurt_s = spurt_s
        self.pause_s = pause_s
        self.rng = np.random.default_rng(seed)
        self.speaking = self.rng.random(n) < (
            spurt_s / (spurt_s + pause_s))
        self._left = np.where(
            self.speaking,
            self.rng.exponential(spurt_s, n),
            self.rng.exponential(pause_s, n))

    def reset_rows(self, rows) -> None:
        """Fresh state for recycled rows (a new stream must not inherit
        the departed occupant's mid-spurt phase)."""
        rows = np.asarray(rows, dtype=np.int64)
        self.speaking[rows] = False
        self._left[rows] = self.rng.exponential(self.pause_s, len(rows))

    def advance(self, dt: float) -> np.ndarray:
        """Advance all chains by `dt` seconds; returns the speaking
        mask.  Streams may flip several times within a large dt."""
        self._left -= dt
        expired = np.nonzero(self._left <= 0.0)[0]
        # per-row loop only over EXPIRED rows: at voice time constants
        # (~1 s) and tick dt (~20 ms) that's a few percent of rows
        for i in expired:
            while self._left[i] <= 0.0:
                self.speaking[i] = not self.speaking[i]
                mean = self.spurt_s if self.speaking[i] else self.pause_s
                self._left[i] += self.rng.exponential(mean)
        return self.speaking


class ChurnModel:
    """Poisson join/leave churn: joins arrive as a Poisson process at
    `join_rate_hz` (optionally modulated by a `DiurnalProfile`), each
    admitted stream's hold time is exponential with mean `mean_hold_s`,
    so departures are a per-stream hazard `dt / mean_hold_s`.  In
    steady state the population settles near join_rate * mean_hold
    (M/M/inf), and total churn is ~2 * join_rate events/sec.

    Deterministic per seed.  The model only COUNTS events —
    `step(dt, now, population)` returns (n_joins, n_leaves) and the
    caller decides which streams those are (LIFO, random, ...)."""

    def __init__(self, join_rate_hz: float, mean_hold_s: float,
                 seed: int = 0,
                 diurnal: Optional[DiurnalProfile] = None):
        if join_rate_hz < 0 or mean_hold_s <= 0:
            raise ValueError("need join_rate_hz >= 0, mean_hold_s > 0")
        self.join_rate_hz = join_rate_hz
        self.mean_hold_s = mean_hold_s
        self.diurnal = diurnal
        self.rng = np.random.default_rng(seed)
        self.joins_offered = 0
        self.leaves_offered = 0

    def step(self, dt: float, now: float,
             population: int) -> Tuple[int, int]:
        """Advance model time by `dt`; returns (joins, leaves) offered
        in the window given the current population."""
        rate = self.join_rate_hz
        if self.diurnal is not None:
            rate *= self.diurnal.factor(now)
        joins = int(self.rng.poisson(rate * dt))
        hazard = min(1.0, dt / self.mean_hold_s)
        leaves = (int(self.rng.binomial(population, hazard))
                  if population > 0 else 0)
        self.joins_offered += joins
        self.leaves_offered += leaves
        return joins, leaves
