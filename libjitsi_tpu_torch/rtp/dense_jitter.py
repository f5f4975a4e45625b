"""Dense jitter-buffer bank: S streams as struct-of-arrays, zero
per-stream Python objects.

The scalar `rtp.jitter_buffer.JitterBuffer` (one dict + dataclass per
packet per stream — FMJ's JitterBuffer family re-imagined) is fine for
tens of streams but is a Python-loop bottleneck at 10k streams x 50 pps.
This bank holds every stream's ring in `[S, depth]` arrays and processes
whole packet batches with NumPy, the same dense-state doctrine as
`SrtpStreamTable` (SURVEY §2.3's re-design obligation).

Semantics match the scalar buffer (same adaptive target-delay law,
late-drop rule, gap-skip law, RFC 3550 transit-jitter EWMA), with one
bounded-memory deviation: each stream holds at most `depth` outstanding
packets (a ring slot per seq mod depth); a slot collision evicts the
older packet and counts it in `overwritten`.  The scalar buffer's dict
is unbounded — at bridge scale, bounded rings are the point.

In-batch ordering: multiple packets of one stream in one `insert_batch`
are applied in batch order (wave decomposition by per-stream rank), so
results are identical to feeding the scalar buffer one packet at a time.

Counterpart: `libjitsi_tpu/rtp/dense_jitter.py` (copied; host NumPy).
Its snapshot format is the JAX bank's, so `DenseJitterBank.restore`
adopts a JAX bank's `snapshot()`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.rtp_math import segment_ranks, seq_delta
from libjitsi_tpu_torch.utils.checkpoint import ArraySnapshotMixin


class DenseJitterBank(ArraySnapshotMixin):
    """S adaptive jitter buffers in dense arrays.

    payload_cap bounds the stored payload bytes per packet (audio
    payloads; oversize inserts are truncated — callers with jumbo video
    frames use the SFU path, which does not buffer).
    """

    def __init__(self, capacity: int, depth: int = 16,
                 payload_cap: int = 256, clock_rate: int = 48000,
                 frame_ms: float = 20.0, min_delay_ms: float = 0.0,
                 max_delay_ms: float = 200.0,
                 jitter_multiplier: float = 2.0):
        if depth & (depth - 1):
            raise ValueError("depth must be a power of two")
        s = capacity
        self.capacity = s
        self.depth = depth
        self.payload_cap = payload_cap
        self.clock_rate = np.full(s, clock_rate, dtype=np.float64)
        self.frame_s = np.full(s, frame_ms / 1000.0, dtype=np.float64)
        self.min_delay = np.full(s, min_delay_ms / 1000.0, dtype=np.float64)
        self.max_delay = np.full(s, max_delay_ms / 1000.0, dtype=np.float64)
        self.mult = np.full(s, jitter_multiplier, dtype=np.float64)

        self.next_seq = np.full(s, -1, dtype=np.int32)     # -1 = unset
        self.released = np.zeros(s, dtype=bool)
        self.jitter_s = np.zeros(s, dtype=np.float64)
        self._last_transit = np.zeros(s, dtype=np.float64)
        self._has_transit = np.zeros(s, dtype=bool)
        self.lost = np.zeros(s, dtype=np.int64)
        self.late_dropped = np.zeros(s, dtype=np.int64)
        self.overwritten = np.zeros(s, dtype=np.int64)

        self._occ = np.zeros((s, depth), dtype=bool)
        self._slot_seq = np.zeros((s, depth), dtype=np.int32)
        self._arrival = np.zeros((s, depth), dtype=np.float64)
        self._plen = np.zeros((s, depth), dtype=np.int32)
        self._pay = np.zeros((s, depth, payload_cap), dtype=np.uint8)

    def configure_streams(self, sids, clock_rate=None, frame_ms=None
                          ) -> None:
        """Per-stream media clocks (codecs differ across a bridge)."""
        sids = np.asarray(sids, dtype=np.int64)
        if clock_rate is not None:
            self.clock_rate[sids] = clock_rate
        if frame_ms is not None:
            self.frame_s[sids] = np.asarray(frame_ms, np.float64) / 1000.0

    @property
    def target_delay(self) -> np.ndarray:
        return np.minimum(np.maximum(self.mult * self.jitter_s,
                                     self.min_delay), self.max_delay)

    # ---------------------------------------------------------------- insert
    def insert_batch(self, sids, seq, rtp_ts, payload: np.ndarray,
                     plen, now) -> None:
        """Insert a decrypted batch: sids/seq/rtp_ts/plen [B], payload
        [B, <=payload_cap], now scalar or [B] arrival times."""
        sids = np.asarray(sids, dtype=np.int64)
        b = len(sids)
        if b == 0:
            return
        seq = np.asarray(seq, dtype=np.int64) & 0xFFFF
        rtp_ts = np.asarray(rtp_ts, dtype=np.int64)
        plen = np.minimum(np.asarray(plen, dtype=np.int64),
                          self.payload_cap).astype(np.int32)
        payload = np.asarray(payload, dtype=np.uint8)[:, :self.payload_cap]
        now = np.broadcast_to(np.asarray(now, dtype=np.float64), (b,))

        # common case: one packet per stream -> a single wave, no sort
        if int(np.bincount(sids, minlength=1).max()) == 1:
            self._insert_wave(sids, seq, rtp_ts, payload, plen, now)
            return
        ranks = segment_ranks(sids)
        for r in range(int(ranks.max(initial=0)) + 1):
            rows = np.nonzero(ranks == r)[0]
            if len(rows) == 0:
                break
            self._insert_wave(sids[rows], seq[rows], rtp_ts[rows],
                              payload[rows], plen[rows], now[rows])

    def _insert_wave(self, s, q, ts, pay, pl, now) -> None:
        """One packet per stream (callers guarantee uniqueness).

        Tick-budget path: one gather per state array, flat [S*depth]
        views for the ring writes (a 2-array fancy index costs ~3x a
        flat one at 10k rows), and the rare-branch work (late drops,
        overwrites) only materialized when it occurs.
        """
        nsq = self.next_seq[s]
        unset = nsq < 0
        # delta is garbage on unset rows (nsq=-1) but `behind` masks them
        delta = seq_delta(q, nsq)
        behind = ~unset & (delta < 0)
        late = behind & self.released[s]
        if late.any():
            np.add.at(self.late_dropped, s[late], 1)
            keep = ~late
            s, q, ts = s[keep], q[keep], ts[keep]
            pay, pl, now = pay[keep], pl[keep], now[keep]
            nsq, unset, behind = nsq[keep], unset[keep], behind[keep]
            if len(s) == 0:
                return
        # unset rows adopt q; behind-but-not-released rows move back
        self.next_seq[s] = np.where(unset | behind, q,
                                    nsq).astype(np.int32)

        transit = now - ts / self.clock_rate[s]
        jit = self.jitter_s[s]
        d = np.abs(transit - self._last_transit[s])
        self.jitter_s[s] = np.where(self._has_transit[s],
                                    jit + (d - jit) / 16.0, jit)
        self._last_transit[s] = transit
        self._has_transit[s] = True

        flat = s * self.depth + (q & (self.depth - 1))
        occf = self._occ.reshape(-1)
        seqf = self._slot_seq.reshape(-1)
        occ_other = occf[flat] & (seqf[flat] != q)
        if occ_other.any():
            np.add.at(self.overwritten, s[occ_other], 1)
        occf[flat] = True
        seqf[flat] = q
        self._arrival.reshape(-1)[flat] = now
        self._plen.reshape(-1)[flat] = pl
        payf = self._pay.reshape(-1, self.payload_cap)
        w = pay.shape[1]
        if w == self.payload_cap:
            payf[flat] = pay
        else:
            payf[flat, :w] = pay
            payf[flat, w:] = 0

    # ------------------------------------------------------------------ pop
    def pop_all(self, now: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One decode tick for every stream: release the next in-order
        frame where due (same laws as the scalar pop, applied to all S
        at once).  Returns (ready [S] bool, payload [S, cap], plen [S]);
        streams with nothing due have ready=False.
        """
        ready = np.zeros(self.capacity, dtype=bool)
        out_pay = np.zeros((self.capacity, self.payload_cap), np.uint8)
        out_len = np.zeros(self.capacity, np.int32)
        target = self.target_delay
        occf = self._occ.reshape(-1)
        seqf = self._slot_seq.reshape(-1)
        arrf = self._arrival.reshape(-1)
        plenf = self._plen.reshape(-1)
        payf = self._pay.reshape(-1, self.payload_cap)
        s = np.nonzero(self.next_seq >= 0)[0]
        # Bounded gap-skip loop.  Only streams that *skipped* can make
        # progress in a later round (a released stream is done for this
        # tick; a hit-but-not-due or empty stream cannot change state
        # until `now` advances), so rounds after the first run on the
        # skip set only — round 1 is full-width, the rest are tiny.
        for _ in range(self.depth + 1):
            if len(s) == 0:
                break
            nq = self.next_seq[s].astype(np.int64)
            flat = s * self.depth + (nq & (self.depth - 1))
            hit = occf[flat] & (seqf[flat] == nq)
            due = hit & (now - arrf[flat] >= target[s] - 1e-6)
            if due.all() and len(s) == self.capacity:
                # every stream releases (steady-state tick): one gather,
                # no compress/scatter round trip
                ready[:] = True
                out_pay = payf[flat]
                out_len = plenf[flat]
                occf[flat] = False
                self.next_seq[:] = ((nq + 1) & 0xFFFF).astype(np.int32)
                self.released[:] = True
                return ready, out_pay, out_len
            if due.any():
                rel = s[due]
                rf = flat[due]
                ready[rel] = True
                out_pay[rel] = payf[rf]
                out_len[rel] = plenf[rf]
                occf[rf] = False
                self.next_seq[rel] = ((nq[due] + 1)
                                      & 0xFFFF).astype(np.int32)
                self.released[rel] = True

            # gap skip: buffer non-empty and its oldest waited out
            # target + one frame.  The scalar pop's recursion skips seq
            # by seq until it lands on a buffered one; since the oldest-
            # arrival condition stays true throughout, that is a jump
            # straight to the nearest buffered seq with the whole gap
            # counted lost — done here in one vector step so a large
            # sender jump doesn't stall for depth-bounded ticks.
            miss = s[~hit]
            sk = miss[:0]
            if len(miss):
                # empty-buffer streams (idle rows between ticks) exit
                # before the [M, depth] arrival scan
                miss = miss[self._occ[miss].any(axis=1)]
            if len(miss):
                occ = self._occ[miss]
                oldest = np.where(occ, self._arrival[miss],
                                  np.inf).min(axis=1)
                skip = (now - oldest
                        > target[miss] + self.frame_s[miss])
                sk = miss[skip]
                if len(sk):
                    d = seq_delta(self._slot_seq[sk],
                                  self.next_seq[sk][:, None])
                    d = np.where(self._occ[sk] & (d > 0), d,
                                 np.int32(1 << 16))
                    jump = d.min(axis=1).astype(np.int64)
                    ok_j = jump < (1 << 16)   # a buffered target exists
                    sk, jump = sk[ok_j], jump[ok_j]
                    self.lost[sk] += jump
                    self.next_seq[sk] = ((self.next_seq[sk]
                                          + jump) & 0xFFFF
                                         ).astype(np.int32)
            s = sk
        return ready, out_pay, out_len

    def depth_used(self) -> np.ndarray:
        return self._occ.sum(axis=1)

    def reset_streams(self, sids) -> None:
        """Clear per-stream state for (re)used rows — a new participant
        on a recycled sid must not inherit the previous occupant's
        sequence window, jitter estimate or counters."""
        s = np.asarray(sids, dtype=np.int64)
        self.next_seq[s] = -1
        self.released[s] = False
        self.jitter_s[s] = 0.0
        self._has_transit[s] = False
        self.lost[s] = 0
        self.late_dropped[s] = 0
        self.overwritten[s] = 0
        self._occ[s] = False

    # --------------------------------------------------------- checkpoint
    # (snapshot()/restore() from ArraySnapshotMixin; SURVEY §5: a
    # restarted worker resumes the playout sequence windows, or streams
    # glitch)
    _SNAP_FIELDS = ("clock_rate", "frame_s", "min_delay", "max_delay",
                    "mult", "next_seq", "released", "jitter_s",
                    "_last_transit", "_has_transit", "lost",
                    "late_dropped", "overwritten", "_occ", "_slot_seq",
                    "_arrival", "_plen", "_pay")

    def _snap_scalars(self) -> dict:
        return {"depth": self.depth, "payload_cap": self.payload_cap}

    @classmethod
    def _restore_kwargs(cls, snap: dict) -> dict:
        return {"capacity": len(snap["next_seq"]),
                "depth": snap["depth"],
                "payload_cap": snap["payload_cap"]}
