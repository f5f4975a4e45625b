"""Off-tick SRTP-GCM keystream pregeneration cache.

Counterpart: `libjitsi_tpu/transform/srtp/keystream.py` (`KeystreamCache`).

SRTP-GCM's per-packet AES work is fixed before the packet exists: the IV
is salt ^ (SSRC || ROC || SEQ) (RFC 7714 §8.1), so for an admitted stream
the CTR keystream and the E(K, J0) tag mask of the next packet indices
are functions of state the table already holds.  `fill()` computes them
between ticks into slot tables on the table's device (kernel O,
`csrc/gcm_fill.cu`, through `kernels.gcm.gcm_ks_fill`), and the tick's
protect and unprotect then run M's and N's cached instances on a window
hit: the XOR and the GHASH, no AES.

Sliding windows: each cached stream owns one pool row of `window` slots
addressed as a ring (slot = idx % window), valid while base <= idx < base
+ window; base is one past the stream's consumption frontier (the most of
its tx index, its rx high-water and the cache's own served high-water).

Never serve twice:
- within a window a per-slot consumed bitmap is checked under an
  all-or-nothing batch claim and set before the kernel runs; the same slot
  twice in one batch is a miss, unless the rows are exact aliases (the
  size-class padding's repeated rows), which share one serve;
- across slides and whole-cache invalidations the refill base starts past
  the per-stream served high-water, which lasts until the stream's keys
  change (`forget`), so one (key epoch, SSRC, index) keystream is claimed
  at most once;
- a miss (reorder past the window, a consumed slot, rekey, a new SSRC, a
  payload past `ks_bytes`, AADs that differ in a part) runs the stock
  kernels, byte for byte the same output, and serves nothing.

The GCM IV needs the wire SSRC, which the table does not keep: the cache
learns it per row from tick-path headers (`observe`) and fills only rows
whose SSRC it knows.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from libjitsi_tpu_torch.core.device import to_device
from libjitsi_tpu_torch.kernels import gcm


class KeystreamCache:
    """Sliding-window keystream pregeneration for one `SrtpStreamTable`
    (one direction).  The pool maps up to `pool` stream ids onto rows of
    `window` slots, each slot holding `ks_bytes` of CTR keystream and
    the 16-byte E(K, J0) tag mask of one packet index."""

    def __init__(self, table, window: int = 64, ks_bytes: int = 256,
                 pool: Optional[int] = None, debug: bool = False):
        if not getattr(table, "_gcm", False):
            raise ValueError("keystream cache requires an AEAD-GCM table")
        w = int(window)
        if w < 1 or w & (w - 1):
            raise ValueError("window must be a power of two")
        self.table = table
        self.window = w
        self.ks_bytes = (int(ks_bytes) + 15) & ~15
        cap = int(table.capacity)
        self.pool = int(pool) if pool is not None else min(cap, 128)
        self.debug = bool(debug)
        # stream <-> pool-row maps
        self._row = np.full(cap, -1, dtype=np.int32)
        self._row_stream = np.full(self.pool, -1, dtype=np.int64)
        self._free: List[int] = list(range(self.pool - 1, -1, -1))
        # per-row window state
        self.base = np.full(self.pool, -1, dtype=np.int64)
        self.consumed = np.zeros((self.pool, w), dtype=bool)
        self.ssrc = np.full(self.pool, -1, dtype=np.int64)
        # per-stream never-reuse state (survives whole-cache invalidation;
        # reset only when the stream's keys change)
        self._served_hi = np.full(cap, -1, dtype=np.int64)
        self._kgen = np.zeros(cap, dtype=np.int64)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.gen = 0
        self.fill_seconds = 0.0
        self.filled_slots = 0
        n = self.pool * w
        self._scratch_slot = n
        dev = table.device
        self._ks_tab = torch.zeros((n + 1, self.ks_bytes), dtype=torch.uint8,
                                   device=dev)
        self._ek_tab = torch.zeros((n + 1, 16), dtype=torch.uint8,
                                   device=dev)
        self._serve_log: Optional[list] = [] if debug else None

    # ------------------------------------------------------------ learn

    def observe(self, stream: np.ndarray, wire_ssrc: np.ndarray) -> None:
        """Learn per-row SSRCs from tick-path headers and give pool rows to
        first-seen streams while the pool lasts.  A row whose SSRC changes
        loses its window (it would decrypt nothing)."""
        stream = np.asarray(stream, dtype=np.int64)
        wire_ssrc = np.asarray(wire_ssrc, dtype=np.int64)
        rows = self._row[stream]
        if self._free and (rows < 0).any():
            for s in np.unique(stream[rows < 0]):
                if not self._free:
                    break
                s = int(s)
                if self._row[s] < 0 and self.table.active[s]:
                    r = self._free.pop()
                    self._row[s] = r
                    self._row_stream[r] = s
            rows = self._row[stream]
        ok = rows >= 0
        if not ok.any():
            return
        r = rows[ok]
        v = wire_ssrc[ok]
        cur = self.ssrc[r]
        changed = (cur >= 0) & (cur != v)
        if changed.any():
            for rc in np.unique(r[changed]):
                self._drop_window(int(rc))
        self.ssrc[r] = v

    def _drop_window(self, r: int) -> None:
        if self.base[r] >= 0:
            self.evictions += int((~self.consumed[r]).sum())
        self.base[r] = -1
        self.consumed[r, :] = False

    # ------------------------------------------------------------ serve

    def claim(self, stream, wire_ssrc, idx, ct_len, aad_ok: bool):
        """All-or-nothing window claim for one part.

        Returns (ks_tab, ek_tab, slot [n] int32) when every row hits; the
        slots are marked consumed first, so no slot is served to two
        different packets (exact alias rows of the size-class padding
        share one serve).  Else None, with the miss counter up by the
        part's rows."""
        n = len(stream)
        if n == 0 or not aad_ok:
            self.misses += n
            return None
        stream = np.asarray(stream, dtype=np.int64)
        cap = len(self._row)
        if ((stream < 0) | (stream >= cap)).any():
            self.misses += n
            return None
        wire_ssrc = np.asarray(wire_ssrc, dtype=np.int64)
        self.observe(stream, wire_ssrc)
        idx = np.asarray(idx, dtype=np.int64)
        ct = np.asarray(ct_len, dtype=np.int64)
        rows = self._row[stream]
        rows_s = np.clip(rows, 0, self.pool - 1)
        b = self.base[rows_s]
        off = idx - b
        pos = idx % self.window
        hit = ((rows >= 0) & (b >= 0)
               & (off >= 0) & (off < self.window)
               & (ct >= 0) & (ct <= self.ks_bytes)
               & (self.ssrc[rows_s] == wire_ssrc)
               & ~self.consumed[rows_s, pos])
        if not hit.all():
            self.misses += n
            return None
        flat = rows.astype(np.int64) * self.window + pos
        uniq, first, inv = np.unique(flat, return_index=True,
                                     return_inverse=True)
        sel = slice(None)
        if uniq.size != n:
            # the same slot twice: exact aliases (the padding's repeated
            # rows: same ssrc, index and length) share the one slot, as
            # the stock path gives them the same bytes; anything else
            # would pair one keystream with two plaintexts
            rep = first[inv]
            alias = ((idx == idx[rep]) & (ct == ct[rep])
                     & (wire_ssrc == wire_ssrc[rep]))
            if not alias.all():
                self.misses += n
                return None
            sel = np.sort(first)
        self.consumed[rows, pos] = True
        np.maximum.at(self._served_hi, stream, idx)
        self.hits += n
        if self._serve_log is not None:
            srv_s, srv_v, srv_i = stream[sel], wire_ssrc[sel], idx[sel]
            self._serve_log.extend(
                zip(self._kgen[srv_s].tolist(), srv_s.tolist(),
                    srv_v.tolist(), srv_i.tolist()))
        return self._ks_tab, self._ek_tab, flat.astype(np.int32)

    # ------------------------------------------------------------- fill

    def _frontier(self, s: int) -> int:
        t = self.table
        return int(max(t.tx_ext[s], t.rx_max[s], self._served_hi[s])) + 1

    def fill(self, max_slots: int = 4096) -> int:
        """Slide or refill every learned row's window up to its predicted
        frontier, between ticks, whole rows at a time, at most about
        `max_slots` slots.  Returns the number of slots generated."""
        pairs: List[Tuple[int, int]] = []
        w = self.window
        budget = max(int(max_slots), w)
        for r in np.nonzero(self._row_stream >= 0)[0]:
            r = int(r)
            if self.ssrc[r] < 0:
                continue
            s = int(self._row_stream[r])
            if not self.table.active[s]:
                continue
            want = self._frontier(s)
            b = int(self.base[r])
            if b < 0 or want >= b + w:
                need = range(want, want + w)
            elif want > b:
                need = range(b + w, want + w)
            else:
                continue
            # a row's window advances only with its slots' generation
            if pairs and len(pairs) + len(need) > budget:
                break
            if b < 0 or want >= b + w:
                if b >= 0:
                    self.evictions += int((~self.consumed[r]).sum())
                self.consumed[r, :] = False
            else:
                drop = np.arange(b, want) % w
                self.evictions += int((~self.consumed[r, drop]).sum())
                self.consumed[r, drop] = False
            self.base[r] = want
            pairs.extend((r, i) for i in need)
        if pairs:
            self._generate(pairs)
        return len(pairs)

    def prime(self, stream, wire_ssrc, start: Optional[int] = None) -> None:
        """Give rows, learn SSRCs and fill windows now.  `start` sets the
        base of every given stream (an rx-side cache primed for traffic
        whose indices are known)."""
        stream = np.asarray(stream, dtype=np.int64)
        wire_ssrc = np.asarray(wire_ssrc, dtype=np.int64)
        self.observe(stream, wire_ssrc)
        if start is None:
            self.fill(max_slots=len(np.unique(stream)) * self.window)
            return
        pairs: List[Tuple[int, int]] = []
        for s in np.unique(stream):
            r = int(self._row[int(s)])
            if r < 0:
                continue
            self._drop_window(r)
            self.base[r] = int(start)
            pairs.extend((r, i)
                         for i in range(int(start), int(start) + self.window))
        if pairs:
            self._generate(pairs)

    def _generate(self, pairs: List[Tuple[int, int]]) -> None:
        """One launch of kernel O over the (pool row, index) pairs."""
        t0 = time.perf_counter()
        tbl = self.table
        rows = np.asarray([p[0] for p in pairs], dtype=np.int64)
        idxs = np.asarray([p[1] for p in pairs], dtype=np.int64)
        streams = self._row_stream[rows]
        iv12 = gcm.srtp_gcm_iv(tbl._salt_rtp[streams], self.ssrc[rows], idxs)
        slot = (rows * self.window + (idxs % self.window)).astype(np.int32)
        d = tbl.device
        gcm.gcm_ks_fill(self._ks_tab, self._ek_tab, tbl._device_tables()[0],
                        to_device(streams.astype(np.int32), d),
                        to_device(iv12, d), to_device(slot, d))
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()
        self.filled_slots += len(pairs)
        self.fill_seconds += time.perf_counter() - t0

    # ------------------------------------------------------ invalidation

    def invalidate(self) -> None:
        """Drop every window (the table's key-mutation barrier calls
        this).  Windows refill between ticks; the per-stream served
        high-water stays, so a refilled window never covers an index the
        stream already consumed under the same keys."""
        live = self.base >= 0
        if live.any():
            self.evictions += int((~self.consumed[live]).sum())
        self.base[:] = -1
        self.consumed[:] = False
        self.gen += 1

    def forget(self, stream) -> None:
        """The streams' session keys changed (install, removal): their
        served high-water resets, as the new keys give other keystream
        for every index, and their pool rows are freed."""
        for s in np.atleast_1d(np.asarray(stream, dtype=np.int64)):
            s = int(s)
            if not (0 <= s < len(self._row)):
                continue
            self._kgen[s] += 1
            self._served_hi[s] = -1
            r = int(self._row[s])
            if r >= 0:
                self._drop_window(r)
                self._row[s] = -1
                self._row_stream[r] = -1
                self.ssrc[r] = -1
                self._free.append(r)

    def move(self, src, dst) -> None:
        """Row move: the keys at `src` now live at `dst`, so `dst` takes
        `src`'s served high-water and never-serve-twice holds across the
        rename."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int64))
        hi = self._served_hi[src].copy()
        self.forget(src)
        self.forget(dst)
        np.maximum.at(self._served_hi, dst, hi)

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "gen": self.gen,
            "filled_slots": self.filled_slots,
            "fill_seconds": round(self.fill_seconds, 6),
            "rows_live": int((self._row_stream >= 0).sum()),
            "window": self.window, "ks_bytes": self.ks_bytes,
            "pool": self.pool,
        }
