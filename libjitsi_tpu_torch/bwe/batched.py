"""Batched receive-side bandwidth estimation: T transports as arrays.

The scalar classes (`InterArrival`, `OveruseEstimator`, `OveruseDetector`,
`AimdRateControl`, `RateStatistics` — ports of the reference's
`...remotebitrateestimator.*`, themselves WebRTC GCC ports) are one
Python state machine per transport, driven per packet.  A bridge with
thousands of transports pays a Python-loop toll per packet; this bank
keeps every transport's state in `[T]` NumPy arrays and applies the same
update laws vectorized — the dense-state doctrine of the rest of the
framework (SURVEY §2.3's re-design note).

Equivalence: updates use the identical formulas in the identical order,
so results match the scalar classes to float rounding; the differential
test tests/test_dense_receive.py::test_batched_bwe_matches_scalar pins
it.  In-batch multi-packet
transports decompose into waves by per-transport rank, preserving
per-packet sequencing.

States are int codes here (vector-friendly): signal 0/1/2 =
normal/overusing/underusing; rate state 0/1/2 = hold/increase/decrease;
region 0/1 = multiplicative/additive.

Counterpart: `libjitsi_tpu/bwe/batched.py` (copied; host NumPy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.rtp_math import segment_ranks
from libjitsi_tpu_torch.utils.checkpoint import ArraySnapshotMixin

SIG_NORMAL, SIG_OVERUSING, SIG_UNDERUSING = 0, 1, 2
ST_HOLD, ST_INCREASE, ST_DECREASE = 0, 1, 2
RG_MULTIPLICATIVE, RG_ADDITIVE = 0, 1

_BURST_SPAN_MS = 5.0
_BETA = 0.85


class BatchedRemoteBitrateEstimator(ArraySnapshotMixin):
    """T independent GCC estimators in dense arrays."""

    def __init__(self, capacity: int, min_bitrate_bps: float = 30_000,
                 start_bitrate_bps: float = 300_000,
                 max_bitrate_bps: float = 30e6,
                 window_ms: int = 1000):
        t = capacity
        self.capacity = t
        # ---- abs-send-time unwrap
        self._last_send = np.zeros(t, dtype=np.float64)
        self._send_unwrapped = np.zeros(t, dtype=np.float64)
        self._has_send = np.zeros(t, dtype=bool)
        # ---- InterArrival groups
        self._g_has = np.zeros(t, dtype=bool)
        self._g_first_send = np.zeros(t, dtype=np.float64)
        self._g_send = np.zeros(t, dtype=np.float64)
        self._g_arrival = np.zeros(t, dtype=np.float64)
        self._g_size = np.zeros(t, dtype=np.int64)
        self._p_has = np.zeros(t, dtype=bool)
        self._p_send = np.zeros(t, dtype=np.float64)
        self._p_arrival = np.zeros(t, dtype=np.float64)
        self._p_size = np.zeros(t, dtype=np.int64)
        # ---- Kalman (OveruseEstimator)
        self.offset = np.zeros(t, dtype=np.float64)
        self._slope = np.full(t, 8.0 / 512.0, dtype=np.float64)
        self._e00 = np.full(t, 100.0, dtype=np.float64)
        self._e01 = np.zeros(t, dtype=np.float64)
        self._e10 = np.zeros(t, dtype=np.float64)
        self._e11 = np.full(t, 1e-1, dtype=np.float64)
        self._avg_noise = np.zeros(t, dtype=np.float64)
        self._var_noise = np.full(t, 50.0, dtype=np.float64)
        self.num_deltas = np.zeros(t, dtype=np.int64)
        # ---- detector
        self.threshold = np.full(t, 12.5, dtype=np.float64)
        self._last_update_ms = np.full(t, -1.0, dtype=np.float64)
        self._time_over_using = np.full(t, -1.0, dtype=np.float64)
        self._overuse_counter = np.zeros(t, dtype=np.int64)
        self.signal = np.zeros(t, dtype=np.int8)
        self._overuse_time_th = 10.0
        # ---- AIMD
        self.min_bitrate = float(min_bitrate_bps)
        self.max_bitrate = float(max_bitrate_bps)
        self.start_bitrate = float(start_bitrate_bps)
        self.bitrate = np.full(t, float(start_bitrate_bps),
                               dtype=np.float64)
        self.rate_state = np.zeros(t, dtype=np.int8)
        self.region = np.zeros(t, dtype=np.int8)
        self.rtt_ms = np.full(t, 200.0, dtype=np.float64)
        self._avg_max_kbps = np.full(t, -1.0, dtype=np.float64)
        self._var_max_kbps = np.full(t, 0.4, dtype=np.float64)
        self._last_change_ms = np.full(t, -1.0, dtype=np.float64)
        # ---- incoming rate window (erase-on-advance, running totals —
        # the scalar RateStatistics' incremental design, vectorized;
        # no full-window scan on the tick path)
        self.window_ms = window_ms
        self._buckets = np.zeros((t, window_ms), dtype=np.int64)
        self._win_total = np.zeros(t, dtype=np.int64)
        self._oldest_ms = np.full(t, -1, dtype=np.int64)

    def set_rtt(self, tids, rtt_ms) -> None:
        self.rtt_ms[np.asarray(tids, dtype=np.int64)] = rtt_ms

    def reset_rows(self, tids,
                   start_bitrate_bps: Optional[float] = None) -> None:
        """Return rows to their fresh state — a departing transport's
        Kalman/AIMD state must not leak into the next occupant of a
        recycled row."""
        if start_bitrate_bps is None:
            start_bitrate_bps = self.start_bitrate
        t = np.asarray(tids, dtype=np.int64)
        self._last_send[t] = 0.0
        self._send_unwrapped[t] = 0.0
        self._has_send[t] = False
        self._g_has[t] = False
        self._p_has[t] = False
        self.offset[t] = 0.0
        self._slope[t] = 8.0 / 512.0
        self._e00[t] = 100.0
        self._e01[t] = 0.0
        self._e10[t] = 0.0
        self._e11[t] = 1e-1
        self._avg_noise[t] = 0.0
        self._var_noise[t] = 50.0
        self.num_deltas[t] = 0
        self.threshold[t] = 12.5
        self._last_update_ms[t] = -1.0
        self._time_over_using[t] = -1.0
        self._overuse_counter[t] = 0
        self.signal[t] = SIG_NORMAL
        self.bitrate[t] = float(start_bitrate_bps)
        self.rate_state[t] = ST_HOLD
        self.region[t] = RG_MULTIPLICATIVE
        self.rtt_ms[t] = 200.0
        self._avg_max_kbps[t] = -1.0
        self._var_max_kbps[t] = 0.4
        self._last_change_ms[t] = -1.0
        self._buckets[t] = 0
        self._win_total[t] = 0
        self._oldest_ms[t] = -1

    # ------------------------------------------------------------- feeding
    def incoming_batch(self, tids, arrival_ms, ast24, sizes) -> None:
        """Feed a packet batch: tids [B] transport rows, arrival_ms [B]
        host arrival, ast24 [B] 24-bit abs-send-time, sizes [B] bytes.

        Fast path: a tick's batch carries many packets per transport,
        but the GCC arrival filter only *updates* on burst-group
        closures (5 ms send-time spans) — so within-group packets fold
        in one vectorized pass and the Python loop runs per group
        closure (1-2 per transport per tick), not per packet.  A batch
        whose arrivals span >= the rate window could alias its own
        bucket writes; that pathological shape routes through the exact
        per-packet wave path instead.
        """
        tids = np.asarray(tids, dtype=np.int64)
        b = len(tids)
        if b == 0:
            return
        arrival_ms = np.asarray(arrival_ms, dtype=np.float64)
        send_ms = (np.asarray(ast24, dtype=np.float64)
                   / float(1 << 18)) * 1000.0
        sizes = np.asarray(sizes, dtype=np.int64)
        if (b > 1 and float(arrival_ms.max()) - float(arrival_ms.min())
                >= self.window_ms - 1):
            self._incoming_waves(tids, arrival_ms, send_ms, sizes)
            return

        order = np.argsort(tids, kind="stable")
        t_s = tids[order]
        a_s = arrival_ms[order]
        s_s = send_ms[order]
        z_s = sizes[order]
        first = np.ones(b, dtype=bool)
        first[1:] = t_s[1:] != t_s[:-1]
        seg_start = np.nonzero(first)[0]
        seg_end = np.append(seg_start[1:], b)
        ut = t_s[seg_start]
        seg_id = np.repeat(np.arange(len(ut)), seg_end - seg_start)

        self._rate_update_batch(ut, seg_id, seg_start, seg_end, a_s, z_s)
        u = self._unwrap_batch(ut, seg_id, seg_start, seg_end, s_s)
        self._group_rounds(ut, seg_start, seg_end, u, a_s, z_s)

    def _incoming_waves(self, tids, arrival_ms, send_ms, sizes) -> None:
        """Exact per-packet order via rank waves (slow fallback)."""
        ranks = segment_ranks(tids)
        for r in range(int(ranks.max(initial=0)) + 1):
            rows = np.nonzero(ranks == r)[0]
            if len(rows) == 0:
                break
            self._packet_wave(tids[rows], arrival_ms[rows],
                              send_ms[rows], sizes[rows])

    def _rate_update_batch(self, ut, seg_id, seg_start, seg_end,
                           a_s, z_s) -> None:
        """Whole-batch form of per-packet `_rate_update`, bit-exact for
        batches spanning < window_ms (guarded by the caller).

        Per packet the scalar does: erase to now-W+1, init oldest on
        first sight, fold late packets into the oldest live bucket, add
        bytes.  With the span bound, the only in-batch interaction is a
        later packet's erase zeroing an earlier packet's bucket — which
        is exactly the set of packets whose effective time falls before
        the *final* window edge, so those are masked out instead of
        written and erased.
        """
        w = self.window_ms
        a_i = a_s.astype(np.int64)
        lo = int(a_i.min())
        # segmented running max of arrivals via a seg-keyed cummax (the
        # key makes later segments always dominate earlier ones)
        span1 = int(a_i.max()) - lo + 1
        enc = seg_id * np.int64(span1) + (a_i - lo)
        pref = (np.maximum.accumulate(enc)
                - seg_id * np.int64(span1)) + lo
        oldest_before = self._oldest_ms[ut]
        oldest_start = np.where(oldest_before >= 0, oldest_before,
                                a_i[seg_start])
        oldest_i = np.maximum(oldest_start[seg_id], pref - w + 1)
        now_eff = np.maximum(a_i, oldest_i)
        final_oldest = oldest_i[seg_end - 1]
        # pre-batch buckets: erase up to the final edge, then pin oldest
        # to the per-packet-equivalent end state (covers fresh rows the
        # erase can't see)
        self._erase_old(ut, pref[seg_end - 1])
        self._oldest_ms[ut] = final_oldest
        survive = now_eff >= final_oldest[seg_id]
        flat = ut[seg_id] * np.int64(w) + now_eff % w
        np.add.at(self._buckets.reshape(-1), flat[survive], z_s[survive])
        tot = np.bincount(seg_id[survive],
                          weights=z_s[survive].astype(np.float64),
                          minlength=len(ut))
        self._win_total[ut] += tot.astype(np.int64)

    def _unwrap_batch(self, ut, seg_id, seg_start, seg_end, s_s
                      ) -> np.ndarray:
        """Per-packet 64 s abs-send-time unwrap as a segmented prefix
        sum of wrapped deltas; returns unwrapped send [B]."""
        b = len(s_s)
        prev = np.empty(b, dtype=np.float64)
        prev[1:] = s_s[:-1]
        prev[seg_start] = self._last_send[ut]
        d = s_s - prev
        d = np.where(d < -32000, d + 64000,
                     np.where(d > 32000, d - 64000, d))
        fresh = ~self._has_send[ut]
        start = np.where(fresh, s_s[seg_start],
                         self._send_unwrapped[ut] + d[seg_start])
        d[seg_start] = 0.0
        c = np.cumsum(d)
        u = start[seg_id] + (c - c[seg_start][seg_id])
        self._send_unwrapped[ut] = u[seg_end - 1]
        self._last_send[ut] = s_s[seg_end - 1]
        self._has_send[ut] = True
        return u

    def _group_rounds(self, ut, seg_start, seg_end, u, a_s, z_s
                      ) -> None:
        """InterArrival group bookkeeping, one Python round per group
        *closure* instead of per packet: each round folds every
        transport's maximal run of in-group/out-of-order packets in one
        vector pass, then performs the (Kalman + detector) closure for
        transports whose next packet opens a new group."""
        big = np.int64(1) << 60
        h = seg_start.copy()
        act = np.nonzero(h < seg_end)[0]
        while len(act):
            t_a = ut[act]
            nog = ~self._g_has[t_a]
            if nog.any():
                rows = h[act[nog]]
                tn = t_a[nog]
                self._g_has[tn] = True
                self._g_first_send[tn] = u[rows]
                self._g_send[tn] = u[rows]
                self._g_arrival[tn] = a_s[rows]
                self._g_size[tn] = z_s[rows]
                h[act[nog]] += 1
                act = act[h[act] < seg_end[act]]
                if len(act) == 0:
                    break
                t_a = ut[act]
            lens = seg_end[act] - h[act]
            offs = np.zeros(len(act), dtype=np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            ar = (np.arange(int(lens.sum()), dtype=np.int64)
                  - np.repeat(offs, lens))
            idx = np.repeat(h[act], lens) + ar
            sid = np.repeat(np.arange(len(act)), lens)
            su = u[idx]
            gf = self._g_first_send[t_a][sid]
            ooo = su < gf                      # out-of-order: ignored
            close = ~ooo & (su - gf > _BURST_SPAN_MS)
            firstclose = np.minimum.reduceat(
                np.where(close, ar, big), offs)
            consumed = ar < firstclose[sid]
            ing = consumed & ~ooo
            if ing.any():
                gmax = np.maximum.reduceat(
                    np.where(ing, su, -np.inf), offs)
                lpos = np.maximum.reduceat(
                    np.where(ing, ar, np.int64(-1)), offs)
                zsum = np.add.reduceat(np.where(ing, z_s[idx], 0), offs)
                hasin = lpos >= 0
                tf = t_a[hasin]
                self._g_send[tf] = np.maximum(self._g_send[tf],
                                              gmax[hasin])
                self._g_arrival[tf] = a_s[h[act[hasin]] + lpos[hasin]]
                self._g_size[tf] += zsum[hasin]
            closing = firstclose < lens
            newh = h[act] + np.minimum(firstclose, lens)
            if closing.any():
                ci = act[closing]
                rows = h[ci] + firstclose[closing]
                tc = ut[ci]
                sg, ag, zg = u[rows], a_s[rows], z_s[rows]
                have_prev = self._p_has[tc]
                send_delta = self._g_send[tc] - self._p_send[tc]
                arr_delta = self._g_arrival[tc] - self._p_arrival[tc]
                size_delta = self._g_size[tc] - self._p_size[tc]
                fm = have_prev & (send_delta >= 0)
                self._p_has[tc] = True
                self._p_send[tc] = self._g_send[tc]
                self._p_arrival[tc] = self._g_arrival[tc]
                self._p_size[tc] = self._g_size[tc]
                self._g_first_send[tc] = sg
                self._g_send[tc] = sg
                self._g_arrival[tc] = ag
                self._g_size[tc] = zg
                if fm.any():
                    filt = tc[fm]
                    self._kalman_update(filt, arr_delta[fm],
                                        send_delta[fm],
                                        size_delta[fm].astype(
                                            np.float64))
                    self._detect(filt, send_delta[fm], ag[fm])
                newh[closing] += 1
            h[act] = newh
            act = np.nonzero(h < seg_end)[0]

    def _packet_wave(self, t, arrival, send, size) -> None:
        """One packet per transport."""
        self._rate_update(t, size, arrival.astype(np.int64))

        # unwrap 64 s abs-send-time circle against the last value
        fresh = ~self._has_send[t]
        d = send - self._last_send[t]
        d = np.where(d < -32000, d + 64000,
                     np.where(d > 32000, d - 64000, d))
        unwrapped = np.where(fresh, send, self._send_unwrapped[t] + d)
        self._send_unwrapped[t] = unwrapped
        self._last_send[t] = send
        self._has_send[t] = True
        send = unwrapped

        # ---- InterArrival group bookkeeping
        no_group = ~self._g_has[t]
        n = t[no_group]
        self._g_has[n] = True
        self._g_first_send[n] = send[no_group]
        self._g_send[n] = send[no_group]
        self._g_arrival[n] = arrival[no_group]
        self._g_size[n] = size[no_group]

        g = ~no_group
        tg, sg, ag, zg = t[g], send[g], arrival[g], size[g]
        ooo = sg < self._g_first_send[tg]            # out-of-order: ignore
        in_group = ~ooo & (sg - self._g_first_send[tg] <= _BURST_SPAN_MS)
        ti = tg[in_group]
        self._g_send[ti] = np.maximum(self._g_send[ti], sg[in_group])
        self._g_arrival[ti] = ag[in_group]
        self._g_size[ti] += zg[in_group]

        closes = ~ooo & ~in_group
        tc = tg[closes]
        if len(tc):
            have_prev = self._p_has[tc]
            send_delta = self._g_send[tc] - self._p_send[tc]
            arr_delta = self._g_arrival[tc] - self._p_arrival[tc]
            size_delta = self._g_size[tc] - self._p_size[tc]
            filt = tc[have_prev & (send_delta >= 0)]
            fm = have_prev & (send_delta >= 0)
            # previous <- current, current <- new packet
            self._p_has[tc] = True
            self._p_send[tc] = self._g_send[tc]
            self._p_arrival[tc] = self._g_arrival[tc]
            self._p_size[tc] = self._g_size[tc]
            self._g_first_send[tc] = sg[closes]
            self._g_send[tc] = sg[closes]
            self._g_arrival[tc] = ag[closes]
            self._g_size[tc] = zg[closes]
            if len(filt):
                self._kalman_update(filt, arr_delta[fm], send_delta[fm],
                                    size_delta[fm].astype(np.float64))
                self._detect(filt, send_delta[fm], ag[closes][fm])

    # --------------------------------------------------------------- kalman
    def _kalman_update(self, t, t_delta, ts_delta, fs_delta) -> None:
        """OveruseEstimator.update, vectorized over the closing rows."""
        self.num_deltas[t] = np.minimum(self.num_deltas[t] + 1, 60)
        t_ts_delta = t_delta - ts_delta

        e00, e01 = self._e00[t], self._e01[t]
        e10, e11 = self._e10[t], self._e11[t]
        e00 = e00 + 1e-13
        e11 = e11 + 1e-3
        sig = self.signal[t]
        off = self.offset[t]
        unstable = ((sig == SIG_OVERUSING) & (off < 0)) | \
                   ((sig == SIG_UNDERUSING) & (off > 0))
        e11 = e11 + np.where(unstable, 10 * 1e-3, 0.0)

        h0, h1 = fs_delta, 1.0
        eh0 = e00 * h0 + e01 * h1
        eh1 = e10 * h0 + e11 * h1
        residual = t_ts_delta - self._slope[t] * h0 - off

        max_residual = 3.0 * np.sqrt(self._var_noise[t])
        in_stable = np.abs(residual) < max_residual
        shaped = np.where(in_stable, residual,
                          np.copysign(max_residual, residual))
        self._update_noise(t, ts_delta, shaped)

        denom = self._var_noise[t] + (h0 * eh0 + h1 * eh1)
        k0, k1 = eh0 / denom, eh1 / denom
        ikh00 = 1.0 - k0 * h0
        ikh01 = -k0 * h1
        ikh10 = -k1 * h0
        ikh11 = 1.0 - k1 * h1
        n00 = e00 * ikh00 + e10 * ikh01
        n01 = e01 * ikh00 + e11 * ikh01
        n10 = e00 * ikh10 + e10 * ikh11
        n11 = e01 * ikh10 + e11 * ikh11
        self._e00[t], self._e01[t] = n00, n01
        self._e10[t], self._e11[t] = n10, n11
        self._slope[t] += k0 * residual
        self.offset[t] = off + k1 * residual

    def _update_noise(self, t, ts_delta, residual) -> None:
        norm = self.signal[t] == SIG_NORMAL
        alpha = np.where(ts_delta > 0,
                         np.power(0.01, np.maximum(ts_delta, 0) / 30.0),
                         0.0)
        alpha = np.clip(alpha, 0.0, 1.0)
        avg = alpha * self._avg_noise[t] + (1 - alpha) * residual
        var = alpha * self._var_noise[t] + (1 - alpha) * (
            residual - avg) ** 2
        var = np.maximum(var, 1.0)
        self._avg_noise[t] = np.where(norm, avg, self._avg_noise[t])
        self._var_noise[t] = np.where(norm, var, self._var_noise[t])

    # -------------------------------------------------------------- detect
    def _detect(self, t, ts_delta, now_ms) -> None:
        nd = self.num_deltas[t]
        enough = nd >= 2
        tt = np.minimum(nd, 60) * self.offset[t]
        over = tt > self.threshold[t]
        under = tt < -self.threshold[t]

        tou = self._time_over_using[t]
        tou = np.where(over, np.where(tou == -1, ts_delta / 2,
                                      tou + ts_delta), -1.0)
        cnt = np.where(over, self._overuse_counter[t] + 1, 0)
        trip = over & (tou > self._overuse_time_th) & (cnt > 1)
        sig = self.signal[t]
        new_sig = np.where(trip, SIG_OVERUSING,
                           np.where(under, SIG_UNDERUSING,
                                    np.where(over, sig, SIG_NORMAL)))
        self._time_over_using[t] = np.where(enough, tou,
                                            self._time_over_using[t])
        self._overuse_counter[t] = np.where(enough, cnt,
                                            self._overuse_counter[t])
        self.signal[t] = np.where(enough, new_sig, sig).astype(np.int8)

        # adaptive threshold
        lu_orig = self._last_update_ms[t]
        lu = np.where(lu_orig < 0, now_ms, lu_orig)
        far = np.abs(tt) > self.threshold[t] + 15.0
        k = np.where(np.abs(tt) < self.threshold[t], 0.039, 0.0087)
        dt = np.clip(now_ms - lu, 0.0, 100.0)
        new_th = self.threshold[t] + k * (np.abs(tt)
                                          - self.threshold[t]) * dt
        new_th = np.clip(new_th, 6.0, 600.0)
        self.threshold[t] = np.where(enough & ~far, new_th,
                                     self.threshold[t])
        self._last_update_ms[t] = np.where(enough, now_ms, lu_orig)

    # ------------------------------------------------------------ rate win
    def _erase_old(self, t, now_ms) -> None:
        """Advance each transport's window edge to now-window+1,
        subtracting the outgoing buckets (vectorized form of the scalar
        _erase_old; the partial-erase loop is bounded by the largest
        advance, typically the tick interval in ms)."""
        seen = self._oldest_ms[t] >= 0
        new_oldest = np.asarray(now_ms) - self.window_ms + 1
        adv = np.where(seen,
                       np.clip(new_oldest - self._oldest_ms[t], 0, None),
                       0)
        full = adv >= self.window_ms
        ft = t[full]
        if len(ft):
            self._buckets[ft] = 0
            self._win_total[ft] = 0
        part = np.nonzero(~full & (adv > 0))[0]
        if len(part):
            # ragged zeroing: all outgoing buckets of all rows at once
            # (advance < window, so each row's range hits distinct slots)
            tp = t[part]
            start = self._oldest_ms[tp]
            n = np.asarray(adv[part], dtype=np.int64)
            offs = np.zeros(len(part), dtype=np.int64)
            np.cumsum(n[:-1], out=offs[1:])
            ar = (np.arange(int(n.sum()), dtype=np.int64)
                  - np.repeat(offs, n))
            flat = (np.repeat(tp, n) * np.int64(self.window_ms)
                    + (np.repeat(start, n) + ar) % self.window_ms)
            bf = self._buckets.reshape(-1)
            gone = bf[flat]
            self._win_total[tp] -= np.add.reduceat(gone, offs)
            bf[flat] = 0
        upd = adv > 0
        self._oldest_ms[t] = np.where(
            upd, np.broadcast_to(new_oldest, adv.shape),
            self._oldest_ms[t])

    def _rate_update(self, t, nbytes, now_ms) -> None:
        self._erase_old(t, now_ms)
        first = self._oldest_ms[t] < 0
        self._oldest_ms[t] = np.where(first, now_ms, self._oldest_ms[t])
        # late packet: fold into the oldest live bucket (scalar rule)
        now_eff = np.maximum(now_ms, self._oldest_ms[t])
        idx = now_eff % self.window_ms
        self._buckets[t, idx] += nbytes
        self._win_total[t] += nbytes

    def incoming_rate(self, now_ms: int) -> np.ndarray:
        """Windowed receive rate, bits/sec, all T transports (O(T) via
        the running totals; the erase keeps them window-exact)."""
        now_ms = int(now_ms)
        self._erase_old(np.arange(self.capacity), now_ms)
        seen = self._oldest_ms >= 0
        active = np.where(seen,
                          np.clip(now_ms - self._oldest_ms + 1, 1,
                                  self.window_ms),
                          1)
        return self._win_total * 8000.0 / active

    # ---------------------------------------------------------------- aimd
    def update_estimate(self, now_ms: float) -> np.ndarray:
        """Periodic GCC tick for every transport -> REMB bitrates [T]."""
        sig = self.signal
        st = self.rate_state.copy()
        st = np.where((sig == SIG_NORMAL) & (st == ST_HOLD),
                      ST_INCREASE, st)
        st = np.where(sig == SIG_OVERUSING, ST_DECREASE, st)
        st = np.where(sig == SIG_UNDERUSING, ST_HOLD, st)

        lc = self._last_change_ms
        lc = np.where(lc < 0, now_ms, lc)
        dt = now_ms - lc
        self._last_change_ms[:] = now_ms

        incoming = self.incoming_rate(int(now_ms))
        rate = self.bitrate.copy()

        inc = st == ST_INCREASE
        mul = inc & (self.region == RG_MULTIPLICATIVE)
        factor = np.minimum(np.power(1.08, np.minimum(dt / 1000.0, 1.0)),
                            1.5)
        rate = np.where(mul, rate * factor, rate)
        add = inc & (self.region == RG_ADDITIVE)
        response_ms = 100.0 + self.rtt_ms
        alpha = 0.5 * np.minimum(dt / response_ms, 1.0)
        rate = np.where(add, rate + np.maximum(1000.0, alpha * 8 * 1200),
                        rate)

        dec = st == ST_DECREASE
        rate = np.where(dec, _BETA * incoming, rate)
        # max-estimate EWMA on decrease
        sample = incoming / 1000.0
        d = self._avg_max_kbps < 0
        avg = np.where(d, sample,
                       0.95 * self._avg_max_kbps + 0.05 * sample)
        norm = np.maximum(avg, 1.0)
        dev = (sample - avg) ** 2 / norm
        var = np.clip(0.95 * self._var_max_kbps + 0.05 * dev, 0.4, 2.5)
        self._avg_max_kbps = np.where(dec, avg, self._avg_max_kbps)
        self._var_max_kbps = np.where(dec, var, self._var_max_kbps)
        self.region = np.where(dec, RG_ADDITIVE, self.region
                               ).astype(np.int8)
        st = np.where(dec, ST_HOLD, st)

        # back to multiplicative far above the max estimate
        has_max = self._avg_max_kbps >= 0
        sigma = np.sqrt(np.maximum(self._var_max_kbps
                                   * self._avg_max_kbps, 0.0))
        above = has_max & (rate / 1000.0
                           > self._avg_max_kbps + 3 * sigma)
        self.region = np.where(above, RG_MULTIPLICATIVE, self.region
                               ).astype(np.int8)
        self._avg_max_kbps = np.where(above, -1.0, self._avg_max_kbps)

        self.bitrate = np.clip(rate, self.min_bitrate, self.max_bitrate)
        self.rate_state = st.astype(np.int8)
        return self.bitrate

    # --------------------------------------------------------- checkpoint
    # (snapshot()/restore() from ArraySnapshotMixin; SURVEY §5: a
    # restarted worker must not re-probe bandwidth from the start
    # bitrate and overload already-congested links)
    _SNAP_FIELDS = (
        "_last_send", "_send_unwrapped", "_has_send", "_g_has",
        "_g_first_send", "_g_send", "_g_arrival", "_g_size", "_p_has",
        "_p_send", "_p_arrival", "_p_size", "offset", "_slope", "_e00",
        "_e01", "_e10", "_e11", "_avg_noise", "_var_noise", "num_deltas",
        "threshold", "_last_update_ms", "_time_over_using",
        "_overuse_counter", "signal", "bitrate", "rate_state", "region",
        "rtt_ms", "_avg_max_kbps", "_var_max_kbps", "_last_change_ms",
        "_buckets", "_win_total", "_oldest_ms")

    def _snap_scalars(self) -> dict:
        return {"window_ms": self.window_ms,
                "min_bitrate": self.min_bitrate,
                "max_bitrate": self.max_bitrate,
                "start_bitrate": self.start_bitrate}

    @classmethod
    def _restore_kwargs(cls, snap: dict) -> dict:
        return {"capacity": len(snap["offset"]),
                "min_bitrate_bps": snap["min_bitrate"],
                "max_bitrate_bps": snap["max_bitrate"],
                "start_bitrate_bps": snap.get("start_bitrate", 300_000),
                "window_ms": snap["window_ms"]}
