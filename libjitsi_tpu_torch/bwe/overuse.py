"""Over-use estimation + detection (reference:
`...remotebitrateestimator.{OveruseEstimator,OveruseDetector}` — the
WebRTC Kalman filter over the one-way-delay gradient and the adaptive
threshold detector).

Counterpart: `libjitsi_tpu/bwe/overuse.py` (copied).
"""

from __future__ import annotations

import math


NORMAL, OVERUSING, UNDERUSING = "normal", "overusing", "underusing"


class OveruseEstimator:
    """Kalman filter on [offset_ms, slope]; tracks the queuing-delay
    gradient m(t) from per-group (send_delta, arrival_delta)."""

    def __init__(self):
        self.offset = 0.0            # estimated delay gradient (ms)
        self._slope = 8.0 / 512.0
        self._e = [[100.0, 0.0], [0.0, 1e-1]]
        self._process_noise = [1e-13, 1e-3]
        self._avg_noise = 0.0
        self._var_noise = 50.0
        self.num_deltas = 0

    def update(self, t_delta_ms: float, ts_delta_ms: float,
               size_delta: int, state: str) -> None:
        min_frame_period = ts_delta_ms
        self.num_deltas = min(self.num_deltas + 1, 60)
        t_ts_delta = t_delta_ms - ts_delta_ms
        fs_delta = float(size_delta)

        # propagate covariance
        e = self._e
        e[0][0] += self._process_noise[0]
        e[1][1] += self._process_noise[1]
        if state == OVERUSING and self.offset < 0 or \
           state == UNDERUSING and self.offset > 0:
            e[1][1] += 10 * self._process_noise[1]

        h = [fs_delta, 1.0]
        eh = [e[0][0] * h[0] + e[0][1] * h[1],
              e[1][0] * h[0] + e[1][1] * h[1]]
        residual = t_ts_delta - self._slope * h[0] - self.offset

        max_residual = 3.0 * math.sqrt(self._var_noise)
        in_stable = abs(residual) < max_residual
        self._update_noise(min_frame_period,
                           residual if in_stable else
                           math.copysign(max_residual, residual), state)

        denom = self._var_noise + (h[0] * eh[0] + h[1] * eh[1])
        k = [eh[0] / denom, eh[1] / denom]
        ikh = [[1.0 - k[0] * h[0], -k[0] * h[1]],
               [-k[1] * h[0], 1.0 - k[1] * h[1]]]
        e00, e01 = e[0]
        e10, e11 = e[1]
        e[0][0] = e00 * ikh[0][0] + e10 * ikh[0][1]
        e[0][1] = e01 * ikh[0][0] + e11 * ikh[0][1]
        e[1][0] = e00 * ikh[1][0] + e10 * ikh[1][1]
        e[1][1] = e01 * ikh[1][0] + e11 * ikh[1][1]

        self._slope += k[0] * residual
        self.offset += k[1] * residual

    def _update_noise(self, ts_delta: float, residual: float,
                      state: str) -> None:
        if state != NORMAL:
            return
        alpha = 0.01 ** (ts_delta / 30.0) if ts_delta > 0 else 0.0
        alpha = min(max(alpha, 0.0), 1.0)
        self._avg_noise = alpha * self._avg_noise + (1 - alpha) * residual
        self._var_noise = alpha * self._var_noise + (1 - alpha) * (
            residual - self._avg_noise) ** 2
        self._var_noise = max(self._var_noise, 1.0)


class OveruseDetector:
    """Adaptive-threshold comparison of the estimator's offset
    (WebRTC's 'adaptive threshold' kup/kdown gains)."""

    def __init__(self, overuse_time_th_ms: float = 10.0):
        self.threshold = 12.5
        self._last_update_ms: float = -1.0
        self._time_over_using = -1.0
        self._overuse_counter = 0
        self.state = NORMAL
        self._overuse_time_th = overuse_time_th_ms

    def detect(self, offset: float, ts_delta_ms: float, num_deltas: int,
               now_ms: float) -> str:
        if num_deltas < 2:
            return NORMAL
        t = min(num_deltas, 60) * offset
        if t > self.threshold:
            if self._time_over_using == -1:
                self._time_over_using = ts_delta_ms / 2
            else:
                self._time_over_using += ts_delta_ms
            self._overuse_counter += 1
            if self._time_over_using > self._overuse_time_th and \
               self._overuse_counter > 1:
                self.state = OVERUSING
        elif t < -self.threshold:
            self._time_over_using = -1
            self._overuse_counter = 0
            self.state = UNDERUSING
        else:
            self._time_over_using = -1
            self._overuse_counter = 0
            self.state = NORMAL
        self._adapt(t, now_ms)
        return self.state

    def _adapt(self, t: float, now_ms: float) -> None:
        if self._last_update_ms < 0:
            self._last_update_ms = now_ms
        if abs(t) > self.threshold + 15.0:
            self._last_update_ms = now_ms
            return
        # kDown (fast decay toward |t| when below), kUp (slow growth above)
        k = 0.039 if abs(t) < self.threshold else 0.0087
        dt = min(max(now_ms - self._last_update_ms, 0.0), 100.0)
        self.threshold += k * (abs(t) - self.threshold) * dt
        self.threshold = min(max(self.threshold, 6.0), 600.0)
        self._last_update_ms = now_ms
