"""AIMD rate control (reference:
`...remotebitrateestimator.AimdRateControl` — WebRTC GCC's
increase/hold/decrease state machine).

Counterpart: `libjitsi_tpu/bwe/aimd.py` (copied).
"""

from __future__ import annotations

from libjitsi_tpu_torch.bwe.overuse import NORMAL, OVERUSING, UNDERUSING

HOLD, INCREASE, DECREASE = "hold", "increase", "decrease"
MULTIPLICATIVE, ADDITIVE = "multiplicative", "additive"

BETA = 0.85
DEFAULT_RTT_MS = 200.0


class AimdRateControl:
    def __init__(self, min_bitrate_bps: float = 30_000,
                 start_bitrate_bps: float = 300_000,
                 max_bitrate_bps: float = 30e6):
        self.min_bitrate = min_bitrate_bps
        self.max_bitrate = max_bitrate_bps
        self.bitrate = start_bitrate_bps
        self.state = HOLD
        self.region = MULTIPLICATIVE
        self.rtt_ms = DEFAULT_RTT_MS
        self._avg_max_bitrate_kbps = -1.0
        self._var_max_bitrate_kbps = 0.4
        self._last_change_ms = -1.0
        self._inited = False

    def set_rtt(self, rtt_ms: float) -> None:
        self.rtt_ms = rtt_ms

    def update(self, signal: str, incoming_bitrate_bps: float,
               now_ms: float) -> float:
        """One GCC tick: map the detector signal to the rate state
        machine and move the target bitrate."""
        # state transitions (reference: AimdRateControl.changeState)
        if signal == NORMAL:
            if self.state == HOLD:
                self.state = INCREASE
        elif signal == OVERUSING:
            self.state = DECREASE
        elif signal == UNDERUSING:
            self.state = HOLD

        if self._last_change_ms < 0:
            self._last_change_ms = now_ms
        dt = now_ms - self._last_change_ms
        self._last_change_ms = now_ms

        if self.state == INCREASE:
            if self.region == MULTIPLICATIVE:
                factor = min(1.08 ** min(dt / 1000.0, 1.0), 1.5)
                self.bitrate *= factor
            else:
                # additive: ~ one packet per response time
                response_ms = 100.0 + self.rtt_ms
                alpha = 0.5 * min(dt / response_ms, 1.0)
                packet_bits = 8 * 1200
                self.bitrate += max(1000.0, alpha * packet_bits)
            self._inited = True
        elif self.state == DECREASE:
            self.bitrate = BETA * incoming_bitrate_bps
            self._update_max_estimate(incoming_bitrate_bps / 1000.0)
            # near the observed max: switch to cautious additive increase
            self.region = ADDITIVE
            self.state = HOLD
        # hold: no change

        # switch back to multiplicative when far below the max estimate
        if self._avg_max_bitrate_kbps >= 0:
            sigma = (self._var_max_bitrate_kbps *
                     self._avg_max_bitrate_kbps) ** 0.5
            if self.bitrate / 1000.0 > self._avg_max_bitrate_kbps + 3 * sigma:
                self.region = MULTIPLICATIVE
                self._avg_max_bitrate_kbps = -1.0

        self.bitrate = min(max(self.bitrate, self.min_bitrate),
                           self.max_bitrate)
        return self.bitrate

    def _update_max_estimate(self, sample_kbps: float) -> None:
        alpha = 0.05
        if self._avg_max_bitrate_kbps < 0:
            self._avg_max_bitrate_kbps = sample_kbps
        else:
            self._avg_max_bitrate_kbps = (
                (1 - alpha) * self._avg_max_bitrate_kbps +
                alpha * sample_kbps)
        norm = max(self._avg_max_bitrate_kbps, 1.0)
        dev = (sample_kbps - self._avg_max_bitrate_kbps) ** 2 / norm
        self._var_max_bitrate_kbps = min(max(
            (1 - alpha) * self._var_max_bitrate_kbps + alpha * dev,
            0.4), 2.5)
