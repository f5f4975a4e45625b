"""Receive-side bandwidth estimator (reference:
`...remotebitrateestimator.RemoteBitrateEstimatorAbsSendTime`): packets
stamped with abs-send-time feed InterArrival -> Kalman OveruseEstimator
-> OveruseDetector -> AIMD; the result goes out as REMB.

Counterpart: `libjitsi_tpu/bwe/remote_estimator.py` (copied).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from libjitsi_tpu_torch.bwe.aimd import AimdRateControl
from libjitsi_tpu_torch.bwe.inter_arrival import InterArrival
from libjitsi_tpu_torch.bwe.overuse import OveruseDetector, OveruseEstimator
from libjitsi_tpu_torch.bwe.rate_stats import RateStatistics


def abs_send_time_to_ms(ast24: int) -> float:
    """24-bit 6.18 fixed-point seconds -> ms (wraps every 64 s)."""
    return (ast24 / float(1 << 18)) * 1000.0


class RemoteBitrateEstimator:
    """One estimator per transport (all SSRCs share the bottleneck)."""

    def __init__(self, min_bitrate_bps: float = 30_000,
                 start_bitrate_bps: float = 300_000):
        self._inter = InterArrival()
        self._est = OveruseEstimator()
        self._det = OveruseDetector()
        self._aimd = AimdRateControl(min_bitrate_bps, start_bitrate_bps)
        self._incoming = RateStatistics(window_ms=1000)
        self._last_send_ms: Optional[float] = None
        self._send_unwrapped = 0.0

    def _unwrap_send_ms(self, send_ms: float) -> float:
        """abs-send-time wraps every 64 s; unwrap against the last value."""
        if self._last_send_ms is None:
            self._last_send_ms = send_ms
            self._send_unwrapped = send_ms
            return self._send_unwrapped
        d = send_ms - self._last_send_ms
        if d < -32000:       # wrapped forward
            d += 64000
        elif d > 32000:      # out-of-order across the wrap
            d -= 64000
        self._last_send_ms = send_ms
        self._send_unwrapped += d
        return self._send_unwrapped

    def incoming_packet(self, arrival_ms: float, ast24: int, size: int
                        ) -> None:
        """Feed one media packet (arrival host time, abs-send-time stamp)."""
        self._incoming.update(size, int(arrival_ms))
        send_ms = self._unwrap_send_ms(abs_send_time_to_ms(ast24))
        deltas = self._inter.add(send_ms, arrival_ms, size)
        if deltas is None:
            return
        send_delta, arrival_delta, size_delta = deltas
        self._est.update(arrival_delta, send_delta, size_delta,
                         self._det.state)
        self._det.detect(self._est.offset, send_delta,
                         self._est.num_deltas, arrival_ms)

    def incoming_batch(self, arrival_ms, ast24, sizes) -> None:
        for a, s, z in zip(np.asarray(arrival_ms), np.asarray(ast24),
                           np.asarray(sizes)):
            self.incoming_packet(float(a), int(s), int(z))

    def update_estimate(self, now_ms: float) -> float:
        """Periodic tick -> current REMB bitrate (bps)."""
        return self._aimd.update(self._det.state,
                                 self._incoming.rate(int(now_ms)), now_ms)

    def set_rtt(self, rtt_ms: float) -> None:
        self._aimd.set_rtt(rtt_ms)

    @property
    def state(self) -> str:
        return self._det.state
