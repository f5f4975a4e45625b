"""Sliding-window rate counter (reference:
`org.jitsi.impl.neomedia.rtp.remotebitrateestimator.RateStatistics`, a
port of webrtc/modules/remote_bitrate_estimator's rate_statistics).

Counterpart: `libjitsi_tpu/bwe/rate_stats.py` (copied).
"""

from __future__ import annotations

import numpy as np


class RateStatistics:
    """Bytes-per-window -> bits/sec over a ms-bucketed circular window."""

    def __init__(self, window_ms: int = 1000, scale: float = 8000.0):
        self.window_ms = window_ms
        self.scale = scale  # converts bytes/window to bits/sec
        self._buckets = np.zeros(window_ms, dtype=np.int64)
        self._total = 0
        self._oldest_ms = -1

    def update(self, nbytes: int, now_ms: int) -> None:
        if self._oldest_ms < 0:
            self._oldest_ms = now_ms
        self._erase_old(now_ms)
        if now_ms < self._oldest_ms:       # very late packet: fold into oldest
            now_ms = self._oldest_ms
        self._buckets[now_ms % self.window_ms] += nbytes
        self._total += nbytes

    def rate(self, now_ms: int) -> float:
        """Current rate in bits/sec."""
        self._erase_old(now_ms)
        active = min(max(now_ms - self._oldest_ms + 1, 1), self.window_ms) \
            if self._oldest_ms >= 0 else 1
        return self._total * self.scale / active

    def _erase_old(self, now_ms: int) -> None:
        if self._oldest_ms < 0:
            return
        new_oldest = now_ms - self.window_ms + 1
        if new_oldest <= self._oldest_ms:
            return
        if new_oldest - self._oldest_ms >= self.window_ms:
            self._buckets[:] = 0
            self._total = 0
        else:
            for t in range(self._oldest_ms, new_oldest):
                b = t % self.window_ms
                self._total -= self._buckets[b]
                self._buckets[b] = 0
        self._oldest_ms = new_oldest
