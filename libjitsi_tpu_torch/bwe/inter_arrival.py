"""Inter-arrival burst grouping (reference:
`...remotebitrateestimator.InterArrival`, WebRTC GCC §5.2).

Counterpart: `libjitsi_tpu/bwe/inter_arrival.py` (copied).

Packets whose send times fall in the same 5 ms window form one group;
the filterable signal is the per-group (send delta, arrival delta, size
delta) triple.  Out-of-order send times reset nothing — they are simply
ignored, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BURST_DELTA_THRESHOLD_MS = 5


@dataclasses.dataclass
class _Group:
    first_send_ms: float = 0.0
    send_ms: float = 0.0       # max send time in group
    arrival_ms: float = 0.0    # last arrival
    size: int = 0
    complete: bool = False


class InterArrival:
    def __init__(self, group_span_ms: float = BURST_DELTA_THRESHOLD_MS):
        self.span = group_span_ms
        self._cur: Optional[_Group] = None
        self._prev: Optional[_Group] = None

    def add(self, send_ms: float, arrival_ms: float, size: int
            ) -> Optional[Tuple[float, float, int]]:
        """Feed one packet; returns (send_delta_ms, arrival_delta_ms,
        size_delta) when a group completes, else None."""
        if self._cur is None:
            self._cur = _Group(send_ms, send_ms, arrival_ms, size)
            return None
        if send_ms < self._cur.first_send_ms:
            return None  # out-of-order send time: ignore
        if send_ms - self._cur.first_send_ms <= self.span:
            self._cur.send_ms = max(self._cur.send_ms, send_ms)
            self._cur.arrival_ms = arrival_ms
            self._cur.size += size
            return None
        # group completed
        out = None
        if self._prev is not None:
            send_delta = self._cur.send_ms - self._prev.send_ms
            arrival_delta = self._cur.arrival_ms - self._prev.arrival_ms
            size_delta = self._cur.size - self._prev.size
            if send_delta >= 0:
                out = (send_delta, arrival_delta, size_delta)
        self._prev = self._cur
        self._cur = _Group(send_ms, send_ms, arrival_ms, size)
        return out
