"""MediaStreamStats2-shaped pull API over the dense stats arrays.

Counterpart: `libjitsi_tpu/rtp/stats2.py` (copied).

The reference exposes per-track pull statistics
(`org.jitsi.service.neomedia.stats.{MediaStreamStats2,TrackStats,
SendTrackStats,ReceiveTrackStats}`, SURVEY §2.3): packet/byte totals,
recent packet/bit rates, jitter, RTT, loss.  Here a "track" is a stream
row (one SSRC direction pair), the totals already live in
`StreamStatsTable`'s dense arrays, and the rates come from a poller that
differences snapshots — so polling 10k streams is a handful of array
subtractions, not 10k object traversals.

`StatsPoller.poll()` refreshes the rate window for ALL rows at once;
`send_stats(sid)` / `receive_stats(sid)` build the per-track views.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from libjitsi_tpu_torch.rtp.stats import StreamStatsTable


@dataclasses.dataclass
class SendTrackStats:
    """Reference: `stats.SendTrackStats` (+ TrackStats base)."""

    sid: int
    packets: int
    bytes: int
    packet_rate_pps: float
    bitrate_bps: float
    rtt_ms: float                   # -1.0 when no RR echoed an SR yet


@dataclasses.dataclass
class ReceiveTrackStats:
    """Reference: `stats.ReceiveTrackStats` (+ TrackStats base)."""

    sid: int
    packets: int
    bytes: int
    packet_rate_pps: float
    bitrate_bps: float
    jitter_ms: float
    cumulative_lost: int
    fraction_lost: float            # over the current poll interval
    highest_seq: int                # extended; -1 before any packet


class StatsPoller:
    """Windowed rates for every stream row from snapshot differencing.

    One instance per StreamStatsTable; each `poll()` closes the current
    interval (all rows, vectorized) and the per-track accessors read the
    latest closed interval.  Mirrors the reference's TrackStats rate
    windows without per-packet listener churn.
    """

    def __init__(self, table: StreamStatsTable):
        self.table = table
        s = table.capacity
        self._t = -1.0
        self._tx_p = np.zeros(s, dtype=np.int64)
        self._tx_b = np.zeros(s, dtype=np.int64)
        self._rx_p = np.zeros(s, dtype=np.int64)
        self._rx_b = np.zeros(s, dtype=np.int64)
        self._exp = np.zeros(s, dtype=np.int64)
        self.tx_pps = np.zeros(s, dtype=np.float64)
        self.tx_bps = np.zeros(s, dtype=np.float64)
        self.rx_pps = np.zeros(s, dtype=np.float64)
        self.rx_bps = np.zeros(s, dtype=np.float64)
        self.fraction_lost = np.zeros(s, dtype=np.float64)

    def reset(self, sid: int) -> None:
        """Zero one row's baselines and rates (a recycled stream row
        must not difference against the dead stream's totals)."""
        self._tx_p[sid] = 0
        self._tx_b[sid] = 0
        self._rx_p[sid] = 0
        self._rx_b[sid] = 0
        self._exp[sid] = 0
        self.tx_pps[sid] = 0.0
        self.tx_bps[sid] = 0.0
        self.rx_pps[sid] = 0.0
        self.rx_bps[sid] = 0.0
        self.fraction_lost[sid] = 0.0

    def poll(self, now: Optional[float] = None) -> None:
        """Close the rate interval for all rows (call periodically)."""
        t = self.table
        now = time.time() if now is None else now
        if self._t >= 0:
            dt = max(now - self._t, 1e-3)
            self.tx_pps = (t.tx_packets - self._tx_p) / dt
            self.tx_bps = (t.tx_bytes - self._tx_b) * 8.0 / dt
            self.rx_pps = (t.rx_packets - self._rx_p) / dt
            self.rx_bps = (t.rx_bytes - self._rx_b) * 8.0 / dt
            expected = np.where(t.rx_base_ext >= 0,
                                t.rx_max_ext - t.rx_base_ext + 1, 0)
            exp_int = expected - self._exp
            rec_int = t.rx_packets - self._rx_p
            lost = np.maximum(exp_int - rec_int, 0)
            self.fraction_lost = np.where(exp_int > 0,
                                          lost / np.maximum(exp_int, 1),
                                          0.0)
            self._exp = expected
        else:
            self._exp = np.where(t.rx_base_ext >= 0,
                                 t.rx_max_ext - t.rx_base_ext + 1, 0)
        self._t = now
        self._tx_p = t.tx_packets.copy()
        self._tx_b = t.tx_bytes.copy()
        self._rx_p = t.rx_packets.copy()
        self._rx_b = t.rx_bytes.copy()

    # ------------------------------------------------------------ accessors
    def send_stats(self, sid: int) -> SendTrackStats:
        t = self.table
        return SendTrackStats(
            sid=sid,
            packets=int(t.tx_packets[sid]),
            bytes=int(t.tx_bytes[sid]),
            packet_rate_pps=float(self.tx_pps[sid]),
            bitrate_bps=float(self.tx_bps[sid]),
            rtt_ms=float(t.rtt[sid] * 1e3) if t.rtt[sid] >= 0 else -1.0)

    def receive_stats(self, sid: int) -> ReceiveTrackStats:
        t = self.table
        rate = max(int(t.clock_rate[sid]), 1)
        return ReceiveTrackStats(
            sid=sid,
            packets=int(t.rx_packets[sid]),
            bytes=int(t.rx_bytes[sid]),
            packet_rate_pps=float(self.rx_pps[sid]),
            bitrate_bps=float(self.rx_bps[sid]),
            jitter_ms=float(t.jitter[sid]) * 1e3 / rate,
            cumulative_lost=t.cumulative_lost(sid),
            fraction_lost=float(self.fraction_lost[sid]),
            highest_seq=int(t.rx_max_ext[sid]))

    def all_send_stats(self, sids) -> List[SendTrackStats]:
        return [self.send_stats(int(s)) for s in sids]

    def all_receive_stats(self, sids) -> List[ReceiveTrackStats]:
        return [self.receive_stats(int(s)) for s in sids]
