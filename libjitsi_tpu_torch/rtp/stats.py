"""Vectorized per-stream RTP statistics (RFC 3550 §6.4 + A.3/A.8).

Counterpart: `libjitsi_tpu/rtp/stats.py` (copied).

The reference keeps one `MediaStreamStatsImpl` object per stream
(`org.jitsi.impl.neomedia.MediaStreamStatsImpl`, API
`org.jitsi.service.neomedia.stats.MediaStreamStats2` with per-track
Send/ReceiveTrackStats); at 10k streams that is 10k mutable objects and
locks.  Here stats for all streams are a handful of dense arrays and one
batched update per packet batch — no per-stream objects at all (SURVEY
§2.3 "stats" row).

Covered: send/receive packet+byte counts and rates, extended-highest-seq
tracking, cumulative/interval loss, interarrival jitter (RFC 3550 A.8,
computed in RTP clock units), SR/RR report-block generation, and RTT from
LSR/DLSR (§6.4.1).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from libjitsi_tpu_torch.core.rtp_math import chain_packet_indices, segment_ranks
from libjitsi_tpu_torch.rtp.rtcp import ReceiverReport, ReportBlock, SenderReport

NTP_EPOCH_OFFSET = 2208988800  # seconds between 1900 (NTP) and 1970 (unix)


def ntp_time(now: float):
    """Split a unix time into (ntp_sec, ntp_frac)."""
    sec = int(now) + NTP_EPOCH_OFFSET
    frac = int((now - int(now)) * (1 << 32)) & 0xFFFFFFFF
    return sec, frac


def ntp_middle32(now: float) -> int:
    """Middle 32 bits of the 64-bit NTP timestamp (for LSR)."""
    s, f = ntp_time(now)
    return ((s & 0xFFFF) << 16) | (f >> 16)


class StreamStatsTable:
    """Batched send/receive statistics for up to `capacity` streams."""

    def __init__(self, capacity: int = 1024):
        s = capacity
        self.capacity = s
        # ---- receive side
        self.rx_packets = np.zeros(s, dtype=np.int64)
        self.rx_bytes = np.zeros(s, dtype=np.int64)
        self.rx_base_ext = np.full(s, -1, dtype=np.int64)
        self.rx_max_ext = np.full(s, -1, dtype=np.int64)
        self.jitter = np.zeros(s, dtype=np.float64)       # RTP clock units
        self._last_transit = np.zeros(s, dtype=np.float64)
        self._has_transit = np.zeros(s, dtype=bool)
        self.clock_rate = np.full(s, 48000, dtype=np.int64)
        # interval state for fraction-lost
        self._expected_prior = np.zeros(s, dtype=np.int64)
        self._received_prior = np.zeros(s, dtype=np.int64)
        # last SR seen per stream (for LSR/DLSR in our RRs)
        self._last_sr_mid32 = np.zeros(s, dtype=np.int64)
        self._last_sr_arrival = np.zeros(s, dtype=np.float64)
        self._has_sr = np.zeros(s, dtype=bool)
        # ---- send side
        self.tx_packets = np.zeros(s, dtype=np.int64)
        self.tx_bytes = np.zeros(s, dtype=np.int64)
        # ---- RTT (seconds, -1 unknown), fed by RRs that echo our SRs
        self.rtt = np.full(s, -1.0, dtype=np.float64)
        self._sr_sent_mid32 = np.zeros(s, dtype=np.int64)
        self._sr_sent_time = np.zeros(s, dtype=np.float64)

    def reset(self, stream: int) -> None:
        """Zero one row (a released stream id must not leak its counters
        into the next stream allocated on the same row)."""
        self.rx_packets[stream] = 0
        self.rx_bytes[stream] = 0
        self.rx_base_ext[stream] = -1
        self.rx_max_ext[stream] = -1
        self.jitter[stream] = 0.0
        self._last_transit[stream] = 0.0
        self._has_transit[stream] = False
        self.clock_rate[stream] = 48000
        self._expected_prior[stream] = 0
        self._received_prior[stream] = 0
        self._last_sr_mid32[stream] = 0
        self._last_sr_arrival[stream] = 0.0
        self._has_sr[stream] = False
        self.tx_packets[stream] = 0
        self.tx_bytes[stream] = 0
        self.rtt[stream] = -1.0
        self._sr_sent_mid32[stream] = 0
        self._sr_sent_time[stream] = 0.0

    # ------------------------------------------------------------- updates
    def on_sent(self, stream: np.ndarray, nbytes: np.ndarray) -> None:
        stream = np.asarray(stream, dtype=np.int64)
        np.add.at(self.tx_packets, stream, 1)
        np.add.at(self.tx_bytes, stream, np.asarray(nbytes, dtype=np.int64))

    def on_received(self, stream: np.ndarray, seq: np.ndarray,
                    rtp_ts: np.ndarray, nbytes: np.ndarray,
                    arrival: Optional[np.ndarray] = None) -> None:
        """Batched receive update: counts, ext-seq, jitter (RFC 3550 A.8).

        `arrival` is per-packet host receive time in seconds (one batch
        usually shares a capture instant; pass a scalar-broadcast array).
        """
        stream = np.asarray(stream, dtype=np.int64)
        seq = np.asarray(seq, dtype=np.int64)
        rtp_ts = np.asarray(rtp_ts, dtype=np.int64)
        if arrival is None:
            arrival = np.full(len(stream), time.time())
        arrival = np.asarray(arrival, dtype=np.float64)

        np.add.at(self.rx_packets, stream, 1)
        np.add.at(self.rx_bytes, stream, np.asarray(nbytes, dtype=np.int64))

        ext = chain_packet_indices(stream, seq, self.rx_max_ext)
        first = self.rx_base_ext[stream] < 0
        if np.any(first):
            # base = first ext seq seen for the stream (min within batch)
            tmp = np.full(self.capacity, np.iinfo(np.int64).max)
            np.minimum.at(tmp, stream[first], ext[first])
            rows = tmp < np.iinfo(np.int64).max
            self.rx_base_ext[rows] = tmp[rows]
        np.maximum.at(self.rx_max_ext, stream, ext)

        # jitter: transit = arrival(in RTP units) - rtp_ts; EWMA of |D|.
        rate = self.clock_rate[stream].astype(np.float64)
        transit = arrival * rate - rtp_ts.astype(np.float64)
        rank = segment_ranks(stream)
        max_rank = int(rank.max(initial=-1))
        for r in range(max_rank + 1):
            rows = rank == r
            st = stream[rows]
            tr = transit[rows]
            have = self._has_transit[st]
            d = np.abs(tr - self._last_transit[st])
            j = self.jitter[st]
            self.jitter[st] = np.where(have, j + (d - j) / 16.0, j)
            self._last_transit[st] = tr
            self._has_transit[st] = True

    def on_sr_received(self, stream: int, sr: SenderReport,
                       arrival: Optional[float] = None) -> None:
        """Record a remote SR (for LSR/DLSR echo in our receiver reports)."""
        self._last_sr_mid32[stream] = ((sr.ntp_sec & 0xFFFF) << 16) | (
            sr.ntp_frac >> 16)
        self._last_sr_arrival[stream] = time.time() if arrival is None \
            else arrival
        self._has_sr[stream] = True

    def on_rr_received(self, stream: int, block: ReportBlock,
                       now: Optional[float] = None) -> None:
        """Compute RTT from a report block echoing our SR (RFC 3550 §6.4.1)."""
        if block.lsr == 0 or block.lsr != self._sr_sent_mid32[stream]:
            return
        now = time.time() if now is None else now
        a = ntp_middle32(now)
        rtt_units = (a - block.lsr - block.dlsr) & 0xFFFFFFFF
        self.rtt[stream] = rtt_units / 65536.0

    # ------------------------------------------------------------- reports
    def expected(self, stream: int) -> int:
        if self.rx_base_ext[stream] < 0:
            return 0
        return int(self.rx_max_ext[stream] - self.rx_base_ext[stream] + 1)

    def cumulative_lost(self, stream: int) -> int:
        return max(0, self.expected(stream) - int(self.rx_packets[stream]))

    def make_report_block(self, stream: int, remote_ssrc: int,
                          now: Optional[float] = None) -> ReportBlock:
        """One RR/SR report block about `remote_ssrc` heard on `stream`."""
        now = time.time() if now is None else now
        expected = self.expected(stream)
        received = int(self.rx_packets[stream])
        exp_int = expected - int(self._expected_prior[stream])
        rec_int = received - int(self._received_prior[stream])
        self._expected_prior[stream] = expected
        self._received_prior[stream] = received
        lost_int = max(0, exp_int - rec_int)
        fraction = (lost_int << 8) // exp_int if exp_int > 0 else 0
        lsr = int(self._last_sr_mid32[stream]) if self._has_sr[stream] else 0
        dlsr = int((now - self._last_sr_arrival[stream]) * 65536) \
            if self._has_sr[stream] else 0
        return ReportBlock(
            ssrc=remote_ssrc, fraction_lost=min(fraction, 255),
            cumulative_lost=self.cumulative_lost(stream),
            highest_seq=int(self.rx_max_ext[stream]) & 0xFFFFFFFF
            if self.rx_max_ext[stream] >= 0 else 0,
            jitter=int(self.jitter[stream]),
            lsr=lsr, dlsr=dlsr)

    def make_sr(self, stream: int, ssrc: int, rtp_ts: int,
                reports: Optional[List[ReportBlock]] = None,
                now: Optional[float] = None) -> SenderReport:
        now = time.time() if now is None else now
        s, f = ntp_time(now)
        self._sr_sent_mid32[stream] = ntp_middle32(now)
        self._sr_sent_time[stream] = now
        return SenderReport(
            ssrc=ssrc, ntp_sec=s, ntp_frac=f, rtp_ts=rtp_ts,
            packet_count=int(self.tx_packets[stream]),
            octet_count=int(self.tx_bytes[stream]),
            reports=reports or [])

    def make_rr(self, stream: int, ssrc: int, remote_ssrc: int,
                now: Optional[float] = None) -> ReceiverReport:
        return ReceiverReport(
            ssrc=ssrc,
            reports=[self.make_report_block(stream, remote_ssrc, now)])
