"""Adaptive jitter buffer (host-side, per stream).

Counterpart: `libjitsi_tpu/rtp/jitter_buffer.py` (copied; host code, no
device work).  `service/pump.py`'s `ReceivePump` holds one a stream; the
dense many-stream form is `rtp/dense_jitter.py`.

The reference gets this from FMJ (`net.sf.fmj.media.rtp.JitterBuffer`
family, tuned by libjitsi) — an adaptive de-jitter queue between the
network and the decoder.  Only the decode/mix path needs it (the SFU
path forwards without buffering, SURVEY §2.3).  Packets insert by
sequence number; `pop()` releases the next in order once its target
hold time has elapsed, declaring losses when the gap timer expires.
The depth adapts to measured interarrival jitter (target =
jitter_multiplier x EWMA jitter, clamped).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from libjitsi_tpu_torch.core.rtp_math import seq_delta


@dataclasses.dataclass
class _Entry:
    seq: int
    rtp_ts: int
    payload: bytes
    arrival: float


class JitterBuffer:
    def __init__(self, clock_rate: int = 48000, frame_ms: float = 20.0,
                 min_delay_ms: float = 0.0, max_delay_ms: float = 200.0,
                 jitter_multiplier: float = 2.0):
        self.clock_rate = clock_rate
        self.frame_ms = frame_ms
        self.min_delay = min_delay_ms / 1000.0
        self.max_delay = max_delay_ms / 1000.0
        self.mult = jitter_multiplier
        self._buf: Dict[int, _Entry] = {}
        self._next_seq: Optional[int] = None
        self._released = False
        self._jitter_s = 0.0
        self._last_transit: Optional[float] = None
        self._bad_seq: Optional[int] = None
        self.lost = 0
        self.late_dropped = 0
        self.resets = 0

    #: beyond this mod-2^16 backward distance a packet is no longer a
    #: plausible reorder — it is either ancient or (indistinguishably,
    #: since seq_delta folds at +/-32768) a huge forward jump from a
    #: sender reset.  RFC 3550's MAX_MISORDER.
    MAX_MISORDER = 100

    @property
    def target_delay(self) -> float:
        return min(max(self.mult * self._jitter_s, self.min_delay),
                   self.max_delay)

    def insert(self, seq: int, rtp_ts: int, payload: bytes,
               now: float) -> None:
        seq &= 0xFFFF
        if self._next_seq is not None:
            d = int(seq_delta(seq, self._next_seq))
            if -self.MAX_MISORDER <= d < 0:
                if self._released:
                    self.late_dropped += 1  # released past this seq
                    return
                self._next_seq = seq  # window not started: move start back
            elif d < 0:
                # Too far back to be a reorder.  seq_delta cannot tell a
                # very-late packet from a forward jump > 32768 (sender
                # reset / seq randomization); before this branch existed
                # a reset read as "late" forever and the stream stalled
                # permanently.  RFC 3550 resync: drop the first
                # out-of-range packet but remember its successor; a
                # second consecutive one confirms the new seq space.
                if seq == self._bad_seq:
                    self.resets += 1
                    self._buf.clear()
                    self._next_seq = seq
                    self._bad_seq = None
                else:
                    self._bad_seq = (seq + 1) & 0xFFFF
                    self.late_dropped += 1
                    return
            else:
                self._bad_seq = None
        transit = now - rtp_ts / self.clock_rate
        if self._last_transit is not None:
            d = abs(transit - self._last_transit)
            self._jitter_s += (d - self._jitter_s) / 16.0
        self._last_transit = transit
        self._buf[seq] = _Entry(seq, rtp_ts, payload, now)
        if self._next_seq is None:
            self._next_seq = seq

    def pop(self, now: float) -> Optional[bytes]:
        """Release the next in-order frame if due; skips a missing seq
        (counting it lost) once its successor has waited out the target
        delay plus one frame.  Iterative (a recursion here blows the
        interpreter stack on a large sender seq jump — seen at ~1000)."""
        while self._next_seq is not None:
            e = self._buf.pop(self._next_seq, None)
            if e is not None:
                # 1 µs tolerance: float rounding in the transit-jitter
                # EWMA yields epsilon (~1e-11 s) target delays that would
                # hold a frame popped the same instant it arrived
                if now - e.arrival < self.target_delay - 1e-6:
                    self._buf[e.seq] = e  # not due yet
                    return None
                self._next_seq = (self._next_seq + 1) & 0xFFFF
                self._released = True
                return e.payload
            # gap: wait for reordering up to target + one frame, then skip
            if not self._buf:
                return None
            oldest = min(self._buf.values(), key=lambda x: x.arrival)
            if now - oldest.arrival <= self.target_delay + \
                    self.frame_ms / 1000.0:
                return None
            # Jump straight to the nearest buffered seq (mod-2^16).
            # Every buffered entry is ahead of _next_seq (insert either
            # moves the window back or drops/resyncs), so the smallest
            # forward delta IS the loss run — stepping one seq at a
            # time both miscounts across 65535->0 and costs O(gap).
            d, s = min((int(seq_delta(e.seq, self._next_seq)), e.seq)
                       for e in self._buf.values())
            self.lost += d
            self._next_seq = s
        return None

    def __len__(self) -> int:
        return len(self._buf)
