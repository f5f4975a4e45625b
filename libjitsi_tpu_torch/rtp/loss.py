"""Receiver-side loss detection from RTP sequence-number gaps.

The reference detects losses implicitly (FMJ jitter buffer timers,
`RetransmissionRequesterImpl` seq tracking); this module makes the gap
detector an explicit, reusable piece: both bridges (uplink losses on a
sender->bridge leg) and receiving endpoints (downlink losses on a
bridge->receiver leg) feed arriving sequence numbers through a
`LossTracker` and get back the newly-missing seqs to hand to a NACK
scheduler (`sfu/recovery.py`).

All arithmetic is mod-2^16 via `seq_delta` — a burst that straddles
65535->0 reports the same losses as one mid-range.  Large forward
jumps are classified as sender resets (seq randomization on SSRC
collision, a rejoining sender), NOT as thousands of losses: NACKing a
40000-packet "gap" would be a retransmission-request storm.

Counterpart: `libjitsi_tpu/rtp/loss.py` (copied; host only).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from libjitsi_tpu_torch.core.rtp_math import seq_delta


class LossTracker:
    """Track one RTP stream's highest seq; report fresh gaps as losses.

    `observe(seq)` returns `(new_losses, advanced)`:

    - in-order / small forward gap: the skipped seqs (at most `max_gap`)
      are returned once, exactly when the gap opens;
    - late or duplicate (delta <= 0): no losses, `advanced` False — the
      caller cancels any pending NACK for that seq;
    - jump beyond `max_gap` (either direction past the reorder window):
      counted in `resets`, the window re-anchors, nothing is reported
      lost — a reset is a new seq space, not mass loss.
    """

    def __init__(self, max_gap: int = 64):
        self.max_gap = max_gap
        self.highest: Optional[int] = None
        self.received = 0
        self.resets = 0
        self.lost_detected = 0

    def observe(self, seq: int) -> Tuple[List[int], bool]:
        seq = int(seq) & 0xFFFF
        self.received += 1
        if self.highest is None:
            self.highest = seq
            return [], True
        d = int(seq_delta(seq, self.highest))
        if d == 0:
            return [], False                      # duplicate
        if d < 0:
            if -d > self.max_gap:                 # ancient: seq space moved
                self.resets += 1
                self.highest = seq
                return [], True
            return [], False                      # late arrival (reordered)
        if d > self.max_gap:                      # sender reset / huge jump
            self.resets += 1
            self.highest = seq
            return [], True
        losses = [(self.highest + i) & 0xFFFF for i in range(1, d)]
        self.highest = seq
        self.lost_detected += len(losses)
        return losses, True
