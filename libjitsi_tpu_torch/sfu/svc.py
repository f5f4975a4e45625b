"""VP9 SVC layer projection — per-receiver subset of ONE layered stream.

VP8 simulcast sends L independent streams (separate SSRCs) and the SFU
forwards exactly one (`sfu/simulcast.py`).  VP9 SVC inverts that: one
SSRC carries every spatial/temporal layer, and the SFU *subsets* it per
receiver — forward packets with ``sid <= target_sid`` and ``tid <=
target_tid``, drop the rest.  Reference: the videobridge's VP9
projection over the track/encoding model (`MediaStreamTrackDesc` /
`RTPEncodingDesc`, SURVEY §2.3), the layered twin of simulcast
forwarding.

What must be rewritten so the receiver sees a coherent stream:

- **seq**: dropping interleaved upper-layer packets leaves gaps the
  receiver would NACK forever; forwarded packets renumber into a
  gapless output space via a bounded original->output map.  Late
  re-deliveries of an already-forwarded packet reuse their assigned
  number; a kept-layer packet whose FIRST arrival is older than the
  newest mapped original (upstream loss recovered after its successors
  were compacted) has no hole left to occupy and is dropped rather
  than emitted with an out-of-order fresh number (`late_dropped`) —
  picture recovery then rides the keyframe/PLI path.
- **RTP marker**: the sender marks the last packet of the TOP layer of
  each picture; when that layer is dropped, the end-of-frame (E bit)
  packet of the top *forwarded* spatial layer gets the marker instead
  (top forwarded = min(projection target, the previous picture's
  observed top layer), so a sender that stops emitting upper layers
  keeps markers flowing).
- SSRC/ts/picture-id stay untouched — it is the same stream, merely
  thinned (unlike simulcast, where three streams must be disguised as
  one).

Switch gating (inter-layer prediction makes mid-GOP upgrades
undecodable): spatial raises only on a keyframe picture; temporal
raises at a switching point (U bit) or keyframe; downswitches take
effect at the next picture boundary, never mid-picture.

Counterpart: `libjitsi_tpu/sfu/svc.py` (copied; host NumPy).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np

from libjitsi_tpu_torch.codecs import vp9
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header


class Vp9SvcForwarder:
    """Per-receiver spatial/temporal projection of a VP9 SVC stream."""

    SEQ_MAP_WINDOW = 512      # original seqs remembered for re-delivery

    def __init__(self, initial_sid: int = 0, initial_tid: int = 7):
        self.current_sid = int(initial_sid)
        self.target_sid = int(initial_sid)
        self.current_tid = int(initial_tid)
        self.target_tid = int(initial_tid)
        self._seq_map: "OrderedDict[int, int]" = OrderedDict()
        self._next_out = 0
        self._max_orig: Optional[int] = None    # newest mapped original
        self._cur_pid: Optional[int] = None
        self._pic_max_sid = 0                   # running, this picture
        self._prev_pic_max_sid: Optional[int] = None
        self.forwarded = 0
        self.dropped = 0
        self.late_dropped = 0
        self.switches = 0

    # ------------------------------------------------------------ control
    def request_layers(self, sid: Optional[int] = None,
                       tid: Optional[int] = None) -> bool:
        """Set the projection targets; returns True when an upstream
        keyframe request is needed to complete a spatial raise."""
        if sid is not None:
            self.target_sid = int(sid)
        if tid is not None:
            self.target_tid = int(tid)
        return self.target_sid > self.current_sid

    @property
    def awaiting_keyframe(self) -> bool:
        return self.target_sid > self.current_sid

    # ------------------------------------------------------------ forward
    def forward(self, batch: PacketBatch) -> List[bytes]:
        """Project one decrypted batch; returns rewritten (pre-SRTP)
        datagrams of the subset, in batch order."""
        hdr = rtp_header.parse(batch)
        desc = vp9.parse_descriptors(batch, hdr=hdr)
        out: List[bytes] = []
        for i in range(batch.batch_size):
            if not desc.valid[i]:
                continue
            pid = int(desc.picture_id[i])
            # layer ids default to (0, 0) when the L byte is absent
            # (single-layer stream): everything forwards
            sid = max(int(desc.sid[i]), 0)
            tid = max(int(desc.tid[i]), 0)
            # picture boundary: new picture id, or — when the stream
            # carries no picture ids — any begin of the bottom layer
            if desc.begin_frame[i] and (pid != self._cur_pid
                                        or (pid == -1 and sid == 0)):
                self._on_picture_boundary(bool(desc.is_keyframe[i]),
                                          pid)
            self._pic_max_sid = max(self._pic_max_sid, sid)
            if (self.target_tid > self.current_tid
                    and desc.switching_up[i] == 1
                    and self.current_tid < tid <= self.target_tid):
                # temporal raise at an explicit upswitch point (U bit):
                # step up to the U packet's OWN layer only — higher
                # layers still need their own switch point (their
                # frames may reference ones the receiver never got)
                self.current_tid = tid
                self.switches += 1
            if sid > self.current_sid or tid > self.current_tid:
                self.dropped += 1
                continue
            pkt = self._rewrite(batch, hdr, desc, i)
            if pkt is not None:
                out.append(pkt)
                self.forwarded += 1
        return out

    def _on_picture_boundary(self, keyframe: bool, pid: int) -> None:
        if self._cur_pid is not None:
            # only a COMPLETED picture informs the observed-top-layer
            # marker heuristic; the pre-stream zero must not
            self._prev_pic_max_sid = self._pic_max_sid
        self._cur_pid = pid
        self._pic_max_sid = 0
        changed = False
        # downswitches land at any picture boundary
        if self.target_sid < self.current_sid:
            self.current_sid = self.target_sid
            changed = True
        if self.target_tid < self.current_tid:
            self.current_tid = self.target_tid
            changed = True
        # raises need a keyframe (spatial) / keyframe counts as a
        # universal switching point (temporal)
        if keyframe:
            if self.target_sid > self.current_sid:
                self.current_sid = self.target_sid
                changed = True
            if self.target_tid > self.current_tid:
                self.current_tid = self.target_tid
                changed = True
        if changed:
            self.switches += 1

    def _rewrite(self, batch: PacketBatch, hdr, desc, i: int
                 ) -> Optional[bytes]:
        orig = int(hdr.seq[i])
        out_seq = self._seq_map.get(orig)
        if out_seq is None:
            if self._max_orig is not None and \
                    ((orig - self._max_orig) & 0xFFFF) >= 0x8000:
                # first arrival of an OLDER original: its successors
                # were already compacted, there is no hole to fill —
                # drop (see module docstring's recovery policy)
                self.late_dropped += 1
                return None
            out_seq = self._next_out & 0xFFFF
            self._next_out += 1
            self._seq_map[orig] = out_seq
            self._max_orig = orig
            while len(self._seq_map) > self.SEQ_MAP_WINDOW:
                self._seq_map.popitem(last=False)
        raw = bytearray(batch.to_bytes(i))
        raw[2:4] = out_seq.to_bytes(2, "big")
        # marker = end of the top spatial layer this projection will
        # actually forward (the sender may emit fewer layers than the
        # target; judge by the previous picture's observed top)
        sid = max(int(desc.sid[i]), 0)
        top = self.current_sid
        if self._prev_pic_max_sid is not None:
            top = min(top, self._prev_pic_max_sid)
        mark = bool(desc.end_frame[i]) and sid >= top
        raw[1] = (raw[1] & 0x7F) | (0x80 if mark else 0)
        return bytes(raw)
