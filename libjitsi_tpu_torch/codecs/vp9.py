"""VP9 RTP payload descriptor handling (draft-ietf-payload-vp9) — vectorized.

Rebuilds the role of the reference's VP9 depacketizer
(`org.jitsi.impl.neomedia.codec.video.vp9.DePacketizer` [M per SURVEY
§2.5 — era-dependent]) the same way `codecs/vp8.py` rebuilds the VP8 one:
batched parse of the payload descriptor over a PacketBatch — I/P/L/F/B/E/
V/Z flags, 7/15-bit PictureID, layer indices (TID/U/SID/D + TL0PICIDX in
non-flexible mode), flexible-mode P_DIFFs, and the scalability structure
(SS) size — plus keyframe detection (P=0, B=1, SID=0).  The VP9 bitstream
itself stays on libvpx (host, verification only).

Counterpart: `libjitsi_tpu/codecs/vp9.py` (copied; host NumPy).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header

_MAX_PDIFF = 3      # flexible mode allows at most 3 reference diffs
_MAX_NG = 8         # picture-group entries we account for in SS sizing


@dataclasses.dataclass
class Vp9Descriptors:
    """Parsed per-row VP9 payload descriptor fields (-1 where absent)."""

    desc_len: np.ndarray        # descriptor size in bytes
    inter_predicted: np.ndarray  # P bit
    flexible: np.ndarray        # F bit
    begin_frame: np.ndarray     # B bit
    end_frame: np.ndarray       # E bit
    not_reference: np.ndarray   # Z bit
    payload_start: np.ndarray   # first VP9 payload byte (abs column)
    payload_end: np.ndarray     # one past the last payload byte (no padding)
    picture_id: np.ndarray      # 7/15-bit, -1 if no I
    tid: np.ndarray             # temporal layer id, -1 if no L
    sid: np.ndarray             # spatial layer id, -1 if no L
    switching_up: np.ndarray    # U bit (-1 if no L)
    inter_layer_dep: np.ndarray  # D bit (-1 if no L)
    tl0picidx: np.ndarray       # -1 unless L and non-flexible
    num_pdiff: np.ndarray       # flexible-mode reference count
    has_ss: np.ndarray          # V bit
    is_keyframe: np.ndarray     # P=0, B=1 and (no L or SID=0)
    valid: np.ndarray


def parse_descriptors(batch: PacketBatch, hdr=None) -> Vp9Descriptors:
    """Vectorized draft-ietf-payload-vp9 §4.2 parse over RTP payloads.

    Pass `hdr` (a prior `rtp_header.parse(batch)`) to avoid re-parsing
    on hot paths that already hold one (the SVC forwarder)."""
    if hdr is None:
        hdr = rtp_header.parse(batch)
    d = batch.data
    n, cap = d.shape
    ln = np.asarray(batch.length, dtype=np.int64)
    off = hdr.payload_off.astype(np.int64)

    def byte_at(pos):
        return rtp_header.byte_at(d, pos)

    b0 = byte_at(off)
    i_bit = (b0 >> 7) & 1
    p_bit = (b0 >> 6) & 1
    l_bit = (b0 >> 5) & 1
    f_bit = (b0 >> 4) & 1
    b_bit = (b0 >> 3) & 1
    e_bit = (b0 >> 2) & 1
    v_bit = (b0 >> 1) & 1
    z_bit = b0 & 1
    cur = off + 1

    # PictureID: 7-bit, or 15-bit when the M bit of the first byte is set
    pid0 = byte_at(cur)
    m_bit = (pid0 >> 7) & 1
    pic7 = pid0 & 0x7F
    pic15 = ((pid0 & 0x7F) << 8) | byte_at(cur + 1)
    picture_id = np.where(i_bit == 1,
                          np.where(m_bit == 1, pic15, pic7), -1)
    cur = cur + i_bit * (1 + m_bit)

    # Layer indices: TID(3) U(1) SID(3) D(1); + TL0PICIDX in non-flexible
    lb = np.where(l_bit == 1, byte_at(cur), 0)
    tid = np.where(l_bit == 1, (lb >> 5) & 0x7, -1)
    switching_up = np.where(l_bit == 1, (lb >> 4) & 1, -1)
    sid = np.where(l_bit == 1, (lb >> 1) & 0x7, -1)
    inter_layer_dep = np.where(l_bit == 1, lb & 1, -1)
    cur = cur + l_bit
    nonflex_tl0 = l_bit * (1 - f_bit)
    tl0picidx = np.where(nonflex_tl0 == 1, byte_at(cur), -1)
    cur = cur + nonflex_tl0

    # Flexible mode P_DIFFs: while the N bit continues, up to 3
    num_pdiff = np.zeros(n, dtype=np.int64)
    take = (f_bit == 1) & (p_bit == 1)
    for _ in range(_MAX_PDIFF):
        pb = byte_at(cur)
        num_pdiff = num_pdiff + take.astype(np.int64)
        cur = cur + take.astype(np.int64)
        take = take & ((pb & 1) == 1)

    # Scalability structure (V): N_S(3) Y(1) G(1); sizes counted so
    # desc_len is right — the SS content itself is keyframe-rate metadata
    ssb = np.where(v_bit == 1, byte_at(cur), 0)
    n_s = ((ssb >> 5) & 0x7) + 1
    y_bit = (ssb >> 4) & 1
    g_bit = (ssb >> 3) & 1
    cur = cur + v_bit
    cur = cur + v_bit * y_bit * n_s * 4          # WIDTH/HEIGHT pairs
    ng = np.where((v_bit == 1) & (g_bit == 1), byte_at(cur), 0)
    cur = cur + v_bit * g_bit
    # each picture-group entry: TID|U|R byte + R × P_DIFF
    remaining = np.minimum(ng, _MAX_NG)
    for _ in range(_MAX_NG):
        has = remaining > 0
        gb = np.where(has, byte_at(cur), 0)
        r = (gb >> 2) & 0x3
        cur = cur + has.astype(np.int64) * (1 + r)
        remaining = remaining - has.astype(np.int64)

    desc_len = cur - off
    payload_end = ln - hdr.pad_len                 # padding is not payload
    # rows with more SS picture-group entries than we size are NOT parsed
    # with a guessed desc_len — they are rejected, not silently corrupted
    valid = (hdr.valid & (payload_end > off + desc_len)
             & (ng <= _MAX_NG))
    is_keyframe = ((p_bit == 0) & (b_bit == 1)
                   & ((l_bit == 0) | (sid == 0)) & valid)
    return Vp9Descriptors(
        desc_len=desc_len.astype(np.int32),
        payload_start=(off + desc_len).astype(np.int32),
        payload_end=payload_end.astype(np.int32),
        inter_predicted=p_bit.astype(bool),
        flexible=f_bit.astype(bool),
        begin_frame=b_bit.astype(bool),
        end_frame=e_bit.astype(bool),
        not_reference=z_bit.astype(bool),
        picture_id=picture_id,
        tid=tid, sid=sid,
        switching_up=switching_up,
        inter_layer_dep=inter_layer_dep,
        tl0picidx=tl0picidx,
        num_pdiff=num_pdiff,
        has_ss=(v_bit == 1),
        is_keyframe=np.asarray(is_keyframe, dtype=bool),
        valid=np.asarray(valid, dtype=bool),
    )


def build_descriptor(
    begin: bool, end: bool = False, picture_id: int = -1,
    tid: int = -1, sid: int = 0, tl0picidx: int = -1,
    inter_predicted: bool = True, flexible: bool = False,
    pdiffs: Optional[List[int]] = None,
    ss_sizes: Optional[List[tuple]] = None,
) -> bytes:
    """Build a VP9 payload descriptor (test/packetizer helper)."""
    i = picture_id >= 0
    l = tid >= 0
    pdiffs = pdiffs or []
    f = flexible
    if f and inter_predicted and not pdiffs:
        # F=1,P=1 implies at least one P_DIFF on the wire; emitting none
        # would make every parser (ours included) eat a payload byte
        raise ValueError("flexible inter-predicted descriptor needs >=1 "
                         "pdiff (or inter_predicted=False)")
    v = ss_sizes is not None
    b0 = ((i << 7) | (int(inter_predicted) << 6) | (l << 5) | (f << 4)
          | (int(begin) << 3) | (int(end) << 2) | (v << 1))
    out = bytes([b0])
    if i:
        if picture_id > 0x7F:
            out += bytes([0x80 | (picture_id >> 8), picture_id & 0xFF])
        else:
            out += bytes([picture_id & 0x7F])
    if l:
        out += bytes([((tid & 7) << 5) | ((sid & 7) << 1)])
        if not f:
            out += bytes([tl0picidx & 0xFF if tl0picidx >= 0 else 0])
    if f and inter_predicted:
        for k, pd in enumerate(pdiffs):
            n_bit = 1 if k + 1 < len(pdiffs) else 0
            out += bytes([((pd & 0x7F) << 1) | n_bit])
    if v:
        n_s = len(ss_sizes)
        out += bytes([((n_s - 1) << 5) | (1 << 4)])   # Y=1, G=0
        for w, h in ss_sizes:
            out += w.to_bytes(2, "big") + h.to_bytes(2, "big")
    return out


class Vp9FrameAssembler:
    """Groups packets of one VP9 spatial/temporal stream into frames by
    (picture_id, sid), tracking begin/end markers — the depacketizer's
    frame-boundary logic, host-side (per-frame rate is low)."""

    def __init__(self):
        self._partial = {}

    def push(self, desc: Vp9Descriptors, batch: PacketBatch,
             row: int) -> Optional[bytes]:
        """Feed one row; returns the assembled frame payload when its
        end-marker packet arrives (packets assumed seq-ordered, as after
        the jitter buffer)."""
        if not desc.valid[row]:
            return None
        key = (int(desc.picture_id[row]), int(desc.sid[row]))
        payload = bytes(batch.data[
            row, int(desc.payload_start[row]):int(desc.payload_end[row])])
        if desc.begin_frame[row]:
            # a new frame on this spatial layer obsoletes any partial
            # frame whose end packet was lost — evict, don't leak
            sid = key[1]
            for stale in [k for k in self._partial
                          if k[1] == sid and k != key]:
                del self._partial[stale]
            self._partial[key] = [payload]
        elif key in self._partial:
            self._partial[key].append(payload)
        else:
            return None                      # mid-frame without a start
        if desc.end_frame[row]:
            return b"".join(self._partial.pop(key))
        return None
