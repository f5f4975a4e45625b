"""H.264 RTP packetization/depacketization (RFC 6184).

Rebuilds the header logic of the reference's
`org.jitsi.impl.neomedia.codec.video.h264.{Packetizer,DePacketizer}`:
single NAL unit mode, STAP-A aggregation, and FU-A fragmentation, plus
keyframe (IDR/SPS) detection for layer switching.  The bitstream codec
half (the reference's JNIEncoder/JNIDecoder over ffmpeg) is
`codecs.avcodec` (libavcodec via ctypes); `split_annexb` bridges its
Annex-B access units to the NAL lists this module packetizes.

Counterpart: `libjitsi_tpu/codecs/h264.py` (copied; host Python).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

NAL_STAP_A = 24
NAL_FU_A = 28
NAL_IDR = 5
NAL_SPS = 7
NAL_PPS = 8


def split_annexb(au: bytes) -> List[bytes]:
    """Split an Annex-B access unit (00 00 [00] 01 start codes) into
    bare NAL units (the packetizer's input format)."""
    nals: List[bytes] = []
    i = 0
    n = len(au)
    start = -1
    while i + 2 < n:
        if au[i] == 0 and au[i + 1] == 0 and \
                (au[i + 2] == 1
                 or (i + 3 < n and au[i + 2] == 0 and au[i + 3] == 1)):
            sc = 3 if au[i + 2] == 1 else 4
            if start >= 0:
                nal = au[start:i]
                if nal:
                    nals.append(nal)
            i += sc
            start = i
        else:
            i += 1
    if start >= 0 and start < n:
        nals.append(au[start:])
    return nals


def packetize(nals: List[bytes], mtu: int = 1200) -> List[bytes]:
    """NAL units (one access unit) -> RTP payloads (RFC 6184).

    Small NALs aggregate into STAP-A; oversized NALs fragment into
    FU-A.  Reference: h264.Packetizer.
    """
    out: List[bytes] = []
    agg: List[bytes] = []
    agg_size = 1  # STAP-A indicator byte

    def flush_agg():
        nonlocal agg, agg_size
        if not agg:
            return
        if len(agg) == 1:
            out.append(agg[0])  # single NAL unit packet
        else:
            nri = max((n[0] >> 5) & 3 for n in agg)
            blob = bytes([(nri << 5) | NAL_STAP_A])
            for n in agg:
                blob += len(n).to_bytes(2, "big") + n
            out.append(blob)
        agg = []
        agg_size = 1

    for nal in nals:
        if not nal:
            continue
        if len(nal) + 2 + agg_size > mtu:
            flush_agg()
        if len(nal) <= mtu:
            agg.append(nal)
            agg_size += 2 + len(nal)
            continue
        # FU-A fragmentation
        flush_agg()
        hdr = nal[0]
        fu_ind = (hdr & 0xE0) | NAL_FU_A
        typ = hdr & 0x1F
        payload = nal[1:]
        pos = 0
        chunk = mtu - 2
        while pos < len(payload):
            piece = payload[pos:pos + chunk]
            s = 0x80 if pos == 0 else 0
            e = 0x40 if pos + chunk >= len(payload) else 0
            out.append(bytes([fu_ind, s | e | typ]) + piece)
            pos += len(piece)
    flush_agg()
    return out


@dataclasses.dataclass
class H264Depacketizer:
    """Reassemble NAL units from RTP payloads (reference: DePacketizer).

    Feed payloads in seq order (post jitter buffer); `push` returns the
    completed NAL units from that payload (possibly several for STAP-A,
    one after the final FU-A fragment, none mid-fragment).
    """

    _fu: Optional[bytearray] = None
    keyframe_seen: bool = False

    def push(self, payload: bytes) -> List[bytes]:
        if not payload:
            return []
        typ = payload[0] & 0x1F
        if typ == NAL_STAP_A:
            nals = []
            off = 1
            while off + 2 <= len(payload):
                ln = int.from_bytes(payload[off:off + 2], "big")
                nal = payload[off + 2:off + 2 + ln]
                if len(nal) == ln:
                    nals.append(nal)
                off += 2 + ln
            for n in nals:
                self._note(n)
            return nals
        if typ == NAL_FU_A:
            if len(payload) < 2:
                return []
            ind, fu = payload[0], payload[1]
            start, end = fu & 0x80, fu & 0x40
            if start:
                hdr = (ind & 0xE0) | (fu & 0x1F)
                self._fu = bytearray([hdr]) + payload[2:]
            elif self._fu is not None:
                self._fu += payload[2:]
            if end and self._fu is not None:
                nal = bytes(self._fu)
                self._fu = None
                self._note(nal)
                return [nal]
            return []
        # single NAL unit packet
        self._note(payload)
        return [payload]

    def _note(self, nal: bytes) -> None:
        if nal and (nal[0] & 0x1F) in (NAL_IDR, NAL_SPS):
            self.keyframe_seen = True


def is_keyframe_payload(payload: bytes) -> bool:
    """Does this RTP payload start/contain an IDR or SPS NAL?
    (reference: DePacketizer.isKeyFrame)"""
    if not payload:
        return False
    typ = payload[0] & 0x1F
    if typ in (NAL_IDR, NAL_SPS):
        return True
    if typ == NAL_STAP_A and len(payload) >= 4:
        off = 1
        while off + 2 < len(payload):
            ln = int.from_bytes(payload[off:off + 2], "big")
            if off + 2 < len(payload) and \
                    (payload[off + 2] & 0x1F) in (NAL_IDR, NAL_SPS):
                return True
            off += 2 + ln
    if typ == NAL_FU_A and len(payload) >= 2:
        return bool(payload[1] & 0x80) and \
            (payload[1] & 0x1F) in (NAL_IDR, NAL_SPS)
    return False
