"""ulpfec — RFC 5109 XOR forward error correction (reference:
`org.jitsi.impl.neomedia.transform.fec.{FECTransformEngine,FECSender,
FECReceiver}`).

One FEC packet protects a group of k media packets (level-0 protection
covering each packet in full).  Recovery of a single lost packet is the
XOR of the FEC packet with the surviving k-1 — a pure byte-matrix XOR
reduction, done here as one vectorized NumPy fold over the group (the
batched-device variant rides the same math; host XOR at RTCP-feedback
rates is nowhere near the bottleneck).

Wire format (RFC 5109 §7.3, no RED encapsulation — the separate-stream
variant the reference uses for video): FEC header (10B) + one level
header (4B) + payload = XOR of protected packets' payloads.

Counterpart: `libjitsi_tpu/transform/fec.py` (copied; host NumPy).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.rtp_math import seq_delta


def _xor_fold(chunks: List[bytes], width: int) -> np.ndarray:
    m = np.zeros((len(chunks), width), dtype=np.uint8)
    for i, c in enumerate(chunks):
        m[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
    return np.bitwise_xor.reduce(m, axis=0)


def build_fec(media_packets: List[bytes], seq_base: int) -> bytes:
    """Build one FEC payload protecting `media_packets` (RTP packets with
    consecutive seqs starting at seq_base).  Returns the FEC *payload*
    (caller wraps it in its own RTP header with the FEC PT)."""
    if not 1 <= len(media_packets) <= 16:
        raise ValueError("protect 1..16 packets per FEC group")
    # recovery fields are XORs over the protected packets' header fields
    first = media_packets[0]
    ts_rec = 0
    len_rec = 0
    pt_rec = 0
    cc_rec = 0
    m_rec = 0
    p_rec = 0
    x_rec = 0
    for p in media_packets:
        b0, b1 = p[0], p[1]
        p_rec ^= (b0 >> 5) & 1
        x_rec ^= (b0 >> 4) & 1
        cc_rec ^= b0 & 0x0F
        m_rec ^= b1 >> 7
        pt_rec ^= b1 & 0x7F
        ts_rec ^= struct.unpack("!I", p[4:8])[0]
        len_rec ^= len(p) - 12
    mask = 0
    for i in range(len(media_packets)):
        mask |= 1 << (15 - i)
    hdr = bytes([
        (p_rec << 5) | (x_rec << 4) | cc_rec,       # E=0 L=0 P X CC
        (m_rec << 7) | pt_rec,
    ]) + struct.pack("!H", seq_base & 0xFFFF) + struct.pack(
        "!I", ts_rec) + struct.pack("!H", len_rec)
    payload_xor = _xor_fold([p[12:] for p in media_packets],
                            max(len(p) - 12 for p in media_packets))
    level = struct.pack("!HH", len(payload_xor), mask)
    return hdr + level + payload_xor.tobytes()


def parse_fec(payload: bytes) -> dict:
    if len(payload) < 14:
        raise ValueError("short FEC payload")
    b0, b1 = payload[0], payload[1]
    seq_base = struct.unpack("!H", payload[2:4])[0]
    ts_rec = struct.unpack("!I", payload[4:8])[0]
    len_rec = struct.unpack("!H", payload[8:10])[0]
    prot_len, mask = struct.unpack("!HH", payload[10:14])
    return {
        "p_rec": (b0 >> 5) & 1, "x_rec": (b0 >> 4) & 1, "cc_rec": b0 & 0x0F,
        "m_rec": b1 >> 7, "pt_rec": b1 & 0x7F,
        "seq_base": seq_base, "ts_rec": ts_rec, "len_rec": len_rec,
        "mask": mask, "xor": payload[14:14 + prot_len],
    }


class FecSender:
    """Group outgoing media packets, emit one FEC payload per k
    (reference: FECSender)."""

    def __init__(self, k: int = 5):
        self.k = k
        self._group: List[bytes] = []
        self._seq_base: Optional[int] = None

    def push(self, rtp_packet: bytes) -> Optional[bytes]:
        """Returns a FEC payload when the group completes."""
        seq = struct.unpack("!H", rtp_packet[2:4])[0]
        if not self._group:
            self._seq_base = seq
        self._group.append(rtp_packet)
        if len(self._group) >= self.k:
            fec = build_fec(self._group, self._seq_base)
            self._group = []
            return fec
        return None


class FecReceiver:
    """Buffer media + FEC per SSRC; recover single losses
    (reference: FECReceiver)."""

    def __init__(self, window: int = 128):
        self.window = window
        self._media: Dict[int, bytes] = {}  # seq -> rtp packet
        self._max_seq: Optional[int] = None
        self.recovered = 0

    def push_media(self, rtp_packet: bytes) -> None:
        seq = struct.unpack("!H", rtp_packet[2:4])[0]
        self._media[seq] = rtp_packet
        if self._max_seq is None or seq_delta(seq, self._max_seq) > 0:
            self._max_seq = seq
        # prune outside window
        for s in [s for s in self._media
                  if seq_delta(self._max_seq, s) > self.window]:
            del self._media[s]

    def push_fec(self, fec_payload: bytes, ssrc: int) -> Optional[bytes]:
        """Process one FEC payload; returns a recovered RTP packet if
        exactly one protected packet is missing."""
        f = parse_fec(fec_payload)
        prot = [(f["seq_base"] + i) & 0xFFFF for i in range(16)
                if f["mask"] & (1 << (15 - i))]
        missing = [s for s in prot if s not in self._media]
        if len(missing) != 1:
            return None
        have = [self._media[s] for s in prot if s in self._media]
        seq = missing[0]
        # header recovery (RFC 5109 §8.2)
        p = f["p_rec"]
        x = f["x_rec"]
        cc = f["cc_rec"]
        m = f["m_rec"]
        pt = f["pt_rec"]
        ts = f["ts_rec"]
        ln = f["len_rec"]
        for pk in have:
            b0, b1 = pk[0], pk[1]
            p ^= (b0 >> 5) & 1
            x ^= (b0 >> 4) & 1
            cc ^= b0 & 0x0F
            m ^= b1 >> 7
            pt ^= b1 & 0x7F
            ts ^= struct.unpack("!I", pk[4:8])[0]
            ln ^= len(pk) - 12
        width = max(len(f["xor"]), max((len(pk) - 12 for pk in have),
                                       default=0))
        payload = _xor_fold([f["xor"]] + [pk[12:] for pk in have], width)
        hdr = bytes([(2 << 6) | (p << 5) | (x << 4) | cc,
                     (m << 7) | pt]) + struct.pack("!H", seq) + \
            struct.pack("!I", ts) + struct.pack("!I", ssrc)
        pkt = hdr + payload[:ln].tobytes()
        self.recovered += 1
        self._media[seq] = pkt
        return pkt
