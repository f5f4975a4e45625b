"""RTCP codec: compound packet parse/build (RFC 3550, 4585, REMB, TCC).

The reference gets SR/RR/SDES/BYE from the FMJ stack and adds feedback
types in-tree (`org.jitsi.impl.neomedia.rtcp.{RTCPPacketParserEx,
RTCPIterator,RTCPREMBPacket,RTCPTCCPacket,NACKPacket}`); here the whole
codec is rebuilt from the RFCs.  RTCP is the cold-ish control plane
(every ~1 s per stream, vs thousands of RTP packets), so this is host
Python/NumPy over bytes — clarity over batching; the hot feedback math
(BWE filters) consumes the parsed arrays.

Supported: SR(200), RR(201), SDES(202), BYE(203), APP(204),
RTPFB(205): NACK fmt=1, TCC fmt=15; PSFB(206): PLI fmt=1, FIR fmt=4,
REMB fmt=15.

Counterpart: `libjitsi_tpu/rtp/rtcp.py` (copied; host NumPy).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

SR, RR, SDES, BYE, APP, RTPFB, PSFB = 200, 201, 202, 203, 204, 205, 206
FMT_NACK, FMT_TCC = 1, 15
FMT_PLI, FMT_FIR, FMT_REMB = 1, 4, 15


@dataclasses.dataclass
class ReportBlock:
    ssrc: int
    fraction_lost: int          # 0..255
    cumulative_lost: int        # 24-bit signed
    highest_seq: int            # extended highest sequence received
    jitter: int
    lsr: int                    # middle 32 bits of last SR NTP time
    dlsr: int                   # delay since last SR, 1/65536 s


@dataclasses.dataclass
class SenderReport:
    ssrc: int
    ntp_sec: int
    ntp_frac: int
    rtp_ts: int
    packet_count: int
    octet_count: int
    reports: List[ReportBlock]


@dataclasses.dataclass
class ReceiverReport:
    ssrc: int
    reports: List[ReportBlock]


@dataclasses.dataclass
class SdesChunk:
    ssrc: int
    items: List[Tuple[int, bytes]]  # (type, value); CNAME=1


@dataclasses.dataclass
class Bye:
    ssrcs: List[int]
    reason: bytes = b""


@dataclasses.dataclass
class App:
    subtype: int
    ssrc: int
    name: bytes
    data: bytes


@dataclasses.dataclass
class Nack:
    sender_ssrc: int
    media_ssrc: int
    lost_seqs: List[int]        # decoded from PID/BLP pairs


@dataclasses.dataclass
class Pli:
    sender_ssrc: int
    media_ssrc: int


@dataclasses.dataclass
class Fir:
    sender_ssrc: int
    media_ssrc: int
    entries: List[Tuple[int, int]]  # (ssrc, command seq)


@dataclasses.dataclass
class Remb:
    sender_ssrc: int
    bitrate_bps: int
    ssrcs: List[int]


@dataclasses.dataclass
class TccFeedback:
    """Transport-wide congestion control feedback
    (draft-holmer-rmcat-transport-wide-cc-extensions-01)."""

    sender_ssrc: int
    media_ssrc: int
    base_seq: int
    reference_time: int          # multiples of 64 ms
    fb_pkt_count: int
    # parallel arrays over [base_seq, base_seq + n): received flag and
    # arrival offset in 0.25 ms units from reference_time (0 where lost)
    received: np.ndarray
    arrival_250us: np.ndarray

    def seqs(self) -> np.ndarray:
        return (self.base_seq + np.arange(len(self.received))) & 0xFFFF


# ------------------------------------------------------------------ parse --

def parse_compound(data: bytes) -> list:
    """Parse a compound RTCP packet into a list of typed packets.

    Unknown/unsupported packet types are skipped (the reference's parser
    does the same, surfacing only what consumers understand).
    """
    out = []
    off = 0
    n = len(data)
    while off + 4 <= n:
        b0, pt, length_words = data[off], data[off + 1], struct.unpack(
            "!H", data[off + 2:off + 4])[0]
        version = b0 >> 6
        count = b0 & 0x1F
        plen = 4 * (length_words + 1)
        if version != 2 or off + plen > n:
            break
        body = data[off + 4:off + plen]
        # a malformed-but-well-framed packet must be skipped, not crash
        # the receive loop (the reference's parser likewise drops what it
        # cannot read) — body-length errors surface as struct/index errors
        try:
            if pt == SR:
                out.append(_parse_sr(body, count))
            elif pt == RR:
                out.append(_parse_rr(body, count))
            elif pt == SDES:
                out.append(_parse_sdes(body, count))
            elif pt == BYE:
                out.append(_parse_bye(body, count))
            elif pt == APP:
                out.append(_parse_app(body, count))
            elif pt == RTPFB and count == FMT_NACK:
                out.append(_parse_nack(body))
            elif pt == RTPFB and count == FMT_TCC:
                p = _parse_tcc(body)
                if p is not None:
                    out.append(p)
            elif pt == PSFB and count == FMT_PLI:
                out.append(Pli(*struct.unpack("!II", body[:8])))
            elif pt == PSFB and count == FMT_FIR:
                out.append(_parse_fir(body))
            elif pt == PSFB and count == FMT_REMB:
                p = _parse_remb(body)
                if p is not None:
                    out.append(p)
        except (struct.error, IndexError, ValueError):
            pass
        off += plen
    return out


def _parse_report_blocks(body: bytes, off: int, count: int
                         ) -> List[ReportBlock]:
    blocks = []
    for _ in range(count):
        if off + 24 > len(body):
            break
        ssrc, fl_cl, hs, jit, lsr, dlsr = struct.unpack(
            "!IIIIII", body[off:off + 24])
        fraction = fl_cl >> 24
        cum = fl_cl & 0xFFFFFF
        if cum & 0x800000:
            cum -= 1 << 24
        blocks.append(ReportBlock(ssrc, fraction, cum, hs, jit, lsr, dlsr))
        off += 24
    return blocks


def _parse_sr(body: bytes, count: int) -> SenderReport:
    ssrc, ntps, ntpf, rts, pc, oc = struct.unpack("!IIIIII", body[:24])
    return SenderReport(ssrc, ntps, ntpf, rts, pc, oc,
                        _parse_report_blocks(body, 24, count))


def _parse_rr(body: bytes, count: int) -> ReceiverReport:
    ssrc = struct.unpack("!I", body[:4])[0]
    return ReceiverReport(ssrc, _parse_report_blocks(body, 4, count))


def _parse_sdes(body: bytes, count: int) -> List[SdesChunk]:
    chunks = []
    off = 0
    for _ in range(count):
        if off + 4 > len(body):
            break
        ssrc = struct.unpack("!I", body[off:off + 4])[0]
        off += 4
        items = []
        while off < len(body) and body[off] != 0:
            t = body[off]
            ln = body[off + 1]
            items.append((t, body[off + 2:off + 2 + ln]))
            off += 2 + ln
        off = (off // 4 + 1) * 4  # skip null + pad to 32-bit
        chunks.append(SdesChunk(ssrc, items))
    return chunks


def _parse_bye(body: bytes, count: int) -> Bye:
    ssrcs = [struct.unpack("!I", body[4 * i:4 * i + 4])[0]
             for i in range(count)]
    reason = b""
    off = 4 * count
    if off < len(body):
        rl = body[off]
        reason = body[off + 1:off + 1 + rl]
    return Bye(ssrcs, reason)


def _parse_app(body: bytes, subtype: int) -> App:
    ssrc = struct.unpack("!I", body[:4])[0]
    return App(subtype, ssrc, body[4:8], body[8:])


def _parse_nack(body: bytes) -> Nack:
    sender, media = struct.unpack("!II", body[:8])
    lost = []
    for off in range(8, len(body) - 3, 4):
        pid, blp = struct.unpack("!HH", body[off:off + 4])
        lost.append(pid)
        for k in range(16):
            if blp & (1 << k):
                lost.append((pid + k + 1) & 0xFFFF)
    return Nack(sender, media, lost)


def _parse_fir(body: bytes) -> Fir:
    sender, media = struct.unpack("!II", body[:8])
    entries = []
    for off in range(8, len(body) - 7, 8):
        ssrc, seq = struct.unpack("!IB3x", body[off:off + 8])
        entries.append((ssrc, seq))
    return Fir(sender, media, entries)


def _parse_remb(body: bytes) -> Optional[Remb]:
    if len(body) < 16 or body[8:12] != b"REMB":
        return None
    sender = struct.unpack("!I", body[:4])[0]
    num = body[12]
    exp = body[13] >> 2
    mant = ((body[13] & 0x03) << 16) | (body[14] << 8) | body[15]
    ssrcs = [struct.unpack("!I", body[16 + 4 * i:20 + 4 * i])[0]
             for i in range(num) if 20 + 4 * i <= len(body)]
    return Remb(sender, mant << exp, ssrcs)


def _parse_tcc(body: bytes) -> Optional[TccFeedback]:
    if len(body) < 16:
        return None
    sender, media, base_seq, status_count = struct.unpack(
        "!IIHH", body[:12])
    ref_time = int.from_bytes(body[12:15], "big", signed=True)
    fb_count = body[15]
    symbols: List[int] = []
    off = 16
    while len(symbols) < status_count and off + 2 <= len(body):
        chunk = struct.unpack("!H", body[off:off + 2])[0]
        off += 2
        if chunk >> 15 == 0:  # run-length
            sym = (chunk >> 13) & 0x03
            run = chunk & 0x1FFF
            symbols.extend([sym] * run)
        else:                 # status vector
            two_bit = (chunk >> 14) & 1
            if two_bit:
                symbols.extend(((chunk >> (12 - 2 * k)) & 0x03)
                               for k in range(7))
            else:
                symbols.extend(((chunk >> (13 - k)) & 0x01)
                               for k in range(14))
    symbols = symbols[:status_count]
    received = np.array([s in (1, 2) for s in symbols], dtype=bool)
    arrival = np.zeros(status_count, dtype=np.int64)
    t = 0
    for i, s in enumerate(symbols):
        if s == 1:
            if off + 1 > len(body):
                return None
            t += body[off]
            off += 1
            arrival[i] = t
        elif s == 2:
            if off + 2 > len(body):
                return None
            d = struct.unpack("!h", body[off:off + 2])[0]
            off += 2
            t += d
            arrival[i] = t
    return TccFeedback(sender, media, base_seq, ref_time, fb_count,
                       received, arrival)


# ------------------------------------------------------------------ build --

def _hdr(pt: int, count: int, body: bytes) -> bytes:
    assert len(body) % 4 == 0
    return struct.pack("!BBH", (2 << 6) | count, pt, len(body) // 4) + body


def _pack_report_blocks(reports: Sequence[ReportBlock]) -> bytes:
    out = b""
    for r in reports:
        cum = r.cumulative_lost & 0xFFFFFF
        out += struct.pack("!IIIIII", r.ssrc,
                           ((r.fraction_lost & 0xFF) << 24) | cum,
                           r.highest_seq & 0xFFFFFFFF, r.jitter & 0xFFFFFFFF,
                           r.lsr & 0xFFFFFFFF, r.dlsr & 0xFFFFFFFF)
    return out


def build_sr(sr: SenderReport) -> bytes:
    body = struct.pack("!IIIIII", sr.ssrc, sr.ntp_sec, sr.ntp_frac,
                       sr.rtp_ts & 0xFFFFFFFF, sr.packet_count,
                       sr.octet_count) + _pack_report_blocks(sr.reports)
    return _hdr(SR, len(sr.reports), body)


def build_rr(rr: ReceiverReport) -> bytes:
    return _hdr(RR, len(rr.reports),
                struct.pack("!I", rr.ssrc) + _pack_report_blocks(rr.reports))


def build_sdes(chunks: Sequence[SdesChunk]) -> bytes:
    body = b""
    for c in chunks:
        item_bytes = b"".join(
            struct.pack("!BB", t, len(v)) + v for t, v in c.items)
        chunk = struct.pack("!I", c.ssrc) + item_bytes + b"\x00"
        chunk += b"\x00" * (-len(chunk) % 4)
        body += chunk
    return _hdr(SDES, len(chunks), body)


def build_bye(b: Bye) -> bytes:
    body = b"".join(struct.pack("!I", s) for s in b.ssrcs)
    if b.reason:
        r = struct.pack("!B", len(b.reason)) + b.reason
        r += b"\x00" * (-len(r) % 4)
        body += r
    return _hdr(BYE, len(b.ssrcs), body)


def build_nack(n: Nack) -> bytes:
    """Encode lost seqs as PID/BLP pairs (reference: NACKPacket).

    Wrap-aware: the PID/BLP packing walks the seqs in *circular* order,
    anchored just after the largest mod-2^16 gap.  A loss run across
    65535->0 — numerically [0, 65534, 65535] — packs as one pair
    (PID=65534, BLP covering 65535 and 0) instead of two, and the PIDs
    come out in the order the packets were actually sent.
    """
    seqs = sorted(set(s & 0xFFFF for s in n.lost_seqs))
    if len(seqs) > 1:
        gaps = [(seqs[i] - seqs[i - 1]) & 0xFFFF for i in range(len(seqs))]
        k = gaps.index(max(gaps))         # i=0 wraps to seqs[-1]
        # list rotation (concat, not arithmetic) # jitlint: disable=rtp-mod16
        seqs = seqs[k:] + seqs[:k]
    fci = b""
    i = 0
    while i < len(seqs):
        pid = seqs[i]
        blp = 0
        j = i + 1
        while j < len(seqs) and 0 < (seqs[j] - pid) & 0xFFFF <= 16:
            blp |= 1 << (((seqs[j] - pid) & 0xFFFF) - 1)
            j += 1
        fci += struct.pack("!HH", pid, blp)
        i = j
    return _hdr(RTPFB, FMT_NACK,
                struct.pack("!II", n.sender_ssrc, n.media_ssrc) + fci)


def build_pli(p: Pli) -> bytes:
    return _hdr(PSFB, FMT_PLI, struct.pack("!II", p.sender_ssrc, p.media_ssrc))


def build_fir(f: Fir) -> bytes:
    body = struct.pack("!II", f.sender_ssrc, f.media_ssrc)
    for ssrc, seq in f.entries:
        body += struct.pack("!IB3x", ssrc, seq & 0xFF)
    return _hdr(PSFB, FMT_FIR, body)


def build_remb(r: Remb) -> bytes:
    mant = r.bitrate_bps
    exp = 0
    while mant >= (1 << 18):
        mant >>= 1
        exp += 1
    body = struct.pack("!II", r.sender_ssrc, 0) + b"REMB" + struct.pack(
        "!B", len(r.ssrcs)) + bytes([
            (exp << 2) | (mant >> 16), (mant >> 8) & 0xFF, mant & 0xFF])
    body += b"".join(struct.pack("!I", s) for s in r.ssrcs)
    return _hdr(PSFB, FMT_REMB, body)


def build_tcc(fb: TccFeedback) -> bytes:
    """Encode TCC feedback.  Uses two-bit status-vector chunks throughout
    (always valid, if not maximally compact) with small/large deltas
    chosen per packet."""
    received = np.asarray(fb.received, dtype=bool)
    arrival = np.asarray(fb.arrival_250us, dtype=np.int64)
    n = len(received)
    symbols = []
    deltas = b""
    t = 0
    for i in range(n):
        if not received[i]:
            symbols.append(0)
            continue
        d = int(arrival[i]) - t
        t = int(arrival[i])
        if 0 <= d <= 0xFF:
            symbols.append(1)
            deltas += struct.pack("!B", d)
        else:
            symbols.append(2)
            deltas += struct.pack("!h", max(-32768, min(32767, d)))
    chunks = b""
    for i in range(0, n, 7):
        grp = symbols[i:i + 7] + [0] * (7 - len(symbols[i:i + 7]))
        word = (1 << 15) | (1 << 14)
        for k, s in enumerate(grp):
            word |= s << (12 - 2 * k)
        chunks += struct.pack("!H", word)
    body = struct.pack("!IIHH", fb.sender_ssrc, fb.media_ssrc,
                       fb.base_seq & 0xFFFF, n)
    body += int(fb.reference_time).to_bytes(3, "big", signed=True)
    body += struct.pack("!B", fb.fb_pkt_count & 0xFF)
    body += chunks + deltas
    body += b"\x00" * (-len(body) % 4)
    return _hdr(RTPFB, FMT_TCC, body)


def build_compound(packets: Sequence[bytes]) -> bytes:
    return b"".join(packets)
