"""Vectorized RTP header codec (RFC 3550 §5.1, RFC 5285 extensions).

Rebuilds the header parse/mutate surface of the reference's `RawPacket`
(org/jitsi/service/neomedia/RawPacket.java: getVersion/getPayloadType/
getSequenceNumber/getTimestamp/getSSRC/getCsrcList/getHeaderExtension...)
as batched NumPy ops: one call parses/patches B packets at once.

Counterpart: `libjitsi_tpu/rtp/header.py` (copied; host NumPy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch, RTP_FIXED_HEADER_LEN, RTP_VERSION


@dataclasses.dataclass
class RtpHeaders:
    """Parsed header fields, one entry per packet row (all int32/int64)."""

    version: np.ndarray
    padding: np.ndarray  # 0/1
    extension: np.ndarray  # 0/1
    cc: np.ndarray  # CSRC count
    marker: np.ndarray  # 0/1
    pt: np.ndarray  # payload type
    seq: np.ndarray
    ts: np.ndarray  # int64 to hold u32
    ssrc: np.ndarray  # int64 to hold u32
    ext_profile: np.ndarray  # 0 when no extension
    ext_words: np.ndarray  # extension length in 32-bit words (excl. 4B ext header)
    header_len: np.ndarray  # fixed + CSRCs + extension block
    pad_len: np.ndarray
    payload_off: np.ndarray  # == header_len
    payload_len: np.ndarray  # length - header_len - pad_len (clamped >= 0)
    valid: np.ndarray  # bool: version==2 and length >= minimal header


def _u16(data, off):
    """Big-endian u16 at per-row byte offset `off` (array or scalar)."""
    off = np.broadcast_to(np.asarray(off, dtype=np.int32), data.shape[:1])
    b0 = np.take_along_axis(data, off[:, None], axis=1)[:, 0].astype(np.int64)
    b1 = np.take_along_axis(data, off[:, None] + 1, axis=1)[:, 0].astype(np.int64)
    return (b0 << 8) | b1


def _u16_fixed(data, off: int):
    """u16 at a compile-time-constant offset: column slices, no gather."""
    return (data[:, off].astype(np.int64) << 8) | data[:, off + 1]


def _u32_fixed(data, off: int):
    return (_u16_fixed(data, off) << 16) | _u16_fixed(data, off + 2)


# public alias: big-endian u32 column read at a constant offset (used by
# SRTCP's SSRC extraction and other fixed-layout parsers)
read_u32 = _u32_fixed


def byte_at(data: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Per-row single-byte gather: data [B, W], pos [B] -> int64 [B]
    (clamped to the buffer; callers mask validity separately)."""
    return np.take_along_axis(
        data, np.clip(pos, 0, data.shape[1] - 1)[:, None].astype(np.int64),
        axis=1)[:, 0].astype(np.int64)


def parse(batch: PacketBatch) -> RtpHeaders:
    """Parse all RTP headers in the batch (vectorized, no per-packet loop)."""
    d = batch.data
    ln = np.asarray(batch.length).astype(np.int32)
    b0 = d[:, 0].astype(np.int32)
    b1 = d[:, 1].astype(np.int32)
    version = b0 >> 6
    padding = (b0 >> 5) & 1
    extension = (b0 >> 4) & 1
    cc = b0 & 0x0F
    marker = b1 >> 7
    pt = b1 & 0x7F
    seq = _u16_fixed(d, 2).astype(np.int32)
    ts = _u32_fixed(d, 4)
    ssrc = _u32_fixed(d, 8)

    ext_off = RTP_FIXED_HEADER_LEN + 4 * cc
    # Guard reads past `length` by clamping the offset; values are masked out
    # below via `extension`/`valid`.
    safe_off = np.minimum(ext_off, batch.capacity - 4).astype(np.int32)
    ext_profile = np.where(extension == 1, _u16(d, safe_off), 0)
    ext_words = np.where(extension == 1, _u16(d, safe_off + 2), 0).astype(np.int32)
    header_len = ext_off + np.where(extension == 1, 4 + 4 * ext_words, 0)

    last_off = np.maximum(ln - 1, 0)
    last_byte = np.take_along_axis(d, last_off[:, None].astype(np.int32), axis=1)[
        :, 0
    ].astype(np.int32)
    pad_len = np.where(padding == 1, last_byte, 0)

    payload_len = ln - header_len - pad_len
    valid = (
        (version == RTP_VERSION)
        & (ln >= RTP_FIXED_HEADER_LEN)
        & (header_len + pad_len <= ln)
    )
    payload_len = np.maximum(payload_len, 0)

    return RtpHeaders(
        version=version,
        padding=padding,
        extension=extension,
        cc=cc,
        marker=marker,
        pt=pt,
        seq=seq,
        ts=ts,
        ssrc=ssrc,
        ext_profile=ext_profile,
        ext_words=ext_words,
        header_len=header_len.astype(np.int32),
        pad_len=pad_len,
        payload_off=header_len.astype(np.int32),
        payload_len=payload_len.astype(np.int32),
        valid=valid,
    )


def build(
    payloads,
    seq,
    ts,
    ssrc,
    pt,
    marker=None,
    csrcs=None,
    capacity: int = 1504,
    stream=None,
    ext=None,
) -> PacketBatch:
    """Build a batch of RTP packets (host-side; used by tests/fixtures/packetizers).

    `payloads` is a list of bytes; other args broadcast over the batch.
    `ext` is None or a per-row list of `(profile_u16, body_bytes)` /
    None entries: a present entry sets the X bit and emits an RFC 5285
    extension block after the CSRCs, body zero-padded to a 32-bit word
    boundary — `parse()` folds it into `header_len`/`payload_off`, so
    readers that slice at `payload_off` skip it transparently.
    Reference analog: FMJ's RTP packetization + RawPacket header writes.
    """
    n = len(payloads)
    seq = np.broadcast_to(np.asarray(seq, dtype=np.int64), (n,))
    ts = np.broadcast_to(np.asarray(ts, dtype=np.int64), (n,))
    ssrc = np.broadcast_to(np.asarray(ssrc, dtype=np.int64), (n,))
    pt = np.broadcast_to(np.asarray(pt, dtype=np.int64), (n,))
    marker = (
        np.zeros((n,), dtype=np.int64)
        if marker is None
        else np.broadcast_to(np.asarray(marker, dtype=np.int64), (n,))
    )
    csrc_lists = csrcs if csrcs is not None else [[]] * n
    ext_list = ext if ext is not None else [None] * n

    pkts = []
    for i, p in enumerate(payloads):
        cl = csrc_lists[i]
        hdr = bytearray(RTP_FIXED_HEADER_LEN + 4 * len(cl))
        hdr[0] = (RTP_VERSION << 6) | len(cl)
        hdr[1] = (int(marker[i]) << 7) | (int(pt[i]) & 0x7F)
        hdr[2:4] = int(seq[i] & 0xFFFF).to_bytes(2, "big")
        hdr[4:8] = int(ts[i] & 0xFFFFFFFF).to_bytes(4, "big")
        hdr[8:12] = int(ssrc[i] & 0xFFFFFFFF).to_bytes(4, "big")
        for j, c in enumerate(cl):
            hdr[12 + 4 * j : 16 + 4 * j] = int(c & 0xFFFFFFFF).to_bytes(4, "big")
        if ext_list[i] is not None:
            profile, body = ext_list[i]
            body = bytes(body)
            if len(body) % 4:
                body += b"\x00" * (4 - len(body) % 4)
            hdr[0] |= 0x10
            hdr += int(profile & 0xFFFF).to_bytes(2, "big")
            hdr += (len(body) // 4).to_bytes(2, "big")
            hdr += body
        pkts.append(bytes(hdr) + bytes(p))
    return PacketBatch.from_payloads(pkts, capacity, stream)


# ---- vectorized in-place header mutators (hot-path safe) ----------------


def set_seq(data: np.ndarray, seq) -> np.ndarray:
    """Write seq numbers into all rows; returns the (mutated) array."""
    seq = np.asarray(seq, dtype=np.int64)
    data[:, 2] = (seq >> 8) & 0xFF
    data[:, 3] = seq & 0xFF
    return data


def set_ts(data: np.ndarray, ts) -> np.ndarray:
    ts = np.asarray(ts, dtype=np.int64)
    for k in range(4):
        data[:, 4 + k] = (ts >> (8 * (3 - k))) & 0xFF
    return data


def set_ssrc(data: np.ndarray, ssrc) -> np.ndarray:
    ssrc = np.asarray(ssrc, dtype=np.int64)
    for k in range(4):
        data[:, 8 + k] = (ssrc >> (8 * (3 - k))) & 0xFF
    return data


def set_pt(data: np.ndarray, pt) -> np.ndarray:
    pt = np.asarray(pt, dtype=np.int64)
    data[:, 1] = (data[:, 1].astype(np.int64) & 0x80) | (pt & 0x7F)
    return data


def set_marker(data: np.ndarray, marker) -> np.ndarray:
    m = np.asarray(marker, dtype=np.int64)
    data[:, 1] = (data[:, 1].astype(np.int64) & 0x7F) | ((m & 1) << 7)
    return data
