"""RFC 5285 one-byte RTP header extensions, vectorized.

The reference's `RawPacket.getHeaderExtension(byte id)` /
`addExtension(...)` walk the extension block per packet; the engines that
stamp extensions on the hot path (`AbsSendTimeEngine`,
`TransportCCEngine`, `CsrcTransformEngine`'s audio level) all use the
one-byte form (profile 0xBEDE).  Here the walk is a bounded vectorized
cursor loop over the whole batch and the insert is one batched shift —
no per-packet Python.

Only the one-byte element form is handled (id 1..14, len 1..16); 0xBEDE
is the only recognized profile, matching what WebRTC interop actually
uses and what the reference's engines emit.

Counterpart: `libjitsi_tpu/rtp/ext.py` (copied; host NumPy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch, RTP_FIXED_HEADER_LEN
from libjitsi_tpu_torch.rtp.header import RtpHeaders

ONE_BYTE_PROFILE = 0xBEDE
MAX_ELEMENTS = 16  # scan bound: more elements than this are ignored


def _ceil4(x):
    return (x + 3) & ~3


def find_one_byte_ext(batch: PacketBatch, hdr: RtpHeaders, ext_id: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Locate element `ext_id` in each row's 0xBEDE extension block.

    Returns (data_off [B], data_len [B], found [B]): byte offset of the
    element *payload* and its length.  Rows without the element (or
    without a one-byte-profile extension) have found=False.
    """
    d = batch.data
    n = batch.batch_size
    ext_start = (RTP_FIXED_HEADER_LEN + 4 * hdr.cc).astype(np.int64)
    has = (hdr.extension == 1) & (hdr.ext_profile == ONE_BYTE_PROFILE)
    end = ext_start + 4 + 4 * hdr.ext_words.astype(np.int64)

    cur = np.where(has, ext_start + 4, np.int64(1) << 40)  # cursor per row
    off = np.zeros(n, dtype=np.int64)
    dlen = np.zeros(n, dtype=np.int64)
    found = np.zeros(n, dtype=bool)
    cap = batch.capacity
    for _ in range(MAX_ELEMENTS):
        inb = (cur < end) & ~found
        safe = np.minimum(np.maximum(cur, 0), cap - 1).astype(np.int32)
        b = np.take_along_axis(d, safe[:, None], axis=1)[:, 0].astype(np.int64)
        eid = b >> 4
        elen = (b & 0x0F) + 1  # encoded len-1
        is_pad = inb & (b == 0)
        is_stop = inb & (eid == 15)  # id 15 terminates parsing per RFC
        hit = inb & ~is_pad & ~is_stop & (eid == ext_id)
        off = np.where(hit, cur + 1, off)
        dlen = np.where(hit, elen, dlen)
        found |= hit
        # advance: padding skips 1 byte, element skips 1 + len
        step = np.where(is_pad, 1, 1 + elen)
        cur = np.where(inb & ~is_stop & ~hit, cur + step,
                       np.where(is_stop, end, cur))
    return off, dlen, found


def set_one_byte_ext(batch: PacketBatch, hdr: RtpHeaders, ext_id: int,
                     payload: np.ndarray, enable=None) -> PacketBatch:
    """Stamp element `ext_id` = payload[i] into every enabled row, batched.

    payload: uint8 [B, L] with one static L for the whole call (each
    engine stamps one fixed-size element: abs-send-time L=3, transport-cc
    seq L=2, ssrc-audio-level L=1).  Three per-row cases, all handled in
    one vectorized shift pass:

    - element already present with length L: rewritten in place;
    - 0xBEDE block present, element absent: element appended after the
      block (block grows by ceil4(1+L));
    - no extension block: a fresh one-byte-profile block is inserted
      after the CSRCs (grows by 4 + ceil4(1+L)).

    Rows with enable=False pass through untouched.  Returns a new
    PacketBatch (host-side NumPy; stamping happens before SRTP in the
    send chain, exactly as the reference orders its engines).
    """
    payload = np.asarray(payload, dtype=np.uint8)
    n, L = payload.shape
    if not (1 <= ext_id <= 14) or not (1 <= L <= 16):
        raise ValueError("one-byte ext needs id in 1..14, len in 1..16")
    enable = np.ones(n, bool) if enable is None else np.asarray(enable, bool)

    d = batch.data
    ln = np.asarray(batch.length, dtype=np.int64)
    ext_start = (RTP_FIXED_HEADER_LEN + 4 * hdr.cc).astype(np.int64)
    has_block = (hdr.extension == 1) & (hdr.ext_profile == ONE_BYTE_PROFILE)
    eoff, elen, present = find_one_byte_ext(batch, hdr, ext_id)
    rewrite = enable & present & (elen == L)
    append = enable & has_block & ~rewrite
    fresh = enable & ~has_block & (hdr.extension == 0)

    # same id already present at a DIFFERENT length: blank the stale
    # element to padding zeros before appending, or receivers scanning in
    # order would keep seeing the old value shadowing the new one
    stale = enable & present & (elen != L)
    if np.any(stale):
        d = d.copy()
        scols = np.arange(batch.capacity, dtype=np.int64)[None, :]
        zone = (scols >= (eoff - 1)[:, None]) & \
            (scols < (eoff + elen)[:, None]) & stale[:, None]
        d = np.where(zone, 0, d)

    elem_sz = _ceil4(1 + L)
    grow = np.where(append, elem_sz, np.where(fresh, 4 + elem_sz, 0)
                    ).astype(np.int64)
    if np.any(ln + grow > batch.capacity):
        raise ValueError("extension stamp would exceed batch capacity")

    # insertion point: end of existing block (append) or ext_start (fresh)
    block_end = ext_start + 4 + 4 * hdr.ext_words.astype(np.int64)
    ins = np.where(append, block_end, ext_start)

    # shift: out[:, j] = d[:, j - grow] for j >= ins + grow, zeros (the
    # implicit padding) in [ins, ins + grow).  The JAX package gathers the
    # whole [B, capacity] array per row; here each distinct (ins, grow)
    # pair is one slice copy over its rows, which gives the same bytes
    # without the dense index arrays (the cost of a 256-row mix batch).
    out = d.copy()
    cap = batch.capacity
    moved = np.nonzero(grow)[0]
    pairs = np.stack([ins[moved], grow[moved]], axis=1)
    for i0, g in np.unique(pairs, axis=0).tolist():
        rows = moved[(ins[moved] == i0) & (grow[moved] == g)]
        out[rows, i0 + g:] = d[rows, i0:cap - g]
        out[rows, i0:i0 + g] = 0

    def _write_at(arr, pos, vals, sel):
        """Scatter vals [B, K] at per-row byte offset pos (rows in sel);
        bytes that would land past the capacity are dropped."""
        for k in range(vals.shape[1]):
            col = pos + k
            ok = sel & (col >= 0) & (col < cap)
            arr[ok, col[ok]] = vals[ok, k]

    # fresh rows: block header 0xBEDE | words
    words = np.where(fresh, elem_sz // 4,
                     hdr.ext_words.astype(np.int64) + np.where(append, elem_sz // 4, 0))
    bh = np.zeros((n, 4), dtype=np.uint8)
    bh[:, 0] = ONE_BYTE_PROFILE >> 8
    bh[:, 1] = ONE_BYTE_PROFILE & 0xFF
    bh[:, 2] = (words >> 8) & 0xFF
    bh[:, 3] = words & 0xFF
    # fresh rows get the whole header; append rows the patched length
    _write_at(out, ext_start, bh, fresh | append)

    # element bytes: tag || payload
    elem = np.zeros((n, 1 + L), dtype=np.uint8)
    elem[:, 0] = (ext_id << 4) | (L - 1)
    elem[:, 1:] = payload
    elem_pos = np.where(rewrite, eoff - 1,
                        np.where(append, ins, ins + 4))
    _write_at(out, elem_pos, elem, rewrite | append | fresh)

    # set the X bit on fresh rows
    out[fresh, 0] |= 0x10
    new_len = (ln + grow).astype(np.int32)
    return PacketBatch(out, new_len, batch.stream)
