"""Batched SHA-1 / HMAC-SHA1 for the PyTorch port.

Counterpart: `libjitsi_tpu/kernels/sha1.py`.

- Host part (copied, NumPy): `hmac_precompute`, `hmac_precompute_batch`
  and `_compress_blocks_np` — the per-key ipad/opad midstates, computed
  once per stream at install time.
- Plain PyTorch versions: `sha1` and `hmac_sha1_plain`, the same
  masked-block formulation as the JAX package (pad every row to the
  widest block count, compress, keep each row's state only while its
  own blocks last), in int64 with `& 0xFFFFFFFF` so no shift is ever
  arithmetic on a sign bit.
- `hmac_sha1`: the wrapper of kernel B (`csrc/hmac_sha1.cu`), launched
  for CUDA tensors; CPU tensors run `hmac_sha1_plain`.

Midstates travel as int32 tensors holding the uint32 bit patterns.
Lengths are clamped to [0, W] (a longer length has no bytes to hash).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from libjitsi_tpu_torch.kernels import build as _k

_H0 = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0],
               dtype=np.uint32)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)

BLOCK = 64  # bytes
DIGEST = 20  # bytes
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# HMAC key midstates (host)
# ---------------------------------------------------------------------------

def hmac_precompute(key: bytes) -> np.ndarray:
    """Host-side: compress the ipad/opad blocks once per key.

    Returns a [2, 5] uint32 midstate array (row 0 = inner, row 1 = outer).
    """
    if len(key) > BLOCK:
        key = hashlib.sha1(key).digest()
    return hmac_precompute_batch(np.frombuffer(key, dtype=np.uint8)[None])[0]


def hmac_precompute_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorized `hmac_precompute`: [S, kl<=64] uint8 -> [S, 2, 5] uint32."""
    keys = np.atleast_2d(np.asarray(keys, dtype=np.uint8))
    s, kl = keys.shape
    if kl > BLOCK:
        raise ValueError("batched HMAC keys must be <= one block (64B)")
    k = np.zeros((s, BLOCK), dtype=np.uint8)
    k[:, :kl] = keys
    # the ipad and opad blocks of every key in one compression pass (the
    # pass's cost is mostly per call: a key install of a few rows)
    blk = np.concatenate([k ^ 0x36, k ^ 0x5C]).astype(np.uint32).reshape(
        2 * s, 16, 4)
    w16 = ((blk[..., 0] << 24) | (blk[..., 1] << 16)
           | (blk[..., 2] << 8) | blk[..., 3])
    mid = _compress_blocks_np(_H0, w16)
    out = np.empty((s, 2, 5), dtype=np.uint32)   # C order, for the kernels
    out[:, 0] = mid[:s]
    out[:, 1] = mid[s:]
    return out


def _compress_blocks_np(h: np.ndarray, w16: np.ndarray) -> np.ndarray:
    """SHA-1 compression on host, vectorized over lanes (cold path only).

    h: [5] or [S, 5] uint32 initial state; w16: [S, 16] uint32 words.
    """
    mask = np.uint64(0xFFFFFFFF)
    w16 = np.atleast_2d(w16)
    s = w16.shape[0]
    h = np.broadcast_to(np.asarray(h, dtype=np.uint32), (s, 5))

    def rotl(x, n):
        return ((x << np.uint64(n)) | (x >> np.uint64(32 - n))) & mask

    w = [w16[:, t].astype(np.uint64) for t in range(16)]
    for t in range(16, 80):
        w.append(rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
    a, b, c, d, e = (h[:, i].astype(np.uint64) for i in range(5))
    K = tuple(np.uint64(k) for k in _K)
    for t in range(80):
        if t < 20:
            f = (b & c) | (~b & d & mask)
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = (rotl(a, 5) + f + e + K[t // 20] + w[t]) & mask
        a, b, c, d, e = tmp, a, rotl(b, 30), c, d
    out = np.stack([a, b, c, d, e], axis=1)
    return ((out + h.astype(np.uint64)) & mask).astype(np.uint32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device)
# ---------------------------------------------------------------------------

def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & _M32


def _compress(h, w16):
    """One SHA-1 compression: h [B, 5], w16 [B, 16], int64 words."""
    w = [w16[:, t] for t in range(16)]
    for t in range(16, 80):
        w.append(_rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
    a, b, c, d, e = (h[:, i] for i in range(5))
    for t in range(80):
        if t < 20:
            f = (b & c) | ((b ^ _M32) & d)
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = (_rotl(a, 5) + f + e + _K[t // 20] + w[t]) & _M32
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return (h + torch.stack([a, b, c, d, e], dim=1)) & _M32


def _pad_and_blockify(data, lengths, bit_offset: int):
    """Padded message blocks [B, nblk, 16] int64 + per-row block counts.

    `bit_offset` is added to the encoded bit length (512 for HMAC tails
    whose key block was already compressed into the midstate).
    """
    bsz, width = data.shape
    dev = data.device
    max_total = ((width + 9 + BLOCK - 1) // BLOCK) * BLOCK
    ln = lengths.long().clamp(0, width)
    nblocks = (ln + 9 + BLOCK - 1) // BLOCK
    idx = torch.arange(max_total, device=dev)[None, :]
    buf = torch.zeros((bsz, max_total), dtype=torch.int64, device=dev)
    buf[:, :width] = data.long()
    buf = torch.where(idx < ln[:, None], buf, 0)
    buf = torch.where(idx == ln[:, None], 0x80, buf)
    # 64-bit big-endian bit length in the last 8 bytes of the last used
    # block; the high word is 0 for any row width here
    bitlen = ((ln * 8 + bit_offset) & _M32)[:, None]
    tpos = (nblocks * BLOCK)[:, None] - 8 + torch.arange(8, device=dev)
    shift = torch.tensor([56, 48, 40, 32, 24, 16, 8, 0], device=dev)
    lenbytes = torch.where(shift >= 32, 0, (bitlen >> shift.clamp(max=31))
                           & 0xFF)
    buf.scatter_(1, tpos, lenbytes)
    words = buf.reshape(bsz, max_total // BLOCK, 16, 4)
    w16 = ((words[..., 0] << 24) | (words[..., 1] << 16)
           | (words[..., 2] << 8) | words[..., 3])
    return w16, nblocks


def _sha1_core(w16, nblocks, h0):
    """Masked compression over all blocks; h0 [B, 5] int64."""
    h = h0
    for i in range(w16.shape[1]):
        hn = _compress(h, w16[:, i, :])
        h = torch.where((i < nblocks)[:, None], hn, h)
    return h


def _digest_bytes(h):
    """[B, 5] int64 words -> [B, 20] uint8 big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=h.device)
    return ((h[:, :, None] >> shifts) & 0xFF).reshape(
        h.shape[0], DIGEST).to(torch.uint8)


def sha1(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Batched SHA-1.  data: [B, L] uint8; lengths: [B]. -> [B, 20] uint8."""
    w16, nblocks = _pad_and_blockify(data, lengths, 0)
    h0 = torch.as_tensor(_H0.astype(np.int64), device=data.device)
    return _digest_bytes(_sha1_core(w16, nblocks,
                                    h0.expand(data.shape[0], 5)))


def hmac_sha1_plain(midstates: torch.Tensor, data: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Batched HMAC-SHA1 from key midstates, plain PyTorch.

    midstates: [B, 2, 5] (uint32 bit patterns, from `hmac_precompute`);
    data: [B, L] uint8; lengths: [B].  -> [B, 20] uint8 tags.
    """
    _k.plain_calls["hmac_sha1"] += 1
    mid = midstates.long() & _M32
    w16, nblocks = _pad_and_blockify(data, lengths, 512)
    inner = _digest_bytes(_sha1_core(w16, nblocks, mid[:, 0, :]))
    lens20 = torch.full((data.shape[0],), DIGEST, device=data.device)
    w16o, nbo = _pad_and_blockify(inner, lens20, 512)
    return _digest_bytes(_sha1_core(w16o, nbo, mid[:, 1, :]))


# ---------------------------------------------------------------------------
# Kernel B wrapper
# ---------------------------------------------------------------------------

def hmac_sha1(midstates: torch.Tensor, data: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Batched HMAC-SHA1: [B, 2, 5] int32 midstates, [B, L] uint8 data,
    [B] int32 lengths -> [B, 20] uint8.

    CUDA tensors go through kernel B (`csrc/hmac_sha1.cu`); CPU tensors
    through `hmac_sha1_plain`.
    """
    if _k.route(data) == "cpu":
        return hmac_sha1_plain(midstates, data, lengths)
    dev = data.device
    bsz, width = data.shape
    _k.expect(midstates, "midstates", torch.int32, dev, (bsz, 2, 5))
    _k.expect(data, "data", torch.uint8, dev)
    _k.expect(lengths, "lengths", torch.int32, dev, (bsz,))
    out = torch.empty((bsz, DIGEST), dtype=torch.uint8, device=dev)
    if bsz:
        rc = _k.library().ljt_hmac_sha1(
            midstates.data_ptr(), data.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), bsz, width, _k.stream_handle(dev))
        _k.check(rc, "hmac_sha1")
        _k.launches["hmac_sha1"] += 1
    return out
