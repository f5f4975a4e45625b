"""GHASH, GCM's GF(2^128) universal hash: host math, the packed matrix
form and the plain PyTorch Horner.

Counterpart: `libjitsi_tpu/kernels/ghash.py` (`gf_mult`, `ghash_matrix`,
`ghash_matrix_batch`, `ghash_ref`, and the device functions `ghash`,
`ghash_grouped`, `ghash_grouped_packed`, which this module's
`ghash_plain` replaces: all four give the same digests).

Multiplication by the fixed hash key H is GF(2)-linear, so a Horner step
Y <- (Y xor X) * H is a 128 x 128 bit matrix M_H applied to a 128-bit
vector.  The port keeps M_H packed, [128, 4] 32-bit words a stream (row i
of M_H as four words, bit j at bit 31 - j % 32 of word j // 32, the
order of the JAX package's `_pack_bits`), 2 KB a stream where the JAX
int8 form takes 16 KB.  Bit i of X * H is then the parity of the 128
bits of (row i AND X): on the card (`csrc/ghash.cuh`) a warp holds the
matrix in registers, lane l four rows, and each Horner step is 16 AND
folded into 4 popcounts and 4 ballots a lane, with no load or branch
that depends on H, the state or the data.

Bit order follows NIST SP 800-38D: bit 0 is the MSB of byte 0.
"""

from __future__ import annotations

import numpy as np
import torch

_R = 0xE1 << 120  # reduction polynomial bits (11100001 || 0^120)
_M32 = 0xFFFFFFFF


def gf_mult(x: int, y: int) -> int:
    """SP 800-38D §6.3 multiplication on 128-bit ints (b0 = MSB)."""
    z = 0
    v = y
    for i in range(128):
        if (x >> (127 - i)) & 1:
            z ^= v
        lsb = v & 1
        v >>= 1
        if lsb:
            v ^= _R
    return z


def ghash_matrix(h_block: bytes) -> np.ndarray:
    """[128, 128] uint8 matrix M with (M @ bits(X)) % 2 == bits(X * H),
    for the 16-byte hash subkey H = AES_K(0^128)."""
    return ghash_matrix_batch(np.frombuffer(bytes(h_block), np.uint8))[0]


def _columns(h_blocks: np.ndarray) -> np.ndarray:
    """[S, 16] uint8 H blocks -> [S, 128, 128] uint8 bits whose row j is
    column j of M_H, H * x^j: one right shift and a conditional
    reduction a step, 128 vector steps across all S streams."""
    hb = np.atleast_2d(np.asarray(h_blocks, dtype=np.uint8))
    rbits = np.unpackbits(
        np.frombuffer(_R.to_bytes(16, "big"), dtype=np.uint8))
    cols = np.empty((hb.shape[0], 128, 128), dtype=np.uint8)
    cols[:, 0] = np.unpackbits(hb, axis=1)          # b0 = MSB
    for j in range(1, 128):
        prev, cur = cols[:, j - 1], cols[:, j]
        cur[:, 0] = 0
        cur[:, 1:] = prev[:, :-1]
        cur ^= prev[:, 127:128] * rbits[None, :]    # x^127 reduces
    return cols


def ghash_matrix_batch(h_blocks: np.ndarray) -> np.ndarray:
    """Vectorized `ghash_matrix`: [S, 16] uint8 H blocks -> [S, 128,
    128] uint8 matrices (column j is H * x^j)."""
    return np.ascontiguousarray(_columns(h_blocks).transpose(0, 2, 1))


def pack_matrices(m: np.ndarray) -> np.ndarray:
    """[S, 128, 128] 0/1 matrices (any integer type) -> [S, 128, 4]
    uint32: row i's bit j at bit 31 - j % 32 of word j // 32."""
    bits = np.asarray(m).astype(np.uint8) & 1
    return np.packbits(bits, axis=-1).view(">u4").astype(np.uint32)


def unpack_matrices(words: np.ndarray) -> np.ndarray:
    """[S, 128, 4] packed rows (uint32 or their int32 bit patterns) ->
    [S, 128, 128] int8 0/1 matrices, the JAX package's form."""
    w = np.ascontiguousarray(np.asarray(words).astype(np.uint32)
                             .astype(">u4"))
    return np.unpackbits(w.view(np.uint8), axis=-1).astype(np.int8)


def ghash_matrix_packed(h_blocks: np.ndarray, chunk: int = 1024
                        ) -> np.ndarray:
    """[S, 16] H blocks -> [S, 128, 4] uint32 packed matrices, packed
    straight from the columns, `chunk` streams at a time so a 10k-stream
    install never holds the 16 KB-a-stream bit form of every stream."""
    hb = np.atleast_2d(np.asarray(h_blocks, dtype=np.uint8))
    out = np.zeros((hb.shape[0], 128, 4), dtype=np.uint32)
    for lo in range(0, hb.shape[0], chunk):
        # byte k of packed row i holds bits j = 8k .. 8k + 7 of row i
        by = np.packbits(_columns(hb[lo:lo + chunk]), axis=1)  # [s, 16, i]
        out[lo:lo + chunk] = np.ascontiguousarray(
            by.transpose(0, 2, 1)).view(">u4").astype(np.uint32)
    return out


def ghash_ref(h_block: bytes, data: bytes) -> bytes:
    """Host reference GHASH over a whole (block-aligned) byte string."""
    if len(data) % 16:
        raise ValueError("ghash input must be block-aligned")
    h = int.from_bytes(h_block, "big")
    y = 0
    for i in range(0, len(data), 16):
        y = gf_mult(y ^ int.from_bytes(data[i:i + 16], "big"), h)
    return y.to_bytes(16, "big")


# ------------------------------------------------------------ plain Horner

def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Parity of each 32-bit value held in an int64 tensor."""
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> sh)
    return x & 1


def _bytes_to_words(blk: torch.Tensor) -> torch.Tensor:
    """[..., 16] uint8 -> [..., 4] int64 big-endian words."""
    b = blk.long().reshape(*blk.shape[:-1], 4, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def _words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """[..., 4] big-endian words (int64) -> [..., 16] uint8."""
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    return ((w[..., :, None] >> shifts) & 0xFF).reshape(
        *w.shape[:-1], 16).to(torch.uint8)


def ghash_plain(gm: torch.Tensor, data: torch.Tensor,
                nblocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GHASH: gm [B, 128, 4] int32 packed matrices (uint32
    bit patterns), data [B, n*16] uint8 block streams, nblocks [B] the
    blocks each row hashes (at most n) -> [B, 16] uint8 digests.

    Each Horner step ANDs the 128 packed rows with Y xor X and takes the
    parity of each row; rows past their block count keep their Y.
    """
    bsz = data.shape[0]
    m = gm.long() & _M32                                     # [B, 128, 4]
    shifts = torch.arange(31, -1, -1, device=data.device)
    y = torch.zeros((bsz, 4), dtype=torch.int64, device=data.device)
    nb = nblocks.long()
    for i in range(data.shape[1] // 16):
        t = y ^ _bytes_to_words(data[:, 16 * i:16 * i + 16])
        and_ = m & t[:, None, :]
        bits = _parity32(and_[..., 0] ^ and_[..., 1] ^ and_[..., 2]
                         ^ and_[..., 3])                     # [B, 128]
        y2 = (bits.reshape(bsz, 4, 32) << shifts).sum(-1)
        y = torch.where((i < nb)[:, None], y2, y)
    return _words_to_bytes(y)
