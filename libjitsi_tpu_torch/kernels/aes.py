"""Batched AES-128/256 and AES-CTR for the PyTorch port.

Counterpart: `libjitsi_tpu/kernels/aes.py`.

- Host part (copied, NumPy): the generated S-box, `expand_key`,
  `expand_keys_batch`, `aes_encrypt_np` and `ctr_keystream_np` — the
  cold paths (key schedules, RFC 3711 key derivation) that never touch
  the device.
- Plain PyTorch versions: `aes_encrypt_plain`, `ctr_keystream`,
  `ctr_crypt`, `f8_keystream_plain` and `f8_crypt_plain`.  They compute
  exactly what the JAX functions `aes_encrypt_table`, `ctr_keystream`,
  `ctr_crypt_uniform`/`_offset`, `f8_keystream` and
  `f8_crypt_uniform`/`_offset` compute (one per-row-offset form covers
  both crypt variants of each mode), on any device; the CPU tests and
  the card's comparisons use them.  The F8 keystream has no wrapper of
  its own: it runs fused inside kernels K, L and the F8 instances of I
  and J (`csrc/srtp_tile.cuh` `f8_tile`).
- `aes_encrypt`: the wrapper of kernel A (`csrc/aes_encrypt.cu`), which
  replaces the Pallas TPU kernel `aes_encrypt_pallas_bitsliced`.  On a
  CUDA tensor it launches the kernel; on a CPU tensor it runs
  `aes_encrypt_plain`.

Byte order is FIPS-197's flat state (index = row + 4*col) throughout,
so blocks go in and out with no repacking.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libjitsi_tpu_torch.kernels import build as _k


# ---------------------------------------------------------------------------
# GF(2^8) tables (host, generated once)
# ---------------------------------------------------------------------------

def _make_sbox() -> np.ndarray:
    # log/antilog over GF(2^8) with generator 0x03
    exp = np.zeros(256, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # x *= 3  (== xtime(x) ^ x)
        x = (((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF) ^ x
    sbox = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        inv = 0 if a == 0 else exp[(255 - log[a]) % 255]
        s = inv
        for _ in range(4):
            inv = ((inv << 1) | (inv >> 7)) & 0xFF
            s ^= inv
        sbox[a] = s ^ 0x63
    return sbox


_SBOX = _make_sbox()

# ShiftRows as a static permutation of the flat (row + 4*col) state:
# out[r + 4c] = in[r + 4*((c + r) % 4)]
_SHIFT_IDX = np.array(
    [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)], dtype=np.int32
)


# ---------------------------------------------------------------------------
# Key expansion (host)
# ---------------------------------------------------------------------------

def expand_key(key) -> np.ndarray:
    """FIPS-197 key schedule.  key: 16 or 32 bytes -> [rounds+1, 16] uint8."""
    key = np.frombuffer(bytes(key), dtype=np.uint8) if isinstance(key, (bytes, bytearray)) else np.asarray(key, dtype=np.uint8)
    if len(key) not in (16, 32):
        raise ValueError("AES key must be 16 or 32 bytes")
    return expand_keys_batch(key[None])[0]


def expand_keys_batch(keys: np.ndarray) -> np.ndarray:
    """[S, 16|32] uint8 -> [S, rounds+1, 16] uint8 round-key tensor.

    Vectorized across streams: the FIPS-197 schedule is sequential in the
    word index (44/60 steps) but embarrassingly parallel across keys.
    """
    keys = np.atleast_2d(np.asarray(keys, dtype=np.uint8))
    s, kl = keys.shape
    if kl not in (16, 32):
        raise ValueError("AES keys must be 16 or 32 bytes")
    nk = kl // 4
    nr = nk + 6
    w = np.zeros((s, 4 * (nr + 1), 4), dtype=np.uint8)
    w[:, :nk] = keys.reshape(s, nk, 4)
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = w[:, i - 1].copy()
        if i % nk == 0:
            t = np.roll(t, -1, axis=1)
            t = _SBOX[t]
            t[:, 0] ^= np.uint8(rcon)
            rcon = ((rcon << 1) ^ (0x11B if rcon & 0x80 else 0)) & 0xFF
        elif nk == 8 and i % nk == 4:
            t = _SBOX[t]
        w[:, i] = w[:, i - nk] ^ t
    # word c of round r -> flat bytes [4c .. 4c+3] == (row + 4*col) layout
    return w.reshape(s, nr + 1, 16)


# ---------------------------------------------------------------------------
# Host cipher (NumPy — cold paths only)
# ---------------------------------------------------------------------------

def _xtime_np(x):
    return ((x << 1) ^ (np.uint8(0x1B) * (x >> 7))).astype(np.uint8)


def aes_encrypt_np(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Host-side batched AES block encrypt (NumPy).

    round_keys: [R, 16] or [B, R, 16]; blocks: [B, 16].  Used by key
    derivation at stream setup and by known-answer tests.
    """
    rk = np.asarray(round_keys, dtype=np.uint8)
    if rk.ndim == 2:
        rk = np.broadcast_to(rk, (blocks.shape[0],) + rk.shape)
    st = np.asarray(blocks, dtype=np.uint8) ^ rk[:, 0, :]
    nr = rk.shape[1] - 1
    for r in range(1, nr):
        st = _SBOX[st][:, _SHIFT_IDX]
        s = st.reshape(-1, 4, 4)
        x = _xtime_np(s)
        r0 = x[..., 0] ^ x[..., 1] ^ s[..., 1] ^ s[..., 2] ^ s[..., 3]
        r1 = s[..., 0] ^ x[..., 1] ^ x[..., 2] ^ s[..., 2] ^ s[..., 3]
        r2 = s[..., 0] ^ s[..., 1] ^ x[..., 2] ^ x[..., 3] ^ s[..., 3]
        r3 = x[..., 0] ^ s[..., 0] ^ s[..., 1] ^ s[..., 2] ^ x[..., 3]
        st = np.stack([r0, r1, r2, r3], axis=-1).reshape(st.shape) ^ rk[:, r, :]
    return (_SBOX[st][:, _SHIFT_IDX] ^ rk[:, nr, :]).astype(np.uint8)


def ctr_keystream_np(round_keys: np.ndarray, iv16: np.ndarray, nbytes: int) -> np.ndarray:
    """Host AES-CTR keystream from one IV block: [R,16] keys, [16] iv -> [nbytes]."""
    nblocks = (nbytes + 15) // 16
    iv = np.asarray(iv16, dtype=np.uint8)
    ctrs = np.zeros((nblocks, 16), dtype=np.uint8)
    val = int.from_bytes(bytes(iv), "big")
    for j in range(nblocks):
        ctrs[j] = np.frombuffer(
            ((val + j) % (1 << 128)).to_bytes(16, "big"), dtype=np.uint8
        )
    return aes_encrypt_np(np.asarray(round_keys), ctrs).reshape(-1)[:nbytes]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    return (torch.as_tensor(_SBOX.astype(np.int64), device=device),
            torch.as_tensor(_SHIFT_IDX.astype(np.int64), device=device))


def _xtime(x):
    return ((x << 1) & 0xFF) ^ (0x1B * (x >> 7))


def _mix_columns(st):
    # st: [..., 16] flat (row + 4*col) -> view as [..., 4 cols, 4 rows]
    s = st.reshape(st.shape[:-1] + (4, 4))
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    x0, x1, x2, x3 = _xtime(s0), _xtime(s1), _xtime(s2), _xtime(s3)
    r0 = x0 ^ (x1 ^ s1) ^ s2 ^ s3
    r1 = s0 ^ x1 ^ (x2 ^ s2) ^ s3
    r2 = s0 ^ s1 ^ x2 ^ (x3 ^ s3)
    r3 = (x0 ^ s0) ^ s1 ^ s2 ^ x3
    return torch.stack([r0, r1, r2, r3], dim=-1).reshape(st.shape)


def aes_encrypt_plain(round_keys: torch.Tensor,
                      blocks: torch.Tensor) -> torch.Tensor:
    """Batched AES block encrypt, plain PyTorch (S-box gather core).

    round_keys: [..., R, 16] uint8 (R = 11 for AES-128, 15 for AES-256);
    blocks: [..., 16] uint8 -> [..., 16] uint8.  Same function as the JAX
    package's `aes_encrypt_table`.
    """
    _k.plain_calls["aes_encrypt"] += 1
    sbox, shift = _consts(blocks.device)
    rk = round_keys.long()
    st = blocks.long() ^ rk[..., 0, :]
    nr = rk.shape[-2] - 1
    for r in range(1, nr):
        st = _mix_columns(sbox[st][..., shift]) ^ rk[..., r, :]
    return (sbox[st][..., shift] ^ rk[..., nr, :]).to(torch.uint8)


def _counter_blocks(iv: torch.Tensor, nblocks: int) -> torch.Tensor:
    """[B, 16] iv -> [B, nblocks, 16] counter blocks: the IV plus the
    block number as one 128-bit big-endian integer, carry included."""
    b = iv.long().reshape(iv.shape[0], 4, 4)
    limbs = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    j = torch.arange(nblocks, dtype=torch.int64, device=iv.device)[None, :]
    l3 = limbs[:, 3:4] + j
    l2 = limbs[:, 2:3] + (l3 >> 32)
    l1 = limbs[:, 1:2] + (l2 >> 32)
    l0 = limbs[:, 0:1] + (l1 >> 32)
    words = torch.stack([l0, l1, l2, l3], dim=-1) & _M32     # [B, n, 4]
    shifts = torch.tensor([24, 16, 8, 0], device=iv.device)
    return ((words[..., None] >> shifts) & 0xFF).reshape(
        iv.shape[0], nblocks, 16).to(torch.uint8)


def ctr_keystream(round_keys: torch.Tensor, iv: torch.Tensor,
                  nblocks: int) -> torch.Tensor:
    """AES-CTR keystream: [B, R, 16] keys + [B, 16] iv -> [B, nblocks*16].

    The counter is the full 128-bit big-endian block (NIST SP 800-38A);
    SRTP's 16-bit block counter (RFC 3711 §4.1.1) is the case where the
    IV's low 16 bits start at zero.
    """
    bsz = iv.shape[0]
    ctr = _counter_blocks(iv, nblocks)
    # widen before broadcasting: the expanded view is never materialized
    rk = round_keys.long()[:, None].expand(bsz, nblocks,
                                           *round_keys.shape[1:])
    return aes_encrypt_plain(rk, ctr).reshape(bsz, nblocks * 16)


def ctr_crypt(round_keys: torch.Tensor, iv: torch.Tensor,
              data: torch.Tensor, offset: torch.Tensor,
              length: torch.Tensor) -> torch.Tensor:
    """XOR an AES-CTR keystream into each row's [offset, offset+length).

    data: [B, W] uint8; offset/length: [B] — per-row payload windows.
    Column j of a window takes keystream byte j - offset; bytes outside
    pass through.  Encrypt == decrypt.  Covers both of the JAX
    package's `ctr_crypt_uniform` (every row at one offset) and
    `ctr_crypt_offset`.  -> [B, W] uint8.
    """
    nblocks = (data.shape[1] + 15) // 16
    return _xor_window(data, ctr_keystream(round_keys, iv, nblocks), offset,
                       length)


def f8_m(session_key: bytes, session_salt: bytes) -> bytes:
    """RFC 3711 §4.1.2.2: m = k_s || 0x55.. padded to the key length."""
    return session_salt + b"\x55" * (len(session_key) - len(session_salt))


def f8_keystream_plain(round_keys: torch.Tensor, f8_round_keys: torch.Tensor,
                       iv: torch.Tensor, nblocks: int) -> torch.Tensor:
    """AES-F8 keystream (RFC 3711 §4.1.2): [B, R, 16] schedules of k_e
    and of k_e XOR m, [B, 16] IVs -> [B, nblocks*16].

    IV' = E(k_e XOR m, IV), then S(j) = E(k_e, IV' XOR j XOR S(j-1)) with
    S(-1) = 0 and j a 32-bit big-endian counter XORed into bytes 12-15
    only: sequential over a row's blocks, parallel over rows.
    """
    ivp = aes_encrypt_plain(f8_round_keys, iv)
    bsz = iv.shape[0]
    shifts = torch.tensor([24, 16, 8, 0], device=iv.device)
    s = torch.zeros_like(ivp)
    out = []
    for j in range(nblocks):
        blk = ivp ^ s
        jb = ((torch.tensor(j, device=iv.device) >> shifts) & 0xFF).to(
            torch.uint8)
        blk = torch.cat([blk[:, :12], blk[:, 12:] ^ jb[None, :]], dim=1)
        s = aes_encrypt_plain(round_keys, blk)
        out.append(s)
    if not out:
        return torch.zeros((bsz, 0), dtype=torch.uint8, device=iv.device)
    return torch.stack(out, dim=1).reshape(bsz, nblocks * 16)


def f8_crypt_plain(round_keys: torch.Tensor, f8_round_keys: torch.Tensor,
                   iv: torch.Tensor, data: torch.Tensor, offset: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """XOR an AES-F8 keystream into each row's [offset, offset+length),
    keystream byte k at column offset + k; bytes outside pass through.
    Encrypt == decrypt.  Covers both of the JAX package's
    `f8_crypt_uniform` and `f8_crypt_offset` (the uniform form's shorter
    keystream is a prefix of the same one).  -> [B, W] uint8.
    """
    width = data.shape[1]
    nblocks = (width + 15) // 16
    ks = f8_keystream_plain(round_keys, f8_round_keys, iv, nblocks)
    return _xor_window(data, ks, offset, length)


def _xor_window(data, ks, offset, length):
    """Column j of row i's window [offset, offset + length) takes
    keystream byte j - offset of ks [B, n]; the rest passes through."""
    if ks.shape[1] == 0:
        return data
    col = torch.arange(data.shape[1], device=data.device)[None, :]
    off = offset.long()[:, None]
    ln = length.long()[:, None]
    rel = (col - off).clamp(0, ks.shape[1] - 1)
    inside = (col >= off) & (col < off + ln)
    return torch.where(inside, data ^ ks.gather(1, rel), data)


# ---------------------------------------------------------------------------
# Kernel A wrapper
# ---------------------------------------------------------------------------

def aes_encrypt(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Batched AES block encrypt: [N, R, 16] keys, [N, 16] blocks -> [N, 16].

    CUDA tensors go through kernel A (`csrc/aes_encrypt.cu`); CPU tensors
    through `aes_encrypt_plain`.
    """
    if _k.route(blocks) == "cpu":
        return aes_encrypt_plain(round_keys, blocks)
    dev = blocks.device
    n = blocks.shape[0]
    if round_keys.dim() != 3 or round_keys.shape[1] not in (11, 15):
        raise ValueError("round_keys must be [N, 11 | 15, 16]")
    _k.expect(blocks, "blocks", torch.uint8, dev, (n, 16))
    _k.expect(round_keys, "round_keys", torch.uint8, dev,
              (n, round_keys.shape[1], 16))
    if blocks.data_ptr() % 16 or round_keys.data_ptr() % 16:
        raise ValueError("blocks and round_keys must be 16-byte aligned "
                         "(kernel A loads them as 16-byte vectors)")
    out = torch.empty((n, 16), dtype=torch.uint8, device=dev)
    if n:
        rc = _k.library().ljt_aes_encrypt(
            round_keys.data_ptr(), blocks.data_ptr(), out.data_ptr(), n,
            round_keys.shape[1] - 1, _k.stream_handle(dev))
        _k.check(rc, "aes_encrypt")
        _k.launches["aes_encrypt"] += 1
    return out
