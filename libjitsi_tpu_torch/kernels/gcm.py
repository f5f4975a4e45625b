"""Batched AES-GCM AEAD (SP 800-38D) for SRTP and SRTCP (RFC 7714):
plain PyTorch versions, the RFC 7714 IV, and kernel O (the keystream
cache's fill).

Counterpart: `libjitsi_tpu/kernels/gcm.py`.  The JAX package seals and
opens through several device functions that give the same bytes:
per-row (`gcm_protect`, `gcm_unprotect`), stream-grouped
(`*_grouped`), cached (`*_cached`, `*_cached_grouped`, with an int8 or
a packed GHASH) and the full-mesh fan-out (`gcm_protect_fanout`).  The
port keeps one function a direction (`gcm_protect`, `gcm_unprotect`,
and their cached twins), which the tests hold against every JAX variant;
on the card they are kernels M and N (`csrc/srtp_gcm.cu`, wrappers in
`transform/srtp/kernel.py`) and H's GCM instance (`csrc/srtp_fanout.cu`).

Layout, as the SRTP packet: data[:aad_len] is the AAD (the RTP header, or
the SRTCP header and E || index word) and data[aad_len:length] the
plaintext or ciphertext, encrypted in place; the 16-byte tag follows it.
CTR starts at inc32(J0), J0 = IV || 0x00000001; within one packet the
low word never wraps, so the CTR stage's 128-bit counter add gives the
same blocks.  GHASH runs over AAD || 0* || C || 0* || be64(aad bits) ||
be64(ct bits), ceil(a/16) + ceil(c/16) + 1 blocks a row.

Edge semantics, shared by the kernels and these plain versions: lengths
are clamped to the row, [0, W]; the AAD to [0, L] for the clamped length
L (seal) or L - 16 (open); ct = L - aad.  Seal writes the tag at L, bytes
past the row dropped, and returns length + 16; open reads the tag at
L - 16, fails a row shorter than a tag, always decrypts (the caller masks
failed rows) and returns length - 16.  The cached versions XOR keystream
byte k of the row's slot into ct byte k for k < KS (the slot's bytes);
past KS they XOR nothing, where the table's hit test never lets a row go.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libjitsi_tpu_torch.kernels import build as _k
from libjitsi_tpu_torch.kernels.aes import (_xor_window, aes_encrypt_plain,
                                            ctr_keystream)
from libjitsi_tpu_torch.kernels.ghash import ghash_plain
from libjitsi_tpu_torch.kernels.scatter import gather_span, scatter_bytes

TAG_LEN = 16


def _ceil16(x):
    return (x + 15) & ~15


def _length_block(aad: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """[B] byte counts -> [B, 16] uint8 be64(aad bits) || be64(ct bits)."""
    shifts = torch.arange(56, -8, -8, device=aad.device)
    a = ((aad.long()[:, None] * 8) >> shifts) & 0xFF
    c = ((ct.long()[:, None] * 8) >> shifts) & 0xFF
    return torch.cat([a, c], dim=1).to(torch.uint8)


def ghash_input(data: torch.Tensor, aad: torch.Tensor, ct: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, W] rows -> ([B, ceil16(W) + 32] GHASH block streams AAD || 0* ||
    C || 0* || lengths, [B] block counts), for per-row AAD and ciphertext
    lengths with aad + ct <= W."""
    bsz, w = data.shape
    width = _ceil16(w) + 32
    a = aad.long()[:, None]
    c = ct.long()[:, None]
    ap = _ceil16(a)
    cp = _ceil16(c)
    cols = torch.arange(width, device=data.device)[None, :]
    in_aad = cols < a
    k = cols - ap
    in_ct = (k >= 0) & (k < c)
    src = torch.where(in_aad, cols, torch.where(in_ct, a + k, 0))
    got = data.gather(1, src.clamp(0, w - 1))
    out = torch.where(in_aad | in_ct, got, torch.zeros_like(got))
    p = cols - (ap + cp)
    lb = _length_block(aad, ct)
    out = torch.where((p >= 0) & (p < 16), lb.gather(1, p.clamp(0, 15)), out)
    return out, ((ap + cp) // 16 + 1)[:, 0]


def j0_blocks(iv12: torch.Tensor) -> torch.Tensor:
    """[B, 12] -> [B, 16] J0 = IV || 0x00000001."""
    tail = torch.tensor([0, 0, 0, 1], dtype=torch.uint8, device=iv12.device)
    return torch.cat([iv12, tail.expand(iv12.shape[0], 4)], dim=1)


def inc32(block: torch.Tensor) -> torch.Tensor:
    """Increment the last 32 bits (big-endian, wrapping) of [B, 16]."""
    lo = block[:, 12:].long()
    v = ((lo[:, 0] << 24) | (lo[:, 1] << 16) | (lo[:, 2] << 8) | lo[:, 3])
    v = (v + 1) & 0xFFFFFFFF
    shifts = torch.tensor([24, 16, 8, 0], device=block.device)
    return torch.cat([block[:, :12],
                      ((v[:, None] >> shifts) & 0xFF).to(torch.uint8)], 1)


def _windows(length, aad_len, width: int, opening: bool):
    """(clamped length L, aad, ct) of each row (see the module doc)."""
    ln = length.long().clamp(0, width)
    m = (ln - TAG_LEN).clamp(min=0) if opening else ln
    a = aad_len.long().clamp(min=0)
    a = torch.minimum(a, m)
    return ln, a, m - a


def _digest(gm, data, a, c):
    gin, nblk = ghash_input(data, a, c)
    return ghash_plain(gm, gin, nblk)


def gcm_protect(data, length, aad_len, round_keys, gm, iv12
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched seal (JAX `gcm_protect`, `gcm_protect_grouped` and
    `gcm_protect_fanout`): encrypt data[aad:length] in place and append the
    tag.  data [B, W] uint8; length, aad_len [B] int32; round_keys
    [B, R, 16] uint8; gm [B, 128, 4] int32 packed GHASH matrices; iv12
    [B, 12] uint8.  Returns (data', length + 16)."""
    ln, a, c = _windows(length, aad_len, data.shape[1], False)
    j0 = j0_blocks(iv12)
    nblocks = (data.shape[1] + 15) // 16
    ks = ctr_keystream(round_keys, inc32(j0), nblocks)
    enc = _xor_window(data, ks, a, c)
    tag = _digest(gm, enc, a, c) ^ aes_encrypt_plain(round_keys, j0)
    return (scatter_bytes(enc, ln, tag, TAG_LEN),
            (length + TAG_LEN).to(torch.int32))


def gcm_unprotect(data, length, aad_len, round_keys, gm, iv12):
    """Batched open (JAX `gcm_unprotect`, `gcm_unprotect_grouped`): check
    the tag over the received ciphertext (all 16 bytes), decrypt always.
    Returns (data', length - 16, auth_ok)."""
    ln, a, c = _windows(length, aad_len, data.shape[1], True)
    j0 = j0_blocks(iv12)
    want = _digest(gm, data, a, c) ^ aes_encrypt_plain(round_keys, j0)
    auth_ok = ((gather_span(data, ln - TAG_LEN, TAG_LEN) == want).all(1)
               & (ln >= TAG_LEN))
    nblocks = (data.shape[1] + 15) // 16
    ks = ctr_keystream(round_keys, inc32(j0), nblocks)
    return (_xor_window(data, ks, a, c), (length - TAG_LEN).to(torch.int32),
            auth_ok)


def _xor_cached(data, ks, a, c):
    """XOR slot keystream rows ks [B, KS] into [a, a + c); bytes past KS
    take nothing."""
    pad = max(0, data.shape[1] - ks.shape[1])
    ks = torch.nn.functional.pad(ks, (0, pad))
    return _xor_window(data, ks, a, c)


def gcm_protect_cached(data, length, aad_len, ks, ek, gm
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gcm_protect` with the AES plane precomputed (JAX
    `gcm_protect_cached` and `_cached_grouped`): ks [B, KS] uint8 is the
    CTR keystream from inc32(J0), ek [B, 16] the tag mask E(K, J0)."""
    ln, a, c = _windows(length, aad_len, data.shape[1], False)
    enc = _xor_cached(data, ks, a, c)
    tag = _digest(gm, enc, a, c) ^ ek
    return (scatter_bytes(enc, ln, tag, TAG_LEN),
            (length + TAG_LEN).to(torch.int32))


def gcm_unprotect_cached(data, length, aad_len, ks, ek, gm):
    """`gcm_unprotect` on cached keystream and tag-mask rows."""
    ln, a, c = _windows(length, aad_len, data.shape[1], True)
    want = _digest(gm, data, a, c) ^ ek
    auth_ok = ((gather_span(data, ln - TAG_LEN, TAG_LEN) == want).all(1)
               & (ln >= TAG_LEN))
    return (_xor_cached(data, ks, a, c), (length - TAG_LEN).to(torch.int32),
            auth_ok)


def srtp_gcm_iv(salt12: np.ndarray, ssrc: np.ndarray,
                index: np.ndarray) -> np.ndarray:
    """RFC 7714 §8.1 SRTP IV: (00 00 || SSRC || ROC || SEQ) XOR salt, on
    the host, broadcasting: `salt12` [..., >=12] uint8 is copied and XORed
    with `ssrc` (bytes 2..5) and the 48-bit `index` (bytes 6..11)."""
    iv = np.array(salt12[..., :12], dtype=np.uint8, copy=True)
    ssrc = np.asarray(ssrc, dtype=np.int64)
    index = np.asarray(index, dtype=np.int64)
    for k in range(4):
        iv[..., 2 + k] ^= ((ssrc >> (8 * (3 - k))) & 0xFF).astype(np.uint8)
    for k in range(6):
        iv[..., 6 + k] ^= ((index >> (8 * (5 - k))) & 0xFF).astype(np.uint8)
    return iv


def srtcp_gcm_iv(salt12: np.ndarray, ssrc: np.ndarray,
                 index: np.ndarray) -> np.ndarray:
    """RFC 7714 §9.1 SRTCP IV: (00 00 || SSRC || 00 00 || index) XOR
    salt."""
    iv = np.array(salt12[..., :12], dtype=np.uint8, copy=True)
    ssrc = np.asarray(ssrc, dtype=np.int64)
    index = np.asarray(index, dtype=np.int64)
    for k in range(4):
        iv[..., 2 + k] ^= ((ssrc >> (8 * (3 - k))) & 0xFF).astype(np.uint8)
        iv[..., 8 + k] ^= ((index >> (8 * (3 - k))) & 0xFF).astype(np.uint8)
    return iv


# ------------------------------------------------ kernel O: the cache fill

def gcm_ks_fill_plain(ks_tab, ek_tab, tab_rk, stream, iv12, slot) -> None:
    """Plain PyTorch fill of the keystream cache's slot tables, in place:
    slot[k]'s row of ks_tab [N, KS] gets KS bytes of CTR keystream from
    inc32(J0) and its row of ek_tab [N, 16] E(K, J0), under table row
    stream[k]'s round keys (tab_rk [S, R, 16], stream ids clamped into
    it) and IV iv12[k]; slots outside the tables are skipped."""
    _k.plain_calls["gcm_ks_fill"] += 1
    sid = stream.long().clamp(0, tab_rk.shape[0] - 1)
    rk = tab_rk[sid]
    j0 = j0_blocks(iv12)
    ks = ctr_keystream(rk, inc32(j0), ks_tab.shape[1] // 16)
    s = slot.long()
    keep = (s >= 0) & (s < ks_tab.shape[0])
    ks_tab[s[keep]] = ks[keep]
    ek_tab[s[keep]] = aes_encrypt_plain(rk, j0)[keep]


def gcm_ks_fill(ks_tab, ek_tab, tab_rk, stream, iv12, slot) -> None:
    """Fill the keystream cache's slots (JAX `keystream._fill_dev`), in
    place: the tables are updated where they lie, not copied.  CUDA tensors
    go through kernel O (`csrc/gcm_fill.cu`); CPU tensors through
    `gcm_ks_fill_plain`.  Slots must be distinct (the cache's fill gives
    each (row, index) pair one slot)."""
    if _k.route(ks_tab) == "cpu":
        return gcm_ks_fill_plain(ks_tab, ek_tab, tab_rk, stream, iv12, slot)
    dev = ks_tab.device
    n = slot.shape[0]
    n_slots, ks_bytes = ks_tab.shape
    if ks_bytes % 16 or ks_bytes == 0:
        raise ValueError("ks_tab rows must be whole 16-byte blocks")
    if tab_rk.dim() != 3 or tab_rk.shape[1] != 11:
        raise ValueError("kernel O takes AES-128 round keys [S, 11, 16]")
    _k.expect(ks_tab, "ks_tab", torch.uint8, dev)
    _k.expect(ek_tab, "ek_tab", torch.uint8, dev, (n_slots, 16))
    _k.expect(tab_rk, "tab_rk", torch.uint8, dev, tuple(tab_rk.shape))
    _k.expect(stream, "stream", torch.int32, dev, (n,))
    _k.expect(iv12, "iv12", torch.uint8, dev, (n, 12))
    _k.expect(slot, "slot", torch.int32, dev, (n,))
    if n:
        rc = _k.library().ljt_gcm_ks_fill(
            tab_rk.data_ptr(), tab_rk.shape[0], stream.data_ptr(),
            iv12.data_ptr(), slot.data_ptr(), ks_tab.data_ptr(),
            ek_tab.data_ptr(), n, n_slots, ks_bytes, tab_rk.shape[1] - 1,
            _k.stream_handle(dev))
        _k.check(rc, "gcm_ks_fill")
        _k.launches["gcm_ks_fill"] += 1
        _k.count_instance("gcm_ks_fill", tab_rk.shape[1] - 1)
