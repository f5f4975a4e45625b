"""Batched SRTP protect/unprotect on tensors: AES-CM, AES-F8 or NULL,
with HMAC-SHA1, and AEAD_AES_128_GCM.

Counterpart: `libjitsi_tpu/transform/srtp/kernel.py` (`srtp_protect`,
`srtp_unprotect`, `srtcp_protect`, `srtcp_unprotect`) together with the
key-table gather of `libjitsi_tpu/transform/srtp/context.py`
(`_protect_rtp_dev`, `_unprotect_rtp_impl`, `_protect_rtcp_dev`,
`_unprotect_rtcp_dev`).  The functions here take the per-stream key
TABLES and the per-row stream ids, and the gather happens inside: on
the card each kernel reads each row's round keys and midstates straight
from the tables, so the [B, R, 16] round-key tensor the JAX path
materializes never exists.

`cipher` picks the instance, as the JAX functions' `f8_round_keys` and
`encrypt` do: "cm" (AES-CM: kernels C, D, I, J), "f8" (AES-F8, RFC 3711
§4.1.2, with `tab_f8` the per-stream schedules of k_e XOR m: kernels K
and L in `csrc/srtp_f8.cu`, and the F8 instances of I and J) or "null"
(the NULL cipher: the instances of C, D, I and J whose keystream stage is
compiled out; only the tag is written or checked).  Each instance has its
own name in `kernels/build.py` (`srtp_protect_f8`, `srtcp_unprotect_null`,
...), its own launch count and its own plain-call count.

Arguments (all on one device):
  tab_rk [S, R, 16] uint8 round keys (R = 11 or 15), tab_mid [S, 2, 5]
  int32 HMAC midstates (uint32 bit patterns), stream [B] int32 table
  rows, data [B, W] uint8, length/payload_off [B] int32 (payload_off
  is the RTP header length, so never negative), iv [B, 16]
  uint8 (RFC 3711 §4.1.1 counter IV, or §4.1.2.1 F8 IV), roc [B] int32
  (the packet's guessed ROC as a uint32 bit pattern), tag_len in 4..20.

Edge semantics, shared by kernel and plain version: lengths are clamped
to [0, W]; the keystream touches only columns in [payload_off, end)
inside the row; MAC message bytes that would fall past W read as 0 and
tag bytes past W are dropped; stream ids are clamped into the table.
A row shorter than its tag fails authentication.

Beside them: the SFU fan-out (`srtp_fanout_protect`, kernel H in
`csrc/srtp_fanout.cu`, counterpart of `libjitsi_tpu/sfu/translator.py`
`_fanout_protect`), which protects every (packet, receiver leg) pair of
P decrypted packets under the legs' keys: under AES-CM building each
copy's IV on the card, under AES-F8 gathering its packet's IV, under
NULL tagging only (instances `srtp_fanout_cm`, `_f8`, `_null`).

AEAD-GCM (RFC 7714; the JAX `kernels/gcm.py` functions under the table's
GCM paths): `srtp_gcm_protect` / `srtp_gcm_unprotect` (kernels M and N,
`csrc/srtp_gcm.cu`) take the round-key table, the packed GHASH matrices
`tab_gm` [S, 128, 4] int32 (in place of the midstates), stream ids, the
rows with their lengths and AAD lengths, and 12-byte IVs; their cached
instances (`srtp_gcm_protect_cached` / `_unprotect_cached`) take the
keystream cache's slot tables and a slot a row instead of keys and IVs;
`srtp_fanout_gcm` is H's GCM instance.  Edge semantics: `kernels/gcm.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from libjitsi_tpu_torch.kernels import build as _k
from libjitsi_tpu_torch.kernels import gcm
from libjitsi_tpu_torch.kernels.aes import ctr_crypt, f8_crypt_plain
from libjitsi_tpu_torch.kernels.scatter import gather_span, scatter_bytes
from libjitsi_tpu_torch.kernels.sha1 import hmac_sha1_plain

CIPHERS = ("cm", "f8", "null")


def _u32_bytes(x: torch.Tensor) -> torch.Tensor:
    """[B] int (uint32 bit pattern) -> [B, 4] uint8 big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=x.device)
    return ((x.long()[:, None] >> shifts) & 0xFF).to(torch.uint8)


def _gather_keys(tab_rk, tab_mid, stream):
    sid = stream.long().clamp(0, tab_rk.shape[0] - 1)
    return tab_rk[sid], tab_mid[sid]


def _crypt(cipher, tab_rk, tab_f8, stream, iv, data, off, ln):
    """The cipher's keystream XORed into each row's [off, off + ln): the
    plain counterpart of a kernel instance's keystream stage."""
    if cipher == "null":
        return data.clone()
    sid = stream.long().clamp(0, tab_rk.shape[0] - 1)
    if cipher == "f8":
        return f8_crypt_plain(tab_rk[sid], tab_f8[sid], iv, data, off, ln)
    return ctr_crypt(tab_rk[sid], iv, data, off, ln)


def _auth_tags(data, mlen, roc, mid):
    """HMAC-SHA1 over data[:mlen] || ROC (4 bytes big-endian) per row;
    ROC bytes past the row are dropped (read as 0)."""
    buf = scatter_bytes(data, mlen, _u32_bytes(roc), 4)
    buf = torch.nn.functional.pad(buf, (0, 4))
    return hmac_sha1_plain(mid, buf, mlen + 4)


def srtp_protect_plain(tab_rk, tab_mid, stream, data, length, payload_off,
                       iv, roc, tag_len: int, cipher: str = "cm",
                       tab_f8: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SRTP protect: encrypt [payload_off, length) under
    `cipher`, append the HMAC-SHA1 tag over header || ciphertext || ROC
    (RFC 3711 §4.2).  Returns (data', length + tag_len)."""
    _k.plain_calls[f"srtp_protect_{cipher}"] += 1
    return _protect_rows(tab_rk, tab_mid, stream, data, length, payload_off,
                         iv, roc, tag_len, cipher, tab_f8)


def _protect_rows(tab_rk, tab_mid, stream, data, length, payload_off, iv,
                  roc, tag_len: int, cipher: str = "cm", tab_f8=None):
    _, mid = _gather_keys(tab_rk, tab_mid, stream)
    ln = length.long().clamp(0, data.shape[1])
    off = payload_off.long()
    data = _crypt(cipher, tab_rk, tab_f8, stream, iv, data, off, ln - off)
    tags = _auth_tags(data, ln, roc, mid)
    out = scatter_bytes(data, ln, tags, tag_len)
    return out, (length + tag_len).to(torch.int32)


def srtp_unprotect_plain(tab_rk, tab_mid, stream, data, length, payload_off,
                         iv, roc, tag_len: int, cipher: str = "cm",
                         tab_f8: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch SRTP unprotect: check the tag over ciphertext ||
    ROC (all tag bytes, no early exit), decrypt [payload_off, mlen) under
    `cipher`.  Returns (data', mlen = length - tag_len, auth_ok); the tag
    bytes stay in the row past mlen."""
    _k.plain_calls[f"srtp_unprotect_{cipher}"] += 1
    _, mid = _gather_keys(tab_rk, tab_mid, stream)
    mlen = length.long().clamp(0, data.shape[1]) - tag_len
    tags = _auth_tags(data, mlen.clamp(min=0), roc, mid)
    stored = gather_span(data, mlen, tag_len)
    auth_ok = (stored == tags[:, :tag_len]).all(dim=1) & (mlen >= 0)
    off = payload_off.long()
    out = _crypt(cipher, tab_rk, tab_f8, stream, iv, data, off, mlen - off)
    return out, (length - tag_len).to(torch.int32), auth_ok


def _check_args(tab_rk, tab_mid, stream, data, length, payload_off, iv,
                roc, tag_len: int, cipher: str, tab_f8):
    dev = data.device
    bsz, width = data.shape
    _check_tables(tab_rk, tab_mid, dev, tag_len, width, cipher, tab_f8)
    _k.expect(stream, "stream", torch.int32, dev, (bsz,))
    _k.expect(data, "data", torch.uint8, dev)
    _k.expect(length, "length", torch.int32, dev, (bsz,))
    _k.expect(payload_off, "payload_off", torch.int32, dev, (bsz,))
    _k.expect(iv, "iv", torch.uint8, dev, (bsz, 16))
    _k.expect(roc, "roc", torch.int32, dev, (bsz,))


def _key_ptrs(tab_rk, cipher: str, tab_f8):
    """The leading key-table pointers of an instance's C entry point: the
    F8 instances take the k_e XOR m table right after the round keys."""
    if cipher == "f8":
        return (tab_rk.data_ptr(), tab_f8.data_ptr())
    return (tab_rk.data_ptr(),)


def srtp_protect(tab_rk, tab_mid, stream, data, length, payload_off, iv,
                 roc, tag_len: int, cipher: str = "cm",
                 tab_f8: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched SRTP protect (reference: SRTPCryptoContext.transformPacket).

    CUDA tensors go through the `cipher`'s kernel: C (`csrc/srtp_cm.cu`),
    K (`csrc/srtp_f8.cu`) or C's NULL instance; CPU tensors through
    `srtp_protect_plain`.  Returns (data', length').
    """
    args = (tab_rk, tab_mid, stream, data, length, payload_off, iv, roc)
    if _k.route(data) == "cpu":
        return srtp_protect_plain(*args, tag_len, cipher, tab_f8)
    _check_args(*args, tag_len, cipher, tab_f8)
    dev = data.device
    bsz, width = data.shape
    out = torch.empty_like(data)
    out_len = torch.empty_like(length)
    name = f"srtp_protect_{cipher}"
    if bsz:
        rc = getattr(_k.library(), "ljt_" + name)(
            *_key_ptrs(tab_rk, cipher, tab_f8), tab_mid.data_ptr(),
            stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
            length.data_ptr(), payload_off.data_ptr(), iv.data_ptr(),
            roc.data_ptr(), out.data_ptr(), out_len.data_ptr(), bsz, width,
            tab_rk.shape[1] - 1, tag_len, _k.stream_handle(dev))
        _k.check(rc, name)
        _k.launches[name] += 1
        _k.count_instance(name, tab_rk.shape[1] - 1)
    return out, out_len


def srtp_unprotect(tab_rk, tab_mid, stream, data, length, payload_off, iv,
                   roc, tag_len: int, cipher: str = "cm",
                   tab_f8: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched SRTP unprotect (reference:
    SRTPCryptoContext.reverseTransformPacket).

    Returns (data', mlen, auth_ok).  Decrypt always runs (the caller
    masks rows that fail auth); CUDA tensors go through the `cipher`'s
    kernel: D (`csrc/srtp_cm.cu`), L (`csrc/srtp_f8.cu`) or D's NULL
    instance; CPU tensors through `srtp_unprotect_plain`.
    """
    args = (tab_rk, tab_mid, stream, data, length, payload_off, iv, roc)
    if _k.route(data) == "cpu":
        return srtp_unprotect_plain(*args, tag_len, cipher, tab_f8)
    _check_args(*args, tag_len, cipher, tab_f8)
    dev = data.device
    bsz, width = data.shape
    out = torch.empty_like(data)
    mlen = torch.empty_like(length)
    auth_ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    name = f"srtp_unprotect_{cipher}"
    if bsz:
        rc = getattr(_k.library(), "ljt_" + name)(
            *_key_ptrs(tab_rk, cipher, tab_f8), tab_mid.data_ptr(),
            stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
            length.data_ptr(), payload_off.data_ptr(), iv.data_ptr(),
            roc.data_ptr(), out.data_ptr(), mlen.data_ptr(),
            auth_ok.data_ptr(), bsz, width, tab_rk.shape[1] - 1, tag_len,
            _k.stream_handle(dev))
        _k.check(rc, name)
        _k.launches[name] += 1
        _k.count_instance(name, tab_rk.shape[1] - 1)
    return out, mlen, auth_ok


def _check_tables(tab_rk, tab_mid, dev, tag_len: int, width: int,
                  cipher: str = "cm", tab_f8=None):
    if cipher not in CIPHERS:
        raise ValueError(f"cipher {cipher!r}: must be one of {CIPHERS}")
    if (tab_f8 is not None) != (cipher == "f8"):
        raise ValueError("tab_f8 is given with cipher 'f8' and only then")
    if tab_rk.dim() != 3 or tab_rk.shape[1] not in (11, 15):
        raise ValueError("tab_rk must be [S, 11 | 15, 16]")
    if not 4 <= tag_len <= 20:
        raise ValueError(f"tag_len {tag_len}: must be 4..20")
    if width > 32768:
        raise ValueError(f"row width {width} exceeds the kernels' 32768")
    s = tab_rk.shape[0]
    _k.expect(tab_rk, "tab_rk", torch.uint8, dev, (s, tab_rk.shape[1], 16))
    _k.expect(tab_mid, "tab_mid", torch.int32, dev, (s, 2, 5))
    if tab_f8 is not None:
        _k.expect(tab_f8, "tab_f8", torch.uint8, dev, tab_rk.shape)


# ------------------------------------------------------ SFU fan-out (H)

def _fanout_iv(salt, ssrc, index):
    """RFC 3711 §4.1.1 IVs of the fan-out copies: salt [N, 16] ^ (SSRC <<
    64) ^ (48-bit index << 16)."""
    dev = salt.device
    iv = salt.long().clone()
    iv[:, 4:8] ^= ((ssrc.long() & 0xFFFFFFFF)[:, None]
                   >> torch.tensor([24, 16, 8, 0], device=dev)) & 0xFF
    iv[:, 8:14] ^= (index[:, None] >> torch.tensor(
        [40, 32, 24, 16, 8, 0], device=dev)) & 0xFF
    return iv.to(torch.uint8)


def srtp_fanout_protect_plain(tab_rk, tab_mid, tab_salt, data, length,
                              payload_off, ssrc, index, src, recv,
                              tag_len: int, cipher: str = "cm",
                              tab_f8: Optional[torch.Tensor] = None,
                              iv: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SFU fan-out: output row k is packet src[k] protected
    under receiver leg recv[k]'s keys (tables `tab_rk`, `tab_mid`), the ROC
    taken as its 48-bit `index` [P] (int64) >> 16.  The IV under `cipher`:
    "cm", built from the leg's salt (`tab_salt` [S, 16]), the packet's SSRC
    (`ssrc` [P], uint32 bit patterns) and index; "f8", the packet's row of
    `iv` [P, 16] (RFC 3711 §4.1.2), with `tab_f8` the legs' k_e XOR m
    schedules; "null", none (the copy is tagged, not encrypted).
    `tab_salt` and `ssrc` are read under "cm" only.  Returns (out [N, W],
    out_len [N])."""
    _k.plain_calls[f"srtp_fanout_{cipher}"] += 1
    p = src.long().clamp(0, data.shape[0] - 1)
    leg = recv.long().clamp(0, tab_rk.shape[0] - 1)
    idx = index.long()[p] & 0xFFFFFFFFFFFF
    if cipher == "cm":
        civ = _fanout_iv(tab_salt[leg], ssrc[p], idx)
    elif cipher == "f8":
        civ = iv[p]
    else:
        civ = torch.zeros((p.shape[0], 16), dtype=torch.uint8,
                          device=data.device)
    return _protect_rows(tab_rk, tab_mid, leg, data[p], length[p],
                         payload_off[p], civ, idx >> 16, tag_len, cipher,
                         tab_f8)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def srtp_fanout_protect(tab_rk, tab_mid, tab_salt, data, length,
                        payload_off, ssrc, index, src, recv, tag_len: int,
                        cipher: str = "cm",
                        tab_f8: Optional[torch.Tensor] = None,
                        iv: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decrypt-once / re-encrypt-per-leg fan-out (reference:
    RTPTranslatorImpl re-running each receiver's send chain).

    data [P, W] uint8 decrypted packets with length, payload_off [P]
    int32 and index [P] int64; src / recv [N] int32 say which packet and
    which leg each output row is.  `cipher` "cm" reads tab_salt [S, 16]
    and ssrc [P] int32; "f8" reads tab_f8 (the legs' k_e XOR m
    schedules) and iv [P, 16] uint8; "null" neither.  CUDA tensors go
    through kernel H's instance (`csrc/srtp_fanout.cu`:
    `srtp_fanout_cm`, `srtp_fanout_f8`, `srtp_fanout_null`); CPU tensors
    through `srtp_fanout_protect_plain`.  Returns (out [N, W], out_len
    [N]).
    """
    args = (tab_rk, tab_mid, tab_salt, data, length, payload_off, ssrc,
            index, src, recv)
    if _k.route(data) == "cpu":
        return srtp_fanout_protect_plain(*args, tag_len, cipher, tab_f8, iv)
    dev = data.device
    n_src, width = data.shape
    n = src.shape[0]
    _check_tables(tab_rk, tab_mid, dev, tag_len, width, cipher, tab_f8)
    if cipher == "cm":
        _k.expect(tab_salt, "tab_salt", torch.uint8, dev,
                  (tab_rk.shape[0], 16))
        _k.expect(ssrc, "ssrc", torch.int32, dev, (n_src,))
    if (iv is not None) != (cipher == "f8"):
        raise ValueError("iv is given with cipher 'f8' and only then")
    if iv is not None:
        _k.expect(iv, "iv", torch.uint8, dev, (n_src, 16))
    _k.expect(data, "data", torch.uint8, dev)
    for name, t in (("length", length), ("payload_off", payload_off)):
        _k.expect(t, name, torch.int32, dev, (n_src,))
    _k.expect(index, "index", torch.int64, dev, (n_src,))
    _k.expect(src, "src", torch.int32, dev, (n,))
    _k.expect(recv, "recv", torch.int32, dev, (n,))
    if n and not n_src:
        raise ValueError("fan-out rows name packets of an empty batch")
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    out_len = torch.empty((n,), dtype=torch.int32, device=dev)
    name = f"srtp_fanout_{cipher}"
    if n:
        tail = (n_src, src.data_ptr(), recv.data_ptr(), out.data_ptr(),
                out_len.data_ptr(), n, width, tab_rk.shape[1] - 1, tag_len,
                _k.stream_handle(dev))
        lib = _k.library()
        if cipher == "f8":
            rc = lib.ljt_srtp_fanout_f8(
                tab_rk.data_ptr(), tab_f8.data_ptr(), tab_mid.data_ptr(),
                tab_rk.shape[0], data.data_ptr(), length.data_ptr(),
                payload_off.data_ptr(), iv.data_ptr(), index.data_ptr(),
                *tail)
        else:
            rc = getattr(lib, "ljt_" + name)(
                tab_rk.data_ptr(), tab_mid.data_ptr(), _ptr(tab_salt),
                tab_rk.shape[0], data.data_ptr(), length.data_ptr(),
                payload_off.data_ptr(), _ptr(ssrc), index.data_ptr(), *tail)
        _k.check(rc, name)
        _k.launches[name] += 1
        _k.count_instance(name, tab_rk.shape[1] - 1)
    return out, out_len


# -------------------------------------------------------- SRTCP (I, J)

def srtcp_protect_plain(tab_rk, tab_mid, stream, data, length, iv,
                        index_word, tag_len: int, cipher: str = "cm",
                        tab_f8: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SRTCP protect (RFC 3711 §3.4): encrypt [8, length)
    under `cipher`, write the E || index word (`index_word` [B], uint32
    bit patterns) at length and the tag over packet || word after it.
    Returns (data', length + 4 + tag_len)."""
    _k.plain_calls[f"srtcp_protect_{cipher}"] += 1
    _, mid = _gather_keys(tab_rk, tab_mid, stream)
    ln = length.long().clamp(0, data.shape[1])
    data = _crypt(cipher, tab_rk, tab_f8, stream, iv, data,
                  torch.full_like(ln, 8), ln - 8)
    tags = _auth_tags(data, ln, index_word, mid)
    out = scatter_bytes(data, ln, _u32_bytes(index_word), 4)
    out = scatter_bytes(out, ln + 4, tags, tag_len)
    return out, (length + 4 + tag_len).to(torch.int32)


def srtcp_unprotect_plain(tab_rk, tab_mid, stream, data, length, iv,
                          tag_len: int, cipher: str = "cm",
                          tab_f8: Optional[torch.Tensor] = None):
    """Plain PyTorch SRTCP unprotect: read the E || index word at mlen =
    length - tag_len - 4, check the tag over [0, mlen + 4) (all tag
    bytes; a negative mlen fails), decrypt [8, mlen) where E is set
    (under NULL no row is decrypted, whatever its E bit).  Returns
    (data', mlen, auth_ok, e_bit, index)."""
    _k.plain_calls[f"srtcp_unprotect_{cipher}"] += 1
    _, mid = _gather_keys(tab_rk, tab_mid, stream)
    mlen = length.long().clamp(0, data.shape[1]) - tag_len - 4
    wb = gather_span(data, mlen, 4).long()
    word = (wb[:, 0] << 24) | (wb[:, 1] << 16) | (wb[:, 2] << 8) | wb[:, 3]
    e_bit = word >> 31
    tags = hmac_sha1_plain(mid, data, (mlen + 4).clamp(min=0))
    stored = gather_span(data, mlen + 4, tag_len)
    auth_ok = (stored == tags[:, :tag_len]).all(dim=1) & (mlen >= 0)
    dec = _crypt(cipher, tab_rk, tab_f8, stream, iv, data,
                 torch.full_like(mlen, 8), mlen - 8)
    out = torch.where((e_bit == 1)[:, None], dec, data)
    return (out, (length - tag_len - 4).to(torch.int32), auth_ok,
            e_bit.to(torch.int32), (word & 0x7FFFFFFF).to(torch.int32))


def _check_rtcp(tab_rk, tab_mid, stream, data, length, iv, tag_len: int,
                cipher: str, tab_f8):
    dev = data.device
    bsz, width = data.shape
    _check_tables(tab_rk, tab_mid, dev, tag_len, width, cipher, tab_f8)
    _k.expect(stream, "stream", torch.int32, dev, (bsz,))
    _k.expect(data, "data", torch.uint8, dev)
    _k.expect(length, "length", torch.int32, dev, (bsz,))
    _k.expect(iv, "iv", torch.uint8, dev, (bsz, 16))


def srtcp_protect(tab_rk, tab_mid, stream, data, length, iv, index_word,
                  tag_len: int, cipher: str = "cm",
                  tab_f8: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched SRTCP protect (reference: SRTCPCryptoContext.
    transformPacket).  CUDA tensors go through the `cipher`'s instance
    of kernel I (`csrc/srtcp_cm.cu`; NULL: I-NULL, `csrc/srtcp_null.cu`);
    CPU tensors through `srtcp_protect_plain`.  Returns (data',
    length')."""
    args = (tab_rk, tab_mid, stream, data, length, iv, index_word)
    if _k.route(data) == "cpu":
        return srtcp_protect_plain(*args, tag_len, cipher, tab_f8)
    _check_rtcp(*args[:6], tag_len, cipher, tab_f8)
    dev = data.device
    bsz, width = data.shape
    _k.expect(index_word, "index_word", torch.int32, dev, (bsz,))
    out = torch.empty_like(data)
    out_len = torch.empty_like(length)
    name = f"srtcp_protect_{cipher}"
    if bsz:
        rc = getattr(_k.library(), "ljt_" + name)(
            *_key_ptrs(tab_rk, cipher, tab_f8), tab_mid.data_ptr(),
            stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
            length.data_ptr(), iv.data_ptr(), index_word.data_ptr(),
            out.data_ptr(), out_len.data_ptr(), bsz, width,
            tab_rk.shape[1] - 1, tag_len, _k.stream_handle(dev))
        _k.check(rc, name)
        _k.launches[name] += 1
        _k.count_instance(name, tab_rk.shape[1] - 1)
    return out, out_len


def srtcp_unprotect(tab_rk, tab_mid, stream, data, length, iv,
                    tag_len: int, cipher: str = "cm",
                    tab_f8: Optional[torch.Tensor] = None):
    """Batched SRTCP unprotect (reference: SRTCPCryptoContext.
    reverseTransformPacket).  CUDA tensors go through the `cipher`'s
    instance of kernel J (`csrc/srtcp_cm.cu`; NULL: J-NULL,
    `csrc/srtcp_null.cu`); CPU tensors through `srtcp_unprotect_plain`.
    Returns (data', mlen, auth_ok, e_bit, index)."""
    args = (tab_rk, tab_mid, stream, data, length, iv)
    if _k.route(data) == "cpu":
        return srtcp_unprotect_plain(*args, tag_len, cipher, tab_f8)
    _check_rtcp(*args, tag_len, cipher, tab_f8)
    dev = data.device
    bsz, width = data.shape
    out = torch.empty_like(data)
    mlen = torch.empty_like(length)
    auth_ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    e_bit = torch.empty_like(length)
    index = torch.empty_like(length)
    name = f"srtcp_unprotect_{cipher}"
    if bsz:
        rc = getattr(_k.library(), "ljt_" + name)(
            *_key_ptrs(tab_rk, cipher, tab_f8), tab_mid.data_ptr(),
            stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
            length.data_ptr(), iv.data_ptr(), out.data_ptr(),
            mlen.data_ptr(), auth_ok.data_ptr(), e_bit.data_ptr(),
            index.data_ptr(), bsz, width, tab_rk.shape[1] - 1, tag_len,
            _k.stream_handle(dev))
        _k.check(rc, name)
        _k.launches[name] += 1
        _k.count_instance(name, tab_rk.shape[1] - 1)
    return out, mlen, auth_ok, e_bit, index


# ------------------------------------------------ AEAD-GCM (M, N; H-GCM)

def _gcm_rows(tab_rk, tab_gm, stream):
    sid = stream.long().clamp(0, tab_rk.shape[0] - 1)
    return tab_rk[sid], tab_gm[sid]


def srtp_gcm_protect_plain(tab_rk, tab_gm, stream, data, length, aad_len,
                           iv12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch AEAD-GCM seal of table rows (RFC 7714 §8): row i under
    table row stream[i]'s round keys and packed GHASH matrix (`tab_gm`
    [S, 128, 4] int32), AAD data[:aad_len], IV iv12 [B, 12].  Returns
    (data', length + 16); edge semantics in `kernels.gcm`."""
    _k.plain_calls["srtp_gcm_seal"] += 1
    rk, gm = _gcm_rows(tab_rk, tab_gm, stream)
    return gcm.gcm_protect(data, length, aad_len, rk, gm, iv12)


def srtp_gcm_unprotect_plain(tab_rk, tab_gm, stream, data, length, aad_len,
                             iv12):
    """Plain PyTorch AEAD-GCM open of table rows.  Returns (data', length
    - 16, auth_ok)."""
    _k.plain_calls["srtp_gcm_open"] += 1
    rk, gm = _gcm_rows(tab_rk, tab_gm, stream)
    return gcm.gcm_unprotect(data, length, aad_len, rk, gm, iv12)


def _cached_rows(ks_tab, ek_tab, slot):
    s = slot.long().clamp(0, ks_tab.shape[0] - 1)
    return ks_tab[s], ek_tab[s]


def srtp_gcm_protect_cached_plain(ks_tab, ek_tab, slot, tab_gm, stream, data,
                                  length, aad_len):
    """Plain PyTorch cached seal: the keystream and tag mask of row i are
    row slot[i] of the cache's slot tables (ks_tab [N, KS], ek_tab [N,
    16]; slots clamped into them), no AES.  Returns (data', length +
    16)."""
    _k.plain_calls["srtp_gcm_seal_cached"] += 1
    ks, ek = _cached_rows(ks_tab, ek_tab, slot)
    gm = tab_gm[stream.long().clamp(0, tab_gm.shape[0] - 1)]
    return gcm.gcm_protect_cached(data, length, aad_len, ks, ek, gm)


def srtp_gcm_unprotect_cached_plain(ks_tab, ek_tab, slot, tab_gm, stream,
                                    data, length, aad_len):
    """Plain PyTorch cached open.  Returns (data', length - 16,
    auth_ok)."""
    _k.plain_calls["srtp_gcm_open_cached"] += 1
    ks, ek = _cached_rows(ks_tab, ek_tab, slot)
    gm = tab_gm[stream.long().clamp(0, tab_gm.shape[0] - 1)]
    return gcm.gcm_unprotect_cached(data, length, aad_len, ks, ek, gm)


def _check_gcm(tab_gm, stream, data, length, aad_len, n_streams: int):
    dev = data.device
    bsz, width = data.shape
    if width > 32768:
        raise ValueError(f"row width {width} exceeds the kernels' 32768")
    _k.expect(tab_gm, "tab_gm", torch.int32, dev, (n_streams, 128, 4))
    _k.expect(stream, "stream", torch.int32, dev, (bsz,))
    _k.expect(data, "data", torch.uint8, dev)
    _k.expect(length, "length", torch.int32, dev, (bsz,))
    _k.expect(aad_len, "aad_len", torch.int32, dev, (bsz,))


def _check_gcm_keys(tab_rk):
    # the kernels are AES-128 only: no SRTP profile runs AES-256 GCM
    if tab_rk.dim() != 3 or tab_rk.shape[1] != 11:
        raise ValueError("the GCM kernels take AES-128 round keys "
                         "[S, 11, 16]")
    _k.expect(tab_rk, "tab_rk", torch.uint8, tab_rk.device,
              tuple(tab_rk.shape))


def _gcm_launch(name: str, *args, nr: int = 0) -> None:
    """Launch a GCM kernel; `nr`, the AES rounds of an instance that runs
    AES (0 for the cached instances, which run none), is counted too."""
    rc = getattr(_k.library(), "ljt_" + name)(*args)
    _k.check(rc, name)
    _k.launches[name] += 1
    if nr:
        _k.count_instance(name, nr)


def srtp_gcm_protect(tab_rk, tab_gm, stream, data, length, aad_len, iv12
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched AEAD-GCM seal (RFC 7714; reference: SRTPCryptoContext with
    the GCM cipher).  CUDA tensors go through kernel M (`csrc/srtp_gcm.cu`,
    `srtp_gcm_seal`), which gathers each row's keys and matrix itself; CPU
    tensors through `srtp_gcm_protect_plain`.  Returns (data', length +
    16)."""
    args = (tab_rk, tab_gm, stream, data, length, aad_len, iv12)
    if _k.route(data) == "cpu":
        return srtp_gcm_protect_plain(*args)
    _check_gcm_keys(tab_rk)
    _check_gcm(tab_gm, stream, data, length, aad_len, tab_rk.shape[0])
    dev = data.device
    bsz, width = data.shape
    _k.expect(iv12, "iv12", torch.uint8, dev, (bsz, 12))
    out = torch.empty_like(data)
    out_len = torch.empty_like(length)
    if bsz:
        _gcm_launch("srtp_gcm_seal", tab_rk.data_ptr(), tab_gm.data_ptr(),
                    stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
                    length.data_ptr(), aad_len.data_ptr(), iv12.data_ptr(),
                    out.data_ptr(), out_len.data_ptr(), bsz, width,
                    tab_rk.shape[1] - 1, _k.stream_handle(dev),
                    nr=tab_rk.shape[1] - 1)
    return out, out_len


def srtp_gcm_unprotect(tab_rk, tab_gm, stream, data, length, aad_len, iv12):
    """Batched AEAD-GCM open.  Returns (data', length - 16, auth_ok):
    every tag byte is compared, and the decrypt always runs (the caller
    masks rows that fail).  CUDA tensors go through kernel N
    (`srtp_gcm_open`); CPU tensors through `srtp_gcm_unprotect_plain`."""
    args = (tab_rk, tab_gm, stream, data, length, aad_len, iv12)
    if _k.route(data) == "cpu":
        return srtp_gcm_unprotect_plain(*args)
    _check_gcm_keys(tab_rk)
    _check_gcm(tab_gm, stream, data, length, aad_len, tab_rk.shape[0])
    dev = data.device
    bsz, width = data.shape
    _k.expect(iv12, "iv12", torch.uint8, dev, (bsz, 12))
    out = torch.empty_like(data)
    mlen = torch.empty_like(length)
    auth_ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    if bsz:
        _gcm_launch("srtp_gcm_open", tab_rk.data_ptr(), tab_gm.data_ptr(),
                    stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
                    length.data_ptr(), aad_len.data_ptr(), iv12.data_ptr(),
                    out.data_ptr(), mlen.data_ptr(), auth_ok.data_ptr(), bsz,
                    width, tab_rk.shape[1] - 1, _k.stream_handle(dev),
                    nr=tab_rk.shape[1] - 1)
    return out, mlen, auth_ok


def _check_cached(ks_tab, ek_tab, slot, bsz: int):
    dev = slot.device
    n_slots, ks_bytes = ks_tab.shape
    if ks_bytes % 16 or ks_bytes == 0:
        raise ValueError("ks_tab rows must be whole 16-byte blocks")
    _k.expect(ks_tab, "ks_tab", torch.uint8, dev)
    _k.expect(ek_tab, "ek_tab", torch.uint8, dev, (n_slots, 16))
    _k.expect(slot, "slot", torch.int32, dev, (bsz,))


def srtp_gcm_protect_cached(ks_tab, ek_tab, slot, tab_gm, stream, data,
                            length, aad_len
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cached AEAD-GCM seal: the XOR of each row's cached keystream and
    the GHASH, no AES.  CUDA tensors go through M's cached instance
    (`srtp_gcm_seal_cached`); CPU tensors through
    `srtp_gcm_protect_cached_plain`.  Returns (data', length + 16)."""
    args = (ks_tab, ek_tab, slot, tab_gm, stream, data, length, aad_len)
    if _k.route(data) == "cpu":
        return srtp_gcm_protect_cached_plain(*args)
    _check_gcm(tab_gm, stream, data, length, aad_len, tab_gm.shape[0])
    bsz, width = data.shape
    _check_cached(ks_tab, ek_tab, slot, bsz)
    out = torch.empty_like(data)
    out_len = torch.empty_like(length)
    if bsz:
        _gcm_launch("srtp_gcm_seal_cached", ks_tab.data_ptr(),
                    ek_tab.data_ptr(), slot.data_ptr(), ks_tab.shape[0],
                    ks_tab.shape[1], tab_gm.data_ptr(), stream.data_ptr(),
                    tab_gm.shape[0], data.data_ptr(), length.data_ptr(),
                    aad_len.data_ptr(), out.data_ptr(), out_len.data_ptr(),
                    bsz, width, _k.stream_handle(data.device))
    return out, out_len


def srtp_gcm_unprotect_cached(ks_tab, ek_tab, slot, tab_gm, stream, data,
                              length, aad_len):
    """Cached AEAD-GCM open (N's cached instance,
    `srtp_gcm_open_cached`).  Returns (data', length - 16, auth_ok)."""
    args = (ks_tab, ek_tab, slot, tab_gm, stream, data, length, aad_len)
    if _k.route(data) == "cpu":
        return srtp_gcm_unprotect_cached_plain(*args)
    _check_gcm(tab_gm, stream, data, length, aad_len, tab_gm.shape[0])
    dev = data.device
    bsz, width = data.shape
    _check_cached(ks_tab, ek_tab, slot, bsz)
    out = torch.empty_like(data)
    mlen = torch.empty_like(length)
    auth_ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    if bsz:
        _gcm_launch("srtp_gcm_open_cached", ks_tab.data_ptr(),
                    ek_tab.data_ptr(), slot.data_ptr(), ks_tab.shape[0],
                    ks_tab.shape[1], tab_gm.data_ptr(), stream.data_ptr(),
                    tab_gm.shape[0], data.data_ptr(), length.data_ptr(),
                    aad_len.data_ptr(), out.data_ptr(), mlen.data_ptr(),
                    auth_ok.data_ptr(), bsz, width, _k.stream_handle(dev))
    return out, mlen, auth_ok


def srtp_fanout_gcm_plain(tab_rk, tab_gm, tab_salt, data, length,
                          payload_off, ssrc, index, src, recv
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch GCM fan-out: output row k is packet src[k] sealed
    under leg recv[k]'s round keys and packed matrix, with the AAD its
    RTP header (payload_off) and the RFC 7714 §8.1 IV built from the leg's
    salt (`tab_salt` [S, 16], first 12 bytes), the packet's SSRC (`ssrc`
    [P], uint32 bit patterns) and its 48-bit `index` [P] (int64).
    Returns (out [N, W], out_len [N])."""
    _k.plain_calls["srtp_fanout_gcm"] += 1
    p = src.long().clamp(0, data.shape[0] - 1)
    leg = recv.long().clamp(0, tab_rk.shape[0] - 1)
    idx = index.long()[p] & 0xFFFFFFFFFFFF
    dev = data.device
    iv = tab_salt[leg][:, :12].long().clone()
    iv[:, 2:6] ^= ((ssrc.long()[p] & 0xFFFFFFFF)[:, None]
                   >> torch.tensor([24, 16, 8, 0], device=dev)) & 0xFF
    iv[:, 6:12] ^= (idx[:, None] >> torch.tensor(
        [40, 32, 24, 16, 8, 0], device=dev)) & 0xFF
    return gcm.gcm_protect(data[p], length[p], payload_off[p], tab_rk[leg],
                           tab_gm[leg], iv.to(torch.uint8))


def srtp_fanout_gcm(tab_rk, tab_gm, tab_salt, data, length, payload_off,
                    ssrc, index, src, recv
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SFU fan-out under AEAD-GCM: every (packet, leg) copy sealed
    under its leg's keys, rows in the order of `src` / `recv` (the JAX
    translator's packet-major order).  CUDA tensors go through kernel H's
    GCM instance (`csrc/srtp_fanout.cu`, `srtp_fanout_gcm`), which builds
    each copy's IV on the card; CPU tensors through
    `srtp_fanout_gcm_plain`.  Returns (out [N, W], out_len [N])."""
    args = (tab_rk, tab_gm, tab_salt, data, length, payload_off, ssrc,
            index, src, recv)
    if _k.route(data) == "cpu":
        return srtp_fanout_gcm_plain(*args)
    dev = data.device
    n_src, width = data.shape
    n = src.shape[0]
    s = tab_rk.shape[0]
    _check_gcm_keys(tab_rk)
    if width > 32768:
        raise ValueError(f"row width {width} exceeds the kernels' 32768")
    _k.expect(tab_gm, "tab_gm", torch.int32, dev, (s, 128, 4))
    _k.expect(tab_salt, "tab_salt", torch.uint8, dev, (s, 16))
    _k.expect(data, "data", torch.uint8, dev)
    for name, t in (("length", length), ("payload_off", payload_off),
                    ("ssrc", ssrc)):
        _k.expect(t, name, torch.int32, dev, (n_src,))
    _k.expect(index, "index", torch.int64, dev, (n_src,))
    _k.expect(src, "src", torch.int32, dev, (n,))
    _k.expect(recv, "recv", torch.int32, dev, (n,))
    if n and not n_src:
        raise ValueError("fan-out rows name packets of an empty batch")
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    out_len = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _gcm_launch("srtp_fanout_gcm", tab_rk.data_ptr(), tab_gm.data_ptr(),
                    tab_salt.data_ptr(), s, data.data_ptr(),
                    length.data_ptr(), payload_off.data_ptr(),
                    ssrc.data_ptr(), index.data_ptr(), n_src,
                    src.data_ptr(), recv.data_ptr(), out.data_ptr(),
                    out_len.data_ptr(), n, width, tab_rk.shape[1] - 1,
                    _k.stream_handle(dev),
                    nr=tab_rk.shape[1] - 1)
    return out, out_len
