"""Batched SRTP protect/unprotect on tensors: AES-CM, AES-F8 or NULL,
with HMAC-SHA1.

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
`_fanout_protect`, AES-CM only), which protects every (packet, receiver
leg) pair of P decrypted packets under the legs' keys, building each
copy's IV on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from libjitsi_tpu_torch.kernels import build as _k
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
                              tag_len: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SFU fan-out: output row k is packet src[k] protected
    under receiver leg recv[k]'s keys (tables `tab_rk`, `tab_mid`,
    `tab_salt` [S, 16]), the IV built from the leg's salt, the packet's
    SSRC (`ssrc` [P], uint32 bit patterns) and its 48-bit `index` [P]
    (int64), the ROC taken as index >> 16.  Returns (out [N, W],
    out_len [N])."""
    _k.plain_calls["srtp_fanout_cm"] += 1
    p = src.long().clamp(0, data.shape[0] - 1)
    leg = recv.long().clamp(0, tab_rk.shape[0] - 1)
    idx = index.long()[p] & 0xFFFFFFFFFFFF
    iv = _fanout_iv(tab_salt[leg], ssrc[p], idx)
    return _protect_rows(tab_rk, tab_mid, leg, data[p], length[p],
                         payload_off[p], iv, idx >> 16, tag_len)


def srtp_fanout_protect(tab_rk, tab_mid, tab_salt, data, length,
                        payload_off, ssrc, index, src, recv, tag_len: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decrypt-once / re-encrypt-per-leg fan-out (reference:
    RTPTranslatorImpl re-running each receiver's send chain).

    data [P, W] uint8 decrypted packets with length, payload_off and
    ssrc [P] int32 and index [P] int64; src / recv [N] int32 say which
    packet and which leg each output row is.  CUDA tensors go through
    kernel H (`csrc/srtp_fanout.cu`); CPU tensors through
    `srtp_fanout_protect_plain`.  Returns (out [N, W], out_len [N]).
    """
    args = (tab_rk, tab_mid, tab_salt, data, length, payload_off, ssrc,
            index, src, recv)
    if _k.route(data) == "cpu":
        return srtp_fanout_protect_plain(*args, tag_len)
    dev = data.device
    n_src, width = data.shape
    n = src.shape[0]
    _check_tables(tab_rk, tab_mid, dev, tag_len, width)
    _k.expect(tab_salt, "tab_salt", torch.uint8, dev, (tab_rk.shape[0], 16))
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
        rc = _k.library().ljt_srtp_fanout_cm(
            tab_rk.data_ptr(), tab_mid.data_ptr(), tab_salt.data_ptr(),
            tab_rk.shape[0], data.data_ptr(), length.data_ptr(),
            payload_off.data_ptr(), ssrc.data_ptr(), index.data_ptr(),
            n_src, src.data_ptr(), recv.data_ptr(), out.data_ptr(),
            out_len.data_ptr(), n, width, tab_rk.shape[1] - 1, tag_len,
            _k.stream_handle(dev))
        _k.check(rc, "srtp_fanout_cm")
        _k.launches["srtp_fanout_cm"] += 1
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
    of kernel I (`csrc/srtcp_cm.cu`); CPU tensors through
    `srtcp_protect_plain`.  Returns (data', length')."""
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
    return out, out_len


def srtcp_unprotect(tab_rk, tab_mid, stream, data, length, iv,
                    tag_len: int, cipher: str = "cm",
                    tab_f8: Optional[torch.Tensor] = None):
    """Batched SRTCP unprotect (reference: SRTCPCryptoContext.
    reverseTransformPacket).  CUDA tensors go through the `cipher`'s
    instance of kernel J (`csrc/srtcp_cm.cu`); CPU tensors through
    `srtcp_unprotect_plain`.  Returns (data', mlen, auth_ok, e_bit,
    index)."""
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
    return out, mlen, auth_ok, e_bit, index
