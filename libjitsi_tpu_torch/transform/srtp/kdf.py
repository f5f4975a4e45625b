"""RFC 3711 §4.3 session-key derivation (AES-CM PRF), host-side.

Rebuilds the derivation performed at context init by the reference's
`org.jitsi.impl.neomedia.transform.srtp.SRTPCryptoContext.deriveSrtpKeys` /
`SRTCPCryptoContext.deriveSrtcpKeys`: session encryption key, authentication
key and salt are each one short AES-CM keystream keyed by the master key,
with the IV formed from the master salt, a per-component label, and
(index DIV key_derivation_rate).

Cold path (runs once per stream / per re-key), so pure NumPy on host; the
derived keys are then packed into the dense device tensors by
`SrtpStreamTable`.

Counterpart: `libjitsi_tpu/transform/srtp/kdf.py` (copied), running on the
port's own copy of the NumPy AES (`libjitsi_tpu_torch.kernels.aes`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjitsi_tpu_torch.kernels.aes import (aes_encrypt_np, ctr_keystream_np,
                                      expand_key, expand_keys_batch)

# RFC 3711 §4.3.1 / §4.3.2 labels
LABEL_RTP_ENC = 0x00
LABEL_RTP_AUTH = 0x01
LABEL_RTP_SALT = 0x02
LABEL_RTCP_ENC = 0x03
LABEL_RTCP_AUTH = 0x04
LABEL_RTCP_SALT = 0x05


@dataclasses.dataclass
class SessionKeys:
    rtp_enc: bytes
    rtp_auth: bytes
    rtp_salt: bytes
    rtcp_enc: bytes
    rtcp_auth: bytes
    rtcp_salt: bytes


def _derive_one(
    round_keys: np.ndarray, master_salt: bytes, label: int, index_over_kdr: int, n: int
) -> bytes:
    # x = (label || index DIV kdr) XOR master_salt ; IV = x * 2^16
    salt = np.zeros(16, dtype=np.uint8)
    salt[: len(master_salt)] = np.frombuffer(master_salt, dtype=np.uint8)
    # label sits at byte 7 of the 14-byte salt-aligned value; index DIV kdr
    # (48-bit) occupies bytes 8..13 (RFC 3711 §4.3.1 key_id layout).
    key_id = (label << 48) | (index_over_kdr & ((1 << 48) - 1))
    kid = np.frombuffer(key_id.to_bytes(7, "big"), dtype=np.uint8)
    iv = salt.copy()
    iv[7:14] ^= kid
    return bytes(ctr_keystream_np(round_keys, iv, n))


def derive_session_keys(
    master_key: bytes,
    master_salt: bytes,
    *,
    enc_key_len: int = 16,
    auth_key_len: int = 20,
    salt_len: int = 14,
    kdr: int = 0,
    index: int = 0,
    srtcp_index: int = 0,
) -> SessionKeys:
    """Derive all six session keys.

    `kdr` (key derivation rate) of 0 means derive once (index DIV kdr == 0),
    matching the reference's common configuration.
    """
    rk = expand_key(master_key)
    r = (index // kdr) if kdr else 0
    rc = (srtcp_index // kdr) if kdr else 0
    return SessionKeys(
        rtp_enc=_derive_one(rk, master_salt, LABEL_RTP_ENC, r, enc_key_len),
        rtp_auth=_derive_one(rk, master_salt, LABEL_RTP_AUTH, r, auth_key_len),
        rtp_salt=_derive_one(rk, master_salt, LABEL_RTP_SALT, r, salt_len),
        rtcp_enc=_derive_one(rk, master_salt, LABEL_RTCP_ENC, rc, enc_key_len),
        rtcp_auth=_derive_one(rk, master_salt, LABEL_RTCP_AUTH, rc, auth_key_len),
        rtcp_salt=_derive_one(rk, master_salt, LABEL_RTCP_SALT, rc, salt_len),
    )


@dataclasses.dataclass
class SessionKeysBatch:
    """Vectorized SessionKeys: each field is [S, n] uint8."""

    rtp_enc: np.ndarray
    rtp_auth: np.ndarray
    rtp_salt: np.ndarray
    rtcp_enc: np.ndarray
    rtcp_auth: np.ndarray
    rtcp_salt: np.ndarray

    def row(self, i: int) -> SessionKeys:
        return SessionKeys(*(bytes(getattr(self, f.name)[i])
                             for f in dataclasses.fields(SessionKeys)))


def derive_session_keys_batch(
    master_keys: np.ndarray,
    master_salts: np.ndarray,
    *,
    enc_key_len: int = 16,
    auth_key_len: int = 20,
    salt_len: int = 14,
    r: np.ndarray | int = 0,
    rc: np.ndarray | int = 0,
) -> SessionKeysBatch:
    """Vectorized RFC 3711 §4.3 KDF over S streams in one shot.

    Same math as `derive_session_keys`, restructured for the install
    plane's scale (bulk conference joins, checkpoint restore, 10k-stream
    bootstrap): all S key schedules expand in one vectorized pass and all
    6*S*ceil(n/16) PRF blocks run through one batched AES call.
    `r`/`rc` are the per-stream (index DIV kdr) epochs (0 = initial).
    """
    mks = np.atleast_2d(np.asarray(master_keys, dtype=np.uint8))
    mss = np.atleast_2d(np.asarray(master_salts, dtype=np.uint8))
    s = mks.shape[0]
    if mss.shape[0] != s:
        raise ValueError("master_keys/master_salts row mismatch")
    rks = expand_keys_batch(mks)                       # [S, R, 16]

    lens = (enc_key_len, auth_key_len, salt_len)
    nblk = max((n + 15) // 16 for n in lens)           # 2 covers all profiles
    r = np.broadcast_to(np.asarray(r, dtype=np.int64), (s,))
    rc = np.broadcast_to(np.asarray(rc, dtype=np.int64), (s,))

    # counter blocks [S, 6, nblk, 16]: salt-derived IV with the label at
    # byte 7, (index DIV kdr) at bytes 8..13, block counter in byte 15
    # (the salt's low two IV bytes are zero, so IV+j == byte15=j for j<256)
    iv = np.zeros((s, 16), dtype=np.uint8)
    iv[:, : mss.shape[1]] = mss
    blocks = np.broadcast_to(iv[:, None, None, :], (s, 6, nblk, 16)).copy()
    labels = np.arange(6, dtype=np.uint8)
    blocks[:, :, :, 7] ^= labels[None, :, None]
    epoch = np.where(labels[None, :] < 3, r[:, None], rc[:, None])  # [S, 6]
    for k in range(6):
        blocks[:, :, :, 8 + k] ^= (
            (epoch >> (8 * (5 - k))) & 0xFF).astype(np.uint8)[:, :, None]
    blocks[:, :, :, 15] ^= np.arange(nblk, dtype=np.uint8)[None, None, :]

    flat = blocks.reshape(s, 6 * nblk, 16).reshape(-1, 16)
    rk_rows = np.repeat(rks, 6 * nblk, axis=0)
    ks = aes_encrypt_np(rk_rows, flat).reshape(s, 6, nblk * 16)

    def take(label: int, n: int) -> np.ndarray:
        return ks[:, label, :n].copy()

    return SessionKeysBatch(
        rtp_enc=take(LABEL_RTP_ENC, enc_key_len),
        rtp_auth=take(LABEL_RTP_AUTH, auth_key_len),
        rtp_salt=take(LABEL_RTP_SALT, salt_len),
        rtcp_enc=take(LABEL_RTCP_ENC, enc_key_len),
        rtcp_auth=take(LABEL_RTCP_AUTH, auth_key_len),
        rtcp_salt=take(LABEL_RTCP_SALT, salt_len),
    )
