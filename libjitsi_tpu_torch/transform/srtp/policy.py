"""SRTP crypto policies / protection profiles.

Rebuilds the knob surface of the reference's
`org.jitsi.impl.neomedia.transform.srtp.SRTPPolicy` (cipher type, key/salt
lengths, auth type, tag length) plus the SDES/DTLS-SRTP profile names that
select them (`SrtpCryptoSuite`, RFC 4568 / RFC 5764 registry names).

Counterpart: `libjitsi_tpu/transform/srtp/policy.py` (copied).  Every
profile is named here; the port's SRTP table runs the AES-CM, AES-F8
and NULL + HMAC-SHA1 ones and raises `NotImplementedError` for
AEAD-GCM.
"""

from __future__ import annotations

import dataclasses
import enum


class Cipher(enum.Enum):
    NULL = 0
    AES_CM = 1  # AES counter mode (RFC 3711 §4.1.1)
    AES_GCM = 2  # AEAD (RFC 7714)
    AES_F8 = 3  # AES f8 mode (RFC 3711 §4.1.2; reference: SRTPCipherF8)


class Auth(enum.Enum):
    NULL = 0
    HMAC_SHA1 = 1


@dataclasses.dataclass(frozen=True)
class SrtpPolicy:
    cipher: Cipher
    enc_key_len: int  # bytes
    auth: Auth
    auth_key_len: int  # bytes (HMAC-SHA1 -> 20)
    auth_tag_len: int  # bytes on the wire (10 = 80-bit, 4 = 32-bit, 16 = GCM)
    salt_len: int  # bytes (CM -> 14, GCM -> 12)
    window_size: int = 64  # replay window (bits); reference default 64


class SrtpProfile(enum.Enum):
    """Named suites, wire names per RFC 4568 §6.2 / RFC 7714 §12."""

    AES_CM_128_HMAC_SHA1_80 = "AES_CM_128_HMAC_SHA1_80"
    AES_CM_128_HMAC_SHA1_32 = "AES_CM_128_HMAC_SHA1_32"
    AES_256_CM_HMAC_SHA1_80 = "AES_256_CM_HMAC_SHA1_80"
    AES_256_CM_HMAC_SHA1_32 = "AES_256_CM_HMAC_SHA1_32"
    AEAD_AES_128_GCM = "AEAD_AES_128_GCM"
    F8_128_HMAC_SHA1_80 = "F8_128_HMAC_SHA1_80"
    NULL_HMAC_SHA1_80 = "NULL_HMAC_SHA1_80"

    @property
    def policy(self) -> SrtpPolicy:
        return _PROFILE_POLICIES[self]

    @property
    def master_key_len(self) -> int:
        return self.policy.enc_key_len if self.policy.cipher != Cipher.NULL else 16

    @property
    def master_salt_len(self) -> int:
        return self.policy.salt_len


_PROFILE_POLICIES = {
    SrtpProfile.AES_CM_128_HMAC_SHA1_80: SrtpPolicy(
        Cipher.AES_CM, 16, Auth.HMAC_SHA1, 20, 10, 14
    ),
    SrtpProfile.AES_CM_128_HMAC_SHA1_32: SrtpPolicy(
        Cipher.AES_CM, 16, Auth.HMAC_SHA1, 20, 4, 14
    ),
    SrtpProfile.AES_256_CM_HMAC_SHA1_80: SrtpPolicy(
        Cipher.AES_CM, 32, Auth.HMAC_SHA1, 20, 10, 14
    ),
    SrtpProfile.AES_256_CM_HMAC_SHA1_32: SrtpPolicy(
        Cipher.AES_CM, 32, Auth.HMAC_SHA1, 20, 4, 14
    ),
    SrtpProfile.AEAD_AES_128_GCM: SrtpPolicy(
        Cipher.AES_GCM, 16, Auth.NULL, 0, 16, 12
    ),
    SrtpProfile.F8_128_HMAC_SHA1_80: SrtpPolicy(
        Cipher.AES_F8, 16, Auth.HMAC_SHA1, 20, 10, 14
    ),
    SrtpProfile.NULL_HMAC_SHA1_80: SrtpPolicy(
        Cipher.NULL, 16, Auth.HMAC_SHA1, 20, 10, 14
    ),
}
