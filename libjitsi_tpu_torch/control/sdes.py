"""SDES key management — RFC 4568 SDP security descriptions.

Counterpart: `libjitsi_tpu/control/sdes.py` (copied).

Rebuilds the reference's `org.jitsi.impl.neomedia.transform.sdes.
{SDesControlImpl,SDesTransformEngine}` (which delegate the attribute
grammar to the sdes4j library): master keys ride in signaling as
``a=crypto`` lines; no handshake on the media path.  This is the easiest
key provider and the one the round-1 end-to-end slice uses — DTLS-SRTP
plugs into the same ``(master_key, master_salt, profile)`` installation
point later (SURVEY §2.2: "same key provider → SRTP context interface
as DTLS/ZRTP").
"""

from __future__ import annotations

import base64
import dataclasses
import os
from typing import List, Optional, Sequence

from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

# RFC 4568 §6.2 crypto-suite names happen to match SrtpProfile values.
_SUITES = {p.value: p for p in SrtpProfile}


@dataclasses.dataclass
class CryptoAttribute:
    """One ``a=crypto:<tag> <suite> inline:<key||salt b64>`` line."""

    tag: int
    profile: SrtpProfile
    master_key: bytes
    master_salt: bytes

    def encode(self) -> str:
        blob = base64.b64encode(self.master_key + self.master_salt).decode()
        # unpadded per RFC 4568 §9.2 (b64 pad chars are not in the grammar)
        return f"{self.tag} {self.profile.value} inline:{blob.rstrip('=')}"

    @classmethod
    def parse(cls, line: str) -> "CryptoAttribute":
        line = line.strip()
        if line.startswith("a=crypto:"):
            line = line[len("a=crypto:"):]
        parts = line.split()
        if len(parts) < 3 or not parts[2].startswith("inline:"):
            raise ValueError(f"malformed crypto attribute: {line!r}")
        tag = int(parts[0])
        suite = parts[1]
        if suite not in _SUITES:
            raise ValueError(f"unknown crypto-suite {suite!r}")
        profile = _SUITES[suite]
        inline = parts[2][len("inline:"):]
        # key params may carry |lifetime|MKI — take the key portion
        b64 = inline.split("|")[0]
        blob = base64.b64decode(b64 + "=" * (-len(b64) % 4))
        p = profile.policy
        need = p.enc_key_len + p.salt_len
        if len(blob) != need:
            raise ValueError(
                f"{suite} needs {need}B key||salt, got {len(blob)}B")
        return cls(tag, profile, blob[: p.enc_key_len], blob[p.enc_key_len:])


class SdesControl:
    """Offer/answer state machine over crypto attributes.

    Reference: SDesControlImpl.{getInitiatorCryptoAttributes,
    responderSelectAttribute, initiatorSelectAttribute}.  After a
    successful exchange, `local_key` protects our sender direction and
    `remote_key` our receiver direction.
    """

    def __init__(self, profiles: Optional[Sequence[SrtpProfile]] = None,
                 rng=os.urandom):
        self.profiles = list(profiles) if profiles else [
            SrtpProfile.AES_CM_128_HMAC_SHA1_80,
            SrtpProfile.AES_CM_128_HMAC_SHA1_32,
        ]
        self._rng = rng
        self.local: Optional[CryptoAttribute] = None
        self.remote: Optional[CryptoAttribute] = None

    def _fresh(self, tag: int, profile: SrtpProfile) -> CryptoAttribute:
        p = profile.policy
        return CryptoAttribute(
            tag, profile, self._rng(p.enc_key_len), self._rng(p.salt_len))

    # -------------------------------------------------------------- offer
    def create_offer(self) -> List[str]:
        """Initiator: one attribute per supported suite (fresh keys)."""
        self._offered = [self._fresh(i + 1, pr)
                         for i, pr in enumerate(self.profiles)]
        return [a.encode() for a in self._offered]

    def accept_answer(self, line: str) -> None:
        """Initiator: responder picked one tag; select the matching key."""
        remote = CryptoAttribute.parse(line)
        mine = [a for a in self._offered if a.tag == remote.tag]
        if not mine or mine[0].profile is not remote.profile:
            raise ValueError("answer does not match any offered attribute")
        self.local, self.remote = mine[0], remote

    # ------------------------------------------------------------- answer
    def create_answer(self, offer_lines: Sequence[str]) -> str:
        """Responder: pick the first offered suite we support."""
        for line in offer_lines:
            try:
                remote = CryptoAttribute.parse(line)
            except ValueError:
                continue
            if remote.profile in self.profiles:
                self.remote = remote
                self.local = self._fresh(remote.tag, remote.profile)
                return self.local.encode()
        raise ValueError("no acceptable crypto attribute in offer")

    # ------------------------------------------------------------- result
    @property
    def negotiated(self) -> bool:
        return self.local is not None and self.remote is not None

    @property
    def profile(self) -> SrtpProfile:
        if not self.negotiated:
            raise RuntimeError("SDES not negotiated")
        return self.local.profile
