"""ZRTP — media-path Diffie-Hellman key agreement (RFC 6189).

Rebuilds the reference's `org.jitsi.impl.neomedia.transform.zrtp.
{ZRTPTransformEngine,ZrtpControlImpl}` (which delegate to the zrtp4j
library) from the RFC: the Hello/Commit/DHPart/Confirm state machine,
the H0..H3 hash-image chain with retroactive message-HMAC verification,
ECDH P-256 ("EC25") key agreement, the RFC 6189 §4.4.1.4 s0 / §4.5.1
KDF derivations, Short Authentication String (B32), and SRTP master
key/salt export feeding `SrtpStreamTable` — the same "key provider →
SRTP context" interface SDES and DTLS-SRTP use.

Packet format: ZRTP messages ride RTP-lookalike packets (version 0,
magic cookie 0x5A525450, CRC-32C trailer) multiplexed on the media
port, demuxed by the cookie.  Like the in-memory DTLS endpoint, this is
packet-in/packet-out for the host I/O loop.

Counterpart: `libjitsi_tpu/control/zrtp.py` (copied, with the port's
imports).  One difference: the `cryptography` import is gated as in
`control/dtls.py`, so the module imports without the package; EC25 then
raises `RuntimeError` when an exchange first needs it, and DH3k (plain
`pow`) keeps working.  The JAX module raises at import instead.
"""

from __future__ import annotations

import collections
import hashlib
import hmac as hmac_mod
import os
import struct
from typing import Dict, List, Optional, Tuple

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    HAVE_CRYPTOGRAPHY = True
except ImportError:
    # gated dependency: only EC25 needs it (DH3k is plain `pow`)
    HAVE_CRYPTOGRAPHY = False

from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

MAGIC = 0x5A525450  # "ZRTP"
PREAMBLE = 0x505A
VERSION = b"1.10"

HASH_S256 = b"S256"
HASH_S384 = b"S384"
CIPHER_AES1 = b"AES1"
CIPHER_AES3 = b"AES3"
AUTH_HS80 = b"HS80"
AUTH_HS32 = b"HS32"
KA_EC25 = b"EC25"
KA_DH3K = b"DH3k"
KA_MULT = b"Mult"
SAS_B32 = b"B32 "

# ------------------------------------------------ algorithm agility tables --
# RFC 6189 §4.1.2: each Hello advertises ORDERED preference lists per
# slot; the committing endpoint selects, per slot, the first algorithm
# in its own order that the peer also advertised (preference
# intersection).  The old fixed suite (S256/AES1/HS80/EC25/B32) is the
# head of every default list, so default deployments negotiate exactly
# what they always did.

HASH_FNS = {HASH_S256: hashlib.sha256, HASH_S384: hashlib.sha384}
CIPHER_KEY_BITS = {CIPHER_AES1: 128, CIPHER_AES3: 256}
AUTH_TAG_BITS = {AUTH_HS80: 80, AUTH_HS32: 32}

# RFC 3526 §4 3072-bit MODP group ("DH3k", RFC 6189 §5.1.5): p =
# 2^3072 - 2^3008 - 1 + 2^64*(floor(2^2942 pi) + 1690314), generator 2.
# The constant below was re-derived from that formula (and the same
# derivation reproduces the published 2048-bit group-14 value bit for
# bit); p and (p-1)/2 are both prime.
DH3K_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AAAC42DAD33170D04507A33"
    "A85521ABDF1CBA64ECFB850458DBEF0A8AEA71575D060C7DB3970F85A6E1E4C7"
    "ABF5AE8CDB0933D71E8C94E04A25619DCEE3D2261AD2EE6BF12FFA06D98A0864"
    "D87602733EC86A64521F2B18177B200CBBE117577A615D6C770988C0BAD946E2"
    "08E24FA074E5AB3143DB5BFCE0FD108E4B82D120A93AD2CAFFFFFFFFFFFFFFFF",
    16)
DH3K_G = 2
KA_PUB_LEN = {KA_EC25: 64, KA_DH3K: 384}

DEFAULT_PREFS = {
    "hash": (HASH_S256, HASH_S384),
    "cipher": (CIPHER_AES1, CIPHER_AES3),
    "auth": (AUTH_HS80, AUTH_HS32),
    "ka": (KA_EC25, KA_DH3K),
    "sas": (SAS_B32,),
}
_SLOT_CODES = {
    "hash": tuple(HASH_FNS), "cipher": tuple(CIPHER_KEY_BITS),
    "auth": tuple(AUTH_TAG_BITS), "ka": tuple(KA_PUB_LEN),
    "sas": (SAS_B32,),
}

# (cipher, auth) -> the SRTP profile the negotiated keys feed
PROFILE_BY_SUITE = {
    (CIPHER_AES1, AUTH_HS80): SrtpProfile.AES_CM_128_HMAC_SHA1_80,
    (CIPHER_AES1, AUTH_HS32): SrtpProfile.AES_CM_128_HMAC_SHA1_32,
    (CIPHER_AES3, AUTH_HS80): SrtpProfile.AES_256_CM_HMAC_SHA1_80,
    (CIPHER_AES3, AUTH_HS32): SrtpProfile.AES_256_CM_HMAC_SHA1_32,
}

_B32_ALPHABET = "ybndrfg8ejkmcpqxot1uwisza345h769"  # RFC 6189 §5.1.6

# CRC-32C (Castagnoli, reflected poly 0x82F63B78) — RFC 6189 §5 requires
# the RFC 3309 CRC, not zlib's CRC-32/IEEE.
_CRC32C_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac_mod.new(key, msg, hashlib.sha256).digest()


def _kdf(ki: bytes, label: bytes, context: bytes, length_bits: int) -> bytes:
    """RFC 6189 §4.5.1 (NIST SP 800-108 counter-mode, one block)."""
    data = struct.pack("!I", 1) + label + b"\x00" + context + \
        struct.pack("!I", length_bits)
    return _hmac(ki, data)[: length_bits // 8]


def sas_b32(sashash: bytes) -> str:
    """Render the 20-bit short authentication string (RFC 6189 §5.1.6)."""
    bits = int.from_bytes(sashash[:4], "big") >> 12
    return "".join(_B32_ALPHABET[(bits >> s) & 31] for s in (15, 10, 5, 0))


# ---------------------------------------------------------------- packets --

def _wrap(msg: bytes, seq: int, ssrc: int) -> bytes:
    """ZRTP packet: RTP-lookalike header + message + CRC-32 trailer."""
    hdr = struct.pack("!BBH", 0x10, 0, seq & 0xFFFF) + \
        struct.pack("!II", MAGIC, ssrc & 0xFFFFFFFF)
    body = hdr + msg
    return body + struct.pack("!I", crc32c(body))


def is_zrtp(datagram: bytes) -> bool:
    return (len(datagram) >= 12
            and datagram[0] == 0x10
            and datagram[4:8] == struct.pack("!I", MAGIC))


def _unwrap(datagram: bytes) -> Optional[bytes]:
    if not is_zrtp(datagram) or len(datagram) < 16:
        return None
    body, crc = datagram[:-4], struct.unpack("!I", datagram[-4:])[0]
    if crc32c(body) != crc:
        return None
    return body[12:]


def _msg(mtype: bytes, payload: bytes) -> bytes:
    assert len(mtype) == 8
    total_words = (12 + len(payload)) // 4
    return struct.pack("!HH", PREAMBLE, total_words) + mtype + payload


def _parse_msg(msg: bytes) -> Optional[Tuple[bytes, bytes]]:
    if len(msg) < 12 or struct.unpack("!H", msg[:2])[0] != PREAMBLE:
        return None
    return msg[4:12], msg[12:]


# -------------------------------------------------------------- zid cache --

class ZidCache:
    """RFC 6189 §4.9 retained-secret cache: peer ZID → (rs1, rs2).

    After every completed DH-mode session both sides derive the same
    fresh retained secret and shift it in (rs1 → rs2, new → rs1); the
    next session's s0 then mixes the matching secret as s1 — KEY
    CONTINUITY: a MITM who wasn't in the first session cannot produce
    the continuity secret even if the SAS is never compared.  Keeping
    TWO generations tolerates one-sided update loss (a side that
    crashed before updating still matches the peer's rs2).

    In-memory; `snapshot()`/`restore()` give the caller a serializable
    form (the reference's zrtp4j persists its ZidFile likewise).

    BOUNDED: at most `max_entries` peers, least-recently-used evicted
    first (a reconnect storm from rotating ZIDs must not grow host
    memory without bound).  A lookup hit or an update refreshes the
    entry's recency; evictions are counted and the bound rides
    snapshot/restore.  Evicting a peer costs only key continuity on
    its NEXT session (it renegotiates from scratch) — never media.
    """

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._store: "collections.OrderedDict[bytes, Tuple[bytes, Optional[bytes]]]" \
            = collections.OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, zid: bytes) -> Tuple[Optional[bytes], Optional[bytes]]:
        key = bytes(zid)
        got = self._store.get(key)
        if got is None:
            return (None, None)
        self._store.move_to_end(key)
        return got

    def update(self, zid: bytes, rs_new: bytes) -> None:
        rs1, _ = self.lookup(zid)
        self._store[bytes(zid)] = (bytes(rs_new), rs1)
        self._store.move_to_end(bytes(zid))
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)
            self.evictions += 1

    def forget(self, zid: bytes) -> None:
        self._store.pop(bytes(zid), None)

    def snapshot(self) -> dict:
        return {"max_entries": self.max_entries,
                "evictions": self.evictions,
                # list of (zid, rs1, rs2) in LRU->MRU order so restore
                # reproduces the eviction order exactly
                "store": [(z, rs1, rs2)
                          for z, (rs1, rs2) in self._store.items()]}

    @classmethod
    def restore(cls, snap: dict) -> "ZidCache":
        if "store" not in snap:
            # legacy unbounded-format snapshot: {zid: (rs1, rs2)}
            c = cls()
            for z, (rs1, rs2) in snap.items():
                c._store[bytes(z)] = (bytes(rs1), None if rs2 is None
                                      else bytes(rs2))
            return c
        c = cls(max_entries=int(snap["max_entries"]))
        c.evictions = int(snap.get("evictions", 0))
        for z, rs1, rs2 in snap["store"]:
            c._store[bytes(z)] = (bytes(rs1),
                                  None if rs2 is None else bytes(rs2))
        return c


def _require_ec() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "ZRTP key agreement EC25 requires the 'cryptography' package; "
            "DH3k works without it (algorithms={'ka': (KA_DH3K,)})")


# --------------------------------------------------------------- endpoint --

class ZrtpProtocolError(RuntimeError):
    """An authenticity/protocol check failed on a received message.

    Never escapes `feed()` — the offending packet is dropped and the
    failure recorded in `ZrtpEndpoint.alerts` (an exception here would
    hand any off-path forger a DoS on the host I/O loop)."""


class ZrtpEndpoint:
    """One ZRTP association.  Both sides send Hello; the side told
    `initiate()` sends Commit and becomes the initiator.

    API mirrors the DTLS endpoint: `hello_packets()`, `feed(datagram)`,
    `complete`, `srtp_keys()`, plus `sas` for the user-verification
    string (the MITM defense: both users compare the 4 chars).
    """

    def __init__(self, zid: Optional[bytes] = None, ssrc: int = 0,
                 cache: Optional[ZidCache] = None,
                 multistream_from: Optional["ZrtpEndpoint"] = None,
                 algorithms: Optional[Dict[str, tuple]] = None):
        """`cache`: RFC 6189 §4.9 retained-secret store — sessions with
        a cached peer mix the shared secret into s0 (key continuity)
        and rotate it on completion.  `multistream_from`: a COMPLETED
        DH-mode endpoint of the same peer association; this endpoint
        then keys via Multistream mode (§4.4.3) — no DH, s0 derived
        from the parent's ZRTPSess session key.  `algorithms`: ordered
        preference lists per slot ("hash"/"cipher"/"auth"/"ka"/"sas",
        RFC 6189 §4.1.2) — defaults to DEFAULT_PREFS; the committing
        side selects the first of ITS preferences the peer advertised."""
        if multistream_from is not None:
            if multistream_from.session_key is None:
                raise RuntimeError(
                    "multistream_from endpoint has no session key "
                    "(DH-mode exchange not complete)")
            zid = multistream_from.zid if zid is None else zid
        self.zid = zid if zid is not None else os.urandom(12)
        self.ssrc = ssrc
        self.cache = cache
        self._zrtp_sess = (None if multistream_from is None
                           else multistream_from.session_key)
        # _mult is the NEGOTIATED mode: seeded by capability here, but a
        # peer's DH-mode Commit flips it off (a mult-capable responder
        # must follow the wire, not its constructor)
        self._mult = multistream_from is not None
        self._mult_nonce: Optional[bytes] = None
        self._rotated = False
        # outcomes (read after complete): did a retained secret match
        # (key continuity held), and this session's exportable ZRTPSess
        self.secret_continuity = False
        self.session_key: Optional[bytes] = None
        # hash image chain (RFC 6189 §9)
        self._h0 = os.urandom(32)
        self._h1 = _sha256(self._h0)
        self._h2 = _sha256(self._h1)
        self._h3 = _sha256(self._h2)
        # algorithm agility (RFC 6189 §4.1.2): validated preference
        # lists; the NEGOTIATED suite is pinned at Commit time
        prefs = dict(DEFAULT_PREFS)
        if algorithms:
            for slot, lst in algorithms.items():
                if slot not in _SLOT_CODES:
                    raise ValueError(f"unknown algorithm slot {slot!r}")
                lst = tuple(lst)
                bad = [c for c in lst if c not in _SLOT_CODES[slot]]
                if bad or not lst:
                    raise ValueError(f"unsupported {slot} codes {bad}")
                prefs[slot] = lst
        self._prefs = prefs
        self.suite: Optional[Dict[str, bytes]] = None
        self._hash = hashlib.sha256       # until a suite is negotiated
        self._ka_priv = None              # lazy; depends on suite["ka"]
        self._seq = int.from_bytes(os.urandom(2), "big")
        self.role: Optional[str] = None
        self.complete = False
        self.sas: Optional[str] = None
        self._s0: Optional[bytes] = None
        # dropped-packet security log — bounded: forged packets must not
        # grow host memory (deque evicts oldest)
        self.alerts = collections.deque(maxlen=64)
        self._peer: Dict[bytes, bytes] = {}  # raw peer messages by type
        self._my_hello = self._make_hello()
        self._my_commit: Optional[bytes] = None
        self._my_dhpart: Optional[bytes] = None
        self._peer_pub: Optional[bytes] = None

    # ------------------------------------------------- negotiated suite
    def _nh(self, b: bytes) -> bytes:
        """Negotiated-hash digest (hvi, total_hash, s0 — §4.4.1)."""
        return self._hash(b).digest()

    def _nkdf(self, ki: bytes, label: bytes, context: bytes,
              length_bits: int) -> bytes:
        """§4.5.1 KDF under the NEGOTIATED hash (the message-MAC /
        hash-image-chain domain stays SHA-256: those run before any
        suite exists on the wire)."""
        data = struct.pack("!I", 1) + label + b"\x00" + context + \
            struct.pack("!I", length_bits)
        return hmac_mod.new(ki, data, self._hash).digest()[
            : length_bits // 8]

    def _peer_hello_algs(self) -> Dict[str, tuple]:
        """Parse the peer Hello's per-slot advertised algorithm lists."""
        hello = self._peer[b"Hello   "]
        off = 12 + 4 + 16 + 32 + 12
        cnt = hello[off:off + 8]
        pos = off + 8
        out: Dict[str, tuple] = {}
        for slot, n in (("hash", cnt[1]), ("cipher", cnt[2]),
                        ("auth", cnt[3]), ("ka", cnt[4]),
                        ("sas", cnt[5])):
            out[slot] = tuple(hello[pos + 4 * i: pos + 4 * (i + 1)]
                              for i in range(n))
            pos += 4 * n
        return out

    def _select_suite(self) -> Dict[str, bytes]:
        """RFC 6189 §4.1.2 preference intersection: per slot, the first
        algorithm in OUR ordered list the peer also advertised."""
        peer = self._peer_hello_algs()
        suite: Dict[str, bytes] = {}
        for slot in ("hash", "cipher", "auth", "ka", "sas"):
            theirs = set(peer.get(slot, ()))
            pick = next((c for c in self._prefs[slot] if c in theirs),
                        None)
            if pick is None:
                raise ZrtpProtocolError(
                    f"ZRTP: no common {slot} algorithm "
                    f"(ours {self._prefs[slot]}, theirs "
                    f"{sorted(theirs)})")
            suite[slot] = pick
        return suite

    def _adopt_suite(self, suite: Dict[str, bytes]) -> None:
        self.suite = dict(suite)
        self._hash = HASH_FNS[suite["hash"]]

    def _ka(self) -> bytes:
        return (self.suite or {}).get("ka", KA_EC25)

    # ------------------------------------------------------------ builders
    def _gen_ka(self):
        if self._ka_priv is None:
            if self._ka() == KA_DH3K:
                # 256-bit exponent per RFC 6189 §4.4.1.3 (DH3k)
                self._ka_priv = int.from_bytes(os.urandom(32), "big")
            else:
                _require_ec()
                self._ka_priv = ec.generate_private_key(ec.SECP256R1())
        return self._ka_priv

    def _pub_bytes(self) -> bytes:
        priv = self._gen_ka()
        if self._ka() == KA_DH3K:
            return pow(DH3K_G, priv, DH3K_P).to_bytes(384, "big")
        return priv.public_key().public_bytes(
            serialization.Encoding.X962,
            serialization.PublicFormat.UncompressedPoint)[1:]  # 64B x||y

    def _make_hello(self) -> bytes:
        payload = VERSION + b"libjitsi-tpu    "[:16] + self._h3 + self.zid
        # flags byte + per-slot counts, then the ORDERED lists (§4.1.2)
        p = self._prefs
        payload += bytes([0, len(p["hash"]), len(p["cipher"]),
                          len(p["auth"]), len(p["ka"]), len(p["sas"]),
                          0, 0])
        for slot in ("hash", "cipher", "auth", "ka", "sas"):
            payload += b"".join(p[slot])
        core = _msg(b"Hello   ", payload + b"\x00" * 8)
        mac = _hmac(self._h2, core[:-8])[:8]
        return core[:-8] + mac

    def _make_commit(self) -> bytes:
        suite = self._select_suite()
        if self._mult:
            # Multistream mode (RFC 6189 §4.4.3): no DH — a fresh nonce
            # rides where DH mode carries the hvi commitment
            self._adopt_suite(dict(suite, ka=KA_MULT))
            self._mult_nonce = os.urandom(16)
            payload = self._h2 + self.zid + suite["hash"] + \
                suite["cipher"] + suite["auth"] + KA_MULT + \
                suite["sas"] + self._mult_nonce
            core = _msg(b"Commit  ", payload + b"\x00" * 8)
            return core[:-8] + _hmac(self._h1, core[:-8])[:8]
        self._adopt_suite(suite)
        dh2 = self._make_dhpart(b"DHPart2 ")
        hvi = self._nh(dh2 + self._peer[b"Hello   "])[:32]
        payload = self._h2 + self.zid + suite["hash"] + \
            suite["cipher"] + suite["auth"] + suite["ka"] + \
            suite["sas"] + hvi
        core = _msg(b"Commit  ", payload + b"\x00" * 8)
        mac = _hmac(self._h1, core[:-8])[:8]
        self._my_dhpart = dh2
        return core[:-8] + mac

    def _secret_ids(self, role_label: bytes) -> bytes:
        """RFC 6189 §4.3.1 rs1ID/rs2ID (+ random aux/pbx IDs): each is
        MAC(secret, sender-role label) truncated to 8 bytes; a side with
        no cached secret for this peer sends random IDs, which simply
        never match."""
        rs1 = rs2 = None
        if self.cache is not None and b"Hello   " in self._peer:
            rs1, rs2 = self.cache.lookup(self._peer_zid())
        ids = b""
        for rs in (rs1, rs2):
            ids += (_hmac(rs, role_label)[:8] if rs is not None
                    else os.urandom(8))
        return ids + os.urandom(16)      # auxsecretID, pbxsecretID

    def _make_dhpart(self, mtype: bytes) -> bytes:
        label = b"Initiator" if mtype == b"DHPart2 " else b"Responder"
        payload = self._h1 + self._secret_ids(label) + self._pub_bytes()
        core = _msg(mtype, payload + b"\x00" * 8)
        mac = _hmac(self._h0, core[:-8])[:8]
        return core[:-8] + mac

    def _make_confirm(self, mtype: bytes) -> bytes:
        # simplified confirm: HMAC(mackey, H0||flags) — the encrypted
        # part's semantics (cache expiry, sig) are not modeled
        key = self._mackey_own()
        payload = _hmac(key, self._h0)[:8] + self._h0
        return _msg(mtype, payload)

    # ----------------------------------------------------------- transport
    def _send(self, msg: bytes) -> bytes:
        # 16-bit wire field (RFC 6189 §5 sequence number): wrap at the
        # increment, not at serialization — a random initial seq near
        # 65535 otherwise grows past 2^16 within one handshake retry
        # storm and desyncs any receiver tracking the raw counter
        self._seq = (self._seq + 1) & 0xFFFF
        return _wrap(msg, self._seq, self.ssrc)

    def hello_packets(self) -> List[bytes]:
        return [self._send(self._my_hello)]

    def initiate(self) -> List[bytes]:
        """Become initiator (requires peer Hello already seen).  Idempotent:
        a retry resends the SAME Commit — regenerating it would fork the
        hvi commitment the peer has already pinned.  A side that already
        became responder (peer's Commit won) refuses: flipping roles
        mid-handshake would deadlock both sides."""
        if b"Hello   " not in self._peer:
            raise RuntimeError("peer Hello not yet received")
        if self.role == "responder":
            raise RuntimeError(
                "peer already committed first; this side is responder")
        if self.role == "initiator" and self._my_commit is not None:
            return [self._send(self._my_commit)]
        self.role = "initiator"
        self._my_commit = self._make_commit()
        return [self._send(self._my_commit)]

    @staticmethod
    def _check_mac(msg: bytes, key: bytes, what: str) -> None:
        """Retroactive message-MAC check (RFC 6189 §8.1.1): each message
        carries HMAC(next-revealed-hash-image, message) in its last 8B."""
        if not hmac_mod.compare_digest(_hmac(key, msg[:-8])[:8], msg[-8:]):
            raise ZrtpProtocolError(f"ZRTP: {what} message MAC mismatch "
                                    "(tampered in flight?)")

    def feed(self, datagram: bytes) -> List[bytes]:
        """Process one datagram; returns reply datagrams.  Never raises on
        wire input: malformed, out-of-order, duplicate and wrong-role
        packets are dropped (returns []), and failed authenticity checks
        are dropped with the reason appended to `self.alerts`."""
        msg = _unwrap(datagram)
        if msg is None:
            return []
        parsed = _parse_msg(msg)
        if parsed is None:
            return []
        mtype, payload = parsed
        try:
            return self._process(mtype, payload, msg)
        except ZrtpProtocolError as e:
            self.alerts.append(str(e))
            return []

    def _process(self, mtype: bytes, payload: bytes,
                 msg: bytes) -> List[bytes]:
        out: List[bytes] = []
        if mtype == b"Hello   ":
            # pin the first Hello: its H3/ZID feed the key derivation,
            # so a mid-handshake replacement must not take effect
            if mtype in self._peer:
                if self._peer[mtype] != msg:
                    return []
            else:
                self._peer[mtype] = msg
            out.append(self._send(_msg(b"HelloACK", b"")))
        elif mtype == b"Commit  ":
            if b"Hello   " not in self._peer:
                return []
            if self.role == "initiator":
                # Commit contention (RFC 6189 §4.2): both sides
                # committed.  A DH-mode Commit beats a Multistream one
                # (comparing the 32B hvi against a 16B nonce would be
                # meaningless, and the DH side cannot process Mult);
                # same-mode ties break on the LOWER value backing down
                # to responder and processing the peer's Commit.
                ka_off = 12 + 32 + 12 + 12
                ours_mult = self._my_commit[ka_off:ka_off + 4] == KA_MULT
                theirs_mult = msg[ka_off:ka_off + 4] == KA_MULT
                if ours_mult != theirs_mult:
                    # a DH-mode Commit beats a Multistream one (§4.2;
                    # comparing a 32B hvi against a 16B nonce would be
                    # meaningless, and the DH side cannot process Mult)
                    we_lose = ours_mult
                else:
                    # same MODE (two DH Commits — even with different
                    # KA choices — or two Mults): lower hvi/nonce backs
                    # down, §4.2's symmetric tie-break
                    hvi_off = 12 + 32 + 12 + 20
                    we_lose = self._my_commit[hvi_off:hvi_off + 32] < \
                        msg[hvi_off:hvi_off + 32]
                if not we_lose:
                    return []               # we win; peer backs down
                self.role = None            # back down, re-process below
                self._my_commit = None
                self._my_dhpart = None
                self._mult_nonce = None
                self._ka_priv = None        # peer's suite may differ
            if mtype in self._peer:
                if self._peer[mtype] != msg:
                    return []
                # duplicate Commit: resend the SAME reply (regenerating
                # a DHPart1 would fork total_hash between the sides)
                if self._mult and self._s0 is not None:
                    return [self._send(self._make_confirm(b"Confirm1"))]
                if self._my_dhpart is None:
                    return []
                return [self._send(self._my_dhpart)]
            peer_h2 = payload[:32]
            if _sha256(peer_h2) != self._peer_hello_h3():
                raise ZrtpProtocolError("ZRTP: Commit H2 does not chain to H3")
            # H2 now known -> verify the peer Hello's MAC retroactively
            self._check_mac(self._peer[b"Hello   "], peer_h2, "Hello")
            # the initiator's chosen suite (§4.1.2): every code must be
            # one WE advertised — a Commit naming an alien algorithm is
            # a downgrade/um-mismatch attack or a broken peer
            chosen = {"hash": payload[44:48], "cipher": payload[48:52],
                      "auth": payload[52:56], "sas": payload[60:64]}
            ka_code = payload[56:60]
            if ka_code != KA_MULT:
                chosen["ka"] = ka_code
            for slot, code in chosen.items():
                if code not in self._prefs[slot]:
                    raise ZrtpProtocolError(
                        f"ZRTP: Commit selects {slot} {code!r} we did "
                        "not offer")
            if payload[56:60] == KA_MULT:
                # Multistream commit (§4.4.3): no DH round — derive s0
                # from the shared ZRTPSess and confirm directly
                if self._zrtp_sess is None:
                    raise ZrtpProtocolError(
                        "ZRTP: Multistream Commit but no session key "
                        "(no completed DH-mode association)")
                self._peer[mtype] = msg
                self.role = "responder"
                self._mult = True
                self._adopt_suite(dict(chosen, ka=KA_MULT))
                self._derive()
                out.append(self._send(self._make_confirm(b"Confirm1")))
                return out
            self._peer[mtype] = msg
            self.role = "responder"
            self._mult = False        # peer chose DH mode: follow it
            self._adopt_suite(chosen)
            self._ka_priv = None      # KA is the initiator's choice
            self._my_dhpart = self._make_dhpart(b"DHPart1 ")
            out.append(self._send(self._my_dhpart))
        elif mtype == b"DHPart1 ":
            if self.role != "initiator" or self._my_dhpart is None:
                return []
            if mtype in self._peer:
                if self._peer[mtype] != msg:
                    return []
                return [self._send(self._my_dhpart)]
            # responder never sends Commit; its H1 chains straight to the
            # Hello H3 and reveals H2 = sha256(H1) for the Hello MAC
            peer_h1 = payload[:32]
            peer_h2 = _sha256(peer_h1)
            if _sha256(peer_h2) != self._peer_hello_h3():
                raise ZrtpProtocolError("ZRTP: DHPart1 H1 does not chain to H3")
            self._check_mac(self._peer[b"Hello   "], peer_h2, "Hello")
            pub = payload[64:64 + KA_PUB_LEN[self._ka()]]
            self._parse_point(pub)       # reject junk at receive time
            self._peer[mtype] = msg
            self._peer_pub = pub
            out.append(self._send(self._my_dhpart))
        elif mtype == b"DHPart2 ":
            if self.role != "responder" or b"Commit  " not in self._peer:
                return []
            if mtype in self._peer:
                if self._peer[mtype] != msg or self._s0 is None:
                    return []
                return [self._send(self._make_confirm(b"Confirm1"))]
            # verify commitment: hvi in Commit == hash(DHPart2||our Hello)
            commit = self._peer[b"Commit  "]
            hvi = commit[12 + 32 + 12 + 20:12 + 32 + 12 + 20 + 32]
            if self._nh(msg + self._my_hello)[:32] != hvi:
                raise ZrtpProtocolError("ZRTP: DHPart2 does not match hvi "
                                        "commitment (possible MITM)")
            # H1 revealed -> chains to Commit H2, and keys the Commit MAC
            peer_h1 = payload[:32]
            if _sha256(peer_h1) != commit[12:44]:
                raise ZrtpProtocolError("ZRTP: DHPart2 H1 does not chain to H2")
            self._check_mac(commit, peer_h1, "Commit")
            pub = payload[64:64 + KA_PUB_LEN[self._ka()]]
            self._parse_point(pub)
            self._peer[mtype] = msg
            self._peer_pub = pub
            self._derive()
            out.append(self._send(self._make_confirm(b"Confirm1")))
        elif mtype == b"Confirm1":
            if self.role != "initiator" or \
                    (b"DHPart1 " not in self._peer and not self._mult):
                return []
            self._derive()
            self._verify_confirm(payload)
            out.append(self._send(self._make_confirm(b"Confirm2")))
            self.complete = True
            self._on_complete()
        elif mtype == b"Confirm2":
            if self.role != "responder" or self._s0 is None:
                return []
            self._verify_confirm(payload)
            out.append(self._send(_msg(b"Conf2ACK", b"")))
            self.complete = True
            self._on_complete()
        return out

    def _on_complete(self) -> None:
        """Post-completion continuity bookkeeping (DH mode): rotate the
        retained secret both sides derive identically (§4.5.2) — the
        NEXT session's s0 then proves this one wasn't MITM'd.
        Idempotent: Confirms retransmit on lossy paths, and a double
        rotation would overwrite BOTH cached generations with the same
        value, losing the drift tolerance rs2 exists for."""
        if self._mult or self.cache is None or self._rotated:
            return
        self._rotated = True
        rs_new = self._nkdf(self._s0, b"retained secret", self._ctx, 256)
        self.cache.update(self._peer_zid(), rs_new)

    # ---------------------------------------------------------- key sched
    def _peer_hello_h3(self) -> bytes:
        hello = self._peer[b"Hello   "]
        return hello[12 + 4 + 16:12 + 4 + 16 + 32]

    def _parse_point(self, raw: bytes):
        """Validate a peer's public KA value for the NEGOTIATED group —
        64-byte x||y P-256 point (EC25) or 384-byte MODP element
        (DH3k).  Raises ZrtpProtocolError (dropped+alerted by feed) on
        junk — an invalid value must not escape as ValueError into the
        I/O loop, nor reach the agreement as an invalid-curve /
        small-subgroup input."""
        if self._ka() == KA_DH3K:
            if len(raw) != 384:
                raise ZrtpProtocolError(
                    "ZRTP: DH3k public value truncated")
            y = int.from_bytes(raw, "big")
            if not 1 < y < DH3K_P - 1:
                raise ZrtpProtocolError(
                    "ZRTP: DH3k public value out of range")
            return y
        if len(raw) != 64:
            raise ZrtpProtocolError("ZRTP: DHPart public value truncated")
        _require_ec()
        try:
            return ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256R1(), b"\x04" + raw)
        except ValueError as e:
            raise ZrtpProtocolError(f"ZRTP: invalid EC point ({e})") from e

    def _dh_result(self) -> bytes:
        peer = self._parse_point(self._peer_pub)
        if self._ka() == KA_DH3K:
            return pow(peer, self._gen_ka(), DH3K_P).to_bytes(384, "big")
        return self._gen_ka().exchange(ec.ECDH(), peer)

    def _match_retained(self) -> Optional[bytes]:
        """s1 selection (RFC 6189 §4.3): compare the PEER's rs1ID/rs2ID
        (from its DHPart, keyed by the peer's role label) against our
        cached generations; first match wins.  Both sides hold the same
        rotated values, so they pick the same secret — and the 2x2 scan
        tolerates one side having missed one rotation."""
        if self.cache is None:
            return None
        peer_dh = self._peer.get(b"DHPart1 " if self.role == "initiator"
                                 else b"DHPart2 ")
        if peer_dh is None:
            return None
        ids = (peer_dh[12 + 32:12 + 40], peer_dh[12 + 40:12 + 48])
        peer_label = b"Responder" if self.role == "initiator" \
            else b"Initiator"
        for mine in self.cache.lookup(self._peer_zid()):
            if mine is not None and _hmac(mine, peer_label)[:8] in ids:
                return mine
        return None

    def _derive(self) -> None:
        if self._s0 is not None:
            return
        if self._mult:
            self._derive_mult()
            return
        zidi, zidr, hello_r, commit = self._session_parties()
        if self.role == "initiator":
            dh1 = self._peer[b"DHPart1 "]
            dh2 = self._my_dhpart
        else:
            dh1 = self._my_dhpart
            dh2 = self._peer[b"DHPart2 "]
        total_hash = self._nh(hello_r + commit + dh1 + dh2)
        dhr = self._dh_result()
        # RFC 6189 §4.4.1.4: s1 = matching retained secret (key
        # continuity) or null; aux/pbx (s2, s3) not modeled -> null
        s1 = self._match_retained()
        self.secret_continuity = s1 is not None
        null = struct.pack("!I", 0)
        s1_part = (struct.pack("!I", len(s1)) + s1) if s1 else null
        self._s0 = self._nh(struct.pack("!I", 1) + dhr + b"ZRTP-HMAC-KDF" +
                            zidi + zidr + total_hash + s1_part + null + null)
        self._ctx = zidi + zidr + total_hash
        self.sas = sas_b32(self._nkdf(self._s0, b"SAS", self._ctx, 256))
        # exportable session key: Multistream children key off this
        # (§4.5.2), so additional media streams skip the DH entirely
        self.session_key = self._nkdf(self._s0, b"ZRTP Session Key",
                                      self._ctx, 256)

    def _session_parties(self):
        """Role-dependent (zidi, zidr, responder-Hello, Commit) shared
        by the DH and Multistream derivations."""
        if self.role == "initiator":
            return (self.zid, self._peer_zid(),
                    self._peer[b"Hello   "], self._my_commit)
        return (self._peer_zid(), self.zid,
                self._my_hello, self._peer[b"Commit  "])

    def _derive_mult(self) -> None:
        """Multistream s0 (RFC 6189 §4.4.3.2): KDF from the parent
        association's ZRTPSess over THIS stream's negotiation hash (the
        Commit carries a fresh nonce, so every stream's keys differ)."""
        zidi, zidr, hello_r, commit = self._session_parties()
        total_hash = self._nh(hello_r + commit)
        self._ctx = zidi + zidr + total_hash
        self._s0 = self._nkdf(self._zrtp_sess, b"ZRTP MSK", self._ctx, 256)
        self.sas = sas_b32(self._nkdf(self._s0, b"SAS", self._ctx, 256))
        # ZRTPSess is per ASSOCIATION (§4.5.2): propagate it so further
        # streams can key off this endpoint even when the caller only
        # kept the newest one
        self.session_key = self._zrtp_sess

    def _peer_zid(self) -> bytes:
        hello = self._peer[b"Hello   "]
        return hello[12 + 4 + 16 + 32:12 + 4 + 16 + 32 + 12]

    def _mackey_own(self) -> bytes:
        label = b"Initiator HMAC key" if self.role == "initiator" else \
            b"Responder HMAC key"
        return self._nkdf(self._s0, label, self._ctx, 256)

    def _mackey_peer(self) -> bytes:
        label = b"Responder HMAC key" if self.role == "initiator" else \
            b"Initiator HMAC key"
        return self._nkdf(self._s0, label, self._ctx, 256)

    def _verify_confirm(self, payload: bytes) -> None:
        mac, peer_h0 = payload[:8], payload[8:40]
        if not hmac_mod.compare_digest(
                _hmac(self._mackey_peer(), peer_h0)[:8], mac):
            raise ZrtpProtocolError("ZRTP: Confirm MAC mismatch")
        # retroactive checks (RFC 6189 §8.1.1): H0 -> H1 seen in peer
        # DHPart, and H0 keys the DHPart message MAC
        dh = self._peer.get(b"DHPart1 " if self.role == "initiator"
                            else b"DHPart2 ")
        if dh is not None:
            if _sha256(peer_h0) != dh[12:44]:
                raise ZrtpProtocolError(
                    "ZRTP: H0 does not chain to DHPart H1")
            self._check_mac(dh, peer_h0, "DHPart")
        if self._mult:
            # no DHPart revealed intermediate images in mult mode: the
            # Confirm's H0 must chain all the way to the peer Hello's
            # H3, and (responder side) it keys the Commit MAC the DH
            # path verifies via DHPart2
            h1 = _sha256(peer_h0)
            h2 = _sha256(h1)
            if _sha256(h2) != self._peer_hello_h3():
                raise ZrtpProtocolError(
                    "ZRTP: Confirm H0 does not chain to Hello H3")
            commit = self._peer.get(b"Commit  ")
            if commit is not None:     # peer was the mult initiator
                if h2 != commit[12:44]:
                    raise ZrtpProtocolError(
                        "ZRTP: Confirm H0 does not chain to Commit H2")
                self._check_mac(commit, h1, "Commit")

    # -------------------------------------------------------------- export
    def srtp_keys(self):
        """(profile, tx_key, tx_salt, rx_key, rx_salt) — initiator sends
        with the initiator key (RFC 6189 §4.5.3); key length and SRTP
        profile follow the NEGOTIATED cipher/auth suite."""
        if self._s0 is None:
            raise RuntimeError("ZRTP not negotiated")
        suite = self.suite or {"cipher": CIPHER_AES1, "auth": AUTH_HS80}
        bits = CIPHER_KEY_BITS[suite["cipher"]]
        ki = self._nkdf(self._s0, b"Initiator SRTP master key",
                        self._ctx, bits)
        si = self._nkdf(self._s0, b"Initiator SRTP master salt",
                        self._ctx, 112)
        kr = self._nkdf(self._s0, b"Responder SRTP master key",
                        self._ctx, bits)
        sr = self._nkdf(self._s0, b"Responder SRTP master salt",
                        self._ctx, 112)
        profile = PROFILE_BY_SUITE[(suite["cipher"], suite["auth"])]
        if self.role == "initiator":
            return profile, ki, si, kr, sr
        return profile, kr, sr, ki, si
