"""DTLS-SRTP control plane (RFC 5764), host-side.

Rebuilds the reference's `org.jitsi.impl.neomedia.transform.dtls.
{DtlsControlImpl,DtlsPacketTransformer,TlsClientImpl,TlsServerImpl,
DatagramTransportImpl}` (BouncyCastle-based) on OpenSSL's DTLS via the
`cryptography` package's FFI bindings: memory-BIO packet-in/packet-out
(no sockets — the host I/O loop feeds datagrams, exactly like the
reference's DatagramTransportImpl), the `use_srtp` extension for profile
negotiation, X.509 fingerprint verification against signaling, and
RFC 5764 §4.2 "EXTRACTOR-dtls_srtp" keying-material export feeding the
SRTP tables.  Handshake is the cold path and stays on the host (SURVEY
§2.2).

Counterpart: `libjitsi_tpu/control/dtls.py` (copied, with the port's
imports): `is_dtls`, `generate_certificate`, `fingerprint`,
`DtlsSrtpEndpoint`, `StubDtlsEndpoint` and `DtlsAssociationTable` in
its inline and deferred modes.  The `cryptography` package stays a gated
dependency: the module imports without it, and an OpenSSL endpoint
raises at construction.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

try:
    from cryptography import x509
    from cryptography.hazmat.bindings.openssl.binding import Binding
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    HAVE_CRYPTOGRAPHY = True
except ImportError:
    # gated dependency: the module must import without `cryptography`
    # (demux + SDES-keyed bridges need none of it); DTLS handshakes
    # raise at use time with a clear message instead
    HAVE_CRYPTOGRAPHY = False
import datetime

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from libjitsi_tpu_torch.utils.logging import get_logger

_dtls_log = get_logger("control.dtls")

_lib = _ffi = None


def _openssl():
    """Bind the OpenSSL FFI on first DTLS use (lazy so importing this
    module — which every bridge does for `is_dtls` — never requires the
    `cryptography` package to be installed)."""
    global _lib, _ffi
    if _lib is None:
        if not HAVE_CRYPTOGRAPHY:
            raise RuntimeError(
                "DTLS-SRTP requires the 'cryptography' package; "
                "SDES keying (add_participant) works without it")
        b = Binding()
        _lib, _ffi = b.lib, b.ffi
    return _lib, _ffi

# RFC 5764 §4.1.2 / OpenSSL srtp.h profile registry
_PROFILE_BY_ID = {
    0x0001: SrtpProfile.AES_CM_128_HMAC_SHA1_80,
    0x0002: SrtpProfile.AES_CM_128_HMAC_SHA1_32,
    0x0007: SrtpProfile.AEAD_AES_128_GCM,
}
_OPENSSL_NAME = {
    SrtpProfile.AES_CM_128_HMAC_SHA1_80: "SRTP_AES128_CM_SHA1_80",
    SrtpProfile.AES_CM_128_HMAC_SHA1_32: "SRTP_AES128_CM_SHA1_32",
    SrtpProfile.AEAD_AES_128_GCM: "SRTP_AEAD_AES_128_GCM",
}


def is_dtls(datagram: bytes) -> bool:
    """RFC 5764 §5.1.2 demux: first byte in [20..63] = DTLS record."""
    return len(datagram) > 0 and 20 <= datagram[0] <= 63


def generate_certificate(cn: str = "libjitsi-tpu"
                         ) -> Tuple[bytes, bytes, str]:
    """Self-signed ECDSA P-256 cert: (cert_der, key_der, sha256 fp).

    Reference: DtlsControlImpl generates a per-instance self-signed
    certificate whose fingerprint goes into signaling.
    """
    _openssl()
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=365))
            .sign(key, hashes.SHA256()))
    cert_der = cert.public_bytes(serialization.Encoding.DER)
    key_der = key.private_bytes(
        serialization.Encoding.DER,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    return cert_der, key_der, fingerprint(cert_der)


def fingerprint(cert_der: bytes) -> str:
    """SDP-style uppercase colon-separated SHA-256 fingerprint."""
    h = hashlib.sha256(cert_der).hexdigest().upper()
    return ":".join(h[i:i + 2] for i in range(0, len(h), 2))


class DtlsSrtpEndpoint:
    """One DTLS-SRTP association (client or server role).

    Packet-level API:
      out = ep.handshake_packets()      # datagrams to send now
      out = ep.feed(incoming_datagram)  # returns response datagrams
      ep.complete                       # handshake done?
      ep.srtp_keys()                    # (profile, tx_key, tx_salt,
                                        #  rx_key, rx_salt) per role
    """

    EXTRACTOR = b"EXTRACTOR-dtls_srtp"

    def __init__(self, role: str,
                 profiles: Optional[List[SrtpProfile]] = None,
                 cert_der: Optional[bytes] = None,
                 key_der: Optional[bytes] = None,
                 remote_fingerprint: Optional[str] = None,
                 mtu: int = 1200,
                 cookie_exchange: bool = False):
        if role not in ("client", "server"):
            raise ValueError("role must be client or server")
        _openssl()
        self.role = role
        self.profiles = profiles or [
            SrtpProfile.AES_CM_128_HMAC_SHA1_80,
            SrtpProfile.AEAD_AES_128_GCM,
        ]
        if cert_der is None:
            cert_der, key_der, _ = generate_certificate()
        self.cert_der = cert_der
        self.local_fingerprint = fingerprint(cert_der)
        self.remote_fingerprint = remote_fingerprint
        self.complete = False
        self.peer_cert_der: Optional[bytes] = None

        ctx = _lib.SSL_CTX_new(_lib.DTLS_method())
        if ctx == _ffi.NULL:
            raise RuntimeError("SSL_CTX_new failed")
        self._ctx = _ffi.gc(ctx, _lib.SSL_CTX_free)

        # install cert + key from DER (via memory BIOs — the bindings
        # expose only the *_bio d2i variants)
        cbio = _lib.BIO_new_mem_buf(cert_der, len(cert_der))
        x509p = _lib.d2i_X509_bio(cbio, _ffi.NULL)
        _lib.BIO_free(cbio)
        if x509p == _ffi.NULL:
            raise RuntimeError("d2i_X509_bio failed")
        _lib.SSL_CTX_use_certificate(self._ctx, x509p)
        kbio = _lib.BIO_new_mem_buf(key_der, len(key_der))
        pkey = _lib.d2i_PrivateKey_bio(kbio, _ffi.NULL)
        _lib.BIO_free(kbio)
        if pkey == _ffi.NULL:
            raise RuntimeError("d2i_PrivateKey_bio failed")
        _lib.SSL_CTX_use_PrivateKey(self._ctx, pkey)

        # use_srtp extension (0 == success)
        names = ":".join(_OPENSSL_NAME[p] for p in self.profiles)
        if _lib.SSL_CTX_set_tlsext_use_srtp(self._ctx,
                                            names.encode()) != 0:
            raise RuntimeError("SSL_CTX_set_tlsext_use_srtp failed")

        # request the peer's cert; actual trust = fingerprint vs signaling
        self._verify_cb = _ffi.callback(
            "int(int, X509_STORE_CTX *)", lambda ok, store: 1)
        _lib.SSL_CTX_set_verify(
            self._ctx,
            _lib.SSL_VERIFY_PEER | (
                _lib.SSL_VERIFY_FAIL_IF_NO_PEER_CERT
                if role == "server" else 0),
            self._verify_cb)

        # optional RFC 6347 §4.2.1 cookie exchange (HelloVerifyRequest):
        # a spoofed-source ClientHello costs the server no association
        # state until the cookie round-trips.  Cookie = HMAC-free random
        # per-endpoint secret (no peer address exists on a memory BIO;
        # the bridge's one-socket model ties the exchange to the 5-tuple
        # at the io layer).  Reference behavior: BouncyCastle's
        # DTLSVerifier under DtlsPacketTransformer.
        self._cookie_cbs = None
        if role == "server" and cookie_exchange:
            secret = os.urandom(16)

            @_ffi.callback("int(SSL *, unsigned char *, unsigned int *)")
            def _gen(ssl_p, cookie, clen):
                _ffi.buffer(cookie, 16)[:] = secret
                clen[0] = 16
                return 1

            @_ffi.callback(
                "int(SSL *, const unsigned char *, unsigned int)")
            def _ver(ssl_p, cookie, clen):
                return 1 if _ffi.buffer(cookie, clen)[:] == secret else 0

            self._cookie_cbs = (_gen, _ver)      # keep cffi handles alive
            _lib.SSL_CTX_set_cookie_generate_cb(self._ctx, _gen)
            _lib.SSL_CTX_set_cookie_verify_cb(self._ctx, _ver)

        ssl = _lib.SSL_new(self._ctx)
        self._ssl = _ffi.gc(ssl, _lib.SSL_free)
        self._rbio = _lib.BIO_new(_lib.BIO_s_mem())
        self._wbio = _lib.BIO_new(_lib.BIO_s_mem())
        _lib.SSL_set_bio(self._ssl, self._rbio, self._wbio)  # SSL owns BIOs
        if role == "server" and cookie_exchange:
            _lib.SSL_set_options(self._ssl, 0x00002000)  # OP_COOKIE_EXCHANGE
        if role == "client":
            _lib.SSL_set_connect_state(self._ssl)
        else:
            _lib.SSL_set_accept_state(self._ssl)
        self.retransmits = 0
        # flips once the peer has demonstrably advanced the handshake
        # past the stateless phase (see feed); used by the association
        # table to decide whether an address binding may be superseded
        self.progressed = False
        self._out_bytes = 0

    # ------------------------------------------------------------- pumps
    def _drain_out(self) -> List[bytes]:
        out = []
        buf = _ffi.new("char[]", 4096)
        while True:
            n = _lib.BIO_read(self._wbio, buf, len(buf))
            if n <= 0:
                break
            out.append(_ffi.buffer(buf, n)[:])
        return out

    def _pump(self) -> None:
        rc = _lib.SSL_do_handshake(self._ssl)
        if rc == 1 and not self.complete:
            self._on_complete()

    def handshake_packets(self) -> List[bytes]:
        """Kick/continue the handshake; returns datagrams to transmit."""
        if not self.complete:
            self._pump()
        return self._drain_out()

    def feed(self, datagram: bytes) -> List[bytes]:
        """Process one incoming DTLS datagram; returns responses."""
        buf = _ffi.new("char[]", datagram)
        _lib.BIO_write(self._rbio, buf, len(datagram))
        if not self.complete:
            self._pump()
        out = self._drain_out()
        # a HelloVerifyRequest is one tiny record; the ServerHello
        # flight (certificate etc.) is far larger.  Crossing that line
        # means the peer round-tripped the cookie (or no cookies are in
        # use) and actually holds its source address.
        self._out_bytes += sum(len(d) for d in out)
        if self.complete or self._out_bytes > 300:
            self.progressed = True
        return out

    def tick(self) -> List[bytes]:
        """Drive the RFC 6347 retransmission timer; call periodically
        (e.g. from the media loop tick).  OpenSSL tracks the flight
        timer internally (1 s initial, doubling); when it has expired
        this retransmits the last flight and returns the datagrams —
        without it, one lost handshake datagram deadlocks the
        association.  Reference: BouncyCastle's DTLSReliableHandshake
        under DtlsPacketTransformer.
        """
        if self.complete:
            return []
        rc = _lib.DTLSv1_handle_timeout(self._ssl)
        if rc > 0:
            self.retransmits += 1
        return self._drain_out()

    # ---------------------------------------------------------- completion
    def _on_complete(self) -> None:
        cert = _lib.SSL_get_peer_certificate(self._ssl)
        if cert != _ffi.NULL:
            bio = _lib.BIO_new(_lib.BIO_s_mem())
            _lib.i2d_X509_bio(bio, cert)
            buf = _ffi.new("char[]", 8192)
            n = _lib.BIO_read(bio, buf, len(buf))
            self.peer_cert_der = _ffi.buffer(buf, n)[:] if n > 0 else b""
            _lib.BIO_free(bio)
            _lib.X509_free(cert)
        if self.remote_fingerprint is not None:
            got = fingerprint(self.peer_cert_der or b"")
            if got != self.remote_fingerprint.upper():
                raise RuntimeError(
                    f"DTLS fingerprint mismatch: {got} != "
                    f"{self.remote_fingerprint} (possible MITM)")
        self.complete = True

    @property
    def selected_profile(self) -> SrtpProfile:
        prof = _lib.SSL_get_selected_srtp_profile(self._ssl)
        if prof == _ffi.NULL:
            raise RuntimeError("no SRTP profile negotiated")
        return _PROFILE_BY_ID[prof.id]

    def srtp_keys(self):
        """RFC 5764 §4.2 key export, role-resolved.

        Returns (profile, tx_key, tx_salt, rx_key, rx_salt): the client
        sends with client_write keys, the server with server_write.
        """
        if not self.complete:
            raise RuntimeError("handshake not complete")
        profile = self.selected_profile
        p = profile.policy
        kl, sl = p.enc_key_len, p.salt_len
        total = 2 * (kl + sl)
        out = _ffi.new("unsigned char[]", total)
        rc = _lib.SSL_export_keying_material(
            self._ssl, out, total, self.EXTRACTOR, len(self.EXTRACTOR),
            _ffi.NULL, 0, 0)
        if rc != 1:
            raise RuntimeError("SSL_export_keying_material failed")
        blob = _ffi.buffer(out, total)[:]
        ck, sk = blob[:kl], blob[kl:2 * kl]
        cs, ss = blob[2 * kl:2 * kl + sl], blob[2 * kl + sl:]
        if self.role == "client":
            return profile, ck, cs, sk, ss
        return profile, sk, ss, ck, cs


class StubDtlsEndpoint:
    """Dependency-free stand-in for `DtlsSrtpEndpoint` with the same
    wire surface: `handshake_packets` / `feed` / `tick` / `complete` /
    `progressed` / `srtp_keys` / `selected_profile`.

    NOT DTLS and NOT secure — keys are a public hash of the two hello
    randoms.  It exists so the association table, the off-tick
    handshake plane and the reconnect-storm chaos soak can exercise
    real datagram flows (cookie round-trips, flight retransmission,
    address claiming/supersede, key landing) in environments without
    the `cryptography` package, where `DtlsSrtpEndpoint` raises at
    construction.  Every record's first byte sits in the RFC 5764
    demux range [20, 63] so `is_dtls` routing is identical.

    Handshake shape (mirrors the real flights' roles):
      hello   C->S  small; carries client random + offered profiles
      verify  S->C  small; cookie challenge (cookie_exchange only) —
                    like a HelloVerifyRequest it never flips
                    `progressed`, so spoofed-source hellos still lose
                    the supersede race in `DtlsAssociationTable._claim`
      accept  S->C  LARGE (padded cert: crosses the `progressed` line
                    exactly like a real ServerHello+Certificate flight)
      finish  C->S  carries the client cert for fingerprint pinning
      done    S->C  completes the client side
    """

    _HELLO, _VERIFY, _ACCEPT, _FINISH, _DONE = 58, 59, 60, 61, 62
    FLIGHT_TIMEOUT_S = 0.25        # initial retransmission timer
    #: stable 1-byte wire ids (enum declaration order)
    _PROFILE_ID = {p: i for i, p in enumerate(SrtpProfile)}

    def __init__(self, role: str,
                 profiles: Optional[List[SrtpProfile]] = None,
                 cert_der: Optional[bytes] = None,
                 key_der: Optional[bytes] = None,
                 remote_fingerprint: Optional[str] = None,
                 mtu: int = 1200,
                 cookie_exchange: bool = False):
        if role not in ("client", "server"):
            raise ValueError("role must be client or server")
        self.role = role
        self.profiles = profiles or [
            SrtpProfile.AES_CM_128_HMAC_SHA1_80,
            SrtpProfile.AEAD_AES_128_GCM,
        ]
        self._rand = os.urandom(16)
        self.cert_der = cert_der or (b"stub-cert:" + self._rand)
        self.local_fingerprint = fingerprint(self.cert_der)
        self.remote_fingerprint = remote_fingerprint
        self.peer_cert_der: Optional[bytes] = None
        self.complete = False
        self.progressed = False
        self.retransmits = 0
        self.cookie_exchange = bool(cookie_exchange)
        self._cookie = os.urandom(8) if role == "server" else b"\x00" * 8
        self._peer_rand: Optional[bytes] = None
        self._profile: Optional[SrtpProfile] = None
        self._flight: List[bytes] = []
        self._flight_t = 0.0
        self._timeout = self.FLIGHT_TIMEOUT_S
        self._out_bytes = 0

    # ------------------------------------------------------------ records
    def _hello(self) -> bytes:
        ids = bytes(self._PROFILE_ID[p] for p in self.profiles)
        return (bytes([self._HELLO]) + self._rand + self._cookie
                + bytes([len(ids)]) + ids)

    def _accept(self) -> bytes:
        cert = self.cert_der
        body = (bytes([self._ACCEPT]) + self._rand
                + bytes([self._PROFILE_ID[self._profile]])
                + len(cert).to_bytes(2, "big") + cert)
        return body + b"\x00" * max(0, 400 - len(body))  # cert-flight size

    def _set_flight(self, datagrams: List[bytes]) -> List[bytes]:
        self._flight = list(datagrams)
        self._flight_t = time.monotonic()
        self._timeout = self.FLIGHT_TIMEOUT_S
        return self._note_out(list(datagrams))

    def _note_out(self, out: List[bytes]) -> List[bytes]:
        self._out_bytes += sum(len(d) for d in out)
        if self.complete or self._out_bytes > 300:
            self.progressed = True
        return out

    def _check_fingerprint(self, cert: bytes) -> None:
        self.peer_cert_der = cert
        if self.remote_fingerprint is not None:
            got = fingerprint(cert)
            if got != self.remote_fingerprint.upper():
                raise RuntimeError(
                    f"DTLS fingerprint mismatch: {got} != "
                    f"{self.remote_fingerprint} (possible MITM)")

    # -------------------------------------------------------------- pumps
    def handshake_packets(self) -> List[bytes]:
        if self.complete:
            return []
        if self.role == "client" and not self._flight:
            return self._set_flight([self._hello()])
        return self._note_out(list(self._flight))

    def feed(self, datagram: bytes) -> List[bytes]:
        if not datagram:
            return []
        kind = datagram[0]
        if self.role == "server":
            if kind == self._HELLO:
                rand, cookie = datagram[1:17], datagram[17:25]
                if self.cookie_exchange and cookie != self._cookie:
                    # stateless challenge: tiny, never "progresses"
                    return self._note_out(
                        [bytes([self._VERIFY]) + self._cookie])
                n = datagram[25]
                offered = set(datagram[26:26 + n])
                self._peer_rand = rand
                self._profile = next(
                    (p for p in self.profiles
                     if self._PROFILE_ID[p] in offered),
                    self.profiles[0])
                return self._set_flight([self._accept()])
            if kind == self._FINISH:
                clen = int.from_bytes(datagram[1:3], "big")
                self._check_fingerprint(datagram[3:3 + clen])
                self.complete = True
                self.progressed = True
                self._flight = []
                return self._note_out([bytes([self._DONE])])
            return []
        # client
        if kind == self._VERIFY:
            self._cookie = datagram[1:9]
            return self._set_flight([self._hello()])
        if kind == self._ACCEPT:
            self._peer_rand = datagram[1:17]
            pid = datagram[17]
            self._profile = next(
                (p for p in self.profiles
                 if self._PROFILE_ID[p] == pid), self.profiles[0])
            clen = int.from_bytes(datagram[18:20], "big")
            self._check_fingerprint(datagram[20:20 + clen])
            cert = self.cert_der
            return self._set_flight(
                [bytes([self._FINISH]) + len(cert).to_bytes(2, "big")
                 + cert])
        if kind == self._DONE:
            self.complete = True
            self.progressed = True
            self._flight = []
        return []

    def tick(self) -> List[bytes]:
        if self.complete or not self._flight:
            return []
        now = time.monotonic()
        if now - self._flight_t < self._timeout:
            return []
        self._flight_t = now
        self._timeout *= 2.0           # RFC 6347-style doubling backoff
        self.retransmits += 1
        return self._note_out(list(self._flight))

    # ---------------------------------------------------------- key export
    @property
    def selected_profile(self) -> SrtpProfile:
        if self._profile is None:
            raise RuntimeError("no SRTP profile negotiated")
        return self._profile

    def srtp_keys(self):
        if not self.complete:
            raise RuntimeError("handshake not complete")
        profile = self.selected_profile
        p = profile.policy
        kl, sl = p.enc_key_len, p.salt_len
        cr, sr = ((self._rand, self._peer_rand)
                  if self.role == "client"
                  else (self._peer_rand, self._rand))
        seed = b"stub-dtls-export" + cr + sr
        blob = (hashlib.sha256(seed).digest()
                + hashlib.sha256(seed + b"\x01").digest())
        ck, sk = blob[:kl], blob[kl:2 * kl]
        cs = blob[2 * kl:2 * kl + sl]
        ss = blob[2 * kl + sl:2 * (kl + sl)]
        if self.role == "client":
            return profile, ck, cs, sk, ss
        return profile, sk, ss, ck, cs


class DtlsAssociationTable:
    """Pending DTLS-SRTP associations for a bridge's media loop.

    Owns the sid <-> peer-address binding, datagram routing, flight
    retransmission ticking and the early-media hold window; the owning
    bridge supplies `install(sid, endpoint)` to put exported keys into
    its own tables.  Shared by ConferenceBridge and SfuBridge so the
    association logic exists exactly once.  Reference:
    DtlsPacketTransformer + DtlsControlImpl (SURVEY §3.5).

    Two execution modes:

    * inline (default, `deferred=False`): `on_dtls` runs OpenSSL work
      and key install synchronously on the calling (tick) thread —
      the original behavior, kept for bridges without a lifecycle
      manager.
    * deferred (`deferred=True`, flipped by the lifecycle plane's
      HandshakeQueue): `on_dtls` only ENQUEUES the datagram into a
      bounded inbox and returns nothing; `process(budget)` drains the
      inbox in bounded batches on the between-ticks window, and key
      landing goes through the staged commit barrier (the install
      callback stages; `release_stream` happens at commit).  The tick
      thread never touches OpenSSL.
    """

    def __init__(self, loop, profile: SrtpProfile, install,
                 deferred: bool = False, inbox_limit: int = 8192,
                 endpoint_factory=None):
        self.loop = loop
        self.profile = profile
        self.install = install
        # same-surface endpoint constructor; swap in StubDtlsEndpoint
        # for environments without the `cryptography` package
        self.endpoint_factory = endpoint_factory or DtlsSrtpEndpoint
        self.pending = {}              # sid -> DtlsSrtpEndpoint
        self.addr_of = {}              # (ip, port) -> sid
        self.sid_addr = {}             # sid -> (ip, port)  (companion)
        self.rejected = 0              # fingerprint-mismatch teardowns
        self.deferred = bool(deferred)
        self.inbox_limit = int(inbox_limit)
        self._inbox: "deque" = deque()  # (datagram, addr) awaiting drain
        self.inbox_dropped = 0         # inbox overflow (storm past bound)
        self.retransmits_total = 0     # flight datagrams resent by tick()
        self.feeds_total = 0           # OpenSSL feed() calls (any thread)
        self.handshakes_completed = 0

    def join(self, sid: int, role: str = "server",
             remote_fingerprint: Optional[str] = None,
             cookie_exchange: bool = False,
             remote_addr: Optional[Tuple[int, int]] = None
             ) -> "DtlsSrtpEndpoint":
        ep = self.endpoint_factory(role, profiles=[self.profile],
                                   remote_fingerprint=remote_fingerprint,
                                   cookie_exchange=cookie_exchange)
        self.pending[sid] = ep
        if remote_addr is not None:
            # signaling-known peer address: bind now, no guessing later
            self._bind(sid, tuple(remote_addr))
            ep.progressed = True       # binding is authoritative
        self.loop.hold_stream(sid)
        return ep

    def _bind(self, sid: int, addr) -> None:
        old = self.sid_addr.get(sid)
        if old is not None:
            self.addr_of.pop(old, None)
        self.addr_of[addr] = sid
        self.sid_addr[sid] = addr

    def _claim(self, addr):
        """Pick the sid a first-seen address may drive.  Unclaimed
        pending rows win; otherwise a bound-but-unprogressed row may be
        superseded (with cookie_exchange, a spoofed-source ClientHello
        can bind an address but can never round-trip the cookie, so it
        never progresses and the real peer reclaims the row)."""
        unclaimed = [s for s in self.pending if s not in self.sid_addr]
        if len(unclaimed) == 1:
            return unclaimed[0]
        if not unclaimed:
            stale = [s for s, ep in self.pending.items()
                     if not ep.progressed
                     and self.sid_addr.get(s) is not None]
            if len(stale) == 1:
                return stale[0]
        # ambiguous: guessing could land keys on the wrong row; the
        # peer's flight timer retransmits, signaling-bound joins route
        return None

    def on_dtls(self, datagram: bytes, addr) -> list:
        addr = tuple(addr)
        if self.deferred:
            # tick-thread contract: no OpenSSL here — enqueue only.
            # Replies go out from process() on the between-ticks window.
            if len(self._inbox) >= self.inbox_limit:
                self.inbox_dropped += 1
                return []
            self._inbox.append((bytes(datagram), addr))
            return []
        return self._process_one(datagram, addr)

    # plane=dual: in deferred mode this only ever runs from process()
    # on the between-ticks window; standalone bridges (no lifecycle
    # manager) run it inline from on_dtls, accepting the tick-thread
    # OpenSSL cost.  The runtime twin of this exception is the
    # handshake_tick_thread_feeds counter, which stays 0 whenever a
    # lifecycle manager is attached.
    def _process_one(self, datagram: bytes, addr) -> list:  # jitlint: plane=dual
        sid = self.addr_of.get(addr)
        if sid is None:
            sid = self._claim(addr)
            if sid is None:
                return []
            self._bind(sid, addr)
        ep = self.pending.get(sid)
        if ep is None:
            return []
        try:
            self.feeds_total += 1
            out = ep.feed(datagram)
        except RuntimeError as e:
            # fingerprint mismatch (wrong peer / MITM): drop the
            # association, not the bridge tick
            self.forget(sid)
            self.rejected += 1
            _dtls_log.warn("dtls_association_rejected", sid=sid,
                           error=str(e))
            return []
        if ep.complete:
            # media return address comes from the AUTHENTICATED
            # handshake's bound 5-tuple, never from the first datagram
            self.loop.addr_ip[sid] = addr[0]
            self.loop.addr_port[sid] = addr[1]
            # un-pend BEFORE install: install hooks (e.g. SFU route
            # rebuild) must see this row as keyed
            self.pending.pop(sid, None)
            self.handshakes_completed += 1
            self.install(sid, ep)
            if not self.deferred:
                # deferred mode stages the keys instead; the commit
                # barrier releases held early media atomically
                self.loop.release_stream(sid)
        return out

    def process(self, budget: Optional[int] = None) -> int:
        """Drain up to `budget` queued datagrams (all when None) — the
        off-tick OpenSSL pass for deferred mode.  Replies gather per
        peer address: one PacketBatch/send_batch per address per pass,
        not one per datagram."""
        n = len(self._inbox)
        if budget is not None:
            n = min(n, max(0, int(budget)))
        if n <= 0:
            return 0
        by_addr: Dict[Tuple[int, int], List[bytes]] = {}
        for _ in range(n):
            datagram, addr = self._inbox.popleft()
            out = self._process_one(datagram, addr)
            if out:
                by_addr.setdefault(addr, []).extend(out)
        for addr, datagrams in by_addr.items():
            self.loop.engine.send_batch(
                PacketBatch.from_payloads(datagrams), addr[0], addr[1])
        return n

    def tick(self, stride: int = 1, phase: int = 0) -> int:
        """Flight-retransmission pass: drive RFC 6347 timers and resend
        expired flights, gathered into one PacketBatch per peer address.
        `stride`/`phase` let the off-tick drain service only 1/stride of
        the associations per pass (keyed on sid), spreading a storm's
        flight timers so retransmissions never resend in lockstep — the
        jitter that honors exponential client backoff.  Returns the
        number of datagrams resent."""
        stride = max(1, int(stride))
        by_addr: Dict[Tuple[int, int], List[bytes]] = {}
        for sid, ep in list(self.pending.items()):
            if stride > 1 and (sid % stride) != (phase % stride):
                continue
            out = ep.tick()
            if not out:
                continue
            addr = self.sid_addr.get(sid)
            if addr is None:
                continue
            by_addr.setdefault(addr, []).extend(out)
        sent = 0
        for addr, datagrams in by_addr.items():
            self.loop.engine.send_batch(
                PacketBatch.from_payloads(datagrams), addr[0], addr[1])
            sent += len(datagrams)
        self.retransmits_total += sent
        return sent

    @property
    def backlog(self) -> int:
        """Queued datagrams + pending associations: the admission-facing
        depth of the handshake plane."""
        return len(self._inbox) + len(self.pending)

    def forget(self, sid: int) -> None:
        self.pending.pop(sid, None)
        addr = self.sid_addr.pop(sid, None)
        if addr is not None:
            self.addr_of.pop(addr, None)
            if self._inbox:
                # purge queued datagrams from the forgotten 5-tuple:
                # with recycled addresses (forget -> rejoin same
                # ip:port) a stale ClientHello must never feed the row
                # that later claims the address
                self._inbox = deque(
                    (d, a) for d, a in self._inbox if a != addr)
        self.loop.discard_stream(sid)
