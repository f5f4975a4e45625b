"""The port's ZRTP control (`libjitsi_tpu_torch/control/zrtp.py`) against
the JAX package's, on the CPU.

The codec parts byte for byte (CRC-32C, the KDF, SAS base-32, the packet
wrap and parse); then whole exchanges with `os.urandom` and the P-256 key
generation of both modules drawn from one seeded generator, so the JAX
pair and the port's pair must put the same datagrams on the wire, show
the same SAS and export the same keys: the default suite, S384, AES3,
HS32, DH3k, Multistream, commit contention and retained-secret
continuity.  Then an exchange across the packages, `ZidCache` snapshots
restored across them, the sequence number's wrap mod 2**16 (the twin of
`test_jitlint.py::test_fixed_zrtp_seq_wraps_mod16`), EC25's refusal
without the `cryptography` package, and a `MediaStream` keyed by the
port's ZRTP control at AES-256.  Tolerance: exact equality.
"""

import types

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric import ec

from libjitsi_tpu.control import zrtp as jz
from libjitsi_tpu_torch.control import zrtp as pz
from test_torch_threads import one_torch_thread  # noqa: F401

# the order of the P-256 group
P256_N = int("FFFFFFFF00000000FFFFFFFFFFFFFFFF"
             "BCE6FAADA7179E84F3B9CAC2FC632551", 16)


def _seed(monkeypatch, seed: int) -> None:
    """Both modules' `os.urandom` and the P-256 key generation draw from
    one generator seeded with `seed` (call again to start over)."""
    rng = np.random.default_rng(seed)
    fake_os = types.SimpleNamespace(urandom=lambda n: rng.bytes(n))
    for mod in (jz, pz):
        monkeypatch.setattr(mod, "os", fake_os)

    def gen(curve):
        k = int.from_bytes(rng.bytes(32), "big") % (P256_N - 1) + 1
        return ec.derive_private_key(k, curve)

    monkeypatch.setattr(ec, "generate_private_key", gen)


def _run(a, b, log):
    """a initiates after the Hello exchange; every datagram is logged."""
    wire = [(0, p) for p in a.hello_packets()] + \
           [(1, p) for p in b.hello_packets()]
    started = False
    for _ in range(30):
        if a.complete and b.complete:
            break
        nxt = []
        for who, pkt in wire:
            log.append(pkt)
            ep = b if who == 0 else a
            nxt += [(1 - who, p) for p in ep.feed(pkt)]
        wire = nxt
        if not started and b"Hello   " in a._peer:
            wire += [(0, p) for p in a.initiate()]
            started = True
    assert a.complete and b.complete, "zrtp did not complete"


def _outcome(*eps):
    """What each endpoint agreed (the profile by name: each package has
    its own `SrtpProfile`)."""
    out = []
    for ep in eps:
        prof, *keys = ep.srtp_keys()
        out.append((ep.sas, (prof.name, *keys), ep.role,
                    ep.secret_continuity, ep.session_key, dict(ep.suite)))
    return out


def _contention(mod, log):
    a, b = mod.ZrtpEndpoint(ssrc=1), mod.ZrtpEndpoint(ssrc=2)
    for p in a.hello_packets():
        log.append(p)
        b.feed(p)
    for p in b.hello_packets():
        log.append(p)
        a.feed(p)
    ca, cb = a.initiate()[0], b.initiate()[0]
    log += [ca, cb]
    wire = [(b, p) for p in a.feed(cb)] + [(a, p) for p in b.feed(ca)]
    for _ in range(20):
        if a.complete and b.complete:
            break
        nxt = []
        for dst, pkt in wire:
            log.append(pkt)
            nxt += [(a if dst is b else b, out) for out in dst.feed(pkt)]
        wire = nxt
    assert a.complete and b.complete
    return _outcome(a, b)


def _exchange(mod, case: str, log: list):
    """One scenario on `mod`'s endpoints; returns what both sides agreed."""
    E = mod.ZrtpEndpoint
    if case == "contention":
        return _contention(mod, log)
    if case == "multistream":
        a1, b1 = E(ssrc=1), E(ssrc=2)
        _run(a1, b1, log)
        a2, b2 = E(ssrc=3, multistream_from=a1), E(ssrc=4,
                                                     multistream_from=b1)
        _run(a2, b2, log)
        assert b"DHPart1 " not in a2._peer and a2.suite["ka"] == mod.KA_MULT
        return _outcome(a1, b1, a2, b2)
    if case == "continuity":
        ca, cb = mod.ZidCache(), mod.ZidCache()
        out = []
        for _ in range(2):
            a = E(zid=b"A" * 12, ssrc=1, cache=ca)
            b = E(zid=b"B" * 12, ssrc=2, cache=cb)
            _run(a, b, log)
            out += _outcome(a, b)
        assert out[2][3] and out[3][3]           # the second session
        return out, ca.snapshot(), cb.snapshot()
    algs = {"default": None,
            "S384": {"hash": (mod.HASH_S384,)},
            "AES3": {"cipher": (mod.CIPHER_AES3,)},
            "HS32": {"auth": (mod.AUTH_HS32,)},
            "DH3k": {"ka": (mod.KA_DH3K,)}}[case]
    a, b = E(ssrc=0x11, algorithms=algs), E(ssrc=0x22)
    _run(a, b, log)
    return _outcome(a, b)


CASES = ("default", "S384", "AES3", "HS32", "DH3k", "multistream",
         "contention", "continuity")


@pytest.mark.parametrize("case", CASES)
def test_seeded_exchange_equals_jax_byte_for_byte(monkeypatch, case):
    got = {}
    for name, mod in (("jax", jz), ("port", pz)):
        _seed(monkeypatch, 2200 + CASES.index(case))
        log = []
        got[name] = (_exchange(mod, case, log), log)
    assert got["port"][1] == got["jax"][1]          # every datagram
    assert got["port"][0] == got["jax"][0]          # SAS, keys, suites
    first = got["port"][0][0] if case == "continuity" else got["port"][0]
    (sas_a, keys_a, *_), (sas_b, keys_b, *_) = first[0], first[1]
    assert sas_a == sas_b and keys_a[1:3] == keys_b[3:5]
    want = {"AES3": "AES_256_CM_HMAC_SHA1_80",
            "HS32": "AES_CM_128_HMAC_SHA1_32"}.get(case,
                                                    "AES_CM_128_HMAC_SHA1_80")
    assert keys_a[0] == want


@pytest.mark.parametrize("port_initiates", [False, True])
def test_exchange_across_packages(port_initiates):
    a_mod, b_mod = (pz, jz) if port_initiates else (jz, pz)
    a = a_mod.ZrtpEndpoint(ssrc=1, algorithms={"cipher": (b"AES3",)})
    b = b_mod.ZrtpEndpoint(ssrc=2)
    _run(a, b, [])
    pa, atk, ats, ark, ars = a.srtp_keys()
    pb, btk, bts, brk, brs = b.srtp_keys()
    assert a.sas == b.sas and pa.name == pb.name == "AES_256_CM_HMAC_SHA1_80"
    assert (atk, ats) == (brk, brs) and (ark, ars) == (btk, bts)
    assert len(atk) == 32


def test_codec_parts_equal_jax():
    assert pz.crc32c(b"123456789") == jz.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(5)
    for n in (0, 1, 12, 63, 200):
        blob = rng.bytes(n)
        assert pz.crc32c(blob) == jz.crc32c(blob)
        h = rng.bytes(32)
        assert pz.sas_b32(h) == jz.sas_b32(h)
        for bits in (112, 128, 256):
            args = (rng.bytes(32), b"Initiator SRTP master key",
                    rng.bytes(n), bits)
            assert pz._kdf(*args) == jz._kdf(*args)
        msg = pz._msg(b"Hello   ", blob + b"\x00" * (-n % 4))
        assert msg == jz._msg(b"Hello   ", blob + b"\x00" * (-n % 4))
        for seq in (0, 1, 0xFFFF, 0x1_0001):
            wire = pz._wrap(msg, seq, 0xDEADBEEF)
            assert wire == jz._wrap(msg, seq, 0xDEADBEEF)
            assert pz.is_zrtp(wire) and jz.is_zrtp(wire)
            assert pz._unwrap(wire) == jz._unwrap(wire) == msg
            bad = wire[:-1] + bytes([wire[-1] ^ 1])
            assert pz._unwrap(bad) is None and jz._unwrap(bad) is None
        assert pz._parse_msg(msg) == jz._parse_msg(msg)
    assert pz.DEFAULT_PREFS == jz.DEFAULT_PREFS
    assert {k: v.name for k, v in pz.PROFILE_BY_SUITE.items()} == \
        {k: v.name for k, v in jz.PROFILE_BY_SUITE.items()}
    assert pz.DH3K_P == jz.DH3K_P


def test_zid_cache_snapshots_restore_across_packages():
    rng = np.random.default_rng(8)
    for src, dst in ((jz, pz), (pz, jz)):
        c = src.ZidCache(max_entries=3)
        for i in range(5):
            c.update(bytes([i]) * 12, rng.bytes(32))
        c.update(bytes([3]) * 12, rng.bytes(32))     # a second generation
        c.lookup(bytes([2]) * 12)                    # recency moves
        back = dst.ZidCache.restore(c.snapshot())
        assert back.snapshot() == c.snapshot()
        assert back.evictions == c.evictions == 2 and len(back) == 3
        assert back.lookup(bytes([3]) * 12) == c.lookup(bytes([3]) * 12)
        legacy = {bytes([9]) * 12: (b"r" * 32, None)}
        assert dst.ZidCache.restore(legacy).snapshot() == \
            src.ZidCache.restore(legacy).snapshot()


def test_seq_wraps_mod16_like_jax(monkeypatch):
    """Twin of `test_jitlint.py::test_fixed_zrtp_seq_wraps_mod16` on both
    packages: a send at seq 0xFFFF puts 0 on the wire, and the next 1."""
    got = {}
    for name, mod in (("jax", jz), ("port", pz)):
        _seed(monkeypatch, 77)
        ep = mod.ZrtpEndpoint(ssrc=7)
        ep._seq = 0xFFFE
        pkts = [ep._send(b"\x00" * 12) for _ in range(3)]
        assert ep._seq == 1
        assert [p[2:4] for p in pkts] == [b"\xff\xff", b"\x00\x00",
                                          b"\x00\x01"]
        got[name] = pkts
    assert got["port"] == got["jax"]


def test_ec25_without_cryptography_refuses_and_dh3k_works(monkeypatch):
    monkeypatch.setattr(pz, "HAVE_CRYPTOGRAPHY", False)
    a, b = pz.ZrtpEndpoint(ssrc=1), pz.ZrtpEndpoint(ssrc=2)
    with pytest.raises(RuntimeError, match="EC25 requires"):
        _run(a, b, [])
    dh = {"ka": (pz.KA_DH3K,)}
    a, b = pz.ZrtpEndpoint(ssrc=1, algorithms=dh), pz.ZrtpEndpoint(ssrc=2)
    _run(a, b, [])
    assert a.suite["ka"] == pz.KA_DH3K and a.sas == b.sas


def test_stream_keyed_by_zrtp_control_at_aes256():
    """Twin of JAX `tests/test_media_stream.py::
    test_stream_keyed_by_zrtp_control`, with AES3 negotiated: the
    streams' table runs the AES-256 instances (the plain versions here)."""
    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.media_service import MediaService
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    a_ctl = pz.ZrtpEndpoint(ssrc=1, algorithms={"cipher": (b"AES3",)})
    b_ctl = pz.ZrtpEndpoint(ssrc=2)
    _run(a_ctl, b_ctl, [])
    svc = MediaService(ConfigurationService(), device="cpu")
    prof = SrtpProfile.AES_256_CM_HMAC_SHA1_80
    a = svc.create_media_stream(local_ssrc=0x5A, profile=prof)
    b = svc.create_media_stream(local_ssrc=0x5B, profile=prof)
    a.set_remote_ssrc(b.local_ssrc)
    b.set_remote_ssrc(a.local_ssrc)
    a.start(srtp_control=a_ctl)
    b.start(srtp_control=b_ctl)
    kbuild.reset_counts()
    wire = a.send([b"zrtp-keyed-stream"])
    got, ok = b.receive(wire)
    assert ok.all()
    hdr = rtp_header.parse(got)
    assert got.to_bytes(0)[int(hdr.payload_off[0]):] == b"zrtp-keyed-stream"
    assert kbuild.plain_calls["srtp_protect_cm"] == 1
    assert kbuild.plain_calls["srtp_unprotect_cm"] == 1
    # a stream built for another profile refuses the control loudly
    x = svc.create_media_stream(local_ssrc=0x5C)
    with pytest.raises(ValueError):
        x.start(srtp_control=a_ctl)
