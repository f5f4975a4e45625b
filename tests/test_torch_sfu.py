"""The port's SFU pieces against their JAX twins, on the CPU.

The SFU's media step on both packages: the rx table's
`unprotect_rtp(return_index=True)` (the authenticated 48-bit indices:
a ROC wrap, a ROC near 2^31, a fresh stream), then
`RtpTranslator.translate` (kernel H's plain version) against the JAX
translator on the same receivers and routes, with ragged receiver
counts, packets whose payload starts at different offsets, an unrouted
sender and a removed receiver, and the same refusals.  Output rows must
match within their lengths, with the same receiver ids in the same
order.  The JAX side runs eagerly (`jax.disable_jit`): jit-compiling its
table and fan-out programs costs ~20 s each here.  Under
NULL_HMAC_SHA1_80 the port's copies equal the JAX translator's; under
F8_128_HMAC_SHA1_80 they equal the port's F8 table's `protect_rtp` of
the leg at the same index (byte-equal to JAX's F8 table,
`tests/test_torch_srtp_f8.py`) and decrypt to the sender's bytes, while
the JAX translator's F8 copies do not (it encrypts them with AES-CM, a
fault of the reference).  Under AEAD_AES_128_GCM the port's copies equal
the JAX translator's on its full-mesh and its general path, and open
under their legs' GCM tables.  Then
the host copies — `PacketCache`, `RtcpTermination`, the `rtcp` codec,
`LossTracker` and `RecoveryController` — against their JAX twins on one
call sequence.  Inputs are seeded; tolerance: exact equality.
"""

import dataclasses

import jax
import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu.sfu import PacketCache as JaxCache
from libjitsi_tpu.sfu import RtpTranslator as JaxTranslator
from libjitsi_tpu.sfu.rtcp_termination import RtcpTermination as JaxTerm
from libjitsi_tpu.sfu.recovery import RecoveryController as JaxRecovery
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.sfu import PacketCache, RtcpTermination, RtpTranslator
from libjitsi_tpu_torch.sfu.recovery import RecoveryController
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

RECV = {r: (bytes([r] * 16), bytes([r + 100] * 14)) for r in range(1, 6)}
STATE = ("rx_max", "rx_mask", "auth_fail")


def _translators(profile="AES_CM_128_HMAC_SHA1_80"):
    jt = JaxTranslator(capacity=8, profile=JaxProfile[profile])
    tt = RtpTranslator(capacity=8, profile=SrtpProfile[profile],
                       device="cpu")
    for t in (jt, tt):
        for r, (mk, ms) in RECV.items():
            t.add_receiver(r, mk, ms)
        t.connect(0, [3, 1, 2])       # sorted on connect
        t.connect(6, [1])
        t.connect(7, [5, 2, 3, 4])
    return jt, tt


def _batch(rng, streams, seqs=None, capacity=192):
    n = len(streams)
    seqs = 1000 + np.arange(n) if seqs is None else seqs
    payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                for k in rng.integers(20, 150, n)]
    csrcs = [[1, 2] if i % 3 == 1 else [] for i in range(n)]
    ext = [(0xBEDE, b"\x32\x01\x02\x03") if i % 2 else None
           for i in range(n)]
    return j_header.build(payloads, seqs, 0,
                          0xA000 + np.asarray(streams), 96, csrcs=csrcs,
                          ext=ext, stream=list(streams), capacity=capacity)


def _equal(out_j, recv_j, out_t, recv_t):
    assert np.array_equal(recv_t, np.asarray(recv_j))
    assert np.array_equal(out_t.length, np.asarray(out_j.length))
    for i in range(out_t.batch_size):
        assert out_t.to_bytes(i) == out_j.to_bytes(i), i


def test_decrypt_once_and_fan_out_match_jax():
    """The SFU's media step on both packages: the rx table's
    `unprotect_rtp(return_index=True)`, then the translator's fan-out of
    the decrypted packets at those indices."""
    rng = np.random.default_rng(11)
    jt, tt = _translators()
    streams = [0, 6, 9, 7, 0]         # sender 9 has no route
    seqs = [65535, 9, 3, 1, 0]
    # each sender's state: ROC 0 at a wrap, ROC near 2^31 (an index near
    # 2^47), ROC 3, and a fresh stream
    state = {0: 65534, 6: ((1 << 31) - 2 << 16) | 8, 7: 3 << 16, 9: -1}
    mks = rng.integers(0, 256, (10, 16), np.uint8)
    mss = rng.integers(0, 256, (10, 14), np.uint8)
    j_rx = JaxTable(10)
    t_tx, t_rx = (SrtpStreamTable(10, device="cpu") for _ in range(2))
    for t in (j_rx, t_tx, t_rx):
        t.add_streams(np.arange(10), mks, mss)
    for sid, v in state.items():
        t_tx.tx_ext[sid] = j_rx.rx_max[sid] = t_rx.rx_max[sid] = v
    b = _batch(rng, streams, seqs)
    wire = t_tx.protect_rtp(PacketBatch(b.data, b.length, b.stream))
    with jax.disable_jit():
        dec_j, ok_j, idx_j = j_rx.unprotect_rtp(JaxBatch(
            wire.data.copy(), wire.length.copy(), wire.stream.copy()),
            return_index=True)
    dec_t, ok_t, idx_t = t_rx.unprotect_rtp(wire.copy(), return_index=True)
    assert ok_t.all() and np.array_equal(ok_t, ok_j)
    assert np.array_equal(idx_t, idx_j)
    assert idx_t.tolist() == [65535, ((1 << 31) - 2 << 16) | 9, 3,
                              (3 << 16) | 1, 1 << 16]
    assert np.array_equal(dec_t.data, np.asarray(dec_j.data))
    for k in range(3):
        assert np.array_equal(getattr(t_rx, STATE[k]),
                              getattr(j_rx, STATE[k]))
    with jax.disable_jit():
        out_j, recv_j = jt.translate(dec_j, idx_j)
    kbuild.reset_counts()
    out_t, recv_t = tt.translate(dec_t, idx_t)
    assert kbuild.plain_calls["srtp_fanout_cm"] == 1
    assert recv_t.tolist() == [1, 2, 3, 1, 2, 3, 4, 5, 1, 2, 3]
    _equal(out_j, recv_j, out_t, recv_t)
    # a receiver leaves: its rows go, the order of the rest holds
    jt.remove_receiver(3)
    tt.remove_receiver(3)
    with jax.disable_jit():
        out_j, recv_j = jt.translate(dec_j, idx_j)
    out_t, recv_t = tt.translate(dec_t, idx_t)
    assert recv_t.tolist() == [1, 2, 1, 2, 4, 5, 1, 2]
    _equal(out_j, recv_j, out_t, recv_t)


def test_translator_refusals_and_empty_routes():
    rng = np.random.default_rng(12)
    jt, tt = _translators()
    for t in (jt, tt):
        t.connect(6, [1, 7])          # 7 has no keys
    b = _batch(rng, [6])
    for t, cls in ((jt, JaxBatch), (tt, PacketBatch)):
        with pytest.raises(KeyError):
            t.translate(cls(b.data, b.length, b.stream), np.zeros(1))
    full = _batch(rng, [0])
    full.length[0] = 190              # no room for the tag
    for t, cls in ((jt, JaxBatch), (tt, PacketBatch)):
        with pytest.raises(ValueError):
            t.translate(cls(full.data, full.length, full.stream),
                        np.zeros(1))
    out, recv = tt.translate(_port(_batch(rng, [9, 9])), np.zeros(2))
    assert out.batch_size == 0 and len(recv) == 0
    # NULL, F8 and AEAD-GCM are taken
    for prof in ("NULL_HMAC_SHA1_80", "F8_128_HMAC_SHA1_80",
                 "AEAD_AES_128_GCM"):
        t = RtpTranslator(capacity=2, profile=SrtpProfile[prof],
                          device="cpu")
        assert t.cipher == {"N": "null", "F": "f8", "A": "gcm"}[prof[0]]


# the profiles' fan-out: senders 0, 6 and 7 to ragged routes, at indices
# whose low 16 bits are the packets' seqs (a ROC of 0 at a wrap, one near
# 2^31, 3, 0 and 1)
PROFILE_SEQS = [65535, 9, 3, 1, 0]
PROFILE_INDEX = np.array([65535, ((1 << 31) - 2 << 16) | 9, (3 << 16) | 3,
                          1, 1 << 16], np.int64)
PROFILE_STREAMS = [0, 6, 7, 0, 7]


def _profile_fanout(profile):
    rng = np.random.default_rng(13)
    jt, tt = _translators(profile)
    b = _batch(rng, PROFILE_STREAMS, PROFILE_SEQS)
    with jax.disable_jit():
        out_j, recv_j = jt.translate(
            JaxBatch(b.data.copy(), b.length.copy(), b.stream.copy()),
            PROFILE_INDEX)
    kbuild.reset_counts()
    out_t, recv_t = tt.translate(_port(b.copy()), PROFILE_INDEX)
    assert kbuild.plain_calls[f"srtp_fanout_{tt.cipher}"] == 1
    assert sum(kbuild.launches.values()) == 0
    assert recv_t.tolist() == [1, 2, 3, 1, 2, 3, 4, 5, 1, 2, 3, 2, 3, 4, 5]
    src = np.repeat(np.arange(5), [3, 1, 4, 3, 4])
    return b, src, (out_j, recv_j), (out_t, recv_t)


def _leg_tables(profile, n):
    """A tx and an rx table of `profile` with every receiver's key, one
    row per receiver id."""
    tabs = [SrtpStreamTable(8, SrtpProfile[profile], device="cpu")
            for _ in range(2)]
    for t in tabs:
        for r, (mk, ms) in RECV.items():
            t.add_stream(r, mk, ms)
    return tabs


def _open(rx, wire_row, leg, index):
    """Authenticate and decrypt one copy under its leg's table, whose
    replay state is set just below the copy's index."""
    rx.rx_max[leg] = index - 1
    rx.rx_mask[leg] = 0
    dec, ok = rx.unprotect_rtp(PacketBatch.from_payloads(
        [wire_row], capacity=192, stream=[leg]))
    return bool(ok[0]), dec.to_bytes(0)


def test_null_fanout_matches_jax_translator():
    """NULL_HMAC_SHA1_80: H's NULL instance (plain version) against the
    JAX translator, byte for byte; each copy authenticates under its
    leg's NULL table and carries the sender's bytes in clear."""
    b, src, (out_j, recv_j), (out_t, recv_t) = _profile_fanout(
        "NULL_HMAC_SHA1_80")
    _equal(out_j, recv_j, out_t, recv_t)
    _, rx = _leg_tables("NULL_HMAC_SHA1_80", 8)
    for i in range(out_t.batch_size):
        ok, plain = _open(rx, out_t.to_bytes(i), int(recv_t[i]),
                          int(PROFILE_INDEX[src[i]]))
        assert ok and plain == b.to_bytes(int(src[i]))


def test_f8_fanout_matches_the_f8_table_not_jax():
    """F8_128_HMAC_SHA1_80: each copy of H's F8 instance (plain version)
    equals the port's F8 table protecting the packet for its leg at the
    same index, and decrypts under the leg's table to the sender's bytes.
    The JAX translator's copies authenticate (the tag covers what it
    sent) but do not decrypt to the sender's bytes: it encrypts them with
    AES-CM, a fault of the reference (ROADMAP Queue 3)."""
    b, src, (out_j, recv_j), (out_t, recv_t) = _profile_fanout(
        "F8_128_HMAC_SHA1_80")
    assert np.array_equal(recv_t, np.asarray(recv_j))
    tx, rx = _leg_tables("F8_128_HMAC_SHA1_80", 8)
    jax_plain = 0
    for i in range(out_t.batch_size):
        leg, k = int(recv_t[i]), int(src[i])
        idx = int(PROFILE_INDEX[k])
        tx.tx_ext[leg] = idx - 1
        want = tx.protect_rtp(PacketBatch(
            b.data[k:k + 1].copy(), b.length[k:k + 1].copy(),
            np.array([leg], np.int32)))
        assert out_t.to_bytes(i) == want.to_bytes(0), i
        ok, plain = _open(rx, out_t.to_bytes(i), leg, idx)
        assert ok and plain == b.to_bytes(k), i
        ok_j, plain_j = _open(rx, out_j.to_bytes(i), leg, idx)
        assert ok_j, i
        jax_plain += plain_j == b.to_bytes(k)
    assert jax_plain == 0, "the JAX translator's F8 copies read back"


def _port(b):
    return PacketBatch(b.data, b.length, b.stream)


# AEAD-GCM legs: 12-byte master salts (RFC 7714)
RECV_GCM = {r: (bytes([r] * 16), bytes([r + 100] * 12)) for r in range(1, 6)}


@pytest.mark.parametrize("uniform", [True, False])
def test_gcm_fanout_matches_jax_translator(uniform):
    """AEAD_AES_128_GCM: H's GCM instance (plain version) against the JAX
    translator, whose legs and ours come from the same master keys
    through `add_receiver`.  `uniform`: every sender routed to the same
    legs and every header 12 bytes, the JAX full-mesh path
    (`gcm_protect_fanout`, leg-major, flipped); otherwise ragged routes
    and headers with CSRCs and extensions, its general path.  The port's
    one path equals both, and each copy opens under its leg's GCM table
    as the sender's bytes."""
    rng = np.random.default_rng(17 if uniform else 18)
    routes = ({0: [3, 1, 2], 6: [1, 2, 3], 7: [2, 3, 1]} if uniform else
              {0: [3, 1, 2], 6: [1], 7: [5, 2, 3, 4]})
    prof = "AEAD_AES_128_GCM"
    jt = JaxTranslator(capacity=8, profile=JaxProfile[prof])
    tt = RtpTranslator(capacity=8, profile=SrtpProfile[prof], device="cpu")
    for t in (jt, tt):
        for r, (mk, ms) in RECV_GCM.items():
            t.add_receiver(r, mk, ms)
        for snd, rr in routes.items():
            t.connect(snd, rr)
    streams = [0, 6, 7, 0, 7]
    if uniform:
        pls = [rng.integers(0, 256, int(k), np.uint8).tobytes()
               for k in rng.integers(20, 150, 5)]
        b = j_header.build(pls, PROFILE_SEQS, 0, 0xA000 + np.asarray(
            streams), 96, stream=streams, capacity=192)
    else:
        b = _batch(rng, streams, PROFILE_SEQS)
    with jax.disable_jit():
        out_j, recv_j = jt.translate(
            JaxBatch(b.data.copy(), b.length.copy(), b.stream.copy()),
            PROFILE_INDEX)
    kbuild.reset_counts()
    out_t, recv_t = tt.translate(_port(b.copy()), PROFILE_INDEX)
    assert kbuild.plain_calls["srtp_fanout_gcm"] == 1
    _equal(out_j, recv_j, out_t, recv_t)
    rx = SrtpStreamTable(8, SrtpProfile[prof], device="cpu")
    for r, (mk, ms) in RECV_GCM.items():
        rx.add_stream(r, mk, ms)
    counts = [len(routes[snd]) for snd in streams]
    src = np.repeat(np.arange(5), counts)
    for i in range(out_t.batch_size):
        k = int(src[i])
        ok, plain = _open(rx, out_t.to_bytes(i), int(recv_t[i]),
                          int(PROFILE_INDEX[k]))
        assert ok and plain == b.to_bytes(k), i


def test_packet_cache_matches_jax():
    caches = (JaxCache(max_bytes=700, max_age=0.5),
              PacketCache(max_bytes=700, max_age=0.5))
    rng = np.random.default_rng(3)
    outs = [[], []]
    for step in range(12):
        keys = (rng.integers(0, 3, 8) << 32) | 0xAB
        seqs = (65530 + rng.integers(0, 12, 8)) & 0xFFFF
        pkts = [bytes(rng.integers(0, 256, int(k), np.uint8))
                for k in rng.integers(10, 90, 8)]
        for c, o in zip(caches, outs):
            c.insert_batch(keys, seqs, pkts, now=0.1 * step)
            o.append((len(c), c.size_bytes, c.lookup_nack(
                int(keys[0]), [65535, 0, 65534, 3, 1],
                return_missing=True)))
    assert outs[0] == outs[1]


def _feed(t, mod):
    media = 0xAAA
    for rid, (fl, cum, jit) in enumerate([(10, 5, 100), (80, 50, 900),
                                          (0, 0, 10)]):
        t.on_receiver_rtcp(rid, [mod.ReceiverReport(0x100 + rid, [
            mod.ReportBlock(media, fl, cum, 5000, jit, 0, 0)])])
    t.on_receiver_rtcp(0, [mod.Remb(0x100, 2_000_000, [media])])
    t.on_receiver_rtcp(1, [mod.Remb(0x101, 500_000, [media])])
    t.on_receiver_rtcp(0, [mod.Nack(0x100, media, [10, 11])])
    t.on_receiver_rtcp(2, [mod.Pli(0x102, media)])
    t.queue_nack(media, [12, 65535])
    out = [t.make_sender_feedback(media, now=100.0, own_bps=900_000.0)]
    t.on_receiver_rtcp(0, [mod.Fir(0x100, media, [(media, 3)])])
    out.append(t.make_sender_feedback(media, now=100.2))
    out.append(t.make_sender_feedback(media, now=101.5))
    t.forget_receiver(1)
    return out, t.min_remb(media)


def test_rtcp_termination_matches_jax():
    assert _feed(RtcpTermination(0xBEEF, 1.0), rtcp) == \
        _feed(JaxTerm(0xBEEF, 1.0), j_rtcp)


def _packets(mod):
    rb = mod.ReportBlock(0x11, 12, 345, 70000, 9, 0x1234, 0x55)
    tcc = mod.TccFeedback(
        0x21, 0x22, 65530, 1234, 7,
        np.array([1, 1, 0, 1, 0, 0, 1], bool),
        np.array([4, 300, 0, 2, 0, 0, 70000 // 250], np.int64))
    return [mod.build_sr(mod.SenderReport(0x10, 1 << 31, 9000, 17, 40, 4096,
                                          [rb])),
            mod.build_rr(mod.ReceiverReport(0x12, [rb, rb])),
            mod.build_sdes([mod.SdesChunk(0x13, [(1, b"alice@x")])]),
            mod.build_bye(mod.Bye([0x14, 0x15], b"bye")),
            mod.build_nack(mod.Nack(0x16, 0x17, [1, 2, 3, 40, 65535])),
            mod.build_pli(mod.Pli(0x18, 0x19)),
            mod.build_fir(mod.Fir(0x1A, 0, [(0x1B, 4)])),
            mod.build_remb(mod.Remb(0x1C, 123_456_789, [0x1D, 0x1E])),
            mod.build_tcc(tcc)]


def test_rtcp_codec_matches_jax():
    ours, theirs = _packets(rtcp), _packets(j_rtcp)
    assert ours == theirs
    blob = rtcp.build_compound(ours)
    assert blob == j_rtcp.build_compound(theirs)
    assert _plain(rtcp.parse_compound(blob)) == \
        _plain(j_rtcp.parse_compound(blob))


def _plain(x):
    """Parsed RTCP as nested builtins (the two packages' dataclasses are
    different classes)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {k: _plain(v) for k, v in
                                   vars(x).items()})
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _recover(ctl):
    out = []
    seqs = [10, 11, 14, 15, 12, 200, 201, 65535, 0, 3]
    for k, s in enumerate(seqs):
        ctl.observe_rx([0xAA, 0xBB], [s, (s + 7) & 0xFFFF], 1.0 + 0.01 * k)
        out.append(ctl.collect_upstream_nacks(1.0 + 0.01 * k))
    for fl in (0, 64, 64, 3):
        ctl.on_receiver_report(fl)
        out.append((ctl.fec.k, round(ctl.loss_ewma, 12), ctl.fec_active()))
    for j in range(9):
        pkt = bytes([0x80, 96]) + (500 + j).to_bytes(2, "big") + bytes(
            range(j, j + 30))
        out.append(ctl.fec_protect(3, 0xAA, pkt))
    out.append([ctl.allow_rtx(n, 2.0 + 0.001 * i)
                for i, n in enumerate([30_000, 3000, 3000, 500])])
    ctl.throttle_rtx(True)
    out.append(ctl.allow_rtx(9000, 2.5))
    ctl.forget_legs([3])
    ctl.forget_ssrcs([0xAA])
    out.append((ctl.rtx_budget_dropped, ctl.nacks.pending_count()))
    return out


def test_recovery_controller_matches_jax():
    assert _recover(RecoveryController()) == _recover(JaxRecovery())
