"""The port's SfuBridge on the CPU over loopback UDP, and against the JAX
SfuBridge.

`test_sfu_fanout_and_nack_over_udp` carries the assertions of
`tests/test_sfu_bridge.py::test_sfu_fanout_and_nack_over_udp`: every
endpoint hears the others and not itself, a NACKed seq comes back under
the leg's key, a spoofed NACK serves nothing, and the SRTCP feedback
authenticates at the sender.  A conference-scoped bridge forwards no
copy across conferences.  The host I/O plane: two SO_REUSEPORT ingest
rings with kernel stamps deliver every copy and feed the BWE stamps from
the receive's window; `_feed_bwe` leaves the JAX bridge's BWE state,
from kernel stamps or the tick's clock; a two-ring snapshot restores
across packages both ways; io_uring is refused.  Two `slow` cases hold the port's bridge
against the JAX one byte for byte: restored from a JAX
`SfuBridge.snapshot()`, its next forwarded wire against what the JAX
bridge's own translator makes of the same packets (run eagerly, ~13 s
here); and both bridges restored from one JAX snapshot, every datagram
they send over six ticks (media, an RR reporting 25% loss so FEC runs,
a NACK, SRTCP feedback), for which the JAX bridge compiles its SRTP
tables (minutes here).  Tier-1 holds the SFU's media step against JAX
in `tests/test_torch_sfu.py`.  Endpoints here are the port's CPU SRTP
tables.  Tolerance: exact bytes.
"""

import socket

import numpy as np
import pytest
import torch

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.udp import UdpEngine, uring_available
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
from libjitsi_tpu_torch.transform.header_ext import AbsSendTimeEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401


def _keys(ssrc):
    return ((bytes([ssrc & 0xFF]) * 16, bytes([(ssrc + 1) & 0xFF]) * 14),
            (bytes([(ssrc + 2) & 0xFF]) * 16,
             bytes([(ssrc + 3) & 0xFF]) * 14))


class _Endpoint:
    """A participant: protects its media/RTCP with its rx key, opens what
    the bridge forwards with its tx key (one row per sender SSRC), all
    under one SRTP profile."""

    def __init__(self, ssrc, bridge_port, ext_id=3,
                 profile=SrtpProfile.AES_CM_128_HMAC_SHA1_80):
        self.ssrc = ssrc
        # master salts of the profile's length (12 bytes under AEAD-GCM)
        salt = profile.master_salt_len
        self.rx_key, self.tx_key = ((k, s[:salt]) for k, s in _keys(ssrc))
        self.protect = SrtpStreamTable(1, profile, device="cpu")
        self.protect.add_stream(0, *self.rx_key)
        self.open = SrtpStreamTable(16, profile, device="cpu")
        self.open_rtcp = SrtpStreamTable(1, profile, device="cpu")
        self.open_rtcp.add_stream(0, *self.tx_key)
        self.row_of = {}
        self.engine = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=256)
        self.bridge_port = bridge_port
        self.seq = 500
        self.got = {}                     # (ssrc, seq) -> payload
        self.feedback = []
        self.ast = AbsSendTimeEngine(ext_id, clock=lambda: 12.5)

    def media(self, n=4):
        pls = [b"m-%08x-%d" % (self.ssrc, self.seq + i) for i in range(n)]
        b = rtp_header.build(pls, [self.seq + i for i in range(n)],
                             [0] * n, [self.ssrc] * n, [96] * n,
                             stream=[0] * n)
        b, _ = self.ast.rtp_transformer.transform(b)
        self.seq += n
        return self.protect.protect_rtp(b)

    def send_media(self, n=4):
        self.engine.send_batch(self.media(n), "127.0.0.1", self.bridge_port)

    def expect_sender(self, ssrc):
        row = len(self.row_of)
        self.row_of[ssrc] = row
        self.open.add_stream(row, *self.tx_key)

    def drain(self):
        back, _, _ = self.engine.recv_batch(timeout_ms=2)
        if not back.batch_size:
            return
        is_rtcp = (back.data[:, 1] >= 192) & (back.data[:, 1] <= 223)
        if is_rtcp.any():
            rows = np.nonzero(is_rtcp)[0]
            fb = PacketBatch(back.data[rows], back.length[rows],
                             np.zeros(len(rows), np.int32))
            dec, ok = self.open_rtcp.unprotect_rtcp(fb)
            self.feedback += [(bool(ok[i]), dec.to_bytes(i))
                              for i in range(len(rows))]
        rows = np.nonzero(~is_rtcp)[0]
        media = PacketBatch(back.data[rows], back.length[rows],
                            np.zeros(len(rows), np.int32))
        hdr0 = rtp_header.parse(media)
        media.stream[:] = [self.row_of.get(int(s), -1) for s in hdr0.ssrc]
        dec, ok = self.open.unprotect_rtp(media)
        hdr = rtp_header.parse(dec)
        for i in np.nonzero(ok)[0]:
            i = int(i)
            self.got[(int(hdr.ssrc[i]), int(hdr.seq[i]))] = \
                dec.to_bytes(i)[int(hdr.payload_off[i]):]

    def rtcp_wire(self, blobs):
        return self.protect.protect_rtcp(
            PacketBatch.from_payloads(blobs, stream=[0] * len(blobs)))

    def send_nack(self, media_ssrc, seqs):
        self.engine.send_batch(self.rtcp_wire([rtcp.build_compound([
            rtcp.build_nack(rtcp.Nack(self.ssrc, media_ssrc, list(seqs)))])]),
            "127.0.0.1", self.bridge_port)


def _mesh(eps):
    for e in eps:
        for other in eps:
            if other is not e:
                e.expect_sender(other.ssrc)


def _tick(sfu, now, n=12):
    for _ in range(n):
        sfu.tick(now=now)


def test_sfu_fanout_and_nack_over_udp():
    kbuild.reset_counts()
    sfu = SfuBridge(port=0, capacity=8, recv_window_ms=0, device="cpu")
    eps = [_Endpoint(0x100 + 7 * k, sfu.port) for k in range(3)]
    for e in eps:
        sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    for rnd in range(2):
        for e in eps:
            e.send_media()
        _tick(sfu, 50.0 + rnd * 0.02)
        for e in eps:
            for _ in range(3):
                e.drain()
    assert sfu.forwarded == 2 * 3 * 4 * 2
    for e in eps:
        payloads = b"".join(e.got.values())
        for other in eps:
            if other is not e:
                assert b"m-%08x" % other.ssrc in payloads
        assert b"m-%08x" % e.ssrc not in payloads, "echoed own media"
    # the SFU path ran the plain versions of D and H, never a kernel
    assert kbuild.plain_calls["srtp_unprotect_cm"] > 0
    assert kbuild.plain_calls["srtp_fanout_cm"] > 0
    assert sum(kbuild.launches.values()) == 0

    # NACK service: the victim re-opens its contexts (its replay windows
    # saw these seqs) and gets the cached copy under its own leg key
    victim, sender = eps[0], eps[1]
    victim.got.clear()
    for ssrc, row in victim.row_of.items():
        victim.open.add_stream(row, *victim.tx_key)
    victim.send_nack(sender.ssrc, [501])
    _tick(sfu, 50.5)
    for _ in range(3):
        victim.drain()
    assert sfu.retransmitted == 1
    assert list(victim.got) == [(sender.ssrc, 501)]
    assert victim.got[(sender.ssrc, 501)] == b"m-%08x-501" % sender.ssrc

    # a spoofed NACK (the right SSRC, no key) serves nothing
    spoof = SrtpStreamTable(capacity=1, device="cpu")
    spoof.add_stream(0, bytes(16), bytes(14))
    spoof.rtcp_tx_index[0] = 5       # a fresh index: not a replay
    forged = spoof.protect_rtcp(PacketBatch.from_payloads([
        rtcp.build_compound([rtcp.build_nack(rtcp.Nack(
            victim.ssrc, sender.ssrc, [500, 501, 502]))])], stream=[0]))
    victim.engine.send_batch(forged, "127.0.0.1", sfu.port)
    _tick(sfu, 50.6)
    assert sfu.retransmitted == 1
    assert sfu.rx_table.auth_fail[0] == 1

    # feedback toward each sender authenticates under its SRTCP key
    kbuild.reset_counts()
    sent = sfu.emit_feedback(now=50.7)
    assert sent == 3
    assert kbuild.plain_calls["srtcp_protect_cm"] == 1   # every sender's
    for e in eps:
        for _ in range(3):
            e.drain()
        assert e.feedback and all(ok for ok, _ in e.feedback)
        kinds = {type(p) for _, blob in e.feedback
                 for p in rtcp.parse_compound(blob)}
        assert rtcp.Remb in kinds       # the bridge's own estimate
    sfu.close()
    for e in eps:
        e.engine.close()


@pytest.mark.parametrize("profile", ["NULL_HMAC_SHA1_80",
                                     "F8_128_HMAC_SHA1_80"])
def test_sfu_tick_under_null_and_f8(profile):
    """An SfuBridge of three endpoints under NULL or AES-F8, over
    loopback: each endpoint's copies of the others' media authenticate
    under its leg's table of that profile and read back as what the
    senders sent, and none echoes; the fan-out ran H's instance for the
    cipher (plain version) and the uplink D's."""
    prof = SrtpProfile[profile]
    cipher = {"N": "null", "F": "f8"}[profile[0]]
    kbuild.reset_counts()
    sfu = SfuBridge(port=0, capacity=8, profile=prof, recv_window_ms=0,
                    device="cpu")
    eps = [_Endpoint(0x400 + 9 * k, sfu.port, profile=prof)
           for k in range(3)]
    for e in eps:
        sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    for rnd in range(2):
        for e in eps:
            e.send_media()
        _tick(sfu, 60.0 + rnd * 0.02)
        for e in eps:
            for _ in range(3):
                e.drain()
    assert sfu.forwarded == 2 * 3 * 4 * 2
    for e in eps:
        assert len(e.got) == 2 * 4 * 2
        for (ssrc, seq), payload in e.got.items():
            assert ssrc != e.ssrc, "echoed own media"
            assert payload == b"m-%08x-%d" % (ssrc, seq)
    assert kbuild.plain_calls[f"srtp_fanout_{cipher}"] > 0
    assert kbuild.plain_calls[f"srtp_unprotect_{cipher}"] > 0
    assert sum(kbuild.launches.values()) == 0
    sfu.close()
    for e in eps:
        e.engine.close()


def test_sfu_tick_and_feedback_under_gcm():
    """An SfuBridge of three endpoints under AEAD_AES_128_GCM, over
    loopback: each endpoint's copies of the others' media open under its
    leg's GCM table as what the senders sent, none echoes; an RR from
    one endpoint authenticates (the uplink's SRTCP, N's plain version)
    and the bridge's feedback opens at every endpoint (M's); the fan-out
    ran H's GCM instance (plain version)."""
    prof = SrtpProfile.AEAD_AES_128_GCM
    kbuild.reset_counts()
    sfu = SfuBridge(port=0, capacity=8, profile=prof, recv_window_ms=0,
                    device="cpu")
    eps = [_Endpoint(0x500 + 7 * k, sfu.port, profile=prof)
           for k in range(3)]
    for e in eps:
        sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    for rnd in range(2):
        for e in eps:
            e.send_media()
        _tick(sfu, 70.0 + rnd * 0.02)
        for e in eps:
            for _ in range(3):
                e.drain()
    assert sfu.forwarded == 2 * 3 * 4 * 2
    for e in eps:
        assert len(e.got) == 2 * 4 * 2
        for (ssrc, seq), payload in e.got.items():
            assert ssrc != e.ssrc, "echoed own media"
            assert payload == b"m-%08x-%d" % (ssrc, seq)
    rr = rtcp.build_compound([rtcp.build_rr(rtcp.ReceiverReport(
        eps[0].ssrc, [rtcp.ReportBlock(eps[1].ssrc, 0, 0, 503, 4, 0, 0)]))])
    eps[0].engine.send_batch(eps[0].rtcp_wire([rr]), "127.0.0.1", sfu.port)
    _tick(sfu, 70.1)
    assert int(sfu.rx_table.auth_fail.sum()) == 0
    sid = {v: k for k, v in sfu._ssrc_of.items()}[eps[0].ssrc]
    assert sfu.rx_table.rtcp_rx_max[sid] == 0         # its index 0 taken
    assert sfu.emit_feedback(now=70.2) > 0
    for e in eps:
        for _ in range(3):
            e.drain()
        assert e.feedback and all(ok for ok, _ in e.feedback)
    for name in ("srtp_fanout_gcm", "srtp_gcm_open", "srtp_gcm_seal"):
        assert kbuild.plain_calls[name] > 0, name
    assert sum(kbuild.launches.values()) == 0
    sfu.close()
    for e in eps:
        e.engine.close()


def test_sfu_conference_scoping_and_staged_hold():
    sfu = SfuBridge(port=0, capacity=8, recv_window_ms=0, device="cpu")
    eps = [_Endpoint(0x300 + 5 * k, sfu.port) for k in range(4)]
    sids = sfu.stage_endpoints(
        [(e.ssrc, e.rx_key, e.tx_key, None) for e in eps],
        conferences=[1, 1, 2, 2])
    for grp in (eps[:2], eps[2:]):
        _mesh(grp)
    # media racing the admit waits on the hold (and latches addresses)
    for e in eps:
        e.send_media(2)
    _tick(sfu, 10.0)
    assert sfu.forwarded == 0
    sfu.commit_endpoints(sids)
    assert sfu.forwarded == 4 * 2    # the held packets, replayed
    for e in eps:
        e.send_media()
    _tick(sfu, 10.02)
    for e in eps:
        for _ in range(3):
            e.drain()
    assert sfu.forwarded == 8 + 4 * 4
    for k, e in enumerate(eps):
        heard = {s for s, _ in e.got}
        mate = eps[k ^ 1]
        assert heard == {mate.ssrc}, (hex(e.ssrc), heard)
    sfu.remove_endpoint(sids[1])
    eps[0].send_media()
    _tick(sfu, 10.04)
    assert sfu.forwarded == 24       # nobody left in conference 1
    sfu.close()
    for e in eps:
        e.engine.close()


def test_sfu_entry_points_not_ported_name_their_item():
    sfu = SfuBridge(port=0, capacity=16, device="cpu")
    for call, item in ((lambda: sfu.migrate_endpoints({0: 1}), "item 12"),
                       (lambda: sfu.set_broadcast_speakers(1, []),
                        "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # the video tracks are taken: a joined sender's simulcast and SVC
    # tracks, each attached to the other endpoint
    with pytest.raises(ValueError, match="not joined"):
        sfu.add_video_track(0, [1], [1e5])
    a = sfu.add_endpoint(0x11, *_keys(0x11))
    b = sfu.add_endpoint(0x22, *_keys(0x22))
    assert list(sfu.add_video_track(a, [0x110, 0x111], [1e5, 1e6]).fwd) \
        == [b]
    assert list(sfu.add_svc_track(b, 0x220, [1e5, 1e6]).fwd) == [a]
    sfu.close()
    # the pipelined tick and the NULL, F8 and AEAD-GCM profiles are taken
    for kw in (dict(pipelined=True), dict(pipeline_depth=3),
               dict(profile=SrtpProfile.NULL_HMAC_SHA1_80),
               dict(profile=SrtpProfile.F8_128_HMAC_SHA1_80),
               dict(profile=SrtpProfile.AEAD_AES_128_GCM)):
        SfuBridge(capacity=4, device="cpu", **kw).close()
    # kernel stamps, SO_REUSEPORT rings and the io_uring engine are taken
    SfuBridge(capacity=4, kernel_timestamps=True, ingest_rings=2,
              device="cpu").close()
    SfuBridge(capacity=4, engine_mode="io_uring", device="cpu").close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SfuBridge(capacity=4)        # device=None means the card


# ------------------------------------------------- stamps and rings

def test_sfu_io_uring_is_refused_and_rings_are_taken():
    """The io_uring engine is taken now (every ring on the ring where the
    box has one), and SO_REUSEPORT rings beside it."""
    want = "io_uring" if uring_available() else "recvmmsg"
    sfu = SfuBridge(capacity=4, ingest_rings=3, kernel_timestamps=True,
                    engine_mode="io_uring", device="cpu")
    try:
        assert [e.engine_mode for e in sfu.loop.rings] == [want] * 3
        assert sfu.loop.metrics.sample_total("loop_engine_io_uring") == \
            (1.0 if want == "io_uring" else 0.0)
        assert sfu.snapshot()["engine_mode"] == "io_uring"
    finally:
        sfu.close()
    sfu = SfuBridge(capacity=4, ingest_rings=3, kernel_timestamps=True,
                    device="cpu")
    try:
        assert len(sfu.loop.rings) == 3 and sfu.loop.use_kernel_ts
        assert {e.port for e in sfu.loop.rings} == {sfu.port}
        assert sfu.loop.metrics.sample_total("loop_ingest_rings") == 3
        assert sfu.snapshot()["ingest_rings"] == 3
    finally:
        sfu.close()


def test_sfu_over_two_rings_with_kernel_stamps():
    """Endpoints on their own sockets, spread by the kernel over two
    SO_REUSEPORT rings: once every address is latched (a first round),
    every copy reaches exactly its receivers, and the BWE takes each
    packet's kernel stamp."""
    import time

    sfu = SfuBridge(port=0, capacity=16, recv_window_ms=0, ingest_rings=2,
                    kernel_timestamps=True, device="cpu")
    eps = [_Endpoint(0x600 + 3 * k, sfu.port) for k in range(6)]
    for e in eps:
        sfu.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _mesh(eps)
    fed = []
    orig = sfu.bwe.incoming_batch
    sfu.bwe.incoming_batch = lambda t, a, s, z: (fed.append(np.array(a)),
                                                 orig(t, a, s, z))
    t0 = time.time()
    for rnd in range(3):
        if rnd == 1:
            base = sfu.forwarded
        for e in eps:
            e.send_media()
        _tick(sfu, 80.0 + rnd * 0.02)
        for e in eps:
            for _ in range(3):
                e.drain()
    t1 = time.time()
    # a copy goes to each of the 5 others, ring by ring
    assert sfu.forwarded - base == 2 * 6 * 4 * 5
    for e in eps:
        for other in eps:
            seqs = {q for s, q in e.got if s == other.ssrc}
            if other is e:
                assert not seqs, "echoed own media"
            else:
                assert set(range(504, 512)) <= seqs
    arrivals = np.concatenate(fed)
    assert len(arrivals) == 3 * 6 * 4
    assert ((arrivals > (t0 - 1) * 1e3) & (arrivals < (t1 + 1) * 1e3)).all()
    sfu.close()
    for e in eps:
        e.engine.close()


def _ast_batch(header_mod, k, rng):
    """Eight packets of three senders with abs-send-time stamps."""
    sids = [0, 1, 2, 0, 1, 2, 0, 1]
    ast = ((k * 20 + np.arange(8) * 2 + rng.integers(0, 3, 8)) * 262) \
        & 0xFFFFFF
    return header_mod.build(
        [bytes(40 + 7 * i) for i in range(8)], [100 * k + i
                                                for i in range(8)],
        0, [0x11 + s for s in sids], 96, stream=sids,
        ext=[(0xBEDE, bytes([0x32]) + int(a).to_bytes(3, "big"))
             for a in ast])


@pytest.mark.parametrize("stamps", [True, False])
def test_feed_bwe_follows_jax(stamps):
    """`_feed_bwe(sub, rows, hdr)` on both bridges, arrival times from the
    loop's kernel stamps (`rows` picking some of on_media's rows) or the
    tick's clock: the same BWE state."""
    from libjitsi_tpu.rtp import header as j_header

    jb = _jax_bridge(3)
    pb = SfuBridge(port=0, capacity=8, device="cpu")
    rng = np.random.default_rng(2)
    try:
        for k in range(30):
            batch = _ast_batch(j_header, k, rng)
            keep = np.array([0, 1, 2, 4, 5, 6, 7])
            now = 90.0 + 0.02 * k
            ats = (np.int64(90 * 10 ** 9) + k * 20_000_000
                   + np.arange(9, dtype=np.int64) * 1_500_000
                   + rng.integers(0, 400_000, 9))
            for b, mod in ((jb, j_header), (pb, rtp_header)):
                sub = PacketBatch(batch.data[keep].copy(),
                                  np.asarray(batch.length)[keep].copy(),
                                  np.asarray(batch.stream)[keep].copy())
                if mod is j_header:
                    from libjitsi_tpu.core.packet import PacketBatch as JB
                    sub = JB(sub.data, sub.length, sub.stream)
                b._now = now
                b.loop.last_rtp_arrival_ns = ats[:8] if stamps else None
                b._feed_bwe(sub, keep, mod.parse(sub))
            if k % 5 == 4:
                for b in (jb, pb):
                    b.bwe.update_estimate(now * 1000.0)
        snaps = [jb.bwe.snapshot(), pb.bwe.snapshot()]
        assert sorted(snaps[0]) == sorted(snaps[1])
        for key in snaps[0]:
            assert np.array_equal(np.asarray(snaps[0][key]),
                                  np.asarray(snaps[1][key])), key
        assert np.array_equal(jb._bwe_fed, pb._bwe_fed)
        assert pb._bwe_fed[:3].all()
    finally:
        jb.close()
        pb.close()


@pytest.mark.parametrize("source", ["jax", "port"])
def test_ringed_snapshot_restores_across_packages(source):
    """A snapshot of a two-ring bridge, of either package, restores with
    two rings in the other package (and `kwargs` still win)."""
    import libjitsi_tpu
    from libjitsi_tpu.service.sfu_bridge import SfuBridge as JaxBridge

    libjitsi_tpu.init()
    cfg = libjitsi_tpu.configuration_service()
    eps = [_Endpoint(0x800 + 5 * k, 0) for k in range(3)]
    if source == "jax":
        a = JaxBridge(cfg, port=0, capacity=8, ingest_rings=2)
    else:
        a = SfuBridge(port=0, capacity=8, ingest_rings=2, device="cpu")
    for e in eps:
        a.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    snap = a.snapshot()
    a.close()
    assert snap["ingest_rings"] == 2 and snap["engine_mode"] == "auto"
    if source == "jax":
        b = SfuBridge.restore(snap, port=0, device="cpu")
        one = SfuBridge.restore(snap, port=0, device="cpu", ingest_rings=1)
    else:
        b = JaxBridge.restore(cfg, snap, port=0)
        one = JaxBridge.restore(cfg, snap, port=0, ingest_rings=1)
    try:
        assert b.ingest_rings == 2 and len(b.loop.rings) == 2
        assert {e.port for e in b.loop.rings} == {b.port}
        assert len(one.loop.rings) == 1
        assert sorted(b._ssrc_of.values()) == sorted(e.ssrc for e in eps)
        again = b.snapshot()
        assert again["ingest_rings"] == 2
        assert again["ssrc_of"] == snap["ssrc_of"]
    finally:
        b.close()
        one.close()
        for e in eps:
            e.engine.close()


# ------------------------------------------------------------- parity

def _jax_bridge(n, capacity=8):
    import libjitsi_tpu
    from libjitsi_tpu.service.sfu_bridge import SfuBridge as JaxBridge

    libjitsi_tpu.stop()
    libjitsi_tpu.init()
    return JaxBridge(libjitsi_tpu.configuration_service(), port=0,
                     capacity=capacity, recv_window_ms=0)


class _Capture:
    """Records every datagram a bridge's engine sends, in order."""

    def __init__(self, bridge):
        self.sent = []
        eng = bridge.loop.engine
        orig = eng.send_batch

        def send_batch(batch, ip, port):
            n = batch.batch_size
            ports = np.broadcast_to(np.asarray(port), (n,))
            self.sent += [(int(ports[i]), batch.to_bytes(i))
                          for i in range(n)]
            return orig(batch, ip, port)

        eng.send_batch = send_batch


def _join(bridge, eps):
    return bridge.stage_endpoints(
        [(e.ssrc, e.rx_key, e.tx_key, None) for e in eps],
        conferences=[0] * len(eps))


def _warm(bridge, eps, ticks, send=None):
    for t in range(ticks):
        for e in eps:
            (send or _send_to)(e, bridge.port, e.media())
        _tick(bridge, 30.0 + 0.02 * t, 6)


def _send_to(e, port, wire):
    e.engine.send_batch(wire, "127.0.0.1", port)


@pytest.mark.slow          # the eager JAX fan-out: ~13 s here
def test_port_bridge_restored_from_jax_snapshot_forwards_like_jax():
    """A JAX bridge mid-conference (each sender's ROC at 1, its seq two
    short of a wrap, addresses latched) is snapshotted and the port's
    bridge restored from it; the next tick's forwarded wire equals what
    the JAX bridge's own translator makes of the same packets (run
    eagerly: its jit compile would cost minutes here)."""
    import jax

    from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
    from libjitsi_tpu.transform.header_ext import \
        AbsSendTimeEngine as JaxAst

    eps = [_Endpoint(0x700 + 9 * k, 0) for k in range(3)]
    jb = _jax_bridge(3)
    sids = [jb.add_endpoint(e.ssrc, e.rx_key, e.tx_key) for e in eps]
    lo = int.from_bytes(socket.inet_aton("127.0.0.1"), "big")
    for sid, e in zip(sids, eps):
        e.seq = 65534
        e.protect.tx_ext[0] = (1 << 16) | 65533
        jb.rx_table.rx_max[sid] = (1 << 16) | 65533
        jb.loop.addr_ip[sid] = lo
        jb.loop.addr_port[sid] = e.engine.port
    snap = jb.snapshot()
    jb.close()
    port_b = SfuBridge.restore(snap, port=0, device="cpu", recv_window_ms=0)
    cap = _Capture(port_b)
    for e in eps:
        e.engine.send_batch(e.media(), "127.0.0.1", port_b.port)
    _tick(port_b, 31.0, 6)
    assert port_b.forwarded == 3 * 4 * 2
    # the JAX bridge's translator on the decrypted, stamped packets
    seqs = [65534, 65535, 0, 1]
    idx = np.array([(1 << 16) | 65534, (1 << 16) | 65535, 2 << 16,
                    (2 << 16) | 1] * 3, np.int64)
    plain = rtp_header.build(
        [b"m-%08x-%d" % (e.ssrc, 65534 + i) for e in eps for i in range(4)],
        seqs * 3, [0] * 12, [e.ssrc for e in eps for _ in range(4)],
        [96] * 12, stream=[s for s in sids for _ in range(4)])
    stamped, _ = JaxAst(3, clock=lambda: 31.0).rtp_transformer.transform(
        JaxBatch(plain.data, plain.length, plain.stream))
    with jax.disable_jit():
        out, recv = jb.translator.translate(stamped, idx)
    port_of = {sid: e.engine.port for sid, e in zip(sids, eps)}
    want = sorted((port_of[int(r)], out.to_bytes(i))
                  for i, r in enumerate(recv))
    assert sorted(cap.sent) == want
    # each receiver opens its copies across the wrap
    for e in eps:
        for _ in range(3):
            e.drain()
    _mesh(eps)
    port_b.close()
    for e in eps:
        e.engine.close()


@pytest.mark.slow
def test_port_and_jax_bridges_forward_the_same_wire():
    """Both bridges from one JAX snapshot, the same input each tick (media,
    an RR reporting 25% loss so FEC runs, a NACK): every datagram each
    sends, in order, equal byte for byte."""
    eps = [_Endpoint(0x900 + 11 * k, 0) for k in range(3)]
    jb = _jax_bridge(3)
    for e in eps:
        jb.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
    _warm(jb, eps, 2)
    snap = jb.snapshot()
    jb.close()
    jax_b = type(jb).restore(__import__("libjitsi_tpu")
                             .configuration_service(), snap, port=0,
                             recv_window_ms=0)
    port_b = SfuBridge.restore(snap, port=0, device="cpu", recv_window_ms=0)
    caps = [_Capture(jax_b), _Capture(port_b)]
    rr = [rtcp.build_compound([rtcp.build_rr(rtcp.ReceiverReport(
        eps[1].ssrc, [rtcp.ReportBlock(ssrc=eps[0].ssrc, fraction_lost=64,
                                       cumulative_lost=5, highest_seq=520,
                                       jitter=3, lsr=0, dlsr=0)]))])]
    for t in range(6):
        wires = [e.media() for e in eps]
        extra = []
        if t == 1:
            extra.append(eps[1].rtcp_wire(rr))
        if t == 3:
            extra.append(eps[2].rtcp_wire([rtcp.build_compound([
                rtcp.build_nack(rtcp.Nack(eps[2].ssrc, eps[0].ssrc,
                                          [eps[0].seq - 5]))])]))
        for b in (jax_b, port_b):
            for w in wires + extra:
                eps[0].engine.send_batch(w, "127.0.0.1", b.port)
            _tick(b, 40.0 + 0.02 * t, 6)
            b.emit_feedback(now=40.0 + 0.02 * t + 0.01)
    assert port_b.recovery.fec.fec_packets_sent > 0
    assert port_b.retransmitted == jax_b.retransmitted == 1
    assert [b for _, b in caps[1].sent] == [b for _, b in caps[0].sent]
    jax_b.close()
    port_b.close()
    for e in eps:
        e.engine.close()
