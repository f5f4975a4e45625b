"""The port's conference audio bridge against the JAX package, on the CPU.

Host parts first — the dense jitter bank (in-batch duplicates, late
drops, gap skips, restore from a JAX snapshot), the dominant-speaker
detector at k = 1 and k = 3, the RFC 6464 level engine's bytes, the
receive bank's push and tick — then a four-party `ConferenceBridge` of
each package over UDP loopback, fed the same wire bytes at the same
`now`: per tick and per participant the wire bytes, decrypted payloads,
levels, dominant speaker and speaker events must be identical, serial
and at `pipeline_depth=2` with kernel stamps (the bank's metrics render
as the JAX bank's too).  The
tier-1 case gives the JAX bridge the port's SRTP tables (see
`_jax_bridge`); the case marked slow runs it whole.
Tolerance: exact equality.
"""

import time

import numpy as np
import pytest
import torch

import libjitsi_tpu
from libjitsi_tpu.conference.mixer import AudioMixer as JaxMixer
from libjitsi_tpu.conference.speaker import \
    DominantSpeakerIdentification as JaxSpeaker
from libjitsi_tpu.io.udp import UdpEngine as JaxUdp
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.rtp.dense_jitter import DenseJitterBank as JaxBank
from libjitsi_tpu.service.bridge import ConferenceBridge as JaxBridge
from libjitsi_tpu.service.media_stream import StreamRegistry as JaxRegistry
from libjitsi_tpu.service.pump import ReceiveBank as JaxReceiveBank
from libjitsi_tpu.service.pump import g711_codec as jax_g711_codec
from libjitsi_tpu.transform.header_ext import \
    CsrcAudioLevelEngine as JaxLevelEngine
from libjitsi_tpu_torch.conference.mixer import AudioMixer
from libjitsi_tpu_torch.conference.speaker import DominantSpeakerIdentification
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.rtp.dense_jitter import DenseJitterBank
from libjitsi_tpu_torch.service.bridge import ConferenceBridge
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.service.pump import FrameCodec, ReceiveBank, g711_codec
from libjitsi_tpu_torch.transform.engine import TransformEngineChain
from libjitsi_tpu_torch.transform.header_ext import CsrcAudioLevelEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

BANK_FIELDS = DenseJitterBank._SNAP_FIELDS


def _same_state(a, b, fields):
    for f in fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _bank_pair(cap=6, depth=8):
    return (JaxBank(cap, depth=depth, payload_cap=16, clock_rate=8000),
            DenseJitterBank(cap, depth=depth, payload_cap=16,
                            clock_rate=8000))


def test_dense_jitter_bank_follows_jax_and_restores_its_snapshot():
    rng = np.random.default_rng(3)
    jb, pb = _bank_pair()
    now = 10.0
    # batches: in-batch duplicates of one stream, a reordered pair, a
    # late packet after release, and a gap that must be skipped
    plan = [
        ([0, 0, 1, 2, 0], [100, 101, 7, 9, 102]),
        ([1, 3, 3], [8, 50, 50]),                    # duplicate seq
        ([0, 2], [99, 11]),                          # 99: late after pop
        ([1, 3], [30, 52]),                          # gaps on 1 and 3
        ([4, 4, 4, 5], [65534, 65535, 0, 1]),        # wrap in one batch
    ]
    for k, (sids, seqs) in enumerate(plan):
        n = len(sids)
        pay = rng.integers(0, 256, (n, 16), np.uint8)
        plen = rng.integers(1, 17, n)
        ts = np.asarray(seqs) * 160 + (k % 2) * 37
        for b in (jb, pb):
            b.insert_batch(sids, seqs, ts, pay, plen, now)
        for step in range(3):
            t = now + 0.02 * step + (0.3 if k == 3 else 0.0)
            got = [b.pop_all(t) for b in (jb, pb)]
            for x, y in zip(*got):
                assert np.array_equal(x, y)
        _same_state(jb, pb, BANK_FIELDS)
        now += 0.08
    assert jb.late_dropped.sum() > 0 and jb.lost.sum() > 0
    restored = DenseJitterBank.restore(jb.snapshot())
    _same_state(jb, restored, BANK_FIELDS)
    assert (restored.depth, restored.payload_cap) == (8, 16)
    for b in (jb, restored):
        b.insert_batch([2, 0], [12, 103], [0, 0], np.ones((2, 16), np.uint8),
                       [4, 4], now)
    assert all(np.array_equal(x, y) for x, y in
               zip(jb.pop_all(now + 1), restored.pop_all(now + 1)))


@pytest.mark.parametrize("k", [1, 3])
def test_speaker_detector_follows_jax(k):
    rng = np.random.default_rng(k)
    events = {"jax": [], "port": []}
    dets = {"jax": JaxSpeaker(12, k=k, on_change=events["jax"].append),
            "port": DominantSpeakerIdentification(
                12, k=k, on_change=events["port"].append)}
    for d in dets.values():
        for sid in range(10):
            d.add_participant(sid)
    loud = 127 - 90 * (np.arange(10) % 4 == 1)
    for tick in range(240):
        lv = np.clip(loud + rng.integers(-8, 9, 10), 0, 127).astype(np.uint8)
        if tick > 80:                      # another participant takes over
            lv[6] = rng.integers(0, 15)
        outs = [d.levels(lv) for d in dets.values()]
        assert outs[0] == outs[1]
        if tick == 150:
            for d in dets.values():
                d.remove_participant(5)
    j, p = dets["jax"], dets["port"]
    assert events["jax"] == events["port"] and len(events["port"]) >= 2
    assert j.speakers == p.speakers and len(p.speakers) == k
    for f in ("immediate", "medium", "long"):
        assert np.array_equal(getattr(j, f), getattr(p, f))
    # scores carry over from a JAX detector by copying the arrays
    q = DominantSpeakerIdentification(12, k=k)
    for f in ("immediate", "medium", "long", "active"):
        getattr(q, f)[:] = getattr(j, f)
    lv = np.full(10, 127, np.uint8)
    assert q.levels(lv) == p.levels(lv)


def test_audio_level_engine_bytes_follow_jax():
    rng = np.random.default_rng(5)
    lv_of = rng.integers(0, 128, 8).astype(np.uint8)
    n = 6
    ext = [None, (0xBEDE, bytes([0x10, 0x55])),             # level present
           (0xBEDE, bytes([0x21, 1, 2, 0, 0x10, 0x7F])),     # after another
           (0x1000, bytes(4)), None,
           (0xBEDE, bytes([0x11, 3, 4]))]                   # wrong length
    batch = j_header.build([bytes(range(k + 3)) for k in range(n)],
                           np.arange(n), 0, 0x99 + np.arange(n), 0,
                           stream=[0, 1, 2, 3, 7, 5], ext=ext)
    outs = {}
    for name, cls in (("jax", JaxLevelEngine), ("port", CsrcAudioLevelEngine)):
        eng = cls(1, 8, level_of=lambda s: lv_of[s])
        wire, ok = eng.rtp_transformer.transform(batch.copy())
        back, ok2 = eng.rtp_transformer.reverse_transform(
            PacketBatch(wire.data.copy(), wire.length.copy(),
                        wire.stream.copy()))
        outs[name] = (wire.data, wire.length, ok, ok2, eng.last_levels.copy())
    for x, y in zip(outs["jax"], outs["port"]):
        assert np.array_equal(x, y)
    # stamped on every row but the one with a foreign extension profile
    assert np.array_equal(outs["port"][4][[0, 1, 2, 5, 7]],
                          lv_of[[0, 1, 2, 5, 7]] & 0x7F)
    assert outs["port"][4][3] == 127


@pytest.mark.parametrize("elem_len", [1, 3])
def test_one_byte_ext_stamp_follows_jax(elem_len):
    """`set_one_byte_ext` on fresh, appended, rewritten and stale rows,
    with CSRCs, disabled rows and bytes past each row's length: the same
    whole [B, capacity] array as the JAX package's."""
    from libjitsi_tpu.rtp import ext as j_ext
    from libjitsi_tpu_torch.rtp import ext as p_ext
    from libjitsi_tpu_torch.rtp import header as p_header

    rng = np.random.default_rng(elem_len)
    n = 24
    exts = [None, (0xBEDE, bytes([0x40 | (elem_len - 1)]) + bytes(elem_len)),
            (0xBEDE, bytes([0x21, 1, 2, 0, 0x10, 0x7F])),
            (0xBEDE, bytes([0x41, 9, 9])), (0x1000, bytes(4)),
            (0xBEDE, bytes([0x30, 5, 0, 0, 0, 0, 0, 0]))]
    ext = [exts[k % len(exts)] for k in range(n)]
    csrcs = [list(range(k % 3)) for k in range(n)]
    batch = j_header.build(
        [rng.integers(0, 256, 10 + k, np.uint8).tobytes() for k in range(n)],
        np.arange(n), 0, 1 + np.arange(n), 0, csrcs=csrcs, capacity=96,
        stream=np.arange(n), ext=ext)
    for i in range(n):                          # bytes past the length
        batch.data[i, batch.length[i]:] = rng.integers(
            1, 256, 96 - batch.length[i], np.uint8)
    pay = rng.integers(0, 256, (n, elem_len), np.uint8)
    enable = rng.random(n) < 0.8
    for en in (None, enable):
        want = j_ext.set_one_byte_ext(batch, j_header.parse(batch), 4, pay,
                                      enable=en)
        pb = PacketBatch(batch.data.copy(), batch.length.copy(),
                         batch.stream.copy())
        got = p_ext.set_one_byte_ext(pb, p_header.parse(pb), 4, pay,
                                     enable=en)
        assert np.array_equal(np.asarray(want.data), got.data)
        assert np.array_equal(np.asarray(want.length), got.length)
        assert np.array_equal(pb.data, batch.data)        # input untouched
        off, ln, found = p_ext.find_one_byte_ext(got, p_header.parse(got), 4)
        wo, wl, wf = j_ext.find_one_byte_ext(want, j_header.parse(want), 4)
        assert all(np.array_equal(np.asarray(x), y)
                   for x, y in zip((wo, wl, wf), (off, ln, found)))
    full = PacketBatch(batch.data[:1].copy(), np.array([96], np.int32),
                       batch.stream[:1].copy())
    with pytest.raises(ValueError, match="capacity"):
        p_ext.set_one_byte_ext(full, p_header.parse(full), 4, pay[:1])


def _pcmu_batch(rng, sids, seqs, ts, width=160):
    pcm = rng.integers(-9000, 9000, (len(sids), width)).astype(np.int16)
    codes = g711.ulaw_encode(torch.from_numpy(pcm)).numpy()
    return j_header.build([c.tobytes() for c in codes], seqs, ts,
                          0x700 + np.asarray(sids), 0, stream=sids)


def test_receive_bank_push_and_tick_follow_jax():
    rng = np.random.default_rng(9)
    cap = 6
    jm, pm = (JaxMixer(cap, 160),
              AudioMixer(cap, 160, device="cpu"))
    jbank = JaxReceiveBank(cap, mixer=jm, mixer_rate=8000, plc=True)
    pbank = ReceiveBank(cap, mixer=pm, mixer_rate=8000, plc=True,
                        device="cpu")
    for sid, ulaw in ((0, True), (1, False), (2, True), (4, True)):
        jbank.add_stream(sid, jax_g711_codec(ulaw))
        pbank.add_stream(sid, g711_codec(ulaw, device="cpu"))
        for m in (jm, pm):
            m.add_participant(sid)
    now = 50.0
    for tick in range(8):
        sids = [0, 1, 2, 4] if tick not in (3, 4) else [0, 2]  # 1, 4 lose
        batch = _pcmu_batch(rng, sids, [200 + tick] * len(sids),
                            [tick * 160] * len(sids))
        ok = np.ones(len(sids), bool)
        if tick == 5:
            ok[0] = False                                    # failed auth
        counts = [b.push_decrypted(batch, ok, now=now)
                  for b in (jbank, pbank)]
        assert counts[0] == counts[1]
        (js, jp), (ps, pp) = (jbank.tick(now=now), pbank.tick(now=now))
        assert js == ps
        assert all(np.array_equal(np.asarray(x), y) for x, y in zip(jp, pp))
        (jo, jl), (po, pl) = jm.mix(), pm.mix()
        assert np.array_equal(np.asarray(jo), po)
        assert np.array_equal(np.asarray(jl), pl)
        now += 0.02
    for f in ("decoded_frames", "lost_frames", "plc_frames",
              "oversize_dropped"):
        assert np.array_equal(getattr(jbank, f), getattr(pbank, f)), f
    assert pbank.plc_frames.sum() > 0 and pbank.lost_frames.sum() > 0
    _same_state(jbank.jb, pbank.jb, BANK_FIELDS)


def test_stream_registry_hands_out_rows_like_jax():
    regs = [JaxRegistry(libjitsi_tpu.configuration_service(), capacity=8),
            StreamRegistry(8, device="cpu")]
    seen = []
    for reg in regs:
        got = [reg.alloc(object()) for _ in range(3)]
        reg.release(1)
        reg.reserve_many([5, 6], object())
        with pytest.raises(ValueError):
            reg.reserve_many([5], object())
        got += [reg.alloc(object()) for _ in range(3)]
        seen.append((got, reg.free_slots))
    # a released row is handed out again first
    assert seen[0] == seen[1] == ([0, 1, 2, 1, 3, 4], 1)
    assert regs[1].alloc(object()) == 7
    with pytest.raises(RuntimeError):
        regs[1].alloc(object())


def test_bridge_refuses_what_is_not_ported():
    """G.729 and iLBC legs are refused before a row is claimed; a leg at
    another rate than the first joiner's (PCMU at 16 kHz, Opus at 48 kHz)
    joins and resamples to the bridge clock, and a GSM leg joins as a
    stateful row."""
    bridge = ConferenceBridge(port=0, capacity=4, device="cpu")
    keys = _keys(0)
    try:
        for name in ("G729", "iLBC"):
            leg = FrameCodec(name, 97, 8000, 160, 160, None, None)
            with pytest.raises(NotImplementedError, match="item 9"):
                bridge.add_participant(1, *keys, codec=leg)
        assert bridge.registry.free_slots == 4 and bridge._rate is None
        bridge.add_participant(1, *keys)
        with pytest.raises(ValueError, match="ptime"):
            bridge.add_participant(2, *keys,
                                   codec=g711_codec(ptime_ms=30,
                                                    device="cpu"))
        with pytest.raises(ValueError, match="already joined"):
            bridge.add_participant(1, *keys)
        wide = FrameCodec("PCMU", 0, 16000, 320, 320, None, None)
        opus = FrameCodec("opus", 111, 48000, 960, 960, None, None)
        assert bridge.add_participant(3, *keys, codec=wide) == 1
        assert bridge.add_participant(5, *keys, codec=opus) == 2
        assert bridge._rate == 8000 and bridge.mixer.frame_samples == 160
        assert bridge.bank.frame_samples[:3].tolist() == [160, 320, 960]
        gsm = FrameCodec("GSM", 3, 8000, 160, 160, None, None)
        assert bridge.add_participant(6, *keys, codec=gsm) == 3
        assert bridge.bank._kind[3] == 2            # a stateful row
        bridge.remove_participant(0)
        assert bridge.add_participant(4, *keys) == 0       # row recycled
    finally:
        bridge.close()


def test_add_participant_dtls_names_item_9():
    """The DTLS join keeps the JAX signature (it refused, naming ROADMAP
    item 9, before DTLS was ported): it claims a row at once, which stays
    pending, keyless and out of the egress and the snapshot until the
    handshake completes, then takes the exported keys."""
    import inspect

    from libjitsi_tpu_torch.control.dtls import StubDtlsEndpoint

    assert list(inspect.signature(
        ConferenceBridge.add_participant_dtls).parameters) == list(
        inspect.signature(JaxBridge.add_participant_dtls).parameters)
    bridge = ConferenceBridge(port=0, capacity=4, device="cpu")
    bridge._dtls.endpoint_factory = StubDtlsEndpoint
    try:
        addr = (0x7F000001, 40000)
        sid, ep = bridge.add_participant_dtls(0x77, role="server",
                                              remote_addr=addr)
        assert sid == 0 and bridge.registry.free_slots == 3
        assert sid in bridge._dtls.pending and not ep.complete
        assert not bridge.tx_table.active[sid]
        bridge.loop.addr_ip[sid], bridge.loop.addr_port[sid] = addr
        bridge.tick(now=5.0)
        assert bridge._send_mixes(np.zeros((4, 160), np.int16)) == 0
        assert bridge.snapshot()["ssrc_of"] == {}
        client = StubDtlsEndpoint("client")
        out = client.handshake_packets()
        while out:
            back = [r for d in out for r in bridge._dtls.on_dtls(d, addr)]
            out = [r for d in back for r in client.feed(d)]
        assert ep.complete and client.complete
        assert sid not in bridge._dtls.pending
        assert bridge.tx_table.active[sid] and bridge.rx_table.active[sid]
        assert bridge.snapshot()["ssrc_of"] == {sid: 0x77}
        # the client's tx keys landed as the row's rx keys, and back
        _, ctk, cts, crk, crs = client.srtp_keys()
        for table, key in ((bridge.rx_table, (ctk, cts)),
                           (bridge.tx_table, (crk, crs))):
            ref = SrtpStreamTable(4, device="cpu")
            ref.add_stream(sid, *key)
            for k in ("rk_rtp", "mid_rtp", "salt_rtp"):
                assert np.array_equal(np.asarray(table.snapshot()[k])[sid],
                                      np.asarray(ref.snapshot()[k])[sid]), k
    finally:
        bridge.close()


# ------------------------------------------------------------------ bridge

PARTIES = [(0x1010, 300.0), (0x2020, 700.0), (0x3030, 1100.0),
           (0x4040, 0.0)]           # the last one sends silence


def _keys(i):
    return ((bytes([i + 1]) * 16, bytes([i + 2]) * 14),
            (bytes([i + 3]) * 16, bytes([i + 4]) * 14))


def _client_wire(table, tick):
    """One tick of the four parties' packets, protected: PCMU tones with
    their RFC 6464 levels; party 2 loses ticks 4 and 5."""
    rows, seqs = [], []
    for i, (ssrc, freq) in enumerate(PARTIES):
        if i == 2 and tick in (4, 5):
            continue
        t = tick * 160 + np.arange(160)
        amp = 6000 + 2500 * i if tick < 6 else 6000 + 2500 * (3 - i)
        pcm = (amp * np.sin(2 * np.pi * freq * t / 8000)).astype(np.int16)
        code = g711.ulaw_encode(torch.from_numpy(pcm)).numpy().tobytes()
        rows.append((i, code, 30 + 10 * i))
        seqs.append(1000 * i + tick)
    batch = j_header.build(
        [c for _i, c, _l in rows], seqs, [tick * 160] * len(rows),
        [PARTIES[i][0] for i, _c, _l in rows], 0,
        stream=[i for i, _c, _l in rows],
        ext=[(0xBEDE, bytes([0x10, lv, 0, 0])) for _i, _c, lv in rows])
    return table.protect_rtp(batch)


def _drain(engine, want, tries=100):
    got = []
    for _ in range(tries):
        b, _, _ = engine.recv_batch(timeout_ms=5)
        got += b.to_payloads()
        if len(got) >= want:
            break
    return got


def _jax_bridge(jax_srtp, **kwargs):
    """The JAX bridge; with `jax_srtp` False its two SRTP tables are the
    port's CPU tables (held byte-equal to the JAX tables by
    tests/test_torch_srtp_table.py), since compiling the JAX table's
    protect and unprotect costs over 30 s on the CPU."""
    jb = JaxBridge(libjitsi_tpu.configuration_service(), port=0, capacity=8,
                   **kwargs)
    if not jax_srtp:
        jb.rx_table = SrtpStreamTable(8, device="cpu")
        jb.tx_table = SrtpStreamTable(8, device="cpu")
        jb.chain = TransformEngineChain(
            [jb.levels_engine, SrtpTransformEngine(jb.tx_table, jb.rx_table)])
        jb.loop.chain = jb.chain
    return jb


@pytest.mark.parametrize("jax_srtp", [False,
                                      pytest.param(True,
                                                   marks=pytest.mark.slow)])
def test_four_party_bridge_follows_jax_bridge_tick_by_tick(jax_srtp):
    jbridge = _jax_bridge(jax_srtp)
    pbridge = ConferenceBridge(port=0, capacity=8, device="cpu")
    up = SrtpStreamTable(len(PARTIES), device="cpu")   # the parties' keys
    for i, (ssrc, _f) in enumerate(PARTIES):
        rx, tx = _keys(i)
        sids = [b.add_participant(ssrc, rx, tx) for b in (jbridge, pbridge)]
        assert sids[0] == sids[1] == i
        up.add_stream(i, *rx)
    for f in ("_tx_seq", "_tx_ts", "_tx_ssrc"):
        getattr(pbridge, f)[:] = getattr(jbridge, f)
    clients = [JaxUdp(port=0, max_batch=64), JaxUdp(port=0, max_batch=64)]
    now = 200.0
    heard = {"jax": [], "port": []}
    try:
        for tick in range(10):
            wire = _client_wire(up, tick)
            for eng, b in zip(clients, (jbridge, pbridge)):
                eng.send_batch(wire, "127.0.0.1", b.port)
            time.sleep(0.005)
            kbuild.reset_counts()
            port_stats = pbridge.tick(now=now)
            counts = dict(kbuild.plain_calls)
            stats = [jbridge.tick(now=now), port_stats]
            assert stats[0]["rx"] == stats[1]["rx"] == wire.batch_size
            assert np.array_equal(np.asarray(stats[0]["levels"]),
                                  stats[1]["levels"])
            assert stats[0]["dominant"] == stats[1]["dominant"]
            assert stats[0]["tx"] == stats[1]["tx"] == len(PARTIES)
            for eng, name in zip(clients, heard):
                back = sorted(_drain(eng, len(PARTIES)))
                assert len(back) == len(PARTIES)
                heard[name].append(back)
            assert heard["jax"][-1] == heard["port"][-1]     # wire bytes
            # one call of each plain version a tick: the CPU bridge runs
            # the plain versions where the card runs kernels C-G
            assert {k: counts[k] for k in ("mix_minus", "g711_decode",
                                           "g711_encode", "srtp_protect_cm",
                                           "srtp_unprotect_cm")} == \
                dict.fromkeys(("mix_minus", "g711_decode", "g711_encode",
                               "srtp_protect_cm", "srtp_unprotect_cm"), 1)
            now += 0.02
    finally:
        for eng in clients:
            eng.close()
        jbridge.close()
        pbridge.close()
    assert jbridge.speaker_events == pbridge.speaker_events
    assert len(pbridge.speaker_events) >= 1
    assert np.array_equal(jbridge.levels_engine.last_levels,
                          pbridge.levels_engine.last_levels)
    assert pbridge.levels_engine.last_levels[:4].tolist() == [30, 40, 50, 60]
    assert np.array_equal(jbridge.bank.lost_frames, pbridge.bank.lost_frames)
    assert pbridge.bank.lost_frames[2] >= 2
    # each party decrypts what it heard: the same payloads from both
    for name in heard:
        down = SrtpStreamTable(8, device="cpu")
        for i in range(len(PARTIES)):
            down.add_stream(i, *_keys(i)[1])
        batch = PacketBatch.from_payloads([p for t in heard[name] for p in t])
        batch.stream[:] = j_header.parse(batch).ssrc - 0x42000000
        dec, ok = down.unprotect_rtp(batch)
        assert ok.all()
        heard[name] = dec.to_payloads()
    assert heard["jax"] == heard["port"]


def test_four_party_bridge_under_gcm_hears_what_cm_hears():
    """The port's ConferenceBridge under AEAD_AES_128_GCM (kernels M and N,
    plain versions) beside one under AES-CM, fed the same four parties'
    audio: every reply opens under its party's GCM table, and each
    party hears the same mix as under AES-CM."""
    gcm = SrtpProfile.AEAD_AES_128_GCM
    bridges = {"cm": ConferenceBridge(port=0, capacity=8, device="cpu"),
               "gcm": ConferenceBridge(port=0, capacity=8, profile=gcm,
                                       device="cpu")}
    def keys(i, salt):
        return tuple((k, s[:salt]) for k, s in _keys(i))

    ups = {"cm": SrtpStreamTable(len(PARTIES), device="cpu"),
           "gcm": SrtpStreamTable(len(PARTIES), gcm, device="cpu")}
    downs = {"cm": SrtpStreamTable(8, device="cpu"),
             "gcm": SrtpStreamTable(8, gcm, device="cpu")}
    for name, salt in (("cm", 14), ("gcm", 12)):
        for i, (ssrc, _f) in enumerate(PARTIES):
            rx, tx = keys(i, salt)
            assert bridges[name].add_participant(ssrc, rx, tx) == i
            ups[name].add_stream(i, *rx)
            downs[name].add_stream(i, *tx)
    for f in ("_tx_seq", "_tx_ts", "_tx_ssrc"):
        getattr(bridges["gcm"], f)[:] = getattr(bridges["cm"], f)
    clients = {n: JaxUdp(port=0, max_batch=64) for n in bridges}
    heard = {n: [] for n in bridges}
    now = 300.0
    kbuild.reset_counts()
    try:
        for tick in range(6):
            for name, b in bridges.items():
                clients[name].send_batch(_client_wire(ups[name], tick),
                                         "127.0.0.1", b.port)
            time.sleep(0.005)
            for name, b in bridges.items():
                assert b.tick(now=now)["tx"] == len(PARTIES)
                heard[name] += _drain(clients[name], len(PARTIES))
            now += 0.02
    finally:
        for b in bridges.values():
            b.close()
        for eng in clients.values():
            eng.close()
    assert kbuild.plain_calls["srtp_gcm_open"] == 6        # the bridge's
    assert kbuild.plain_calls["srtp_gcm_seal"] == 12       # parties' too
    out = {}
    for name in heard:
        batch = PacketBatch.from_payloads(sorted(heard[name]))
        batch.stream[:] = j_header.parse(batch).ssrc - 0x42000000
        dec, ok = downs[name].unprotect_rtp(batch)
        assert ok.all() and len(ok) == 6 * len(PARTIES)
        out[name] = sorted(dec.to_payloads())
    assert out["gcm"] == out["cm"]


def test_pipelined_bridge_follows_jax_pipelined_bridge_tick_by_tick():
    """Both packages' bridges at `pipeline_depth=2` with kernel stamps (the
    JAX one on the port's CPU SRTP tables, as in the serial case): tick N's
    unprotect materializes on tick N + 1 and its mixes leave on the tick
    after, so each tick's wire, levels and counters must match, and the
    last mixes leave at the final `flush_sends`."""
    jbridge = _jax_bridge(False, pipeline_depth=2, kernel_timestamps=True)
    pbridge = ConferenceBridge(port=0, capacity=8, pipeline_depth=2,
                               kernel_timestamps=True, device="cpu")
    assert pbridge.loop.pipelined and pbridge.loop.use_kernel_ts
    up = SrtpStreamTable(len(PARTIES), device="cpu")
    for i, (ssrc, _f) in enumerate(PARTIES):
        rx, tx = _keys(i)
        assert [b.add_participant(ssrc, rx, tx)
                for b in (jbridge, pbridge)] == [i, i]
        up.add_stream(i, *rx)
    for f in ("_tx_seq", "_tx_ts", "_tx_ssrc"):
        getattr(pbridge, f)[:] = getattr(jbridge, f)
    clients = [JaxUdp(port=0, max_batch=64), JaxUdp(port=0, max_batch=64)]
    heard = {"jax": [], "port": []}
    now = 400.0
    try:
        for tick in range(6):
            wire = _client_wire(up, tick)
            for eng, b in zip(clients, (jbridge, pbridge)):
                eng.send_batch(wire, "127.0.0.1", b.port)
            time.sleep(0.005)
            stats = [b.tick(now=now) for b in (jbridge, pbridge)]
            for k in ("rx", "tx", "mixed", "dominant"):
                assert stats[0][k] == stats[1][k], k
            assert np.array_equal(np.asarray(stats[0]["levels"]),
                                  stats[1]["levels"])
            # the mixes of the tick before leave at this tick's top
            want = len(PARTIES) if tick else 0
            for eng, name in zip(clients, heard):
                back = sorted(_drain(eng, want, tries=4 if want else 1))
                assert len(back) == want
                heard[name].append(back)
            assert heard["jax"][-1] == heard["port"][-1]
            now += 0.02
        for b in (jbridge, pbridge):
            assert b.loop.flush_sends() == len(PARTIES)
        last = [sorted(_drain(eng, len(PARTIES))) for eng in clients]
        assert last[0] == last[1] and len(last[1]) == len(PARTIES)
    finally:
        for eng in clients:
            eng.close()
        jbridge.close()
        pbridge.close()
    assert np.array_equal(jbridge.bank.decoded_frames,
                          pbridge.bank.decoded_frames)
    assert pbridge.bank.decoded_frames[:4].sum() > 0
    assert jbridge.speaker_events == pbridge.speaker_events


def test_receive_bank_metrics_render_like_jax():
    from libjitsi_tpu.utils.metrics import MetricsRegistry as JaxMetrics
    from libjitsi_tpu_torch.utils.metrics import (MetricsRegistry,
                                                  validate_exposition)

    rng = np.random.default_rng(13)
    jbank = JaxReceiveBank(6, plc=True)
    pbank = ReceiveBank(6, plc=True, device="cpu")
    for sid in (0, 2, 3):
        jbank.add_stream(sid, jax_g711_codec(True))
        pbank.add_stream(sid, g711_codec(True, device="cpu"))
    now = 70.0
    for tick in range(5):
        sids = [0, 2, 3] if tick != 2 else [0]
        jitter = rng.random(len(sids)) * 0.004 * tick
        batch = _pcmu_batch(rng, sids, [10 + tick] * len(sids),
                            [tick * 160] * len(sids))
        for b in (jbank, pbank):
            b.push_decrypted(batch, np.ones(len(sids), bool),
                             now=now + float(jitter.max(initial=0)))
            b.tick(now=now)
        now += 0.02
    regs = [JaxMetrics(), MetricsRegistry()]
    jbank.register_metrics(regs[0])
    pbank.register_metrics(regs[1], prefix="bank")
    for reg in regs:
        reg.set_stream_name(2, 'leg "two"')
    assert pbank.jitter_hist.count == jbank.jitter_hist.count > 0
    for active in (None, np.array([1, 0, 1, 1, 0, 0], bool)):
        texts = [r.render(active=active) for r in regs]
        assert texts[0] == texts[1]
        assert validate_exposition(texts[1]) == []
    assert "bank_decode_delay_seconds_bucket" in texts[1]
