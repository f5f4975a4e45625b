"""The port's public stream API against the JAX package's, on the CPU.

- `control/sdes.py`: the same seeded `rng` gives the same offer, answer
  and keys; lifetime/MKI parameters, `a=crypto:` prefixes and the
  refusals parse alike.
- `core/config.py`: overrides, environment values, defaults, typed
  getters (bad values fall back), prefixes and listeners.
- `rtp/stats.py` / `rtp/stats2.py`: one reordered, lossy, wrapping
  multi-stream run gives the same counters, extended sequence numbers,
  jitter, report blocks, SRs, RTT and polled rates.
- `service/encodings.py`: the same supported encodings (the Opus, GSM
  and Speex probes answer alike) and payload-type tables under
  priorities, registrations and a full dynamic range.
- `MediaStream` / `AudioMediaStream` pairs (keys from seeded SDES,
  SSRCs, seq and ts pinned, a transport-cc and an abs-send-time engine
  on fake clocks) under AES_CM_128_HMAC_SHA1_80, AES_CM_128_HMAC_SHA1_32
  and AEAD_AES_128_GCM: every tick's wire bytes, verdicts, decrypted
  rows, `stats`, `send_stats` / `receive_stats`, RTCP report bytes,
  parsed RTCP, BWE state (RR loss, REMB, TCC feedback), DTMF events and
  levels; a tampered and a replayed datagram refused and not counted; a
  registry-wide ingest in one call through a chain on the registry's
  tables.  The JAX registry gets the port's CPU SRTP tables (held
  byte-equal to the JAX tables by tests/test_torch_srtp_table.py),
  because compiling the JAX table costs over 30 s on the CPU; the
  `slow` case runs the JAX stream whole.
- `Direction` refusals, `close()`'s BYE and row recycling (stats rows
  reset), the Quick start on `device="cpu"` with the device layer, the
  card default that raises without a card, and `VideoMediaStream`'s
  keyframe requests and simulcast layers (`SimulcastReceiver.ingest`).

Inputs come from numpy seeds.  Tolerance: exact equality.
"""

import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

import libjitsi_tpu_torch
from libjitsi_tpu.control import sdes as j_sdes
from libjitsi_tpu.core import config as j_config
from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu.rtp import stats as j_stats
from libjitsi_tpu.rtp import stats2 as j_stats2
from libjitsi_tpu.service import encodings as j_enc
from libjitsi_tpu.service import media_stream as j_ms
from libjitsi_tpu.service import typed_streams as j_typed
from libjitsi_tpu.transform import engine as j_engine
from libjitsi_tpu.transform import header_ext as j_ext
from libjitsi_tpu.transform.srtp import engine as j_srtp_engine
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu_torch import device as p_dev
from libjitsi_tpu_torch.control import sdes as p_sdes
from libjitsi_tpu_torch.core import config as p_config
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import rtcp as p_rtcp
from libjitsi_tpu_torch.rtp import stats as p_stats
from libjitsi_tpu_torch.rtp import stats2 as p_stats2
from libjitsi_tpu_torch.service import aux_services as p_aux
from libjitsi_tpu_torch.service import encodings as p_enc
from libjitsi_tpu_torch.service import media_stream as p_ms
from libjitsi_tpu_torch.service import typed_streams as p_typed
from libjitsi_tpu_torch.service.media_service import MediaService
from libjitsi_tpu_torch.transform import engine as p_engine
from libjitsi_tpu_torch.transform import header_ext as p_ext
from libjitsi_tpu_torch.transform.srtp import engine as p_srtp_engine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

CAP = 8
CM80 = "AES_CM_128_HMAC_SHA1_80"
PROFILES = (CM80, "AES_CM_128_HMAC_SHA1_32", "AEAD_AES_128_GCM")
# the two packages' modules, side by side
P = types.SimpleNamespace(
    sdes=p_sdes, rtcp=p_rtcp, ms=p_ms, typed=p_typed, ext=p_ext,
    engine=p_engine, srtp_engine=p_srtp_engine, Profile=SrtpProfile,
    Batch=PacketBatch)
J = types.SimpleNamespace(
    sdes=j_sdes, rtcp=j_rtcp, ms=j_ms, typed=j_typed, ext=j_ext,
    engine=j_engine, srtp_engine=j_srtp_engine, Profile=JaxProfile,
    Batch=JaxBatch)


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda n: r.bytes(n)


# ---------------------------------------------------------------- SDES

@pytest.mark.parametrize("seed", (0, 1))
def test_sdes_lines_match_jax(seed):
    offers, answers, keys = [], [], []
    for m in (P, J):
        init = m.sdes.SdesControl(
            profiles=[m.Profile.AES_CM_128_HMAC_SHA1_32,
                      m.Profile.AES_CM_128_HMAC_SHA1_80,
                      m.Profile.AEAD_AES_128_GCM], rng=_rng(seed))
        resp = m.sdes.SdesControl(profiles=[m.Profile.AES_CM_128_HMAC_SHA1_80],
                                  rng=_rng(seed + 10))
        offers.append(init.create_offer())
        answers.append(resp.create_answer(
            ["a=crypto:9 BOGUS inline:AAAA"] + offers[-1]))
        init.accept_answer(answers[-1])
        keys.append((init.local.master_key, init.remote.master_salt,
                     resp.local.master_salt, init.profile.value,
                     init.negotiated, resp.negotiated))
    assert offers[0] == offers[1] and answers[0] == answers[1]
    assert keys[0] == keys[1]
    line = "a=crypto:1 " + offers[0][1].split(" ", 1)[1] + "|2^20|1:4"
    pa = p_sdes.CryptoAttribute.parse(line)
    ja = j_sdes.CryptoAttribute.parse(line)
    assert (pa.tag, pa.profile.value, pa.master_key, pa.master_salt) == \
        (ja.tag, ja.profile.value, ja.master_key, ja.master_salt)
    assert pa.encode() == ja.encode()
    for bad in ("1 AES_CM_128_HMAC_SHA1_80", "x AES_CM_128_HMAC_SHA1_80 a",
                "1 NOPE inline:AAAA", "1 AES_CM_128_HMAC_SHA1_80 inline:AAAA"):
        for mod in (p_sdes, j_sdes):
            with pytest.raises(ValueError):
                mod.CryptoAttribute.parse(bad)
    for m in (P, J):
        c = m.sdes.SdesControl(rng=_rng(seed))
        c.create_offer()
        with pytest.raises(ValueError):
            c.accept_answer("7 AES_CM_128_HMAC_SHA1_80 inline:"
                            + "A" * 40)
        with pytest.raises(RuntimeError):
            _ = c.profile
        with pytest.raises(ValueError):
            m.sdes.SdesControl(profiles=[m.Profile.NULL_HMAC_SHA1_80]
                               ).create_answer(offers[0])


# -------------------------------------------------------------- config

def test_config_matches_jax(monkeypatch):
    monkeypatch.setenv("LIBJITSI_TPU_LIBJITSI_TPU_ENV_KEY", "17")
    monkeypatch.setenv("LIBJITSI_TPU_LIBJITSI_TPU_EMPTY", "")
    seen = {"p": [], "j": []}
    svc = {}
    for k, mod in (("p", p_config), ("j", j_config)):
        c = mod.ConfigurationService(overrides={"libjitsi_tpu.a": "3",
                                                "libjitsi_tpu.bad": "x1"})
        c.register_default("libjitsi_tpu.d", 2.5)
        c.register_default("libjitsi_tpu.empty", "dflt")
        c.add_listener(lambda *a, k=k: seen[k].append(("all",) + a))
        cb = (lambda *a, k=k: seen[k].append(("a",) + a))
        c.add_listener(cb, "libjitsi_tpu.a")
        c.set("libjitsi_tpu.a", 4)
        c.set("libjitsi_tpu.a", 4)            # no change: no callback
        c.set("libjitsi_tpu.flag", "Yes")
        c.remove("libjitsi_tpu.flag")
        c.remove_listener(cb, "libjitsi_tpu.a")
        c.set("libjitsi_tpu.a", None)
        c.remove_listener(cb, "never")
        svc[k] = c
    for c in svc.values():
        c.set("libjitsi_tpu.flag", "on")
    got = []
    for c in svc.values():
        got.append((c.get("libjitsi_tpu.a", "miss"),
                    c.get_int("libjitsi_tpu.env.key"),
                    c.get_int("libjitsi_tpu.bad", 9),
                    c.get_float("libjitsi_tpu.d"),
                    c.get_float("libjitsi_tpu.bad", 1.5),
                    c.get_bool("libjitsi_tpu.flag"),
                    c.get_bool("libjitsi_tpu.none", True),
                    c.get_string("libjitsi_tpu.empty"),
                    c.get_string("libjitsi_tpu.none", "s"),
                    sorted(c.properties_by_prefix("libjitsi_tpu.").items())))
    assert got[0] == got[1]
    assert seen["p"] == seen["j"] and len(seen["p"]) == 6
    assert p_config._env_name("a.b-c") == j_config._env_name("a.b-c")


# --------------------------------------------------------------- stats

def _lossy_run(seed, n_streams=4, n=240):
    """A multi-stream run: each stream from a random start seq (some near
    the wrap), 10% lost, neighbours swapped, a duplicate; split into
    batches; arrivals with jitter."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_streams):
        start = int(rng.choice([65_500, int(rng.integers(0, 1 << 16))]))
        seqs = (start + np.arange(n)) & 0xFFFF
        keep = rng.random(n) > 0.1
        seqs, ts = seqs[keep], (np.arange(n) * 160)[keep]
        sw = rng.integers(0, len(seqs) - 1, 8)
        seqs[sw], seqs[sw + 1] = seqs[sw + 1], seqs[sw].copy()
        arr = 50.0 + np.arange(len(seqs)) * 0.02 + rng.uniform(0, 0.01,
                                                               len(seqs))
        for q, t, a in zip(seqs, ts, arr):
            rows.append((s, int(q), int(t), int(rng.integers(60, 300)), a))
        rows.append(rows[-3])                       # a duplicate
    rows.sort(key=lambda r: r[4])
    return np.array(rows, dtype=object)


STAT_ARRAYS = ("rx_packets", "rx_bytes", "rx_base_ext", "rx_max_ext",
               "jitter", "_last_transit", "clock_rate", "_expected_prior",
               "_received_prior", "_last_sr_mid32", "_last_sr_arrival",
               "tx_packets", "tx_bytes", "rtt", "_sr_sent_mid32")


@pytest.mark.parametrize("seed", (0, 1))
def test_stats_tables_and_poller_match_jax(seed):
    tabs = [p_stats.StreamStatsTable(CAP), j_stats.StreamStatsTable(CAP)]
    polls = [p_stats2.StatsPoller(tabs[0]), j_stats2.StatsPoller(tabs[1])]
    run = _lossy_run(seed)
    for t in tabs:
        t.clock_rate[1] = 8000
    blocks, srs = [], []
    for b, i in enumerate(range(0, len(run), 37)):
        part = run[i:i + 37]
        now = float(part[-1][4]) + 0.001
        for t, p in zip(tabs, polls):
            args = [np.array([r[k] for r in part]) for k in range(5)]
            t.on_received(args[0], args[1], args[2], args[3],
                          args[4].astype(np.float64))
            t.on_sent(args[0][::2], args[3][::2])
            if b % 3 == 0:
                p.poll(now)
        for s in range(4):
            mod = (p_rtcp, j_rtcp)
            blocks.append([asdict(t.make_report_block(s, 0x100 + s, now))
                           for t in tabs])
            if b % 4 == 1:
                sr = [t.make_sr(s, 0x200 + s, 1234 * b, now=now)
                      for t in tabs]
                srs.append([asdict(x) for x in sr])
                # the far end echoes our SR 30 ms later
                for t, x, m in zip(tabs, sr, mod):
                    mid = ((x.ntp_sec & 0xFFFF) << 16) | (x.ntp_frac >> 16)
                    rb = m.ReportBlock(0x200 + s, 0, 0, 0, 0, mid, 1966)
                    t.on_rr_received(s, rb, now=now + 0.06)
                    t.on_sr_received(s, m.SenderReport(
                        0x300, x.ntp_sec, x.ntp_frac, 0, 0, 0, []),
                        arrival=now + 0.01)
        assert blocks[-1][0] == blocks[-1][1]
    for name in STAT_ARRAYS:
        assert np.array_equal(getattr(tabs[0], name), getattr(tabs[1], name)), name
    for name in ("tx_pps", "tx_bps", "rx_pps", "rx_bps", "fraction_lost"):
        assert np.array_equal(getattr(polls[0], name),
                              getattr(polls[1], name)), name
    assert all(a == b for a, b in blocks) and all(a == b for a, b in srs)
    assert max(x[0]["cumulative_lost"] for x in blocks) > 0
    assert max(x[0]["fraction_lost"] for x in blocks) > 0
    assert (tabs[0].rtt > 0).sum() == 4
    for s in range(CAP):
        assert tabs[0].cumulative_lost(s) == tabs[1].cumulative_lost(s)
        assert asdict(polls[0].send_stats(s)) == asdict(polls[1].send_stats(s))
        assert asdict(polls[0].receive_stats(s)) == \
            asdict(polls[1].receive_stats(s))
    assert [asdict(x) for x in polls[0].all_receive_stats([0, 3])] == \
        [asdict(x) for x in polls[1].all_receive_stats([0, 3])]
    assert [asdict(x) for x in polls[0].all_send_stats([1])] == \
        [asdict(x) for x in polls[1].all_send_stats([1])]
    assert asdict(tabs[0].make_rr(2, 1, 0x102, now=99.0)) == \
        asdict(tabs[1].make_rr(2, 1, 0x102, now=99.0))
    for t, p in zip(tabs, polls):
        t.reset(2)
        p.reset(2)
    for name in STAT_ARRAYS:
        assert np.array_equal(getattr(tabs[0], name), getattr(tabs[1], name)), name
    assert p_stats.ntp_middle32(1e9 + 0.3) == j_stats.ntp_middle32(1e9 + 0.3)


# ----------------------------------------------------------- encodings

def test_encoding_configuration_matches_jax():
    confs = [p_enc.EncodingConfiguration(), j_enc.EncodingConfiguration()]

    def table(c, media=None):
        return {pt: (e.name, e.clock_rate, e.channels, e.static_pt)
                for pt, e in c.assign_payload_types(media).items()}

    def names(c, media=None):
        return [e.name for e in c.supported(media)]

    for media in (None, "audio", "video"):
        assert table(confs[0], media) == table(confs[1], media)
        assert names(confs[0], media) == names(confs[1], media)
    for c, mod in zip(confs, (p_enc, j_enc)):
        c.set_priority("opus", 0)
        c.set_priority("PCMA", 5000)
        c.register(mod.Encoding("L16", "audio", 44100, 2, 97), 4000)
        c.register(mod.Encoding("ghost", "audio", 8000,
                                available=lambda: False), 4500)
        for i in range(40):                     # overflow 96..127
            c.register(mod.Encoding(f"x{i}", "video", 90000), 10 + i)
        with pytest.raises(KeyError):
            c.set_priority("nope", 1)
    for media in (None, "audio", "video"):
        assert table(confs[0], media) == table(confs[1], media)
        assert names(confs[0], media) == names(confs[1], media)
    assert confs[0].priority("PCMA") == confs[1].priority("PCMA") == 5000
    assert confs[0].priority("nope") == confs[1].priority("nope") == 0
    calls = [[], []]
    for c, log in zip(confs, calls):
        fake = types.SimpleNamespace(add_dynamic_rtp_payload_type=lambda *a,
                                     log=log: log.append(a))
        c.apply_to_stream(fake, "audio")
    assert calls[0] == calls[1] and calls[0][-1][1] == "PCMA"


# ----------------------------------------------------- MediaStream pairs

class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _registry(m, profile, jax_srtp=False):
    if m is P:
        return p_ms.StreamRegistry(CAP, device="cpu")
    reg = j_ms.StreamRegistry(j_config.ConfigurationService(), capacity=CAP)
    if not jax_srtp:
        reg._srtp[JaxProfile(profile)] = (
            SrtpStreamTable(CAP, SrtpProfile(profile), "cpu"),
            SrtpStreamTable(CAP, SrtpProfile(profile), "cpu"))
    return reg


def _pair(m, reg, profile, clock, audio=True, seed=0):
    """Near end `a` (transport-cc and abs-send-time engines) and far end
    `b`, keyed by seeded SDES, seq and ts pinned near their wraps."""
    prof = m.Profile(profile)
    cls = m.typed.AudioMediaStream if audio else m.ms.MediaStream
    a = cls(reg, profile=prof, local_ssrc=0xA0 + seed,
            extra_engines=[m.ext.TransportCCEngine(5, clock=clock),
                           m.ext.AbsSendTimeEngine(3, clock=clock)])
    b = cls(reg, profile=prof, local_ssrc=0xB0 + seed)
    for k, s in enumerate((a, b)):
        s.sdes = m.sdes.SdesControl(profiles=[prof], rng=_rng(2 * seed + k))
        s._tx_seq = 65_530 + 3 * k
        s._tx_ts = 0xFFFF_F000 + k
        s.add_dynamic_rtp_payload_type(0, "PCMU", 8000)
    a.sdes.accept_answer(b.sdes.create_answer(a.sdes.create_offer()))
    a.set_remote_ssrc(b.local_ssrc)
    b.set_remote_ssrc(a.local_ssrc)
    a.start()
    b.start()
    return a, b


def _drive(m, profile, ticks=10, audio=True, jax_srtp=False):
    """One pair through `ticks` 20 ms ticks; returns everything the two
    packages must agree on."""
    clock = _Clock()
    reg = _registry(m, profile, jax_srtp)
    a, b = _pair(m, reg, profile, clock, audio)
    log = {"wire": [], "ok": [], "back": [], "rows": [], "stats": [],
           "rtcp": [], "bwe": [], "events": [], "levels": []}
    if audio:
        b.add_dtmf_listener(lambda sid, e: log["events"].append(
            (sid, e.__dict__)))
        b.add_audio_level_listener(lambda s, lv: log["levels"].append(
            (s.tolist(), lv.tolist())))
        a.set_level_source(lambda sids: (sids * 5 + int(clock.t)) % 128)
    held = []
    reg.stats2.poll(now=100.0)
    for t in range(ticks):
        now = 100.0 + 0.02 * t
        clock.t = now
        if audio and t == 2:
            a.start_sending_dtmf("7")
        if audio and t == 5:
            a.stop_sending_dtmf()
        frames = [bytes([t]) * 160] + ([bytes([t + 1]) * 80] if t % 3 == 0
                                       else [])
        wire = a.send(frames, pt=0, ts_step=160, marker=[t == 0] * len(frames))
        log["wire"].append(wire)
        if t == 3:                      # lost
            continue
        if t == 5:                      # delivered after tick 6's
            held = wire
            continue
        if t == 6:
            wire = wire + held
        if t == 8:                      # a tampered copy and a replay
            bad = bytearray(wire[0])
            bad[20] ^= 0x40
            wire = [bytes(bad)] + wire + [log["wire"][7][0]]
        got, ok = b.receive(wire, arrival=now + 0.003 * (t % 4))
        log["ok"].append(ok.tolist())
        log["rows"].append([got.to_bytes(i) for i in np.nonzero(ok)[0]])
        if t % 3 == 1:                  # the far end talks back
            _, ok2 = a.receive(b.send([b"r" * (10 + t)], pt=0, ts_step=160),
                               arrival=now + 0.001)
            log["back"].append(ok2.tolist())
        reg.stats2.poll(now=now + 0.01)
        if t in (4, 9):
            rep_a = a.make_rtcp_report(now=now + 0.011)
            pk = [b.handle_rtcp(rep_a, now=now + 0.012)]
            rep_b = b.make_rtcp_report(now=now + 0.013)   # echoes a's SR
            pk.append(a.handle_rtcp(rep_b, now=now + 0.016))
            log["rtcp"].append((rep_a, rep_b, repr(pk)))
        if t == 7:
            seen = []
            a.add_rtcp_listener(lambda s, p: seen.append(type(p).__name__))
            fb = m.rtcp.TccFeedback(
                b.local_ssrc, a.local_ssrc, 0, int(now * 1000) // 64, 1,
                np.array([True, True, False, True, True, True, True]),
                np.array([0, 80, 0, 170, 260, 250, 400]))
            blob = m.rtcp.build_compound([
                m.rtcp.build_remb(m.rtcp.Remb(b.local_ssrc, 250_000,
                                              [a.local_ssrc])),
                m.rtcp.build_tcc(fb)])
            a.handle_rtcp(blob, now=now + 0.02)
            log["rtcp"].append((blob, seen))
        log["bwe"].append((a.bwe.estimate_bps, a.bwe.bitrate,
                           a.bwe.loss_estimate, a.bwe.last_fraction_lost,
                           a.bwe.remb_cap, a.bwe.delay_cap))
        log["stats"].append((a.stats, b.stats,
                             asdict(a.send_stats()), asdict(b.receive_stats()),
                             asdict(b.send_stats()), asdict(a.receive_stats())))
    if audio:
        log["levels"].append(b.last_received_level)
    log["tcc"] = a._tcc_engine.next_seq_ext
    return log, reg, a, b


@pytest.mark.parametrize("profile", PROFILES)
def test_media_stream_pair_follows_jax_pair(profile):
    audio = profile == CM80
    port, _, pa, pb = _drive(P, profile, audio=audio)
    jax, _, ja, jb = _drive(J, profile, audio=audio)
    for key in port:
        assert port[key] == jax[key], key
    oks = port["ok"]
    assert all(all(o) for o in port["back"]) and len(port["back"]) == 3
    # tick 8: a tampered copy first, the replay of tick 7's packet last
    assert oks[6][0] is False and oks[6][-1] is False and all(oks[6][1:-1])
    assert pa.stats["rtt_seconds"] > 0 and pa.bwe.remb_cap == 250_000
    assert pa.bwe.delay_cap is not None
    if not audio:
        assert [len(o) - sum(o) for o in oks] == [0, 0, 0, 0, 0, 0, 2, 0]
        assert pb.stats["cumulative_lost"] == 2   # tick 3's two frames
    else:
        # telephone-events are consumed by the DTMF engine, not counted
        assert len(port["events"]) == sum(len(o) - sum(o) for o in oks) - 2
        assert port["events"][-1][1]["end"] and port["events"][0][1]["event"] == 7
        assert len(port["levels"]) > 0


def test_registry_ingest_close_bye_and_recycling_match_jax():
    out = []
    for m in (P, J):
        clock = _Clock()
        reg = _registry(m, CM80)
        pairs = [_pair(m, reg, CM80, clock, audio=False, seed=s)
                 for s in range(3)]
        wire = [w for a, _b in pairs for w in a.send([b"x" * 33, b"y" * 9])]
        batch = m.Batch.from_payloads(wire)
        sids = reg.demux(batch)
        tx, rx = reg.srtp_tables(m.Profile(CM80))
        chain = m.engine.TransformEngineChain(
            [m.srtp_engine.SrtpTransformEngine(tx, rx)])
        got, ok = chain.rtp_transformer.reverse_transform(batch)
        rows = [got.to_bytes(i) for i in range(got.batch_size)]
        a, b = pairs[1]
        a.set_direction(m.ms.Direction.RECVONLY)
        with pytest.raises(RuntimeError):
            a.send([b"nope"])
        a.set_direction(m.ms.Direction.SENDONLY)
        with pytest.raises(RuntimeError):
            a.receive([b"\x80" * 40])
        a.set_direction(m.ms.Direction.INACTIVE)
        refuse = (a.direction.allows_sending, a.direction.allows_receiving)
        a.set_direction(m.ms.Direction.SENDRECV)
        b.receive(a.send([b"z"]), arrival=5.0)
        sid = b.sid
        bye = b.close()
        c = m.ms.MediaStream(reg, local_ssrc=0xC)
        fresh = (c.sid, c.stats, reg.stats2.rx_pps[sid], reg.free_slots)
        with pytest.raises(RuntimeError):
            c.send([b"x"])
        with pytest.raises(RuntimeError):
            c.start()
        demux_after = reg.demux(m.Batch.from_payloads(a.send([b"w"])))
        rtcp_sids = reg.demux_rtcp(m.Batch.from_payloads(
            [pairs[0][0].make_rtcp_report(now=1.0)]))
        out.append((sids.tolist(), ok.tolist(), rows, refuse, bye, fresh,
                    demux_after.tolist(), rtcp_sids.tolist(), sid))
        with pytest.raises(ValueError):
            m.ms.create_media_stream(None)
    assert out[0] == out[1]
    assert out[0][0] == [1, 1, 3, 3, 5, 5] and all(out[0][1])
    assert out[0][5][0] == out[0][8]            # b's row recycled
    assert out[0][6] == [-1]                    # a's peer left the demux


def test_registry_reserve_and_release_reset_rows():
    reg = p_ms.StreamRegistry(4, device="cpu")
    reg.reserve(2, "restored")
    with pytest.raises(ValueError):
        reg.reserve(2, "again")
    assert reg.alloc("x") == 0 and reg.free_slots == 2
    reg.stats.tx_packets[2] = 7
    reg.stats2.tx_pps[2] = 3.0
    reg.release(2)
    assert reg.stats.tx_packets[2] == 0 and reg.stats2.tx_pps[2] == 0.0
    assert reg.free_slots == 3 and 2 not in reg.streams


def test_video_stream_keyframe_requests_match_jax():
    blobs = []
    for m in (P, J):
        reg = _registry(m, CM80)
        v = m.typed.VideoMediaStream(reg, local_ssrc=0x77)
        with pytest.raises(RuntimeError):
            v.request_keyframe()
        v.set_remote_ssrc(0x88)
        blobs.append([v.request_keyframe(), v.request_keyframe(True),
                      v.request_keyframe(True)])
    assert blobs[0] == blobs[1]
    # simulcast layers are taken: the same VP8 batch ingested by each
    # package's SimulcastReceiver leaves the same per-layer bookkeeping
    from libjitsi_tpu.codecs import vp8 as j_vp8
    from libjitsi_tpu_torch.codecs import vp8 as p_vp8
    from libjitsi_tpu_torch.rtp import header as p_rtp_header

    pls, ssrcs = [], []
    for k, ssrc in enumerate((1, 2, 3)):
        for f in range(3):
            frame = bytes([0 if f == 0 else 1, k]) * 40
            for pl in p_vp8.packetize(frame, picture_id=200 * k + f,
                                      max_payload=30, tl0picidx=f):
                pls.append(pl)
                ssrcs.append(ssrc)
    n = len(pls)
    wire = p_rtp_header.build(pls, list(range(n)), 0, ssrcs, [96] * n,
                              stream=[0] * n).to_payloads()
    got = []
    for m, batch, vp8 in ((P, PacketBatch, p_vp8), (J, JaxBatch, j_vp8)):
        v = m.typed.VideoMediaStream(_registry(m, CM80))
        v.set_simulcast_layers([1, 2, 3])
        assert isinstance(v.simulcast, vp8.SimulcastReceiver)
        desc = v.simulcast.ingest(batch.from_payloads(wire))
        got.append((v.simulcast.last_picture_id.tolist(),
                    v.simulcast.last_tl0.tolist(),
                    v.simulcast.keyframe_seen.tolist(),
                    v.simulcast.frames.tolist(), desc.picture_id.tolist(),
                    v.simulcast.select_layer(5e5, [1e5, 4e5, 9e5])))
    assert got[0] == got[1] and got[0][3] == [3, 3, 3]


# --------------------------------------------------------- entry points

def test_quick_start_on_cpu():
    """README's Quick start, on the port with `device="cpu"`."""
    libjitsi_tpu_torch.stop()
    try:
        libjitsi_tpu_torch.init({"libjitsi_tpu.stream_capacity": 16},
                                device="cpu")
        svc = libjitsi_tpu_torch.media_service()
        assert svc is libjitsi_tpu_torch.media_service()
        assert svc.registry.capacity == 16 and svc.device.type == "cpu"
        a = svc.create_media_stream()
        b = svc.create_media_stream("audio")
        answer = b.sdes.create_answer(a.sdes.create_offer())
        a.sdes.accept_answer(answer)
        a.set_remote_ssrc(b.local_ssrc)
        b.set_remote_ssrc(a.local_ssrc)
        a.start()
        b.start()
        wire = a.send([b"opus-frame"])
        assert b"opus-frame" not in wire[0]
        batch, ok = b.receive(wire)
        assert ok.tolist() == [True]
        assert batch.to_bytes(0)[12:] == b"opus-frame"
        assert a.stats["tx_packets"] == b.stats["rx_packets"] == 1
        assert isinstance(svc.create_media_stream("video"),
                          p_typed.VideoMediaStream)
        table = svc.encoding_configuration.assign_payload_types("audio")
        assert table[0].name == "PCMU"
        mixer = svc.audio_mixer(160)
        assert mixer.capacity == 16 and mixer.device.type == "cpu"
        cfg = libjitsi_tpu_torch.configuration_service()
        libjitsi_tpu_torch.init({"libjitsi_tpu.x": 1})    # merges
        assert cfg.get_int("libjitsi_tpu.x") == 1
        assert libjitsi_tpu_torch.resource_management_service() is \
            libjitsi_tpu_torch.resource_management_service()
        res = libjitsi_tpu_torch.resource_management_service()
        res.register("k", 5)
        assert res.get_setting("k") == 5 and res.get_string("k") == "5"
        assert res.get_string("none") is None
        # the device layer: the registry, the mixer as a capture device
        # (on the 160-sample mixer above) and the notifier on it
        ds = svc.device_system
        assert ds is svc.device_system
        assert ds.audio.selected_device(p_dev.DataFlow.PLAYBACK).name == \
            "null"
        mixdev = svc.audio_mixer_device(160)
        assert mixdev is svc.audio_mixer_device(160)
        assert mixdev.mixer is mixer
        with pytest.raises(ValueError, match="frame_samples"):
            svc.audio_mixer_device(960)
        notifier = libjitsi_tpu_torch.audio_notifier_service()
        assert notifier is libjitsi_tpu_torch.audio_notifier_service()
        assert notifier.play(duration_s=0.01).shape == (480,)
    finally:
        libjitsi_tpu_torch.stop()


def test_file_access_service(tmp_path):
    cfg = p_config.ConfigurationService(
        {"libjitsi_tpu.data_dir": str(tmp_path / "data")})
    fa = p_aux.FileAccessService(cfg)
    path = fa.get_private_file("sub/x.bin")
    assert path.startswith(fa.data_dir) and (tmp_path / "data" / "sub").is_dir()
    with pytest.raises(ValueError):
        fa.get_private_file("../escape")
    assert fa.create_temp_file(".pcap").endswith(".pcap")


def test_card_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    libjitsi_tpu_torch.stop()
    try:
        libjitsi_tpu_torch.init()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            libjitsi_tpu_torch.media_service()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MediaService(p_config.ConfigurationService())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_ms.StreamRegistry(4)
    finally:
        libjitsi_tpu_torch.stop()


@pytest.mark.slow
def test_media_stream_pair_follows_whole_jax_pair():
    """The JAX pair on its own (jitted) SRTP tables."""
    port = _drive(P, CM80)[0]
    jax = _drive(J, CM80, jax_srtp=True)[0]
    for key in port:
        assert port[key] == jax[key], key
