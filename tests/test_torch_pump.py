"""The port's media pumps against the JAX package's, on the CPU.

Twins of the 10 cases of `tests/test_pump.py`: device -> codec -> SRTP
stream -> jitter buffer -> decoder -> sink or mixer.  Each case runs the
same graph on both packages: stream pairs keyed by seeded SDES with
their SSRCs, seq and ts pinned, the JAX `StreamRegistry` on the port's
CPU SRTP tables (a JAX table compiles for over 30 s here; the tables are
held byte-equal by tests/test_torch_srtp_table.py), each package's own
sources, codecs, jitter buffer and mixer.  Every wire datagram, every
decoded or concealed frame, every captured mix-minus frame and every
counter (decoded, lost, PLC, decode errors, the jitter buffer's lost,
late and resets, the sink's samples) must be equal.  The three-party
conference also holds the JAX test's own invariant: each capture is the
exact clip of the other two parties' decoded frames.  GSM and Speex run
where their system libraries load; the G.729 and iLBC legs rebuild on
both packages' libavcodec bindings where it has their decoders.

Tolerance: exact equality.
"""

import types

import numpy as np
import pytest

from libjitsi_tpu import device as j_device
from libjitsi_tpu.codecs import g722 as j_g722
from libjitsi_tpu.conference.mixer import AudioMixer as JaxMixer
from libjitsi_tpu.control import sdes as j_sdes
from libjitsi_tpu.core import config as j_config
from libjitsi_tpu.service import media_stream as j_ms
from libjitsi_tpu.service import pump as j_pump
from libjitsi_tpu.service import typed_streams as j_typed
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu.utils import metrics as j_metrics
from libjitsi_tpu_torch import device as p_device
from libjitsi_tpu_torch.codecs import gsm_available, speex_available
from libjitsi_tpu_torch.conference.mixer import AudioMixer
from libjitsi_tpu_torch.control import sdes as p_sdes
from libjitsi_tpu_torch.service import media_stream as p_ms
from libjitsi_tpu_torch.service import pump as p_pump
from libjitsi_tpu_torch.service import typed_streams as p_typed
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from libjitsi_tpu_torch.utils import metrics as p_metrics
from test_torch_threads import one_torch_thread  # noqa: F401

CAP = 16
CM80 = "AES_CM_128_HMAC_SHA1_80"
# the two packages side by side; `g711` builds a PCMU/PCMA leg
P = types.SimpleNamespace(
    name="port", sdes=p_sdes, typed=p_typed, Profile=SrtpProfile,
    pump=p_pump, device=p_device, metrics=p_metrics,
    mixer=lambda f: AudioMixer(capacity=CAP, frame_samples=f, device="cpu"),
    g711=lambda ulaw=True: p_pump.g711_codec(ulaw, device="cpu"))
J = types.SimpleNamespace(
    name="jax", sdes=j_sdes, typed=j_typed, Profile=JaxProfile,
    pump=j_pump, device=j_device, metrics=j_metrics,
    mixer=lambda f: JaxMixer(capacity=CAP, frame_samples=f),
    g711=lambda ulaw=True: j_pump.g711_codec(ulaw))


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda n: r.bytes(n)


def _registry(m, profile=CM80):
    """A registry of CAP rows on the CPU; the JAX one on the port's
    tables."""
    if m is P:
        return p_ms.StreamRegistry(CAP, device="cpu")
    reg = j_ms.StreamRegistry(j_config.ConfigurationService(), capacity=CAP)
    reg._srtp[JaxProfile(profile)] = (
        SrtpStreamTable(CAP, SrtpProfile(profile), "cpu"),
        SrtpStreamTable(CAP, SrtpProfile(profile), "cpu"))
    return reg


def _pair(m, reg, seed, profile=CM80):
    """Audio streams a -> b keyed by seeded SDES, SSRCs, seq and ts
    pinned (the first pairs' seq wraps mid-run; the RTP timestamps stay
    clear of their 32-bit wrap, which the jitter buffer reads as jitter
    in both packages: tests/test_torch_jitter_buffer.py)."""
    prof = m.Profile(profile)
    a = m.typed.AudioMediaStream(reg, profile=prof, local_ssrc=0xA0 + seed)
    b = m.typed.AudioMediaStream(reg, profile=prof, local_ssrc=0xB0 + seed)
    for k, s in enumerate((a, b)):
        s.sdes = m.sdes.SdesControl(profiles=[prof],
                                    rng=_rng(2 * seed + k))
        s._tx_seq = (65_533 + 977 * seed) & 0xFFFF
        s._tx_ts = 0x1000_0000 * (seed % 8) + 3 * seed
    a.sdes.accept_answer(b.sdes.create_answer(a.sdes.create_offer()))
    a.set_remote_ssrc(b.local_ssrc)
    b.set_remote_ssrc(a.local_ssrc)
    a.start()
    b.start()
    return a, b


def _counters(rx):
    return (rx.decoded_frames, rx.lost_frames, rx.plc_frames,
            rx.decode_errors, rx.jb.lost, rx.jb.late_dropped, rx.jb.resets,
            rx.jb.target_delay)


def _both(fn):
    """`fn(m)` on each package: the port's result and the JAX one's."""
    return [fn(m) for m in (P, J)]


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


# --------------------------------------------------------------- cases

def test_send_pump_produces_protected_rtp():
    def run(m):
        a, b = _pair(m, _registry(m), 0)
        pump = m.pump.SendPump(a, m.device.ToneSource(440.0,
                                                      sample_rate=8000),
                               m.g711())
        wire = [pump.tick() for _ in range(3)]
        oks = [list(b.receive(w)[1]) for w in wire]
        return wire, oks

    (pw, pok), (jw, jok) = _both(run)
    assert all(len(w) == 1 and len(w[0]) == 12 + 160 + 10 for w in pw)
    assert pok == jok == [[True]] * 3
    assert pw == jw


def test_send_receive_pump_g722_roundtrip():
    """G.722 (stateful sub-band ADPCM) through both pumps into a NullSink;
    6 ticks (the host coder costs ~0.1 s a frame here)."""
    frames = 6

    def run(m):
        a, b = _pair(m, _registry(m), 1)
        tx = m.pump.SendPump(a, m.device.ToneSource(800.0,
                                                    sample_rate=16000),
                             m.pump.g722_codec())
        sink = m.device.NullSink()
        rx = m.pump.ReceivePump(b, m.pump.g722_codec(), sink=sink)
        t, wire, pcm = 1000.0, [], []
        for _ in range(frames):
            wire.append(tx.tick())
            rx.push(wire[-1], now=t)
            pcm.append(rx.tick(now=t))      # zero target delay: due at once
            t += 0.020
        return wire, pcm, _counters(rx), sink.samples_written

    port, jax = _both(run)
    assert all(p.shape == (320,) for p in port[1])
    assert port[2][:2] == (frames, 0) and port[3] == frames * 320
    assert _equal(port, jax)


def test_pump_loss_plays_silence_and_recovers():
    def run(m):
        a, b = _pair(m, _registry(m), 2)
        tx = m.pump.SendPump(a, m.device.ToneSource(440.0,
                                                    sample_rate=8000),
                             m.g711())
        rx = m.pump.ReceivePump(b, m.g711())
        t = 1000.0
        frames = [tx.tick() for _ in range(6)]
        for i, f in enumerate(frames):
            if i != 2:                      # one packet lost in transit
                rx.push(f, now=t + 0.001 * i)
        outs = [rx.tick(now=t + 0.5 + 0.020 * i) for i in range(6)]
        return frames, outs, _counters(rx)

    port, jax = _both(run)
    assert port[2][0] == 5                  # decoded
    assert sum(not o.any() for o in port[1]) >= 1   # the gap: silence
    assert port[2][4] == 1                  # the jitter buffer's loss
    assert _equal(port, jax)


def test_conference_via_pumps_three_parties():
    """Three parties: send pumps -> receive pumps -> the mixer as a
    capture device; each hears the other two, the exact clip."""
    freqs = {0: 350.0, 1: 800.0, 2: 1300.0}

    def run(m):
        reg = _registry(m)
        mixdev = m.device.AudioMixerMediaDevice(m.mixer(160))
        pairs = {}
        for sid, f in freqs.items():
            s, r = _pair(m, reg, 3 + sid)
            tx = m.pump.SendPump(s, m.device.ToneSource(f, sample_rate=8000),
                                 m.g711())
            rx = m.pump.ReceivePump(r, m.g711(), mixer=mixdev,
                                    mixer_sid=sid)
            mixdev.add_participant(sid)
            pairs[sid] = (tx, rx)
        caps = {sid: mixdev.capture_for(sid) for sid in freqs}
        t, wire = 1000.0, []
        decoded = {sid: [] for sid in freqs}
        levels = []
        for _ in range(5):
            for sid, (tx, rx) in pairs.items():
                wire.append(tx.tick())
                rx.push(wire[-1], now=t)
                decoded[sid].append(rx.tick(now=t))
            levels.append(mixdev.tick()[1][:3])
            t += 0.020
        got = {sid: np.concatenate([caps[sid].read(160) for _ in range(5)])
               for sid in freqs}
        return wire, decoded, got, levels

    port, jax = _both(run)
    _, decoded, got, _ = port
    for sid in freqs:
        want = []
        for i in range(5):
            tot = sum(decoded[s][i].astype(np.int64) for s in freqs)
            want.append(np.clip(tot - decoded[sid][i], -32768, 32767))
        assert np.array_equal(got[sid].astype(np.int64),
                              np.concatenate(want))
    assert _equal(port, jax)


def test_pump_gsm_and_speex_roundtrip():
    cases = []
    if gsm_available():
        cases.append(("gsm", lambda m: m.pump.gsm_codec(), 8000, 160))
    if speex_available():
        cases.append(("speex", lambda m: m.pump.speex_codec("wb"), 16000,
                      320))
    if not cases:
        pytest.skip("no gsm/speex libs present")
    for name, make, rate, n in cases:
        def run(m):
            a, b = _pair(m, _registry(m), 6)
            tx = m.pump.SendPump(a, m.device.ToneSource(
                440.0, sample_rate=rate), make(m))
            rx = m.pump.ReceivePump(b, make(m), sink=m.device.NullSink())
            t, wire, pcm = 2000.0, [], []
            for _ in range(5):
                wire.append(tx.tick())
                rx.push(wire[-1], now=t)
                pcm.append(rx.tick(now=t))
                t += 0.020
            return wire, pcm, _counters(rx)

        port, jax = _both(run)
        assert all(p.shape == (n,) for p in port[1]), name
        assert port[2][0] == 5, name
        # the stream's tail carries real audio (codec warm-up aside)
        assert np.abs(port[1][-1].astype(np.int32)).max() > 200, name
        assert _equal(port, jax), name


def test_pump_survives_malformed_payload():
    """An authenticated but malformed payload plays silence and counts a
    decode error; the pump's metrics export it."""
    if not gsm_available():
        pytest.skip("no libgsm")

    def run(m):
        a, b = _pair(m, _registry(m), 7)
        rx = m.pump.ReceivePump(b, m.pump.gsm_codec())
        wire = a.send([b"\x01" * 32], pt=3)    # not a multiple of 33 B
        rx.push(wire, now=70.0)
        pcm = rx.tick(now=71.0)
        reg = m.metrics.MetricsRegistry()
        rx.register_metrics(reg)
        return wire, pcm, _counters(rx), reg.render()

    port, jax = _both(run)
    assert not port[1].any() and port[2][3] == 1
    assert "rx_pump_decode_errors" in port[3]
    assert _equal(port, jax)


def test_receive_pump_clamps_oversize_payload():
    """Over-long payloads from a remote peer are clamped to one ptime
    before the mixer deposit."""
    def run(m):
        a, b = _pair(m, _registry(m), 8)
        mixdev = m.device.AudioMixerMediaDevice(m.mixer(160))
        mixdev.add_participant(0)
        mixdev.add_participant(1)
        rx = m.pump.ReceivePump(b, m.g711(), mixer=mixdev, mixer_sid=0)
        wire = a.send([b"\xff" * 200], pt=0)   # 200 > 160 samples
        rx.push(wire, now=50.0)
        pcm = rx.tick(now=51.0)
        out, levels = mixdev.tick()
        return wire, pcm, out[:2], levels[:2]

    port, jax = _both(run)
    assert port[1].shape == (160,)
    assert _equal(port, jax)


def test_send_pump_rejects_rate_mismatch():
    for m in (P, J):
        a, _ = _pair(m, _registry(m), 9)
        with pytest.raises(ValueError):
            m.pump.SendPump(a, m.device.ToneSource(440.0, sample_rate=48000),
                            m.g711())


def test_g722_pump_codec_is_stateful_across_frames():
    """The leg's coder carries its state: two frames encode as one
    continuous encode of both, and decode alike, equal to JAX's."""
    from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder

    pcm = np.random.default_rng(3).integers(-8000, 8000, 640,
                                            dtype=np.int16)
    c, jc = p_pump.g722_codec(), j_pump.g722_codec()
    f1, f2 = c.encode(pcm[:320]), c.encode(pcm[320:])
    assert (f1, f2) == (jc.encode(pcm[:320]), jc.encode(pcm[320:]))
    ref = G722Encoder(1).encode(pcm.reshape(1, -1))[0].tobytes()
    assert f1 + f2 == ref
    assert f2 != j_g722.encode(pcm[320:])   # reset-per-frame is wrong
    d, jd = p_pump.g722_codec(), j_pump.g722_codec()
    out = np.concatenate([d.decode(f1), d.decode(f2)])
    assert np.array_equal(out, np.concatenate([jd.decode(f1),
                                               jd.decode(f2)]))
    refd = G722Decoder(1).decode(
        np.frombuffer(ref, np.uint8).reshape(1, -1))[0]
    assert np.array_equal(out, refd)


def test_codec_from_name_rebuilds_receive_only_legs():
    """G.729 and iLBC rebuild on both packages' libavcodec bindings with
    the same geometry, decode the same payload alike and refuse to encode
    (or, where libavcodec lacks the decoder, both raise the JAX binding's
    error); GSM and Speex rebuild on both with the same geometry and code
    the same frame alike."""
    from libjitsi_tpu_torch.codecs.audio_avcodec import \
        audio_decoder_available

    payload = {"G729": bytes(range(20)), "iLBC": bytes(range(38))}
    for name in ("G729", "iLBC"):
        if not audio_decoder_available(name.lower()):
            for m in (P, J):
                with pytest.raises((RuntimeError, OSError)):
                    m.pump.codec_from_name(name, 20)
            continue
        p, j = (m.pump.codec_from_name(name, 20) for m in (P, J))
        assert (p.name, p.pt, p.sample_rate, p.frame_samples, p.ts_step) \
            == (j.name, j.pt, j.sample_rate, j.frame_samples, j.ts_step)
        assert np.array_equal(p.decode(payload[name]),
                              j.decode(payload[name]))
        with pytest.raises(RuntimeError, match="receive-only"):
            p.encode(np.zeros(160, np.int16))
    names = (["GSM"] if gsm_available() else []) + \
        (["speex", "speex/16000", "speex/32000"] if speex_available()
         else [])
    for name in names:
        p, j = (m.pump.codec_from_name(name, 20) for m in (P, J))
        assert (p.name, p.pt, p.sample_rate, p.frame_samples, p.ts_step) \
            == (j.name, j.pt, j.sample_rate, j.frame_samples, j.ts_step)
        pcm = p_device.ToneSource(700.0, sample_rate=p.sample_rate).read(
            p.frame_samples)
        code = p.encode(pcm)
        assert code == j.encode(pcm)
        assert np.array_equal(p.decode(code), j.decode(code))
