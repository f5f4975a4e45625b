"""The port's host codec legs against the JAX package, on the CPU.

G.722: one stateful leg of each package (`g722_codec`) encodes and
decodes three consecutive 20 ms frames; the bytes and the PCM must be
equal, and so must the batched coders' at the three bit rates of the
decoder.  `codec_from_name` rebuilds the same legs as JAX's for PCMU,
PCMA, G722 and OPUS, and refuses GSM, Speex, G.729 and iLBC naming ROADMAP
item 9.  The Opus cases run where the system libopus loads, as
`tests/test_codecs.py` does.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from libjitsi_tpu.codecs import g722 as jg722
from libjitsi_tpu.codecs.opus import opus_available
from libjitsi_tpu.service import pump as jpump
from libjitsi_tpu_torch.codecs import (G722Decoder, G722Encoder,
                                       gsm_available, speex_available)
from libjitsi_tpu_torch.codecs import opus as popus
from libjitsi_tpu_torch.service import pump
from test_torch_threads import one_torch_thread  # noqa: F401

needs_opus = pytest.mark.skipif(not opus_available(),
                                reason="system libopus not available")


def _speech(n, seed):
    """Two tones and noise at 16 kHz, full scale at the peaks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (12000 * np.sin(2 * np.pi * 440 * t / 16000)
         + 9000 * np.sin(2 * np.pi * 3100 * t / 16000)
         + rng.normal(0, 3000, n))
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_g722_leg_bytes_equal_jax_over_consecutive_frames():
    legs = {"jax": jpump.g722_codec(), "port": pump.g722_codec()}
    for k in ("name", "pt", "sample_rate", "frame_samples", "ts_step"):
        assert getattr(legs["jax"], k) == getattr(legs["port"], k), k
    assert (legs["port"].sample_rate, legs["port"].ts_step) == (16000, 160)
    pcm = _speech(3 * 320, 1)
    for f in range(3):
        frame = pcm[f * 320:(f + 1) * 320]
        codes = {n: c.encode(frame) for n, c in legs.items()}
        assert codes["jax"] == codes["port"] and len(codes["port"]) == 160
        back = {n: c.decode(codes[n]) for n, c in legs.items()}
        assert np.array_equal(back["jax"], back["port"])
        assert back["port"].dtype == np.int16 and back["port"].shape == (320,)


@pytest.mark.parametrize("bits", [8, 7, 6])
def test_batched_g722_coders_equal_jax(bits):
    """Three streams at once, two frames each (the state carries over),
    and every code byte through the decoder at each mode."""
    pcm = np.stack([_speech(640, s) for s in range(3)])
    pcm[2, :40] = 32767                       # a row at the rail
    enc = {"jax": jg722.G722Encoder(3), "port": G722Encoder(3)}
    dec = {"jax": jg722.G722Decoder(3, bits), "port": G722Decoder(3, bits)}
    every = np.tile(np.arange(256, dtype=np.uint8), (3, 1))
    for half in (pcm[:, :320], pcm[:, 320:]):
        codes = {n: e.encode(half) for n, e in enc.items()}
        assert np.array_equal(codes["jax"], codes["port"])
        out = {n: d.decode(codes[n]) for n, d in dec.items()}
        assert np.array_equal(out["jax"], out["port"])
    out = {n: d.decode(every) for n, d in dec.items()}
    assert np.array_equal(out["jax"], out["port"])


@pytest.mark.parametrize("name", ["PCMU", "PCMA", "G722",
                                  pytest.param("OPUS", marks=needs_opus)])
def test_codec_from_name_matches_jax(name):
    j = jpump.codec_from_name(name, 20)
    p = pump.codec_from_name(name, 20, device="cpu")
    for k in ("name", "pt", "sample_rate", "frame_samples", "ts_step"):
        assert getattr(j, k) == getattr(p, k), (name, k)
    # fresh legs: the same first frame gives the same bytes and PCM
    # (libopus is deterministic)
    frame = _speech(p.frame_samples, 7)
    codes = j.encode(frame)
    assert codes == p.encode(frame)
    assert np.array_equal(j.decode(codes), p.decode(codes))


@pytest.mark.parametrize("name", ["GSM", "speex", "speex/16000", "G729",
                                  "iLBC"])
def test_codec_from_name_refuses_legs_not_ported(name):
    """G.729 and iLBC are refused naming item 9; GSM and Speex are ported
    and rebuild as the JAX legs do (where their libraries load)."""
    if name in ("G729", "iLBC"):
        with pytest.raises(NotImplementedError, match="item 9"):
            pump.codec_from_name(name, 20)
    else:
        if not (gsm_available() if name == "GSM" else speex_available()):
            pytest.skip(f"no system library for {name}")
        p, j = pump.codec_from_name(name, 20), jpump.codec_from_name(name, 20)
        for k in ("name", "pt", "sample_rate", "frame_samples", "ts_step"):
            assert getattr(j, k) == getattr(p, k), (name, k)
    with pytest.raises(ValueError, match="cannot rebuild"):
        pump.codec_from_name("L16", 20)


@needs_opus
def test_opus_leg_equals_jax_frame_by_frame():
    """Three frames through each package's Opus leg: the same packets and
    the same decoded PCM, then a concealed frame (`decode(None)`)."""
    from libjitsi_tpu.codecs.opus import OpusDecoder as JDec

    legs = {"jax": jpump.opus_codec(), "port": pump.opus_codec()}
    t = np.arange(3 * 960)
    pcm = (8000 * np.sin(2 * np.pi * 700 * t / 48000)).astype(np.int16)
    for f in range(3):
        frame = pcm[f * 960:(f + 1) * 960]
        pkt = {n: c.encode(frame) for n, c in legs.items()}
        assert pkt["jax"] == pkt["port"]
        back = {n: c.decode(pkt[n]) for n, c in legs.items()}
        assert np.array_equal(back["jax"], back["port"])
        assert back["port"].shape == (960,)
    decs = (JDec(48000, 1), popus.OpusDecoder(48000, 1))
    for d in decs:
        d.decode(pkt["port"], 960)
    plc = [d.decode(None, 960) for d in decs]
    assert np.array_equal(plc[0], plc[1]) and plc[1].shape == (960,)
