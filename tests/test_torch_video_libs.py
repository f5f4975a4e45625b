"""The port's libvpx and libavcodec bindings against the JAX package's.

Both packages bind the same system libraries through ctypes
(`codecs/vpx.py`, `codecs/avcodec.py`, `codecs/audio_avcodec.py`): the
same seeded frames (numpy) encode to the same VP8, VP9 and H.264
bitstreams, the same packets decode to the same planes, and the G.729 and
iLBC legs decode the same payloads to the same PCM.  Each case skips
where its library is missing, as the JAX tests do.  Tolerance: exact.
"""

import numpy as np
import pytest

import libjitsi_tpu.codecs.audio_avcodec as j_audio
import libjitsi_tpu.codecs.avcodec as j_av
import libjitsi_tpu.codecs.vpx as j_vpx
import libjitsi_tpu_torch.codecs.audio_avcodec as p_audio
import libjitsi_tpu_torch.codecs.avcodec as p_av
import libjitsi_tpu_torch.codecs.vpx as p_vpx

W, H = 64, 48


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = (np.add.outer(np.arange(H), np.arange(W)) * 2 + i * 9
             + rng.integers(0, 8, (H, W))).astype(np.uint8)
        u = np.full((H // 2, W // 2), 90 + i, np.uint8)
        v = np.full((H // 2, W // 2), 150 + i, np.uint8)
        out.append((y, u, v))
    return out


def _planes_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))


@pytest.mark.skipif(not p_vpx.vpx_available(), reason="libvpx not present")
@pytest.mark.parametrize("codec", ["vp8", "vp9"])
def test_vpx_encode_and_decode_follow_jax(codec):
    frames = _frames(5, 11)
    pkts = []
    for m in (j_vpx, p_vpx):
        enc = m.VpxEncoder(W, H, codec)
        out = []
        for y, u, v in frames:
            out += enc.encode(y, u, v)
        out += enc.flush()
        enc.close()
        pkts.append(out)
    assert pkts[1] == pkts[0] and pkts[0][0][1]          # keyframe first
    decoded = []
    for m in (j_vpx, p_vpx):
        dec = m.VpxDecoder(codec)
        decoded.append([f for p, _ in pkts[0] for f in dec.decode(p)])
        dec.close()
    _planes_equal(decoded[1], decoded[0])
    assert len(decoded[0]) == len(frames)


@pytest.mark.skipif(not p_av.h264_available(),
                    reason="libavcodec/libx264 not present")
def test_h264_encode_and_decode_follow_jax():
    frames = _frames(4, 12)
    aus = []
    for m in (j_av, p_av):
        enc = m.H264Encoder(W, H, fps=30)
        out = []
        for y, u, v in frames:
            out += enc.encode(y, u, v)
        out += enc.flush()
        enc.close()
        aus.append(out)
    assert aus[1] == aus[0] and aus[0]
    decoded = []
    for m in (j_av, p_av):
        dec = m.H264Decoder()
        got = [f for au in aus[0] for f in dec.decode(au)] + dec.flush()
        dec.close()
        decoded.append(got)
    _planes_equal(decoded[1], decoded[0])
    assert len(decoded[0]) == len(frames)


@pytest.mark.parametrize("name,frame_bytes", [("g729", 10), ("ilbc", 38),
                                              ("g723_1", 24)])
def test_audio_decoders_follow_jax(name, frame_bytes):
    if not p_audio.audio_decoder_available(name):
        pytest.skip(f"libavcodec without the {name} decoder")
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, frame_bytes * k, np.uint8).tobytes()
                for k in (1, 2, 3)]
    if name == "g723_1":        # the 6.3 kbit/s frame type in each frame
        payloads = [bytes(b & ~3 if i % 24 == 0 else b
                          for i, b in enumerate(p)) for p in payloads]
    if name == "g729":
        payloads.append(payloads[0] + b"\x11\x22")          # + a SID
    pcm = []
    for m in (j_audio, p_audio):
        d = m.AvAudioDecoder(name)
        pcm.append([d.decode_payload(p) for p in payloads])
        assert d.sample_rate == 8000
        d.close()
    assert all(np.array_equal(a, b) for a, b in zip(pcm[0], pcm[1]))
    assert sum(len(x) for x in pcm[1]) > 0
    # both refuse the same things
    for bad in ((name, b"\x01"),):
        errs = []
        for m in (j_audio, p_audio):
            try:
                m.AvAudioDecoder(bad[0]).decode_payload(bad[1])
                errs.append(None)
            except Exception as e:           # noqa: BLE001
                errs.append((type(e), str(e)))
        assert errs[0] == errs[1]
    for m in (j_audio, p_audio):
        with pytest.raises(ValueError):
            m.AvAudioDecoder("opus")
        with pytest.raises(RuntimeError, match="30 ms"):
            m.AvAudioDecoder("ilbc", ilbc_mode_ms=30)


def test_missing_decoder_raises_the_jax_error(monkeypatch):
    """A libavcodec built without a decoder: both bindings refuse the leg
    with the same `RuntimeError`."""
    try:
        av, u = p_av._load()
    except OSError:
        pytest.skip("libavcodec not present")

    class NoDecoders:
        def __getattr__(self, n):
            return getattr(av, n)

        @staticmethod
        def avcodec_find_decoder_by_name(name):
            return None

    errs = []
    for m in (j_audio, p_audio):
        monkeypatch.setattr(m, "_load", lambda: (NoDecoders(), u))
        with pytest.raises(RuntimeError) as e:
            m.AvAudioDecoder("g729")
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "g729 decoder not present in libavcodec"
