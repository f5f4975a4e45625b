"""The port's synthetic device layer against the JAX package's, on the CPU.

Twins of the 15 cases of `tests/test_devices.py`: the sources (silence,
seeded noise, the phase-continuous tone, raw and WAV files looped and
padded), the sinks (raw, WAV, null), the audio system's device lists,
persisted selection, hotplug events and app devices kept across a
rescan, the paced and bounded rtpdump replay, IVF files, and
`AudioMixerMediaDevice` (the port's mixer on kernel E's plain version
here) with its bounded queues and exact mix-minus; the media service's
device system and mixer device.  Every sample, byte, event, name and
counter must equal the JAX package's for the same inputs, and files one
package writes read the same in the other.

Tolerance: exact equality.
"""

import numpy as np
import pytest

import libjitsi_tpu
import libjitsi_tpu_torch
from libjitsi_tpu import device as j_dev
from libjitsi_tpu.conference import AudioMixer as JaxMixer
from libjitsi_tpu.core.config import ConfigurationService as JaxConfig
from libjitsi_tpu.io import pcap as j_pcap
from libjitsi_tpu_torch import device as p_dev
from libjitsi_tpu_torch.conference.mixer import AudioMixer
from libjitsi_tpu_torch.core.config import ConfigurationService
from libjitsi_tpu_torch.io import pcap as p_pcap
from test_torch_threads import one_torch_thread  # noqa: F401

# (device module, config class, mixer factory, pcap module)
PKGS = ((p_dev, ConfigurationService,
         lambda c, f: AudioMixer(capacity=c, frame_samples=f, device="cpu"),
         p_pcap),
        (j_dev, JaxConfig,
         lambda c, f: JaxMixer(capacity=c, frame_samples=f), j_pcap))


def _both(fn):
    return [fn(*pkg) for pkg in PKGS]


def test_silence_and_noise_sources():
    def run(d, *_):
        assert not d.SilenceSource().read(480).any()
        a = d.NoiseSource(seed=7).read(480)
        assert np.array_equal(a, d.NoiseSource(seed=7).read(480))
        assert a.dtype == np.int16 and a.any()
        return a, d.NoiseSource(seed=8, amplitude=0.9).read(1000)

    (pa, pb), (ja, jb) = _both(run)
    assert np.array_equal(pa, ja) and np.array_equal(pb, jb)


def test_tone_source_is_phase_continuous():
    def run(d, *_):
        src = d.ToneSource(1000.0, amplitude=0.5, sample_rate=48000)
        chunks = np.concatenate([src.read(160) for _ in range(6)])
        whole = d.ToneSource(1000.0, amplitude=0.5,
                             sample_rate=48000).read(960)
        assert np.array_equal(chunks, whole)
        spec = np.abs(np.fft.rfft(whole.astype(np.float64)))
        assert abs(np.argmax(spec[1:]) + 1 - round(1000 * 960 / 48000)) <= 1
        odd = d.ToneSource(437.3, amplitude=0.9, sample_rate=8000)
        return whole, np.concatenate([odd.read(k) for k in (1, 7, 160, 333)])

    port, jax = _both(run)
    assert all(np.array_equal(p, j) for p, j in zip(port, jax))


def test_pcm_file_source_raw_loop_and_pad(tmp_path):
    pcm = np.arange(-100, 100, dtype=np.int16)
    p = tmp_path / "a.pcm"
    p.write_bytes(pcm.tobytes())

    def run(d, *_):
        got = d.PcmFileSource(str(p)).read(300)
        assert np.array_equal(got[:200], pcm) and not got[200:].any()
        looped = d.PcmFileSource(str(p), loop=True)
        out = [looped.read(k) for k in (500, 17, 399)]
        assert np.array_equal(out[0][:400], np.tile(pcm, 2))
        empty = tmp_path / "e.pcm"
        empty.write_bytes(b"")
        return got, out, d.PcmFileSource(str(empty), loop=True).read(5)

    port, jax = _both(run)
    assert np.array_equal(port[0], jax[0]) and np.array_equal(port[2],
                                                              jax[2])
    assert all(np.array_equal(a, b) for a, b in zip(port[1], jax[1]))


def test_wav_roundtrip(tmp_path):
    """A WAV each package writes reads back the same in both, and a
    stereo file downmixes alike."""
    import wave

    tone = p_dev.ToneSource(440.0, sample_rate=16000).read(1600)
    paths = []
    for k, (d, *_) in enumerate(PKGS):
        paths.append(str(tmp_path / f"t{k}.wav"))
        sink = d.WavFileSink(paths[-1], sample_rate=16000)
        sink.write(tone)
        sink.close()
        sink.close()                       # a second close does nothing
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    st = str(tmp_path / "stereo.wav")
    with wave.open(st, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(np.stack([tone[:800], tone[800:]], 1).astype(
            "<i2").tobytes())
    for path in paths + [st]:
        srcs = [d.PcmFileSource(path) for d, *_ in PKGS]
        assert srcs[0].sample_rate == srcs[1].sample_rate
        got = [s.read(1600) for s in srcs]
        assert np.array_equal(got[0], got[1])
    assert np.array_equal(p_dev.PcmFileSource(paths[1]).read(1600), tone)


def test_pcm_sink_and_null_sink(tmp_path):
    def run(d, *_):
        path = str(tmp_path / f"o_{d.__name__}.pcm")
        s = d.PcmFileSink(path)
        s.write(np.array([1, -2, 3], dtype=np.int16))
        s.write(np.array([32767, -32768], dtype=np.int16))
        s.close()
        n = d.NullSink(sample_rate=8000)
        n.write(np.zeros(480, np.int16))
        n.write(np.zeros(7, np.int16))
        return open(path, "rb").read(), n.samples_written, n.sample_rate

    port, jax = _both(run)
    assert np.array_equal(np.frombuffer(port[0], "<i2"),
                          [1, -2, 3, 32767, -32768])
    assert port == jax and port[1] == 487


def test_audio_system_selection_persists():
    def run(d, cfg_cls, *_):
        cfg = cfg_cls()
        sys1 = d.AudioSystem(cfg)
        names = {f.value: [x.name for x in sys1.devices(f)]
                 for f in d.DataFlow}
        first = sys1.selected_device(d.DataFlow.CAPTURE).name
        sys1.set_selected_device(d.DataFlow.CAPTURE, "noise")
        restored = d.AudioSystem(cfg).selected_device(d.DataFlow.CAPTURE)
        with pytest.raises(KeyError):
            sys1.set_selected_device(d.DataFlow.CAPTURE, "no-such-mic")
        src = restored.create_source()
        with pytest.raises(ValueError):
            restored.create_sink()
        return (names, first, restored.name,
                cfg.get_string("libjitsi_tpu.devices.audio.capture"),
                src.read(64))

    port, jax = _both(run)
    assert port[0]["capture"] == ["silence", "tone:440", "noise"]
    assert port[1] == "silence" and port[2] == "noise"
    assert port[:4] == jax[:4] and np.array_equal(port[4], jax[4])


def test_hotplug_events_and_removal():
    def run(d, cfg_cls, *_):
        ds = d.DeviceSystem(cfg_cls())
        events = []
        ds.audio.add_listener(events.append)
        dev = d.MediaDevice("file:cap", "audio", "sendonly",
                            source_factory=d.SilenceSource)
        ds.audio.add_device(dev, d.DataFlow.CAPTURE)
        ds.audio.set_selected_device(d.DataFlow.CAPTURE, "file:cap")
        ds.audio.remove_device("file:cap", d.DataFlow.CAPTURE)
        after = ds.audio.selected_device(d.DataFlow.CAPTURE).name
        ds.reinitialize()
        return events, after, len(ds.audio.devices(d.DataFlow.CAPTURE))

    port, jax = _both(run)
    assert port == jax
    assert "added:capture:file:cap" in port[0]
    assert "removed:capture:file:cap" in port[0]
    assert port[0][-1] == "initialized" and port[1:] == ("silence", 3)


def test_hotplug_preserves_app_devices():
    def run(d, cfg_cls, *_):
        sys_ = d.AudioSystem(cfg_cls())
        dev = d.MediaDevice("file:cap", "audio", "sendonly",
                            source_factory=d.SilenceSource)
        sys_.add_device(dev, d.DataFlow.CAPTURE)
        sys_.set_selected_device(d.DataFlow.CAPTURE, "file:cap")
        sys_.initialize()                    # hotplug rescan
        return ([x.name for x in sys_.devices(d.DataFlow.CAPTURE)],
                sys_.selected_device(d.DataFlow.CAPTURE).name)

    port, jax = _both(run)
    assert port == jax
    assert "file:cap" in port[0] and port[1] == "file:cap"


def _rtpdump(pcap, path, offsets, start):
    w = pcap.RtpdumpWriter(path, start=start)
    for i, off in enumerate(offsets):
        w.write(bytes([0x80, 96, 0, i]) + b"\x00" * 8, ts=start + off)
    w.close()


def test_rtpdump_capture_device_paced_and_looped(tmp_path):
    p = str(tmp_path / "t.rtpdump")
    _rtpdump(p_pcap, p, [0.0, 0.020, 0.040], 100.0)

    def run(d, *_):
        dev = d.RtpdumpCaptureDevice(p)
        paced = [dev.due(now) for now in (0, 39, 1000, 2000)]
        dev.close()
        looped = d.RtpdumpCaptureDevice(p, loop=True)
        return paced, [looped.due(now) for now in (100, 140, 161, 400)]

    port, jax = _both(run)
    assert [[b[3] for b in x] for x in port[0]] == [[0], [1], [2], []]
    assert [b[3] for b in port[1][0]][:4] == [0, 1, 2, 0]
    assert port == jax


def test_rtpdump_loop_is_bounded(tmp_path):
    p = str(tmp_path / "t.rtpdump")
    _rtpdump(j_pcap, p, [0.0, 0.020, 0.040], 0.0)

    def run(d, *_):
        dev = d.RtpdumpCaptureDevice(p, loop=True, max_packets=10)
        return dev.due(10 ** 12), dev.due(10 ** 12)

    port, jax = _both(run)
    assert len(port[0]) == 10                # an absurd jump is bounded
    assert [b[3] for b in port[1]][:3] == [1, 2, 0]
    assert port == jax


def test_mixer_device_queue_bounded():
    def run(d, _cfg, mixer, _pcap):
        dev = d.AudioMixerMediaDevice(mixer(4, 160))
        dev.add_participant(0)
        dev.add_participant(1)
        for k in range(dev.MAX_QUEUED_FRAMES + 20):
            dev.push(1, np.full(160, k, np.int16))
            dev.tick()
        q = dev._out[0]
        dev.remove_participant(1)
        return len(q), [int(f[0]) for f in q], dev.pull_frame(1)

    port, jax = _both(run)
    assert port[0] == p_dev.AudioMixerMediaDevice.MAX_QUEUED_FRAMES
    assert port[1][0] == 20 and port[2] is None   # oldest dropped
    assert port == jax


def test_ivf_truncated_tail_dropped(tmp_path):
    p = str(tmp_path / "trunc.ivf")
    w = p_dev.IvfWriter(p, 64, 64)
    w.write(b"\xaa" * 30, 0)
    w.write(b"\xbb" * 40, 1)
    w.close()
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-25])     # cut mid-way through frame 1
    for d, *_ in PKGS:
        assert [(pts, f) for pts, f in d.IvfReader(p)] == [(0, b"\xaa" * 30)]


def test_ivf_roundtrip(tmp_path):
    frames = [(0, b"\x10" * 50), (1, b"\x20" * 9), (2, b"\x30" * 120)]
    paths = []
    for k, (d, *_) in enumerate(PKGS):
        paths.append(str(tmp_path / f"v{k}.ivf"))
        w = d.IvfWriter(paths[-1], 320, 240, fourcc=b"VP80",
                        timebase=(1, 30))
        for pts, data in frames:
            w.write(data, pts)
        w.close()
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for d, *_ in PKGS:
        r = d.IvfReader(paths[0])
        assert (r.width, r.height, r.fourcc, r.frame_count,
                r.tb_num, r.tb_den) == (320, 240, b"VP80", 3, 1, 30)
        assert [(pts, x) for pts, x in r] == frames
        r.close()
        bad = tmp_path / "bad.ivf"
        bad.write_bytes(b"nope")
        with pytest.raises(ValueError):
            d.IvfReader(str(bad))


def test_mixer_media_device_mix_minus():
    """Three noise sources through each package's mixer device: each
    capture is the exact clip of the other two, equal to JAX's; an empty
    queue pads silence."""
    F = 160

    def run(d, _cfg, mixer, _pcap):
        dev = d.AudioMixerMediaDevice(mixer(8, F))
        srcs = {sid: d.NoiseSource(seed=sid, amplitude=0.6)
                for sid in (0, 1, 2)}
        caps = {sid: dev.capture_for(sid) for sid in srcs}
        out = []
        for _ in range(3):
            frames = {sid: s.read(F) for sid, s in srcs.items()}
            for sid, f in frames.items():
                dev.push(sid, f)
            mixed, levels = dev.tick()
            total = sum(f.astype(np.int64) for f in frames.values())
            for sid in srcs:
                want = np.clip(total - frames[sid], -32768, 32767)
                got = caps[sid].read(F)
                assert np.array_equal(got, want.astype(np.int16))
                out.append(got)
            out.append(levels[:3])
        assert not caps[0].read(F).any()
        # a read straddling frames takes the queue's partial frames
        dev.push(1, np.ones(F, np.int16))
        dev.tick()
        dev.tick()
        out.append(caps[0].read(F + 40))
        return out

    port, jax = _both(run)
    assert all(np.array_equal(a, b) for a, b in zip(port, jax))


def test_media_service_exposes_devices():
    """`media_service()`'s device system and mixer device on both
    packages (the port's on `device="cpu"`), and the audio notifier on
    its NOTIFY device."""
    out = []
    for pkg, d, kw in ((libjitsi_tpu_torch, p_dev, {"device": "cpu"}),
                       (libjitsi_tpu, j_dev, {})):
        pkg.stop()
        pkg.init(**kw)
        try:
            svc = pkg.media_service()
            ds = svc.device_system
            assert ds is svc.device_system   # cached
            playback = ds.audio.selected_device(d.DataFlow.PLAYBACK).name
            mixdev = svc.audio_mixer_device(frame_samples=480)
            assert mixdev is svc.audio_mixer_device(frame_samples=480)
            mixdev.add_participant(0)
            mixdev.push(0, np.zeros(480, np.int16))
            o, levels = mixdev.tick()
            tone = pkg.audio_notifier_service().play(440.0, 0.01, 8000)
            out.append((playback, o.shape[1], int(levels[0]), tone))
        finally:
            pkg.stop()
    assert out[0][:3] == out[1][:3] == ("null", 480, 127)
    assert np.array_equal(out[0][3], out[1][3])
