"""The port's conference recorder (`libjitsi_tpu_torch/recording/
recorder.py`) against the JAX package's, on the CPU.

The recorder cases of JAX `tests/test_speaker_jb_rec.py` run on both
packages with the wall clock of both modules pinned to one fake clock:
the rtpdump files must be the same bytes and the event timeline the same
JSON; the mixed-audio WAV the same file; the `Synchronizer` the same wall
times from the same sender reports (the port's `SenderReport` and the
JAX one built from one set of fields); and a `ConferenceBridge` of the
port hands its dominant-speaker changes to its recorder.  Tolerance:
exact equality.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest

from libjitsi_tpu.recording import recorder as jrec
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu_torch.io.pcap import RtpdumpReader
from libjitsi_tpu_torch.recording import recorder as prec
from libjitsi_tpu_torch.rtp import rtcp as p_rtcp


def _clock(monkeypatch):
    t = types.SimpleNamespace(now=1_700_000_000.25)

    def tick():
        t.now += 0.125
        return t.now

    fake = types.SimpleNamespace(time=tick)
    for mod in (jrec, prec):
        monkeypatch.setattr(mod, "time", fake)
    return t


def _files(d):
    """Every file the recorder wrote, then the directory is removed: both
    packages record into the same path (the timeline names its files)."""
    out = {n: open(os.path.join(d, n), "rb").read()
           for n in sorted(os.listdir(d))}
    shutil.rmtree(d)
    return out


def test_recorder_rtpdump_and_events_equal_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(4)
    pkts = [b"\x80\x00" + bytes([i]) * 16 for i in range(3)] + \
        [rng.bytes(int(n)) for n in rng.integers(12, 200, 5)]
    got = {}
    for name, mod in (("jax", jrec), ("port", prec)):
        _clock(monkeypatch)
        d = str(tmp_path / "rec")
        r = mod.Recorder(d)
        for i, p in enumerate(pkts):
            r.write_rtp(0xABC if i < 3 else 0x1234_5678, p,
                        ts=r._started + 0.02 * i)
        r.write_rtp(0xFFFF_FFFF + 1, pkts[0], ts=r._started + 1.0)  # 32 bits
        r.on_speaker_change(0xABC)
        r.on_speaker_change(0x1234_5678)
        meta = r.close()
        back = [p for _o, p in RtpdumpReader(os.path.join(
            d, "00000abc.rtpdump"))]
        got[name] = (json.load(open(meta)), _files(d), back)
    assert got["port"] == got["jax"]
    meta, files, back = got["port"]
    assert back == pkts[:3] and len(files) == 4
    assert [e["type"] for e in meta["events"]] == [
        "RECORDING_STARTED", "STREAM_STARTED", "STREAM_STARTED",
        "STREAM_STARTED", "SPEAKER_CHANGED", "SPEAKER_CHANGED",
        "RECORDING_ENDED"]


def test_recorder_mixed_audio_wav_equals_jax(monkeypatch, tmp_path):
    tone = (3000 * np.sin(2 * np.pi * 440 / 8000
                          * np.arange(8000))).astype(np.int16)
    got = {}
    for name, mod in (("jax", jrec), ("port", prec)):
        _clock(monkeypatch)
        d = str(tmp_path / "conf")
        rec = mod.Recorder(d)
        rec.enable_audio(sample_rate=8000)
        for k in range(0, 8000, 160):
            rec.write_mixed_audio(tone[k:k + 160])
        with pytest.raises(ValueError):
            rec.write_mixed_audio(tone[:320].reshape(2, 160))
        with pytest.raises(TypeError):
            rec.write_mixed_audio(tone[:160].astype(np.int32))
        rec.close()
        got[name] = _files(d)
    assert got["port"] == got["jax"]
    import io
    import wave

    with wave.open(io.BytesIO(got["port"]["conference.wav"]), "rb") as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == \
            (1, 8000, 8000)
        assert np.array_equal(np.frombuffer(w.readframes(8000), "<i2"), tone)


def test_synchronizer_equals_jax():
    fields = dict(ssrc=7, ntp_sec=1000 + 2208988800, ntp_frac=1 << 31,
                  rtp_ts=48000, packet_count=10, octet_count=1000)
    sync = {"jax": jrec.Synchronizer(), "port": prec.Synchronizer()}
    sync["jax"].on_sender_report(7, j_rtcp.SenderReport(**fields, reports=[]),
                                 48000)
    sync["port"].on_sender_report(7, p_rtcp.SenderReport(**fields,
                                                         reports=[]), 48000)
    for ts in (48000, 96000, 24000, 0, 0xFFFF_FF00, 2 ** 31 + 48000):
        assert sync["port"].wall_time(7, ts) == sync["jax"].wall_time(7, ts)
    assert abs(sync["port"].wall_time(7, 96000) - 1001.5) < 1e-6
    assert sync["port"].wall_time(99, 0) is None is sync["jax"].wall_time(
        99, 0)


def test_conference_bridge_tells_its_recorder(tmp_path):
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    rec = prec.Recorder(str(tmp_path / "conf"))
    bridge = ConferenceBridge(port=0, capacity=4, recorder=rec, device="cpu")
    try:
        keys = ((b"\x01" * 16, b"\x02" * 14), (b"\x03" * 16, b"\x04" * 14))
        bridge.add_participant(0x99, *keys)
        bridge._speaker_changed(0)
        bridge._speaker_changed(3)           # a row without an SSRC
    finally:
        bridge.close()
    assert [(e["type"], e.get("ssrc")) for e in rec._events] == [
        ("RECORDING_STARTED", None), ("SPEAKER_CHANGED", 0x99)]
    assert bridge.speaker_events == [(0, 0), (0, 3)]
