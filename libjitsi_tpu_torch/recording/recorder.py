"""Conference recording (reference:
`org.jitsi.impl.neomedia.recording.{RecorderImpl,RecorderRtpImpl,
SynchronizerImpl,RecorderEventHandlerJSONImpl}`).

Per-SSRC RTP is sunk to rtpdump files (the framework's fixture format —
replayable through RtpdumpReader), a JSON event timeline records
start/stop/speaker changes, and `Synchronizer` rebuilds cross-stream
wall-clock alignment from RTCP SR NTP<->RTP mappings so offline muxing
can align audio and video that started at different times.

Counterpart: `libjitsi_tpu/recording/recorder.py` (copied, with the
port's imports: `io.pcap.RtpdumpWriter`, `rtp.stats.NTP_EPOCH_OFFSET`).
Host only.  The VP8 WebM writer is `recording/webm.py`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from libjitsi_tpu_torch.io.pcap import RtpdumpWriter
from libjitsi_tpu_torch.rtp.rtcp import SenderReport
from libjitsi_tpu_torch.rtp.stats import NTP_EPOCH_OFFSET


class Synchronizer:
    """RTP timestamp -> wall clock, per SSRC (reference: SynchronizerImpl).

    Each RTCP SR carries (NTP time, RTP ts) for its stream; with one SR
    seen, any RTP ts maps to wall time by clock-rate extrapolation.
    """

    def __init__(self):
        self._map: Dict[int, tuple] = {}  # ssrc -> (unix_time, rtp_ts, rate)

    def on_sender_report(self, ssrc: int, sr: SenderReport,
                         clock_rate: int) -> None:
        unix = sr.ntp_sec - NTP_EPOCH_OFFSET + sr.ntp_frac / (1 << 32)
        self._map[ssrc & 0xFFFFFFFF] = (unix, sr.rtp_ts, clock_rate)

    def wall_time(self, ssrc: int, rtp_ts: int) -> Optional[float]:
        m = self._map.get(ssrc & 0xFFFFFFFF)
        if m is None:
            return None
        unix, base_ts, rate = m
        # signed 32-bit wrap distance
        d = (rtp_ts - base_ts) & 0xFFFFFFFF
        if d >= 1 << 31:
            d -= 1 << 32
        return unix + d / rate


class WavWriter:
    """Streaming PCM16 WAV sink over the stdlib `wave` module (mono by
    default; the mixer's interchange format).

    Reference: RecorderImpl's mixed-audio file output — the conference
    mix (`AudioMixer.mix()` rows or the total sum) lands in a standard
    RIFF/WAVE file, header sizes patched on close.
    """

    def __init__(self, path: str, sample_rate: int = 48000,
                 channels: int = 1):
        import wave

        self.path = path
        self.channels = channels
        self._w = wave.open(path, "wb")
        self._w.setnchannels(channels)
        self._w.setsampwidth(2)
        self._w.setframerate(sample_rate)

    def write(self, pcm) -> None:
        """Append int16 samples ([N] mono or [N, channels])."""
        import numpy as _np

        arr = _np.asarray(pcm)
        if arr.dtype != _np.int16:
            raise TypeError(f"WAV sink wants int16 PCM, got {arr.dtype}")
        if self.channels == 1:
            if arr.ndim != 1:       # a [S, F] mix matrix would silently
                raise ValueError(   # interleave into garbage audio
                    f"mono WAV sink wants [N] samples, got {arr.shape}")
        elif arr.ndim != 2 or arr.shape[1] != self.channels:
            raise ValueError(
                f"want [N, {self.channels}] samples, got {arr.shape}")
        self._w.writeframesraw(arr.astype("<i2").tobytes())

    def close(self) -> str:
        self._w.close()
        return self.path


class Recorder:
    """Record per-SSRC RTP to rtpdump + JSON event timeline, plus an
    optional mixed-audio WAV (reference: RecorderImpl records the
    conference audio to files, not just packets)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.sync = Synchronizer()
        self._writers: Dict[int, RtpdumpWriter] = {}
        self._wav: Optional[WavWriter] = None
        self._events: List[dict] = []
        self._started = time.time()
        self._event("RECORDING_STARTED")

    def _event(self, kind: str, **fields) -> None:
        self._events.append(
            {"type": kind, "instant": time.time(), **fields})

    def _writer(self, ssrc: int) -> RtpdumpWriter:
        w = self._writers.get(ssrc)
        if w is None:
            path = os.path.join(self.directory, f"{ssrc:08x}.rtpdump")
            w = RtpdumpWriter(path, start=self._started)
            self._writers[ssrc] = w
            self._event("STREAM_STARTED", ssrc=ssrc, filename=path)
        return w

    def write_rtp(self, ssrc: int, packet: bytes,
                  ts: Optional[float] = None) -> None:
        self._writer(ssrc & 0xFFFFFFFF).write(packet, ts)

    def write_batch(self, batch, ssrcs, ts: Optional[float] = None) -> None:
        for i in range(batch.batch_size):
            self.write_rtp(int(ssrcs[i]), batch.to_bytes(i), ts)

    def on_sender_report(self, ssrc: int, sr: SenderReport,
                         clock_rate: int) -> None:
        self.sync.on_sender_report(ssrc, sr, clock_rate)

    def on_speaker_change(self, ssrc: int) -> None:
        """Reference: the recorder logs active-speaker events so playback
        can follow the dominant speaker."""
        self._event("SPEAKER_CHANGED", ssrc=ssrc)

    # -------------------------------------------------------- mixed audio
    def enable_audio(self, sample_rate: int = 48000,
                     filename: str = "conference.wav") -> None:
        """Open the mixed-audio WAV sink (one mono track: the
        conference sum — feed `write_mixed_audio` once per mix tick)."""
        if self._wav is None:
            path = os.path.join(self.directory, filename)
            self._wav = WavWriter(path, sample_rate=sample_rate)
            self._event("AUDIO_RECORDING_STARTED", filename=path)

    def write_mixed_audio(self, pcm) -> None:
        """Append one mixed PCM frame (int16 [F]); no-op until
        `enable_audio`."""
        if self._wav is not None:
            self._wav.write(pcm)

    def close(self) -> str:
        for w in self._writers.values():
            w.close()
        if self._wav is not None:
            self._wav.close()
        self._event("RECORDING_ENDED")
        path = os.path.join(self.directory, "metadata.json")
        with open(path, "w") as f:
            json.dump({"events": self._events}, f, indent=2)
        return path
