"""Playback sinks — the server-side replacement for renderers.

Counterpart: `libjitsi_tpu/device/sinks.py` (copied; host code).

The reference renders audio through PortAudio/WASAPI/CoreAudio
`Renderer` plugins (SURVEY §2.5); on a server the "speaker" is a file,
a socket, or nothing.  Sinks accept mono int16 PCM via ``write(pcm)``.
"""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np


class AudioSink:
    sample_rate: int = 48000

    def write(self, pcm: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(AudioSink):
    """Discard (the reference's null renderer when no playback device)."""

    def __init__(self, sample_rate: int = 48000):
        self.sample_rate = sample_rate
        self.samples_written = 0

    def write(self, pcm: np.ndarray) -> None:
        self.samples_written += len(pcm)


class PcmFileSink(AudioSink):
    """Raw s16le file sink."""

    def __init__(self, path: str, sample_rate: int = 48000):
        self.sample_rate = sample_rate
        self._f = open(path, "wb")

    def write(self, pcm: np.ndarray) -> None:
        self._f.write(np.asarray(pcm, dtype="<i2").tobytes())

    def close(self) -> None:
        self._f.close()


class WavFileSink(AudioSink):
    """WAV file sink (16-bit mono) for human-auditable test output."""

    def __init__(self, path: str, sample_rate: int = 48000):
        self.sample_rate = sample_rate
        self._w: Optional[wave.Wave_write] = wave.open(path, "wb")
        self._w.setnchannels(1)
        self._w.setsampwidth(2)
        self._w.setframerate(sample_rate)

    def write(self, pcm: np.ndarray) -> None:
        self._w.writeframes(np.asarray(pcm, dtype="<i2").tobytes())

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
