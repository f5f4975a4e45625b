"""Synthetic capture sources — the server-side replacement for hardware.

Counterpart: `libjitsi_tpu/device/sources.py` (copied; host code, the
rtpdump replay on the port's `io/pcap.RtpdumpReader`).

The reference's L3 device layer (SURVEY §2.5) discovers microphones and
cameras through PortAudio/WASAPI/CoreAudio/V4L2 JNI backends; a server-side
TPU framework has none of those, so the survey's stated obligation is
"synthetic sources/sinks (file, PRNG, socket)".  The reference itself ships
the same idea as its CI/offline fixtures (SURVEY §4):

- `...jmfext.media.protocol.audiosilence.DataSource` — a silent capture
  device used when no hardware exists -> `SilenceSource`.
- `...jmfext.media.protocol.rtpdumpfile.DataSource` — plays recorded
  rtpdump traces as a fake capture device -> `RtpdumpCaptureDevice`.
- `...jmfext.media.protocol.ivffile.DataSource` — plays IVF (VP8) files as
  a fake camera -> `IvfReader` (+ `IvfWriter` to author fixtures).

Audio sources produce mono int16 PCM via ``read(n) -> np.ndarray [n]`` and
never block or run dry (silence-pad / loop), matching the reference's
capture `PushBufferStream.read(Buffer)` contract where a stalled device
pads silence rather than stalling the Processor graph.
"""

from __future__ import annotations

import struct
import wave
from typing import Iterator, List, Optional, Tuple

import numpy as np


class AudioSource:
    """Base: mono int16 PCM pull source."""

    sample_rate: int = 48000
    channels: int = 1

    def read(self, n: int) -> np.ndarray:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class SilenceSource(AudioSource):
    """All-zero PCM (reference: the `audiosilence` capture device)."""

    def __init__(self, sample_rate: int = 48000):
        self.sample_rate = sample_rate

    def read(self, n: int) -> np.ndarray:
        return np.zeros(n, dtype=np.int16)


class ToneSource(AudioSource):
    """Continuous-phase sine generator (test signal / notification tone).

    Stands in for the reference's `audionotifier` sound playback as a
    signal generator; also the standard SNR fixture for codec tests.
    """

    def __init__(self, freq_hz: float = 440.0, amplitude: float = 0.5,
                 sample_rate: int = 48000):
        self.freq_hz = float(freq_hz)
        self.amplitude = float(amplitude)
        self.sample_rate = sample_rate
        self._phase = 0.0

    def read(self, n: int) -> np.ndarray:
        w = 2.0 * np.pi * self.freq_hz / self.sample_rate
        t = self._phase + w * np.arange(n)
        self._phase = float((self._phase + w * n) % (2.0 * np.pi))
        return np.round(self.amplitude * 32767.0 * np.sin(t)).astype(np.int16)


class NoiseSource(AudioSource):
    """Seeded PRNG PCM (the survey's "PRNG source"); deterministic."""

    def __init__(self, seed: int = 0, amplitude: float = 0.25,
                 sample_rate: int = 48000):
        self._rng = np.random.default_rng(seed)
        self.amplitude = float(amplitude)
        self.sample_rate = sample_rate

    def read(self, n: int) -> np.ndarray:
        span = int(self.amplitude * 32767)
        return self._rng.integers(-span, span + 1, n).astype(np.int16)


class PcmFileSource(AudioSource):
    """Raw s16le or WAV file as a capture device; loops or silence-pads.

    The file analog of the reference's rtpdumpfile fixture for plain PCM:
    feed recorded audio through the pipeline without hardware.
    """

    def __init__(self, path: str, sample_rate: int = 48000,
                 loop: bool = False):
        self.loop = loop
        if path.endswith(".wav"):
            with wave.open(path, "rb") as w:
                if w.getsampwidth() != 2:
                    raise ValueError("only 16-bit WAV supported")
                self.sample_rate = w.getframerate()
                raw = w.readframes(w.getnframes())
                pcm = np.frombuffer(raw, dtype="<i2")
                if w.getnchannels() > 1:  # downmix to mono
                    pcm = pcm.reshape(-1, w.getnchannels()).mean(
                        axis=1).astype(np.int16)
        else:
            self.sample_rate = sample_rate
            pcm = np.fromfile(path, dtype="<i2")
        self._pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.int16)
        got = 0
        while got < n:
            avail = len(self._pcm) - self._pos
            if avail <= 0:
                if not self.loop or len(self._pcm) == 0:
                    break  # silence-pad the tail
                self._pos = 0
                continue
            take = min(n - got, avail)
            out[got:got + take] = self._pcm[self._pos:self._pos + take]
            self._pos += take
            got += take
        return out


class MixerCaptureSource(AudioSource):
    """A participant's mix-minus output as a capture source.

    Reference: `AudioMixerMediaDevice` presents the conference mix as a
    JMF capture device so a MediaStream can use the mix as its input;
    here the device/system.py AudioMixerMediaDevice deposits each tick's
    per-participant output and this source replays row `sid`.
    """

    def __init__(self, device, sid: int, sample_rate: int = 48000):
        self._device = device
        self.sid = sid
        self.sample_rate = sample_rate
        self._buf = np.zeros(0, dtype=np.int16)

    def read(self, n: int) -> np.ndarray:
        while len(self._buf) < n:
            frame = self._device.pull_frame(self.sid)
            if frame is None:
                break
            self._buf = np.concatenate([self._buf, frame])
        out = np.zeros(n, dtype=np.int16)
        take = min(n, len(self._buf))
        out[:take] = self._buf[:take]
        self._buf = self._buf[take:]
        return out


# ------------------------------------------------------------ rtpdump ----


class RtpdumpCaptureDevice:
    """Paced replay of an rtpdump trace as a packet capture device.

    Reference: `...jmfext.media.protocol.rtpdumpfile.DataSource` — the
    standard way to exercise the RTP pipeline offline.  `due(now_ms)`
    returns every packet whose record offset has elapsed — now_ms is
    **milliseconds since the start of the trace**, not wall clock; a
    host loop ticks it on its own relative clock.  `loop=True` rewinds
    with a timestamp shift the way the reference's RtpdumpFileReader
    restarts; `max_packets` bounds one call so a huge now_ms jump on a
    looping trace cannot materialize unbounded packets.
    """

    def __init__(self, path: str, loop: bool = False,
                 max_packets: int = 1000):
        from libjitsi_tpu_torch.io.pcap import RtpdumpReader

        self._path = path
        self.loop = loop
        self.max_packets = max_packets
        self._reader = RtpdumpReader(path)
        self._it: Iterator[Tuple[int, bytes]] = iter(self._reader)
        self._pending: Optional[Tuple[int, bytes]] = None
        self._epoch_ms = 0  # added to record offsets after each rewind
        self._last_off = 0

    def _next_record(self) -> Optional[Tuple[int, bytes]]:
        from libjitsi_tpu_torch.io.pcap import RtpdumpReader

        rec = next(self._it, None)
        if rec is None and self.loop:
            self._reader.close()
            self._epoch_ms += self._last_off
            self._reader = RtpdumpReader(self._path)
            self._it = iter(self._reader)
            rec = next(self._it, None)
        if rec is None:
            return None
        self._last_off = rec[0]
        return rec[0] + self._epoch_ms, rec[1]

    def due(self, now_ms: int) -> List[bytes]:
        out: List[bytes] = []
        while len(out) < self.max_packets:
            rec = self._pending or self._next_record()
            self._pending = None
            if rec is None:
                return out
            off, pkt = rec
            if off > now_ms:
                self._pending = rec
                return out
            out.append(pkt)
        return out

    def close(self) -> None:
        self._reader.close()


# ---------------------------------------------------------------- IVF ----

_IVF_HDR = struct.Struct("<4sHH4sHHIII4x")   # DKIF header, 32 bytes
_IVF_FRAME = struct.Struct("<IQ")            # size, pts


class IvfWriter:
    """Author IVF (VP8/VP9) fixture files (reference: ivffile devices)."""

    def __init__(self, path: str, width: int, height: int,
                 fourcc: bytes = b"VP80", timebase: Tuple[int, int] = (1, 30)):
        self._f = open(path, "wb")
        self._count = 0
        self._head = (width, height, fourcc, timebase)
        self._write_header()

    def _write_header(self) -> None:
        w, h, fourcc, (num, den) = self._head
        self._f.seek(0)
        self._f.write(_IVF_HDR.pack(b"DKIF", 0, 32, fourcc, w, h, den, num,
                                    self._count))

    def write(self, frame: bytes, pts: int) -> None:
        self._f.seek(0, 2)
        self._f.write(_IVF_FRAME.pack(len(frame), pts))
        self._f.write(frame)
        self._count += 1

    def close(self) -> None:
        self._write_header()  # patch the frame count
        self._f.close()


class IvfReader:
    """Iterate (pts, frame_bytes) from an IVF file; a fake camera.

    Reference: `...jmfext.media.protocol.ivffile.DataSource` plays IVF
    VP8 streams as a capture device for video-pipeline tests.
    """

    def __init__(self, path: str):
        self._f = open(path, "rb")
        head = self._f.read(32)
        if len(head) < 32 or head[:4] != b"DKIF":
            raise ValueError("not an IVF file")
        (_, _, hdr_len, self.fourcc, self.width, self.height, self.tb_den,
         self.tb_num, self.frame_count) = _IVF_HDR.unpack(head)
        self._f.seek(hdr_len)

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        while True:
            h = self._f.read(12)
            if len(h) < 12:
                return
            size, pts = _IVF_FRAME.unpack(h)
            payload = self._f.read(size)
            if len(payload) < size:
                return  # truncated final frame: don't hand fragments on
            yield pts, payload

    def close(self) -> None:
        self._f.close()
