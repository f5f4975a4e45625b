"""G.729 / iLBC / G.723.1 decode via the system libavcodec.

Parity target: the reference's `...codec.audio.{g729,ilbc}.*` (SURVEY
§2.5).  There is no libbcg729 or libilbc to bind, but the system
libavcodec 59 ships NATIVE decoders for g729, ilbc and g723_1, so the decode half closes
through the same validated ctypes binding `codecs.avcodec` built for
H.264 (AVOptions-only context config, probed AVFrame/AVPacket prefix
offsets).  FFmpeg has no native encoders for these codecs, so the
encode half remains honestly unavailable until a system encoder lib
appears; conference legs that must SEND these codecs keep using G.711
(the gateway posture the reference's SILK row takes vs Opus).

Frame sizes:
  g729    10 B / frame -> 80 samples  (10 ms @ 8 kHz); 2 B SID = DTX
  ilbc    38 B -> 160 samples (RFC 3952 mode=20; the 30 ms mode needs
          block_align, which has no AVOptions surface — refused at
          construction rather than silently misdecoded)
  g723_1  24 B -> 240 samples (30 ms @ 8 kHz; 6.3 kbit/s frames)

Counterpart: `libjitsi_tpu/codecs/audio_avcodec.py` (copied; host ctypes).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from libjitsi_tpu_torch.codecs.avcodec import (_AVERROR_EAGAIN, _AVERROR_EOF,
                                         _AvHandle, _F_DATA, _F_FMT,
                                         _P_DATA, _geti, _getp, _load)

_F_NB_SAMPLES = 112          # FFmpeg 5.x AVFrame prefix (after w/h)
_MAX_SAMPLES = 48_000        # refuse implausible counts (offset guard)
_SAMPLE_FMT_S16, _SAMPLE_FMT_S16P = 1, 6

_DECODERS = {"g729": 8000, "ilbc": 8000, "g723_1": 8000}

_nb_samples_probed = False


def _probe_nb_samples(u) -> None:
    """Once per process: a fresh AVFrame must read nb_samples == 0 at
    the poked offset (the binding's refuse-to-run doctrine; the
    per-decode _MAX_SAMPLES bound guards the live values)."""
    global _nb_samples_probed
    if _nb_samples_probed:
        return
    fr = u.av_frame_alloc()
    nb0 = _geti(fr, _F_NB_SAMPLES)
    u.av_frame_free(ctypes.byref(ctypes.c_void_p(fr)))
    if nb0 != 0:
        raise RuntimeError(
            "AVFrame nb_samples offset mismatch (fresh frame read "
            f"{nb0}); refusing raw offsets")
    _nb_samples_probed = True


def audio_decoder_available(name: str) -> bool:
    try:
        av, _ = _load()
    except Exception:
        return False
    return bool(av.avcodec_find_decoder_by_name(name.encode()))


class AvAudioDecoder(_AvHandle):
    """Mono S16 frame decoder over libavcodec (g729/ilbc/g723_1)."""

    def __init__(self, codec_name: str, ilbc_mode_ms: int = 20):
        if codec_name not in _DECODERS:
            raise ValueError(f"unsupported codec {codec_name!r}")
        if codec_name == "ilbc" and ilbc_mode_ms != 20:
            # the 30 ms mode needs block_align on the codec context,
            # which has no AVOptions surface; poking a raw context
            # offset would break the binding's validated-ABI doctrine
            raise RuntimeError(
                "iLBC 30 ms mode unsupported (no AVOptions path to "
                "block_align); RFC 3952 mode=20 only")
        av, u = _load()
        _probe_nb_samples(u)
        codec = av.avcodec_find_decoder_by_name(codec_name.encode())
        if not codec:
            raise RuntimeError(
                f"{codec_name} decoder not present in libavcodec")
        self._av, self._u = av, u
        self.codec_name = codec_name
        self.sample_rate = _DECODERS[codec_name]
        self.ilbc_mode_ms = ilbc_mode_ms
        # assign the context BEFORE open so _AvHandle.close() frees it
        # on the open-failure path too
        self._ctx = av.avcodec_alloc_context3(codec)
        # AVOptions only (name-based, version-stable): sample rate +
        # mono; the decoders refuse to open without a channel count
        u.av_opt_set_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_int]
        u.av_opt_set_int(self._ctx, b"ar", self.sample_rate, 0)
        u.av_opt_set_int(self._ctx, b"ac", 1, 0)
        if av.avcodec_open2(self._ctx, codec, None) != 0:
            raise RuntimeError(f"avcodec_open2({codec_name}) failed")
        self._pkt = av.av_packet_alloc()
        self._fr = u.av_frame_alloc()

    def decode(self, frame: bytes) -> np.ndarray:
        """One codec frame -> int16 PCM [samples] (mono).

        G.729 Annex-B SID (comfort-noise) frames — exactly 2 bytes,
        standard with VAD — return empty PCM rather than erroring:
        callers fill silence, same as a DTX gap.  (0/1-byte fragments
        stay errors: malformed input must not pass silently.)"""
        if self.codec_name == "g729" and len(frame) == 2:
            return np.zeros(0, dtype=np.int16)
        av = self._av
        pkt = self._pkt
        if av.av_new_packet(pkt, len(frame)) != 0:
            raise RuntimeError("av_new_packet failed")
        ctypes.memmove(_getp(pkt, _P_DATA), frame, len(frame))
        r = av.avcodec_send_packet(self._ctx, pkt)
        av.av_packet_unref(pkt)
        if r != 0:
            raise ValueError(
                f"{self.codec_name} rejected a {len(frame)}-byte frame "
                f"({r})")
        out = self._drain()
        if not out:
            return np.zeros(0, dtype=np.int16)
        return np.concatenate(out)

    def _drain(self) -> List[np.ndarray]:
        av, u = self._av, self._u
        fr = self._fr
        out: List[np.ndarray] = []
        while True:
            r = av.avcodec_receive_frame(self._ctx, fr)
            if r != 0:
                if r in (_AVERROR_EAGAIN, _AVERROR_EOF):
                    return out
                raise RuntimeError(f"avcodec_receive_frame: {r}")
            fmt = _geti(fr, _F_FMT)
            if fmt not in (_SAMPLE_FMT_S16, _SAMPLE_FMT_S16P):
                u.av_frame_unref(fr)
                raise RuntimeError(
                    f"unexpected sample format {fmt} from "
                    f"{self.codec_name} (want S16/S16P)")
            n = _geti(fr, _F_NB_SAMPLES)
            if not 0 < n <= _MAX_SAMPLES:
                u.av_frame_unref(fr)
                raise RuntimeError(
                    f"implausible nb_samples {n} (layout drift?)")
            ptr = _getp(fr, _F_DATA)       # mono: plane 0 either way
            pcm = np.frombuffer(ctypes.string_at(ptr, n * 2),
                                dtype=np.int16).copy()
            out.append(pcm)
            u.av_frame_unref(fr)

    # close()/__del__ inherited from _AvHandle

    def decode_payload(self, payload: bytes) -> np.ndarray:
        """One RTP payload -> PCM.

        RFC 3551: a G.729 payload is N back-to-back 10-byte frames with
        an optional trailing 2-byte SID; iLBC (RFC 3952, mode=20) and
        G.723.1 payloads may also stack whole frames.  Splits on the
        codec's frame size and decodes in order (G.723.1 frame size
        follows the 2-bit rate field of each frame's first byte:
        24/20/4/1 bytes)."""
        out: List[np.ndarray] = []
        pos = 0
        while pos < len(payload):
            if self.codec_name == "g729":
                size = 2 if len(payload) - pos == 2 else 10
            elif self.codec_name == "ilbc":
                size = 38                   # mode=20 (enforced at init)
            else:                           # g723_1: per-frame rate bits
                size = {0: 24, 1: 20, 2: 4, 3: 1}[payload[pos] & 3]
            chunk = payload[pos:pos + size]
            if len(chunk) < size:
                raise ValueError(
                    f"truncated {self.codec_name} payload at {pos}")
            if self.codec_name == "g723_1" and size <= 4:
                pcm = np.zeros(0, dtype=np.int16)   # SID: DTX gap
            else:
                pcm = self.decode(chunk)
            if len(pcm):
                out.append(pcm)
            pos += size
        if not out:
            return np.zeros(0, dtype=np.int16)
        return np.concatenate(out)


def g729_decoder() -> AvAudioDecoder:
    return AvAudioDecoder("g729")


def ilbc_decoder() -> AvAudioDecoder:
    return AvAudioDecoder("ilbc")


def g723_1_decoder() -> AvAudioDecoder:
    return AvAudioDecoder("g723_1")
