"""Opus encode/decode through ctypes on the system libopus.

Counterpart: `libjitsi_tpu/codecs/opus.py` (`OpusEncoder`, `OpusDecoder`,
`opus_available`), copied: the port keeps its own copy and imports nothing
of the JAX package.  The encoder takes bitrate, complexity, in-band FEC,
loss and DTX knobs; the decoder conceals a lost packet (`decode(None)`).
Opus is a host codec: the decoded PCM feeds the device mixer.  No library
is fetched: `opus_available()` is False where libopus is not installed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    _lib = ctypes.CDLL(name)
    _lib.opus_encoder_create.restype = ctypes.c_void_p
    _lib.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    _lib.opus_encode.restype = ctypes.c_int
    _lib.opus_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    _lib.opus_encoder_ctl.restype = ctypes.c_int
    _lib.opus_decoder_create.restype = ctypes.c_void_p
    _lib.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _lib.opus_decode.restype = ctypes.c_int
    _lib.opus_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int]
    return _lib


def opus_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


APPLICATION_VOIP = 2048
APPLICATION_AUDIO = 2049
# opus_defines.h ctl request codes
_SET_BITRATE = 4002
_SET_COMPLEXITY = 4010
_SET_INBAND_FEC = 4012
_SET_PACKET_LOSS_PERC = 4014
_SET_DTX = 4016


class OpusEncoder:
    """Reference: Opus.encoder_create/encode + JavaEncoder knobs."""

    def __init__(self, sample_rate: int = 48000, channels: int = 1,
                 application: int = APPLICATION_VOIP):
        lib = _load()
        err = ctypes.c_int()
        self._channels = channels
        self._enc = lib.opus_encoder_create(sample_rate, channels,
                                            application, ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")

    def _ctl(self, request: int, value: int) -> None:
        _load().opus_encoder_ctl(ctypes.c_void_p(self._enc),
                                 ctypes.c_int(request), ctypes.c_int(value))

    def set_bitrate(self, bps: int) -> None:
        self._ctl(_SET_BITRATE, bps)

    def set_complexity(self, c: int) -> None:
        self._ctl(_SET_COMPLEXITY, c)

    def set_inband_fec(self, on: bool) -> None:
        self._ctl(_SET_INBAND_FEC, int(on))

    def set_packet_loss_perc(self, pct: int) -> None:
        self._ctl(_SET_PACKET_LOSS_PERC, pct)

    def set_dtx(self, on: bool) -> None:
        self._ctl(_SET_DTX, int(on))

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: int16 [frame * channels] (20 ms = 960/ch @48k)."""
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        out = ctypes.create_string_buffer(4000)
        n = _load().opus_encode(
            ctypes.c_void_p(self._enc),
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(pcm) // self._channels, out, len(out))
        if n < 0:
            raise RuntimeError(f"opus_encode error {n}")
        return out.raw[:n]


class OpusDecoder:
    """Reference: Opus.decoder_create/decode (+ PLC via data=None)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 1):
        lib = _load()
        err = ctypes.c_int()
        self._channels = channels
        self._rate = sample_rate
        self._dec = lib.opus_decoder_create(sample_rate, channels,
                                            ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")

    def decode(self, packet: Optional[bytes], frame_size: int = 960,
               decode_fec: bool = False) -> np.ndarray:
        """packet=None triggers packet-loss concealment."""
        out = np.empty(frame_size * self._channels, dtype=np.int16)
        n = _load().opus_decode(
            ctypes.c_void_p(self._dec),
            packet if packet is not None else None,
            len(packet) if packet is not None else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            frame_size, int(decode_fec))
        if n < 0:
            raise RuntimeError(f"opus_decode error {n}")
        return out[: n * self._channels]
