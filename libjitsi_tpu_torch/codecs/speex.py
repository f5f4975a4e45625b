"""Speex codec via ctypes to libspeex.

Counterpart: `libjitsi_tpu/codecs/speex.py` (copied): the availability
probe, `SpeexEncoder` and `SpeexDecoder`, host code on the system
library.

Completes the reference's Speex support (`org.jitsi.impl.neomedia.codec.
audio.speex.*` + `src/native/speex`): the RESAMPLER is already a device
kernel (`kernels/resample.py`, the part SURVEY §2.5 flags as mattering
for the mixer); this module adds the bitstream codec itself as a host
ctypes binding (our ctypes = the reference's JNI).

Modes: narrowband (8 kHz, 160-sample frames), wideband (16 kHz, 320),
ultra-wideband (32 kHz, 640).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

MODE_NB, MODE_WB, MODE_UWB = 0, 1, 2
_RATES = {MODE_NB: 8000, MODE_WB: 16000, MODE_UWB: 32000}

_SPEEX_GET_FRAME_SIZE = 3
_SPEEX_SET_QUALITY = 4

_lib = None


class _SpeexBits(ctypes.Structure):
    # public ABI of SpeexBits (speex/speex_bits.h)
    _fields_ = [("chars", ctypes.c_char_p),
                ("nbBits", ctypes.c_int),
                ("charPtr", ctypes.c_int),
                ("bitPtr", ctypes.c_int),
                ("owner", ctypes.c_int),
                ("overflow", ctypes.c_int),
                ("buf_size", ctypes.c_int),
                ("reserved1", ctypes.c_int),
                ("reserved2", ctypes.c_void_p)]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("speex") or "libspeex.so.1"
    lib = ctypes.CDLL(name)
    lib.speex_lib_get_mode.restype = ctypes.c_void_p
    lib.speex_lib_get_mode.argtypes = [ctypes.c_int]
    lib.speex_encoder_init.restype = ctypes.c_void_p
    lib.speex_encoder_init.argtypes = [ctypes.c_void_p]
    lib.speex_decoder_init.restype = ctypes.c_void_p
    lib.speex_decoder_init.argtypes = [ctypes.c_void_p]
    for f in (lib.speex_encoder_destroy, lib.speex_decoder_destroy):
        f.argtypes = [ctypes.c_void_p]
    for f in (lib.speex_encoder_ctl, lib.speex_decoder_ctl):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.speex_bits_init.argtypes = [ctypes.POINTER(_SpeexBits)]
    lib.speex_bits_reset.argtypes = [ctypes.POINTER(_SpeexBits)]
    lib.speex_bits_destroy.argtypes = [ctypes.POINTER(_SpeexBits)]
    lib.speex_bits_write.restype = ctypes.c_int
    lib.speex_bits_write.argtypes = [ctypes.POINTER(_SpeexBits),
                                     ctypes.c_char_p, ctypes.c_int]
    lib.speex_bits_read_from.argtypes = [ctypes.POINTER(_SpeexBits),
                                         ctypes.c_char_p, ctypes.c_int]
    lib.speex_encode_int.restype = ctypes.c_int
    lib.speex_encode_int.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_short),
                                     ctypes.POINTER(_SpeexBits)]
    lib.speex_decode_int.restype = ctypes.c_int
    lib.speex_decode_int.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(_SpeexBits),
                                     ctypes.POINTER(ctypes.c_short)]
    _lib = lib
    return lib


def speex_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class SpeexEncoder:
    def __init__(self, mode: int = MODE_NB, quality: int = 8):
        if mode not in _RATES:
            raise ValueError(f"mode must be one of {sorted(_RATES)}")
        lib = _load()
        self._lib = lib
        self._st = lib.speex_encoder_init(lib.speex_lib_get_mode(mode))
        if not self._st:
            raise RuntimeError("speex_encoder_init failed")
        q = ctypes.c_int(quality)
        lib.speex_encoder_ctl(self._st, _SPEEX_SET_QUALITY,
                              ctypes.byref(q))
        fs = ctypes.c_int(0)
        lib.speex_encoder_ctl(self._st, _SPEEX_GET_FRAME_SIZE,
                              ctypes.byref(fs))
        self.frame_size = fs.value
        self.sample_rate = _RATES[mode]
        self._bits = _SpeexBits()
        lib.speex_bits_init(ctypes.byref(self._bits))

    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 [frame_size] -> one encoded Speex frame."""
        # private copy: speex_encode_int may overwrite its input frame
        # (fixed-point builds), and callers may pass read-only views
        pcm = np.array(pcm, dtype=np.int16, copy=True)
        if pcm.size != self.frame_size:
            raise ValueError(
                f"frame must be {self.frame_size} samples, got {pcm.size}")
        self._lib.speex_bits_reset(ctypes.byref(self._bits))
        self._lib.speex_encode_int(
            self._st, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            ctypes.byref(self._bits))
        buf = ctypes.create_string_buffer(2048)
        n = self._lib.speex_bits_write(ctypes.byref(self._bits), buf, 2048)
        return buf.raw[:n]

    def close(self) -> None:
        if self._st:
            self._lib.speex_encoder_destroy(self._st)
            self._lib.speex_bits_destroy(ctypes.byref(self._bits))
            self._st = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SpeexDecoder:
    def __init__(self, mode: int = MODE_NB):
        if mode not in _RATES:
            raise ValueError(f"mode must be one of {sorted(_RATES)}")
        lib = _load()
        self._lib = lib
        self._st = lib.speex_decoder_init(lib.speex_lib_get_mode(mode))
        if not self._st:
            raise RuntimeError("speex_decoder_init failed")
        fs = ctypes.c_int(0)
        lib.speex_decoder_ctl(self._st, _SPEEX_GET_FRAME_SIZE,
                              ctypes.byref(fs))
        self.frame_size = fs.value
        self.sample_rate = _RATES[mode]
        self._bits = _SpeexBits()
        lib.speex_bits_init(ctypes.byref(self._bits))

    def decode(self, frame: Optional[bytes]) -> np.ndarray:
        """One Speex frame -> int16 [frame_size].  None = packet loss
        (concealment, like the reference decoder's FEC/PLC path)."""
        out = np.zeros(self.frame_size, dtype=np.int16)
        optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        if frame is None:
            self._lib.speex_decode_int(self._st, None, optr)
            return out
        self._lib.speex_bits_read_from(ctypes.byref(self._bits), frame,
                                       len(frame))
        rc = self._lib.speex_decode_int(self._st,
                                        ctypes.byref(self._bits), optr)
        if rc < 0:
            raise ValueError("speex_decode_int failed")
        return out

    def close(self) -> None:
        if self._st:
            self._lib.speex_decoder_destroy(self._st)
            self._lib.speex_bits_destroy(ctypes.byref(self._bits))
            self._st = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
