"""GSM 06.10 full-rate codec via ctypes to libgsm.

Counterpart: `libjitsi_tpu/codecs/gsm.py` (copied): the availability
probe and `GsmCodec`, host code on the system library.

Rebuilds the reference's GSM codec (`org.jitsi.impl.neomedia.codec.audio.
gsm.*`, SURVEY §2.5 telephony codecs) the same way the Opus module wraps
libopus: the host-side bitstream codec binds the system library (our
ctypes = the reference's JNI), while PCM post-processing (mixing,
resampling, levels) rides the device kernels.

Frame geometry: 160 int16 samples at 8 kHz (20 ms) <-> 33-byte frame
(13 kbit/s).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

FRAME_SAMPLES = 160
FRAME_BYTES = 33
SAMPLE_RATE = 8000

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("gsm") or "libgsm.so.1"
    lib = ctypes.CDLL(name)
    lib.gsm_create.restype = ctypes.c_void_p
    lib.gsm_destroy.argtypes = [ctypes.c_void_p]
    lib.gsm_encode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
                               ctypes.POINTER(ctypes.c_ubyte)]
    lib.gsm_decode.restype = ctypes.c_int
    lib.gsm_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                               ctypes.POINTER(ctypes.c_short)]
    _lib = lib
    return lib


def gsm_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class GsmCodec:
    """One GSM 06.10 en/decoder instance (stateful, like the reference's
    per-stream codec plugins)."""

    def __init__(self):
        lib = _load()
        self._lib = lib
        self._enc = lib.gsm_create()
        self._dec = lib.gsm_create()
        if not self._enc or not self._dec:
            raise RuntimeError("gsm_create failed")

    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 [160] (or a multiple) at 8 kHz -> 33 bytes per frame."""
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        if pcm.size % FRAME_SAMPLES:
            raise ValueError(f"PCM length must be a multiple of "
                             f"{FRAME_SAMPLES}, got {pcm.size}")
        out = bytearray()
        frame = (ctypes.c_ubyte * FRAME_BYTES)()
        for k in range(pcm.size // FRAME_SAMPLES):
            chunk = pcm[k * FRAME_SAMPLES:(k + 1) * FRAME_SAMPLES]
            sig = chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
            self._lib.gsm_encode(self._enc, sig, frame)
            out += bytes(frame)
        return bytes(out)

    def decode(self, data: bytes) -> np.ndarray:
        """33-byte frames -> int16 [160 * nframes]."""
        if len(data) % FRAME_BYTES:
            raise ValueError(f"GSM payload must be a multiple of "
                             f"{FRAME_BYTES}B, got {len(data)}")
        n = len(data) // FRAME_BYTES
        out = np.zeros(n * FRAME_SAMPLES, dtype=np.int16)
        buf = (ctypes.c_ubyte * FRAME_BYTES)()
        for k in range(n):
            buf[:] = data[k * FRAME_BYTES:(k + 1) * FRAME_BYTES]
            sig = out[k * FRAME_SAMPLES:(k + 1) * FRAME_SAMPLES]
            rc = self._lib.gsm_decode(
                self._dec, buf, sig.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_short)))
            if rc != 0:
                raise ValueError(f"gsm_decode failed on frame {k}")
        return out

    def close(self) -> None:
        if self._enc:
            self._lib.gsm_destroy(self._enc)
            self._enc = None
        if self._dec:
            self._lib.gsm_destroy(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
