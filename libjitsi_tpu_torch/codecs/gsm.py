"""GSM 06.10 availability probe: a ctypes load of the system libgsm.

Counterpart: `libjitsi_tpu/codecs/gsm.py`, its `_load` and
`gsm_available` (copied), so `EncodingConfiguration` answers as the JAX
one does on the same machine.  The coder itself (`GsmCodec`) is not
ported: the GSM leg is refused (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import ctypes
import ctypes.util

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
