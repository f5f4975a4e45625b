"""Speex availability probe: a ctypes load of the system libspeex.

Counterpart: `libjitsi_tpu/codecs/speex.py`, its `_load` and
`speex_available` (copied), so `EncodingConfiguration` answers as the
JAX one does on the same machine.  The coders themselves are not
ported: the Speex leg is refused (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import ctypes
import ctypes.util

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
