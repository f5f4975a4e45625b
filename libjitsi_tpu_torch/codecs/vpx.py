"""VP8/VP9 bitstream encode/decode via ctypes on the system libvpx.

Rebuilds the JNI surface of the reference's
`org.jitsi.impl.neomedia.codec.video.VPX` (+ `src/native/vpx`): codec
context init, frame encode to compressed packets, packet decode to
I420 planes.  Per SURVEY §2.6 item 4 this is the host-side libvpx
binding (video bitstream coding has no device kernel in scope); it exists
to author/verify real VP8 media for the RTP/SFU path (BASELINE config
#4) and for the recording sink.

ABI note: libvpx's init entry points take an ABI version constant that
changes across releases.  Rather than hard-code one, `_probe_abi`
tries versions until init succeeds — the same role as the reference's
configure-time version check, done at runtime because we bind whatever
libvpx.so the host has.

Counterpart: `libjitsi_tpu/codecs/vpx.py` (copied; host ctypes).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Iterator, List, Optional, Tuple

import numpy as np

_lib = None

VPX_CODEC_OK = 0
_VPX_IMG_FMT_PLANAR = 0x100
VPX_IMG_FMT_I420 = _VPX_IMG_FMT_PLANAR | 2
_VPX_DL_REALTIME = 1
_VPX_CODEC_CX_FRAME_PKT = 0
VPX_FRAME_IS_KEY = 0x1
_CTX_SIZE = 256          # opaque vpx_codec_ctx_t (real one is ~56 bytes)
_CFG_SIZE = 4096         # opaque vpx_codec_enc_cfg_t (~1 KiB with layers)


class _VpxImage(ctypes.Structure):
    """vpx_image_t prefix (vpx/vpx_image.h; stable across 1.x)."""

    _fields_ = [
        ("fmt", ctypes.c_int),
        ("cs", ctypes.c_int),
        ("range", ctypes.c_int),
        ("w", ctypes.c_uint),
        ("h", ctypes.c_uint),
        ("bit_depth", ctypes.c_uint),
        ("d_w", ctypes.c_uint),
        ("d_h", ctypes.c_uint),
        ("r_w", ctypes.c_uint),
        ("r_h", ctypes.c_uint),
        ("x_chroma_shift", ctypes.c_uint),
        ("y_chroma_shift", ctypes.c_uint),
        ("planes", ctypes.c_void_p * 4),
        ("stride", ctypes.c_int * 4),
        ("bps", ctypes.c_int),
        ("user_priv", ctypes.c_void_p),
        ("img_data", ctypes.c_void_p),
        ("img_data_owner", ctypes.c_int),
        ("self_allocd", ctypes.c_int),
        ("fb_priv", ctypes.c_void_p),
    ]


class _CxPkt(ctypes.Structure):
    """vpx_codec_cx_pkt_t frame variant prefix.

    The union after `kind` starts at pointer alignment, so the pad
    between them is pointer-size dependent — computed, not hard-coded
    (on ILP32 there is no pad at all).
    """

    _fields_ = ([("kind", ctypes.c_int)]
                + ([("_pad", ctypes.c_int)]
                   if ctypes.sizeof(ctypes.c_void_p) == 8 else [])
                + [
        ("buf", ctypes.c_void_p),
        ("sz", ctypes.c_size_t),
        ("pts", ctypes.c_int64),
        ("duration", ctypes.c_ulong),
        ("flags", ctypes.c_uint),
        ("partition_id", ctypes.c_int),
    ])


def _load():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("vpx") or "libvpx.so.7"
    lib = ctypes.CDLL(name)
    for f in ("vpx_codec_vp8_cx", "vpx_codec_vp8_dx",
              "vpx_codec_vp9_cx", "vpx_codec_vp9_dx"):
        getattr(lib, f).restype = ctypes.c_void_p
    lib.vpx_codec_enc_config_default.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    lib.vpx_codec_enc_init_ver.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int]
    lib.vpx_codec_dec_init_ver.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int]
    lib.vpx_codec_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_ulong,
        ctypes.c_long, ctypes.c_ulong]
    lib.vpx_codec_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_long]
    lib.vpx_codec_get_cx_data.restype = ctypes.POINTER(_CxPkt)
    lib.vpx_codec_get_cx_data.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_void_p)]
    lib.vpx_codec_get_frame.restype = ctypes.POINTER(_VpxImage)
    lib.vpx_codec_get_frame.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_void_p)]
    lib.vpx_img_alloc.restype = ctypes.POINTER(_VpxImage)
    lib.vpx_img_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_uint, ctypes.c_uint,
                                  ctypes.c_uint]
    lib.vpx_img_free.argtypes = [ctypes.POINTER(_VpxImage)]
    lib.vpx_codec_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def vpx_available() -> bool:
    try:
        _load()
        return True
    except (OSError, AttributeError):
        # AttributeError: lib present but built without vp8/vp9 symbols
        return False


def _probe_abi(init, *args) -> Tuple[int, bytearray]:
    """Find the installed lib's ABI version constant by trial init."""
    for ver in range(6, 40):
        ctx = ctypes.create_string_buffer(_CTX_SIZE)
        if init(ctx, *args, ver) == VPX_CODEC_OK:
            return ver, ctx
    raise RuntimeError("no libvpx ABI version in 6..39 accepted init")


class VpxDecoder:
    """Decode VP8/VP9 packets to I420 planes (the verification path)."""

    def __init__(self, codec: str = "vp8"):
        lib = _load()
        iface = {"vp8": lib.vpx_codec_vp8_dx,
                 "vp9": lib.vpx_codec_vp9_dx}[codec]()
        _, self._ctx = _probe_abi(
            lambda c, v: lib.vpx_codec_dec_init_ver(c, iface, None, 0, v))

    def decode(self, packet: bytes) -> List[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]]:
        """Returns decoded frames as (y, u, v) uint8 arrays."""
        lib = _load()
        if lib.vpx_codec_decode(self._ctx, packet, len(packet),
                                None, 0) != VPX_CODEC_OK:
            raise RuntimeError("vpx_codec_decode failed")
        out = []
        it = ctypes.c_void_p(None)
        while True:
            img = lib.vpx_codec_get_frame(self._ctx, ctypes.byref(it))
            if not img:
                break
            out.append(_image_to_planes(img.contents))
        return out

    def close(self) -> None:
        _load().vpx_codec_destroy(self._ctx)


def _image_to_planes(im: _VpxImage):
    def plane(idx, w, h):
        stride = im.stride[idx]
        buf = (ctypes.c_ubyte * (stride * h)).from_address(im.planes[idx])
        return np.ctypeslib.as_array(buf).reshape(h, stride)[:, :w].copy()

    w, h = im.d_w, im.d_h
    cw = (w + (1 << im.x_chroma_shift) - 1) >> im.x_chroma_shift
    ch = (h + (1 << im.y_chroma_shift) - 1) >> im.y_chroma_shift
    return plane(0, w, h), plane(1, cw, ch), plane(2, cw, ch)


def _drain_packets(lib, ctx) -> List[Tuple[bytes, bool]]:
    out: List[Tuple[bytes, bool]] = []
    it = ctypes.c_void_p(None)
    while True:
        pkt = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
        if not pkt:
            return out
        p = pkt.contents
        if p.kind == _VPX_CODEC_CX_FRAME_PKT:
            out.append((ctypes.string_at(p.buf, p.sz),
                        bool(p.flags & VPX_FRAME_IS_KEY)))


# vpx_codec_enc_cfg_t field offsets (vpx/vpx_encoder.h, stable in 1.x)
_CFG_G_W = 12
_CFG_G_H = 16
_CFG_G_TIMEBASE_NUM = 28
_CFG_G_TIMEBASE_DEN = 32


class VpxEncoder:
    """Encode I420 frames to VP8/VP9 packets (fixture authoring path)."""

    def __init__(self, width: int, height: int, codec: str = "vp8",
                 fps: int = 30):
        lib = _load()
        self._iface = {"vp8": lib.vpx_codec_vp8_cx,
                       "vp9": lib.vpx_codec_vp9_cx}[codec]()
        self.width, self.height = width, height
        cfg = ctypes.create_string_buffer(_CFG_SIZE)
        if lib.vpx_codec_enc_config_default(self._iface, cfg, 0) \
                != VPX_CODEC_OK:
            raise RuntimeError("vpx enc_config_default failed")
        # The offsets below are patched blind, so validate the layout
        # first: libvpx 1.x's defaults at those offsets are g_w=320,
        # g_h=240, g_timebase=1/30.  A build whose cfg prefix differs
        # must fail loudly here, not encode at silently wrong
        # dimensions/timebase.
        def _peek(off: int) -> int:
            return ctypes.c_uint.from_buffer_copy(cfg, off).value
        got = (_peek(_CFG_G_W), _peek(_CFG_G_H),
               _peek(_CFG_G_TIMEBASE_NUM), _peek(_CFG_G_TIMEBASE_DEN))
        if got != (320, 240, 1, 30):
            raise RuntimeError(
                f"vpx_codec_enc_cfg_t layout mismatch: defaults at "
                f"g_w/g_h/g_timebase offsets read {got}, want "
                "(320, 240, 1, 30); refusing to patch raw offsets")
        for off, val in ((_CFG_G_W, width), (_CFG_G_H, height),
                         (_CFG_G_TIMEBASE_NUM, 1),
                         (_CFG_G_TIMEBASE_DEN, fps)):
            ctypes.memmove(ctypes.addressof(cfg) + off,
                           bytes(ctypes.c_uint(val)), 4)
        _, self._ctx = _probe_abi(
            lambda c, v: lib.vpx_codec_enc_init_ver(c, self._iface, cfg,
                                                    0, v))
        self._pts = 0

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
               ) -> List[Tuple[bytes, bool]]:
        """Encode one I420 frame; returns [(packet, is_keyframe)]."""
        lib = _load()
        img = lib.vpx_img_alloc(None, VPX_IMG_FMT_I420, self.width,
                                self.height, 1)
        if not img:
            raise RuntimeError("vpx_img_alloc failed")
        try:
            im = img.contents
            cw = (self.width + 1) >> 1
            ch = (self.height + 1) >> 1
            expect = {0: (self.height, self.width), 1: (ch, cw),
                      2: (ch, cw)}
            for idx, plane in ((0, y), (1, u), (2, v)):
                p = np.asarray(plane, dtype=np.uint8)
                if p.shape != expect[idx]:
                    # writing past the plane allocation would corrupt
                    # the heap silently — fail as a Python error instead
                    raise ValueError(
                        f"plane {idx} shape {p.shape} != {expect[idx]}")
                h, w = p.shape
                stride = im.stride[idx]
                dst = (ctypes.c_ubyte * (stride * h)).from_address(
                    im.planes[idx])
                arr = np.ctypeslib.as_array(dst).reshape(h, stride)
                arr[:, :w] = p
            if lib.vpx_codec_encode(self._ctx, img, self._pts, 1, 0,
                                    _VPX_DL_REALTIME) != VPX_CODEC_OK:
                raise RuntimeError("vpx_codec_encode failed")
            self._pts += 1
        finally:
            lib.vpx_img_free(img)
        return _drain_packets(lib, self._ctx)

    def flush(self) -> List[Tuple[bytes, bool]]:
        """Drain lookahead-lagged packets (VP9 defaults to a multi-frame
        lag; VP8's default lag is 0 so this is usually empty there)."""
        lib = _load()
        out: List[Tuple[bytes, bool]] = []
        while True:
            if lib.vpx_codec_encode(self._ctx, None, self._pts, 1, 0,
                                    _VPX_DL_REALTIME) != VPX_CODEC_OK:
                raise RuntimeError("vpx_codec_encode(flush) failed")
            got = _drain_packets(lib, self._ctx)
            if not got:
                return out
            out += got

    def close(self) -> None:
        _load().vpx_codec_destroy(self._ctx)
