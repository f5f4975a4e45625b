"""H.264 bitstream codec via libavcodec (ctypes).

Parity target: the reference's `...codec.video.h264.{JNIEncoder,
JNIDecoder}` over `src/native/ffmpeg` (SURVEY §2.5) — here a ctypes
binding to the system libavcodec 59 (FFmpeg 5.x): encode through
libx264, decode through the native h264 decoder.  RFC 6184
packetization lives in `codecs.h264`; this module is the bitstream
half.

ABI strategy (same doctrine as `codecs.vpx`): every struct field this
module pokes is validated at runtime before use —

- AVCodecContext is configured ONLY through the AVOptions API
  (`av_opt_set_image_size` / `_pixel_fmt` / `_q` / `av_opt_set`), which
  is name-based and version-stable; no context offsets at all.
- AVFrame/AVPacket use the FFmpeg 5.x prefix layout (data[8], then
  linesize[8], extended_data, width, height, nb_samples, format;
  packet: buf, pts, dts, data, size).  A freshly allocated AVFrame must
  read width=0, height=0, format=-1 at those offsets and a probe
  av_new_packet must read back its size — otherwise the module refuses
  to run rather than corrupt memory.

Counterpart: `libjitsi_tpu/codecs/avcodec.py` (copied; host ctypes).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_AV_PIX_FMT_YUV420P = 0
_AVERROR_EAGAIN = -11      # AVERROR(EAGAIN) on Linux
_AVERROR_EOF = -0x20464F45  # FFERRTAG('E','O','F',' ') as AVERROR

# FFmpeg 5.x AVFrame prefix offsets
_F_DATA, _F_LINESIZE = 0, 64
_F_W, _F_H, _F_FMT = 104, 108, 116
# FFmpeg 5.x AVPacket prefix offsets
_P_DATA, _P_SIZE = 24, 32


class _Q(ctypes.Structure):
    _fields_ = [("num", ctypes.c_int), ("den", ctypes.c_int)]


_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL]] = None


def _load() -> Tuple[ctypes.CDLL, ctypes.CDLL]:
    global _libs
    if _libs is None:
        av = ctypes.CDLL("libavcodec.so.59")
        u = ctypes.CDLL("libavutil.so.57")
        for f in ("avcodec_find_encoder_by_name",
                  "avcodec_find_decoder_by_name",
                  "avcodec_alloc_context3"):
            getattr(av, f).restype = ctypes.c_void_p
        av.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
        av.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
        av.avcodec_alloc_context3.argtypes = [ctypes.c_void_p]
        av.avcodec_open2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
        for f in ("avcodec_send_frame", "avcodec_receive_packet",
                  "avcodec_send_packet", "avcodec_receive_frame"):
            getattr(av, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        av.av_packet_alloc.restype = ctypes.c_void_p
        av.av_new_packet.argtypes = [ctypes.c_void_p, ctypes.c_int]
        av.av_packet_unref.argtypes = [ctypes.c_void_p]
        u.av_frame_alloc.restype = ctypes.c_void_p
        u.av_frame_get_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        u.av_frame_unref.argtypes = [ctypes.c_void_p]
        u.av_frame_free.argtypes = [ctypes.c_void_p]
        av.av_packet_free.argtypes = [ctypes.c_void_p]
        av.avcodec_free_context.argtypes = [ctypes.c_void_p]
        u.av_opt_set_image_size.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        u.av_opt_set_pixel_fmt.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        u.av_opt_set_q.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _Q,
                                   ctypes.c_int]
        u.av_opt_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
        _probe_abi(av, u)
        _libs = (av, u)
    return _libs


def _geti(p: int, off: int) -> int:
    return ctypes.c_int.from_buffer_copy(ctypes.string_at(p + off, 4)).value


def _getp(p: int, off: int) -> int:
    return ctypes.c_void_p.from_buffer_copy(
        ctypes.string_at(p + off, 8)).value or 0


def _seti(p: int, off: int, v: int) -> None:
    ctypes.memmove(p + off, bytes(ctypes.c_int(v)), 4)


def _probe_abi(av, u) -> None:
    """Refuse to run on a layout that fails the known-value probes."""
    fr = u.av_frame_alloc()
    if (_geti(fr, _F_W), _geti(fr, _F_H), _geti(fr, _F_FMT)) \
            != (0, 0, -1):
        raise RuntimeError(
            "AVFrame prefix layout mismatch (fresh frame should read "
            "width=0, height=0, format=-1); refusing raw offsets")
    u.av_frame_free(ctypes.byref(ctypes.c_void_p(fr)))
    pkt = av.av_packet_alloc()
    if av.av_new_packet(pkt, 48) != 0 or _geti(pkt, _P_SIZE) != 48 \
            or not _getp(pkt, _P_DATA):
        raise RuntimeError("AVPacket prefix layout mismatch")
    av.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))


class _AvHandle:
    """Shared lifecycle for (codec context, packet, frame) triples —
    one teardown implementation for every codec class in this binding."""

    _ctx = 0
    _pkt = 0
    _fr = 0

    def close(self) -> None:
        if getattr(self, "_ctx", 0):
            self._av.avcodec_free_context(
                ctypes.byref(ctypes.c_void_p(self._ctx)))
            self._ctx = 0
        if getattr(self, "_pkt", 0):
            self._av.av_packet_free(
                ctypes.byref(ctypes.c_void_p(self._pkt)))
            self._pkt = 0
        if getattr(self, "_fr", 0):
            self._u.av_frame_free(
                ctypes.byref(ctypes.c_void_p(self._fr)))
            self._fr = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def h264_available() -> bool:
    try:
        av, _ = _load()
    except (OSError, RuntimeError):
        return False
    return bool(av.avcodec_find_encoder_by_name(b"libx264")
                and av.avcodec_find_decoder_by_name(b"h264"))


def _drain_packets(av, ctx, pkt) -> List[bytes]:
    out = []
    while True:
        r = av.avcodec_receive_packet(ctx, pkt)
        if r != 0:
            if r in (_AVERROR_EAGAIN, _AVERROR_EOF):
                return out
            raise RuntimeError(f"avcodec_receive_packet: {r}")
        size = _geti(pkt, _P_SIZE)
        out.append(ctypes.string_at(_getp(pkt, _P_DATA), size))
        av.av_packet_unref(pkt)


class H264Encoder(_AvHandle):
    """Encode I420 frames to H.264 Annex-B access units (libx264)."""

    def __init__(self, width: int, height: int, fps: int = 30,
                 bitrate: int = 500_000, keyint: int = 30):
        av, u = _load()
        codec = av.avcodec_find_encoder_by_name(b"libx264")
        if not codec:
            raise RuntimeError("libx264 encoder not present in libavcodec")
        self._av, self._u = av, u
        self.width, self.height = width, height
        ctx = av.avcodec_alloc_context3(codec)
        u.av_opt_set_image_size(ctx, b"video_size", width, height, 0)
        u.av_opt_set_pixel_fmt(ctx, b"pixel_format", _AV_PIX_FMT_YUV420P,
                               0)
        u.av_opt_set_q(ctx, b"time_base", _Q(1, fps), 0)
        u.av_opt_set(ctx, b"preset", b"ultrafast", 1)
        u.av_opt_set(ctx, b"tune", b"zerolatency", 1)  # no B-frame delay
        u.av_opt_set(ctx, b"b", str(bitrate).encode(), 1)
        u.av_opt_set(ctx, b"g", str(keyint).encode(), 1)
        if av.avcodec_open2(ctx, codec, None) != 0:
            raise RuntimeError("avcodec_open2(libx264) failed")
        self._ctx = ctx
        # one reusable frame + packet per instance (unref'd after each
        # use; freed in close() — av_*_unref alone releases buffers but
        # leaks the struct)
        self._pkt = av.av_packet_alloc()
        self._fr = u.av_frame_alloc()

    def encode(self, y: np.ndarray, u_: np.ndarray, v: np.ndarray
               ) -> List[bytes]:
        """One I420 frame -> zero or more Annex-B access units."""
        av, u = self._av, self._u
        w, h = self.width, self.height
        fr = self._fr
        try:
            _seti(fr, _F_W, w)
            _seti(fr, _F_H, h)
            _seti(fr, _F_FMT, _AV_PIX_FMT_YUV420P)
            if u.av_frame_get_buffer(fr, 0) != 0:
                raise RuntimeError("av_frame_get_buffer failed")
            planes = [(np.asarray(y, np.uint8), h, w),
                      (np.asarray(u_, np.uint8), (h + 1) // 2,
                       (w + 1) // 2),
                      (np.asarray(v, np.uint8), (h + 1) // 2,
                       (w + 1) // 2)]
            for i, (arr, ph, pw) in enumerate(planes):
                if arr.shape != (ph, pw):
                    raise ValueError(
                        f"plane {i} must be {(ph, pw)}, got {arr.shape}")
                ls = _geti(fr, _F_LINESIZE + 4 * i)
                ptr = _getp(fr, _F_DATA + 8 * i)
                buf = np.ascontiguousarray(arr)
                for row in range(ph):
                    ctypes.memmove(ptr + row * ls,
                                   buf[row].ctypes.data, pw)
            # pts is deliberately left to libx264's own counter: frames
            # arrive in order and zerolatency keeps decode order equal
            # to presentation order.
            if av.avcodec_send_frame(self._ctx, fr) != 0:
                raise RuntimeError("avcodec_send_frame failed")
            return _drain_packets(av, self._ctx, self._pkt)
        finally:
            u.av_frame_unref(fr)

    def flush(self) -> List[bytes]:
        av = self._av
        av.avcodec_send_frame(self._ctx, None)
        return _drain_packets(av, self._ctx, self._pkt)


class H264Decoder(_AvHandle):
    """Decode H.264 Annex-B access units to I420 frames."""

    def __init__(self):
        av, u = _load()
        codec = av.avcodec_find_decoder_by_name(b"h264")
        if not codec:
            raise RuntimeError("h264 decoder not present in libavcodec")
        self._av, self._u = av, u
        ctx = av.avcodec_alloc_context3(codec)
        if av.avcodec_open2(ctx, codec, None) != 0:
            raise RuntimeError("avcodec_open2(h264) failed")
        self._ctx = ctx
        self._pkt = av.av_packet_alloc()
        self._fr = u.av_frame_alloc()

    def decode(self, au: bytes
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One access unit -> zero or more (y, u, v) I420 frames."""
        av = self._av
        pkt = self._pkt
        if av.av_new_packet(pkt, len(au)) != 0:
            raise RuntimeError("av_new_packet failed")
        ctypes.memmove(_getp(pkt, _P_DATA), au, len(au))
        out: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for attempt in range(2):
            r = av.avcodec_send_packet(self._ctx, pkt)
            if r == _AVERROR_EAGAIN:
                # output queue full: the packet was NOT consumed —
                # drain, then resend (dropping it would break the
                # decoder's reference chain silently)
                out += self._drain()
                continue
            av.av_packet_unref(pkt)
            if r != 0:
                raise RuntimeError(f"avcodec_send_packet: {r}")
            return out + self._drain()
        av.av_packet_unref(pkt)
        raise RuntimeError("avcodec_send_packet: EAGAIN after drain")

    def flush(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        self._av.avcodec_send_packet(self._ctx, None)
        return self._drain()

    def _drain(self):
        av, u = self._av, self._u
        out = []
        fr = self._fr
        while True:
            r = av.avcodec_receive_frame(self._ctx, fr)
            if r != 0:
                if r in (_AVERROR_EAGAIN, _AVERROR_EOF):
                    return out
                raise RuntimeError(f"avcodec_receive_frame: {r}")
            w, h = _geti(fr, _F_W), _geti(fr, _F_H)
            planes = []
            for i, (ph, pw) in enumerate(((h, w),
                                          ((h + 1) // 2, (w + 1) // 2),
                                          ((h + 1) // 2, (w + 1) // 2))):
                ls = _geti(fr, _F_LINESIZE + 4 * i)
                ptr = _getp(fr, _F_DATA + 8 * i)
                rows = np.frombuffer(
                    ctypes.string_at(ptr, ls * ph), np.uint8
                ).reshape(ph, ls)[:, :pw]
                planes.append(rows.copy())
            out.append(tuple(planes))
            u.av_frame_unref(fr)
