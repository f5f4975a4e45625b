"""Minimal WebM (Matroska) muxer for recorded VP8 video.

Rebuilds the role of the reference's native webm writer
(`org.jitsi.impl.neomedia.recording.WebmDataSink` + its C++ JNI glue):
VP8 frames (as reassembled by the depacketizer) mux into a standard
WebM file — EBML header, one video track, clusters of SimpleBlocks
with keyframe flags.  Pure-Python EBML encoding; written from the
Matroska element registry, not a port.

Counterpart: `libjitsi_tpu/recording/webm.py` (copied; host NumPy).
"""

from __future__ import annotations

import struct
from typing import Optional

# EBML element ids (Matroska registry)
_EBML = 0x1A45DFA3
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_CLUSTER = 0x1F43B675
_SIMPLE_BLOCK = 0xA3


def _vint(n: int) -> bytes:
    """EBML variable-size integer (length marker form)."""
    for width in range(1, 9):
        if n < (1 << (7 * width)) - 1:
            b = n | (1 << (7 * width))
            return b.to_bytes(width, "big")
    raise ValueError("vint too large")


def _eid(i: int) -> bytes:
    w = (i.bit_length() + 7) // 8
    return i.to_bytes(w, "big")


def _elem(eid: int, payload: bytes) -> bytes:
    return _eid(eid) + _vint(len(payload)) + payload


def _uint(eid: int, v: int) -> bytes:
    w = max(1, (v.bit_length() + 7) // 8)
    return _elem(eid, v.to_bytes(w, "big"))


def _float(eid: int, v: float) -> bytes:
    return _elem(eid, struct.pack(">d", v))


def _string(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


class WebmWriter:
    """Streamed WebM file: one VP8 video track, 2 s clusters."""

    CLUSTER_SPAN_MS = 2000

    def __init__(self, path: str, width: int = 1280, height: int = 720):
        self._f = open(path, "wb")
        header = _elem(_EBML, b"".join([
            _uint(0x4286, 1),          # EBMLVersion
            _uint(0x42F7, 1),          # EBMLReadVersion
            _uint(0x42F2, 4),          # EBMLMaxIDLength
            _uint(0x42F3, 8),          # EBMLMaxSizeLength
            _string(0x4282, "webm"),   # DocType
            _uint(0x4287, 2),          # DocTypeVersion
            _uint(0x4285, 2),          # DocTypeReadVersion
        ]))
        self._f.write(header)
        # Segment with unknown size (streaming): 8-byte all-ones vint
        self._f.write(_eid(_SEGMENT) + b"\x01\xff\xff\xff\xff\xff\xff\xff")
        info = _elem(_INFO, b"".join([
            _uint(0x2AD7B1, 1_000_000),          # TimestampScale: 1 ms
            _string(0x4D80, "libjitsi-tpu"),     # MuxingApp
            _string(0x5741, "libjitsi-tpu"),     # WritingApp
        ]))
        track = _elem(_TRACKS, _elem(_TRACK_ENTRY, b"".join([
            _uint(0xD7, 1),                      # TrackNumber
            _uint(0x73C5, 1),                    # TrackUID
            _uint(0x83, 1),                      # TrackType: video
            _string(0x86, "V_VP8"),              # CodecID
            _elem(0xE0, b"".join([               # Video
                _uint(0xB0, width),              # PixelWidth
                _uint(0xBA, height),             # PixelHeight
            ])),
        ])))
        self._f.write(info + track)
        self._cluster_ts: Optional[int] = None
        self._cluster_buf = b""
        self.frames = 0

    def write_frame(self, vp8_frame: bytes, ts_ms: int,
                    keyframe: bool) -> None:
        if self._cluster_ts is None or \
                ts_ms - self._cluster_ts > self.CLUSTER_SPAN_MS or \
                ts_ms < self._cluster_ts:
            self._flush_cluster()
            self._cluster_ts = ts_ms
        rel = ts_ms - self._cluster_ts
        flags = 0x80 if keyframe else 0x00
        block = _vint(1) + struct.pack(">hB", rel, flags) + vp8_frame
        self._cluster_buf += _elem(_SIMPLE_BLOCK, block)
        self.frames += 1

    def _flush_cluster(self) -> None:
        if self._cluster_ts is None or not self._cluster_buf:
            return
        payload = _uint(0xE7, self._cluster_ts) + self._cluster_buf
        self._f.write(_elem(_CLUSTER, payload))
        self._cluster_buf = b""

    def close(self) -> None:
        self._flush_cluster()
        self._f.close()
