"""Python face of the port's batched UDP engine (recvmmsg / sendmmsg).

Counterpart: `libjitsi_tpu/io/udp.py` and the recvmmsg/sendmmsg part of
`libjitsi_tpu/native/udp_engine.cpp`.  The port keeps its own copy of
the C engine (`native/udp_engine.cpp`), built with g++ at first use into
the package's git-ignored `build/` directory and loaded with ctypes.
Receives land directly in a PacketBatch-shaped buffer ([max_batch,
capacity] uint8 + int32 lengths), one of a ring of receive arenas:
`recv_batch` copies a window out of its arena, and `recv_batch_view`
(the deep-pipelined loop's ingress) hands out views of the arena, pinned
until `release_arena`; a pinned arena is never handed back to the
kernel, and the ring grows when every arena is pinned (JAX
`io/udp.py:138-170, 305-335, 413-444`).  The ring is Python-side: the C
engine scatters into whatever buffer it is given.

Kernel arrival stamps (`kernel_timestamps=True`, SO_TIMESTAMPNS):
`recv_batch_ts` and `recv_batch_ts_view` add each datagram's int64
CLOCK_REALTIME nanoseconds, row-aligned with the batch, under the same
copy and pin contracts; an engine whose socket refuses the option logs a
warning and reads `kernel_timestamps` False (the stamps are then one
clock read a window).  `syscall_enters` counts native recvmmsg/sendmmsg
calls; `ring_reaps` is 0, the engine having one mode, recvmmsg
(`engine_mode` "auto" or "recvmmsg"; the JAX engine's io_uring mode is
not ported, ROADMAP Queue 1, item 4, and raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import struct
import subprocess
import threading
import time
from typing import Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import DEFAULT_CAPACITY, PacketBatch
from libjitsi_tpu_torch.utils.logging import get_logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "udp_engine.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_lib = None
_lock = threading.Lock()

#: receive arenas an engine starts with; the ring grows past it only
#: while every arena is pinned by a live view
ARENAS = 4


def _build() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha1(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libudp_engine_{key}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.udp_create.restype = ctypes.c_int
            lib.udp_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                       ctypes.c_int, ctypes.c_int]
            lib.udp_close.argtypes = [ctypes.c_int]
            lib.udp_local_port.restype = ctypes.c_int
            lib.udp_local_port.argtypes = [ctypes.c_int]
            lib.udp_rcvbuf.restype = ctypes.c_int
            lib.udp_rcvbuf.argtypes = [ctypes.c_int]
            lib.udp_enable_timestamps.restype = ctypes.c_int
            lib.udp_enable_timestamps.argtypes = [ctypes.c_int]
            lib.udp_recv_batch_ts.restype = ctypes.c_int
            lib.udp_recv_batch_ts.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            lib.udp_send_batch.restype = ctypes.c_int
            lib.udp_send_batch.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.udp_send_batch_idx.restype = ctypes.c_int
            lib.udp_send_batch_idx.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            _lib = lib
    return _lib


class _ArenaToken:
    """Pin receipt handed out with every zero-copy view; idempotent, so a
    double release can never steal another view's pin."""

    __slots__ = ("arena", "gen", "released")

    def __init__(self, arena: "_Arena", gen: int):
        self.arena = arena
        self.gen = gen
        self.released = False


class _Arena:
    """One receive arena, the PacketBatch SoA the kernel scatters into.
    `gen` tags its current occupancy; `pins` counts live views."""

    __slots__ = ("buf", "len", "sip", "sport", "ats", "gen", "pins")

    def __init__(self, rows: int, capacity: int):
        self.buf = np.zeros((rows, capacity), dtype=np.uint8)
        self.len = np.zeros(rows, dtype=np.int32)
        self.sip = np.zeros(rows, dtype=np.uint32)
        self.sport = np.zeros(rows, dtype=np.uint16)
        self.ats = np.zeros(rows, dtype=np.int64)
        self.gen = 0
        self.pins = 0


def ip_to_u32(ip: str) -> int:
    return struct.unpack("!I", socket.inet_aton(ip))[0]


ENGINE_MODES = ("auto", "recvmmsg", "io_uring")


def check_engine_mode(engine_mode: str) -> None:
    """Take "auto" and "recvmmsg"; refuse the JAX engine's io_uring mode,
    which is not ported."""
    if engine_mode not in ENGINE_MODES:
        raise ValueError(f"engine_mode: {engine_mode!r}")
    if engine_mode == "io_uring":
        raise NotImplementedError(
            "the io_uring engine is not ported yet (ROADMAP Queue 1, "
            "item 4)")


class UdpEngine:
    """One batched UDP socket (rtcp-mux style single port per engine).
    SO_REUSEPORT (`reuseport=True`) lets several engines share a port, the
    kernel spreading flows over them by hash."""

    def __init__(self, port: int = 0, bind_ip: str = "0.0.0.0",
                 reuseport: bool = False, capacity: int = DEFAULT_CAPACITY,
                 max_batch: int = 1024, rcvbuf: int = 4 << 20,
                 kernel_timestamps: bool = False,
                 engine_mode: str = "auto"):
        check_engine_mode(engine_mode)
        #: the mode the engine runs: the port has recvmmsg alone
        self.engine_mode = "recvmmsg"
        lib = _load()
        self.capacity = capacity
        #: recv windows honour the current value; the arenas are sized
        #: from the constructor's
        self.max_batch = max_batch
        fd = lib.udp_create(bind_ip.encode(), port, int(reuseport), rcvbuf)
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd))
        self._fd = fd
        self.port = lib.udp_local_port(fd)
        self.kernel_timestamps = False
        if kernel_timestamps:
            self.kernel_timestamps = lib.udp_enable_timestamps(fd) == 0
            if not self.kernel_timestamps:
                # asked for and refused: the stamps fall back to one
                # clock read a window, which must not pass silently
                get_logger("io.udp").warn("kernel_timestamps_unavailable",
                                          port=self.port)
        #: native recvmmsg / sendmmsg calls made
        self.syscall_enters = 0
        #: completions reaped without a syscall (an io_uring engine's);
        #: always 0 here
        self.ring_reaps = 0
        self._rows = max_batch
        self._ring = [_Arena(max_batch, capacity) for _ in range(ARENAS)]
        self._ring_pos = 0
        #: times the ring grew because every arena was pinned
        self.arena_grows = 0

    @property
    def rcvbuf(self) -> int:
        """The receive buffer the kernel granted, in bytes."""
        return _load().udp_rcvbuf(self._fd)

    def _next_arena(self) -> _Arena:
        """The unpinned arena at the ring cursor; the ring grows when
        every arena has a live view (a pinned arena is never handed back
        to the kernel)."""
        ring = self._ring
        for _ in range(len(ring)):
            a = ring[self._ring_pos]
            if a.pins == 0:
                return a
            self._ring_pos = (self._ring_pos + 1) % len(ring)
        a = _Arena(self._rows, self.capacity)
        ring.insert(self._ring_pos, a)
        self.arena_grows += 1
        return a

    def _recv_arena(self, timeout_ms: int, want_ts: bool = False
                    ) -> Tuple[_Arena, int]:
        """One batching window into a fresh arena: (arena, n); with
        `want_ts` the arena's `ats` rows hold the arrival stamps."""
        a = self._next_arena()
        a.gen += 1                  # stale tokens of its last use die
        self.syscall_enters += 1
        n = _load().udp_recv_batch_ts(
            self._fd, a.buf.ctypes.data, self.capacity,
            max(1, min(int(self.max_batch), self._rows)), a.len.ctypes.data,
            a.sip.ctypes.data, a.sport.ctypes.data,
            a.ats.ctypes.data if want_ts else None, timeout_ms)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return a, n

    def _view(self, a: _Arena, n: int) -> PacketBatch:
        """The window's rows as views of the arena, pinned by the batch's
        `arena_token` when it holds any."""
        batch = PacketBatch(a.buf[:n], a.len[:n],
                            np.full(n, -1, dtype=np.int32))
        if n > 0:
            a.pins += 1
            batch.arena_token = _ArenaToken(a, a.gen)
        return batch

    def recv_batch(self, timeout_ms: int = 1
                   ) -> Tuple[PacketBatch, np.ndarray, np.ndarray]:
        """One batching window: up to max_batch datagrams.

        Returns (batch, src_ip_u32, src_port), batch_size 0 on timeout;
        the batch is a copy the caller may keep.
        """
        a, n = self._recv_arena(timeout_ms)
        batch = PacketBatch(a.buf[:n].copy(), a.len[:n].copy(),
                            np.full(n, -1, dtype=np.int32))
        return batch, a.sip[:n].copy(), a.sport[:n].copy()

    def recv_batch_view(self, timeout_ms: int = 1
                        ) -> Tuple[PacketBatch, np.ndarray, np.ndarray]:
        """Zero-copy `recv_batch`: the batch's data and lengths are views
        of the receive arena, tagged `arena_token`; the arena stays
        pinned until that token is passed to `release_arena`, exactly
        once per batch."""
        a, n = self._recv_arena(timeout_ms)
        return self._view(a, n), a.sip[:n], a.sport[:n]

    def recv_batch_ts(self, timeout_ms: int = 1
                      ) -> Tuple[PacketBatch, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """`recv_batch` plus each datagram's arrival time (int64 ns,
        CLOCK_REALTIME): the kernel's receive stamp when
        `kernel_timestamps` is on, else one clock read a window."""
        a, n = self._recv_arena(timeout_ms, want_ts=True)
        batch = PacketBatch(a.buf[:n].copy(), a.len[:n].copy(),
                            np.full(n, -1, dtype=np.int32))
        return batch, a.sip[:n].copy(), a.sport[:n].copy(), a.ats[:n].copy()

    def recv_batch_ts_view(self, timeout_ms: int = 1
                           ) -> Tuple[PacketBatch, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """Zero-copy `recv_batch_ts`; the stamps are views of the same
        pinned arena (see `recv_batch_view`)."""
        a, n = self._recv_arena(timeout_ms, want_ts=True)
        return self._view(a, n), a.sip[:n], a.sport[:n], a.ats[:n]

    @classmethod
    def create_with_retry(cls, retries: int = 5, backoff_s: float = 0.05,
                          sleep=None, **kwargs) -> "UdpEngine":
        """Bind with bounded retry and exponential backoff (`backoff_s`
        doubling a try, at most 2 s): a just-closed socket can hold the
        port a moment, while a port that stays taken still fails, with
        the last `OSError`."""
        if retries < 1:
            raise ValueError("retries must be >= 1")
        sleep = time.sleep if sleep is None else sleep
        for attempt in range(retries):
            try:
                return cls(**kwargs)
            except OSError:
                if attempt + 1 == retries:
                    raise
                sleep(min(backoff_s * 2.0 ** attempt, 2.0))

    def release_arena(self, token) -> None:
        """Drop the pin a `recv_batch_view` placed (`token` is the batch's
        `arena_token`); a second release of a token does nothing."""
        if token is None or token.released:
            return
        token.released = True
        a = token.arena
        if a.gen == token.gen and a.pins > 0:
            a.pins -= 1

    def send_rows(self, batch: PacketBatch, rows, dst_ip, dst_port) -> int:
        """Send the selected rows in one multi-destination sendmmsg (the
        iovec gather is the row selection).  dst_ip (u32 or dotted str)
        and dst_port are scalars or per-selected-row arrays."""
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        return self._send(batch, rows, np.asarray(batch.length)[rows],
                          dst_ip, dst_port)

    def send_batch(self, batch: PacketBatch, dst_ip, dst_port) -> int:
        """Send all rows; dst_ip/dst_port broadcast over the batch."""
        return self._send(batch, None, batch.length, dst_ip, dst_port)

    def _send(self, batch, rows, lengths, dst_ip, dst_port) -> int:
        n = len(lengths)
        if n == 0:
            return 0
        if isinstance(dst_ip, str):
            dst_ip = ip_to_u32(dst_ip)
        data = np.ascontiguousarray(batch.data, dtype=np.uint8)
        lens = np.ascontiguousarray(lengths, dtype=np.int32)
        ips = np.ascontiguousarray(np.broadcast_to(
            np.asarray(dst_ip, dtype=np.uint32), (n,)))
        ports = np.ascontiguousarray(np.broadcast_to(
            np.asarray(dst_port, dtype=np.uint16), (n,)))
        lib = _load()
        self.syscall_enters += 1
        if rows is None:
            sent = lib.udp_send_batch(
                self._fd, data.ctypes.data, data.shape[1], lens.ctypes.data,
                ips.ctypes.data, ports.ctypes.data, n)
        else:
            sent = lib.udp_send_batch_idx(
                self._fd, data.ctypes.data, data.shape[1], lens.ctypes.data,
                ips.ctypes.data, ports.ctypes.data, rows.ctypes.data, n)
        if sent < 0:
            raise OSError(-sent, os.strerror(-sent))
        return sent

    def close(self) -> None:
        if self._fd >= 0:
            _load().udp_close(self._fd)
            self._fd = -1

    def __enter__(self) -> "UdpEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
