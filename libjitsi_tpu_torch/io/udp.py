"""Python face of the port's batched UDP engine (recvmmsg / sendmmsg and
io_uring).

Counterpart: `libjitsi_tpu/io/udp.py` and
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
clock read a window).

Two ingest engines (`engine_mode`), as in JAX `io/udp.py:98-298`:
recvmmsg, one syscall a batching window, and io_uring, where the whole
current arena is armed as ONE linked chain of single-shot RECVMSG SQEs
and steady-state windows reap completions from the shared-memory ring
without entering the kernel, delivering the completed contiguous prefix
of the armed arena (`_URING_ARENA_EXHAUSTED` re-arms the next unpinned
arena).  "auto" resolves to recvmmsg unless `LIBJITSI_TPU_ENGINE_MODE`
pins io_uring and `uring_available()` holds; an explicit "io_uring" takes
the ring whenever the probe passes and otherwise warns
`io_uring_unavailable_fallback` and runs recvmmsg.
`LIBJITSI_TPU_NO_IOURING` (or the pin "recvmmsg") turns the ring off.
Egress stays on sendmmsg unless `LIBJITSI_TPU_URING_EGRESS` opts into
SENDMSG SQEs on the ring.  `syscall_enters` counts native recvmmsg /
sendmmsg calls plus the ring's io_uring_enter syscalls; `ring_reaps`
counts completions reaped ring-side (0 under recvmmsg).
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
from typing import Optional, Tuple

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
            lib.udp_uring_supported.restype = ctypes.c_int
            lib.udp_uring_create.restype = ctypes.c_void_p
            lib.udp_uring_create.argtypes = [ctypes.c_int] * 4
            lib.udp_uring_arm.restype = ctypes.c_int
            lib.udp_uring_arm.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.udp_uring_recv.restype = ctypes.c_int
            lib.udp_uring_recv.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.udp_uring_send_idx.restype = ctypes.c_int
            lib.udp_uring_send_idx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            lib.udp_uring_stat.restype = ctypes.c_long
            lib.udp_uring_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.udp_uring_destroy.restype = None
            lib.udp_uring_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


#: the C engine's sentinel: every row of the armed arena was delivered
_URING_ARENA_EXHAUSTED = -9999


def _uring_env_disabled() -> bool:
    """io_uring turned off by the environment: LIBJITSI_TPU_NO_IOURING, or
    the mode pin LIBJITSI_TPU_ENGINE_MODE=recvmmsg."""
    if os.environ.get("LIBJITSI_TPU_NO_IOURING", ""):
        return True
    mode = os.environ.get("LIBJITSI_TPU_ENGINE_MODE", "").strip().lower()
    return mode == "recvmmsg"


def uring_available() -> bool:
    """The built engine carries the ring, the kernel accepts
    io_uring_setup (probed once, C-side) and the environment does not
    turn it off."""
    if _uring_env_disabled():
        return False
    return bool(_load().udp_uring_supported())


def probe_engine_mode() -> str:
    """The mode a fresh ``UdpEngine(engine_mode="auto")`` picks now:
    io_uring only where LIBJITSI_TPU_ENGINE_MODE pins it and the ring is
    available, else recvmmsg (JAX `io/udp.py:119`: on loopback the ring
    lost ~30% to recvmmsg, so it is not the default)."""
    mode = os.environ.get("LIBJITSI_TPU_ENGINE_MODE", "").strip().lower()
    if mode == "io_uring" and uring_available():
        return "io_uring"
    return "recvmmsg"


class _ArenaToken:
    """Pin receipt handed out with every zero-copy view; idempotent, so a
    double release can never steal another view's pin."""

    __slots__ = ("arena", "gen", "released")

    def __init__(self, arena: "_Arena", gen: int):
        self.arena = arena
        self.gen = gen
        self.released = False

    def __iter__(self):  # the JAX engine's (arena, gen) unpacking
        return iter((self.arena, self.gen))


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


def u32_to_ip(v: int) -> str:
    return socket.inet_ntoa(struct.pack("!I", v & 0xFFFFFFFF))


ENGINE_MODES = ("auto", "recvmmsg", "io_uring")


def check_engine_mode(engine_mode: str) -> None:
    """Take the JAX engine's three modes; refuse anything else."""
    if engine_mode not in ENGINE_MODES:
        raise ValueError(f"engine_mode: {engine_mode!r}")


class UdpEngine:
    """One batched UDP socket (rtcp-mux style single port per engine).
    SO_REUSEPORT (`reuseport=True`) lets several engines share a port, the
    kernel spreading flows over them by hash."""

    def __init__(self, port: int = 0, bind_ip: str = "0.0.0.0",
                 reuseport: bool = False, capacity: int = DEFAULT_CAPACITY,
                 max_batch: int = 1024, rcvbuf: int = 4 << 20,
                 kernel_timestamps: bool = False, arenas: int = ARENAS,
                 engine_mode: str = "auto"):
        check_engine_mode(engine_mode)
        # ring egress is opt-in: one sendmmsg beat N SENDMSG SQEs on the
        # JAX round's box (JAX `io/udp.py:203-211`)
        self.uring_egress = bool(
            os.environ.get("LIBJITSI_TPU_URING_EGRESS", ""))
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
        # native recvmmsg / sendmmsg calls; the ring's enters add in
        self._py_enters = 0
        self._rows = max_batch
        self._ring = [_Arena(max_batch, capacity)
                      for _ in range(max(1, arenas))]
        self._ring_pos = 0
        #: times the ring grew because every arena was pinned
        self.arena_grows = 0
        self._u = None          # the io_uring engine's handle
        self._uring_arena: Optional[_Arena] = None
        want_uring = (engine_mode == "io_uring"
                      or (engine_mode == "auto"
                          and probe_engine_mode() == "io_uring"))
        #: the mode the engine runs
        self.engine_mode = "recvmmsg"
        if want_uring and uring_available():
            # a ring sized to one arena: arming it is one chain of rows
            self._u = lib.udp_uring_create(fd, self._rows, 0,
                                           int(self.kernel_timestamps))
            if self._u:
                self.engine_mode = "io_uring"
                self._uring_arm(self._ring[0])
        if engine_mode == "io_uring" and self.engine_mode != "io_uring":
            # an explicit request degraded: must not pass silently
            get_logger("io.udp").warn("io_uring_unavailable_fallback",
                                      port=self.port)

    def _uring_arm(self, a: "_Arena") -> None:
        """Hand a whole unpinned arena to the kernel as one linked chain of
        recvs; the gen bump voids tokens of its last occupancy."""
        a.gen += 1
        rc = _load().udp_uring_arm(
            self._u, a.buf.ctypes.data, self._rows, self.capacity,
            a.len.ctypes.data, a.sip.ctypes.data, a.sport.ctypes.data,
            a.ats.ctypes.data)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        self._uring_arena = a

    @property
    def syscall_enters(self) -> int:
        """Native recvmmsg / sendmmsg calls plus the ring's io_uring_enter
        syscalls (ring-side reaps cost none)."""
        if self._u is not None:
            return self._py_enters + int(_load().udp_uring_stat(self._u, 0))
        return self._py_enters

    @property
    def ring_reaps(self) -> int:
        """Completions reaped ring-side without entering the kernel."""
        if self._u is not None:
            return int(_load().udp_uring_stat(self._u, 1))
        return 0

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
                    ) -> Tuple[_Arena, int, int]:
        """One batching window: (arena, lo, n), the window's packets in
        arena rows [lo, lo + n).  recvmmsg fills a fresh arena from row 0;
        io_uring hands out the next completed prefix of the armed arena
        (its stamps are always taken), re-arming the next one when it is
        exhausted.  With `want_ts` the arena's `ats` rows hold the
        arrival stamps."""
        lib = _load()
        limit = max(1, min(int(self.max_batch), self._rows))
        if self._u is not None:
            start = ctypes.c_int32(0)
            n = lib.udp_uring_recv(self._u, limit, timeout_ms,
                                   ctypes.byref(start))
            if n == _URING_ARENA_EXHAUSTED:
                # every row delivered, so the kernel holds none of it
                self._uring_arm(self._next_arena())
                n = lib.udp_uring_recv(self._u, limit, timeout_ms,
                                       ctypes.byref(start))
            if n < 0:
                raise OSError(-n, os.strerror(-n))
            return self._uring_arena, int(start.value), n
        a = self._next_arena()
        a.gen += 1                  # stale tokens of its last use die
        self._py_enters += 1
        n = lib.udp_recv_batch_ts(
            self._fd, a.buf.ctypes.data, self.capacity, limit,
            a.len.ctypes.data, a.sip.ctypes.data, a.sport.ctypes.data,
            a.ats.ctypes.data if want_ts else None, timeout_ms)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return a, 0, n

    def _view(self, a: _Arena, lo: int, n: int) -> PacketBatch:
        """The window's rows as views of the arena, pinned by the batch's
        `arena_token` when it holds any."""
        batch = PacketBatch(a.buf[lo:lo + n], a.len[lo:lo + n],
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
        a, lo, n = self._recv_arena(timeout_ms)
        hi = lo + n
        batch = PacketBatch(a.buf[lo:hi].copy(), a.len[lo:hi].copy(),
                            np.full(n, -1, dtype=np.int32))
        return batch, a.sip[lo:hi].copy(), a.sport[lo:hi].copy()

    def recv_batch_view(self, timeout_ms: int = 1
                        ) -> Tuple[PacketBatch, np.ndarray, np.ndarray]:
        """Zero-copy `recv_batch`: the batch's data and lengths are views
        of the receive arena, tagged `arena_token`; the arena stays
        pinned until that token is passed to `release_arena`, exactly
        once per batch."""
        a, lo, n = self._recv_arena(timeout_ms)
        return self._view(a, lo, n), a.sip[lo:lo + n], a.sport[lo:lo + n]

    def recv_batch_ts(self, timeout_ms: int = 1
                      ) -> Tuple[PacketBatch, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """`recv_batch` plus each datagram's arrival time (int64 ns,
        CLOCK_REALTIME): the kernel's receive stamp when
        `kernel_timestamps` is on, else one clock read a window."""
        a, lo, n = self._recv_arena(timeout_ms, want_ts=True)
        hi = lo + n
        batch = PacketBatch(a.buf[lo:hi].copy(), a.len[lo:hi].copy(),
                            np.full(n, -1, dtype=np.int32))
        return (batch, a.sip[lo:hi].copy(), a.sport[lo:hi].copy(),
                a.ats[lo:hi].copy())

    def recv_batch_ts_view(self, timeout_ms: int = 1
                           ) -> Tuple[PacketBatch, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """Zero-copy `recv_batch_ts`; the stamps are views of the same
        pinned arena (see `recv_batch_view`)."""
        a, lo, n = self._recv_arena(timeout_ms, want_ts=True)
        hi = lo + n
        return (self._view(a, lo, n), a.sip[lo:hi], a.sport[lo:hi],
                a.ats[lo:hi])

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
        `arena_token`); a second release of a token does nothing.  The
        JAX engine's (arena, gen) tuple is taken too, checked by its
        generation alone."""
        if token is None:
            return
        if isinstance(token, _ArenaToken):
            if token.released:
                return
            token.released = True
        a, gen = token
        if a.gen == gen and a.pins > 0:
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
        if self._u is not None and self.uring_egress:
            # NULL idx is the identity: every row
            sent = lib.udp_uring_send_idx(
                self._u, data.ctypes.data, data.shape[1], lens.ctypes.data,
                ips.ctypes.data, ports.ctypes.data,
                None if rows is None else rows.ctypes.data, n)
        elif rows is None:
            self._py_enters += 1
            sent = lib.udp_send_batch(
                self._fd, data.ctypes.data, data.shape[1], lens.ctypes.data,
                ips.ctypes.data, ports.ctypes.data, n)
        else:
            self._py_enters += 1
            sent = lib.udp_send_batch_idx(
                self._fd, data.ctypes.data, data.shape[1], lens.ctypes.data,
                ips.ctypes.data, ports.ctypes.data, rows.ctypes.data, n)
        if sent < 0:
            raise OSError(-sent, os.strerror(-sent))
        return sent

    def close(self) -> None:
        if self._u is not None:
            # cancels the armed recvs and drains them before the arenas
            # can go: must come before the socket closes
            _load().udp_uring_destroy(self._u)
            self._u = None
            self._uring_arena = None
        if self._fd >= 0:
            _load().udp_close(self._fd)
            self._fd = -1

    def __del__(self):
        # an armed ring references the arenas: never let them be freed
        # under it
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "UdpEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
