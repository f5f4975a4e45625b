"""Python face of the port's batched UDP engine (recvmmsg / sendmmsg).

Counterpart: `libjitsi_tpu/io/udp.py` and the recvmmsg/sendmmsg part of
`libjitsi_tpu/native/udp_engine.cpp`.  The port keeps its own copy of
the C engine (`native/udp_engine.cpp`), built with g++ at first use into
the package's git-ignored `build/` directory and loaded with ctypes.
Receives land directly in a PacketBatch-shaped buffer ([max_batch,
capacity] uint8 + int32 lengths).  The JAX engine's io_uring mode,
kernel timestamps and zero-copy arena views are not part of this slice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import struct
import subprocess
import threading
from typing import Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import DEFAULT_CAPACITY, PacketBatch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "udp_engine.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_lib = None
_lock = threading.Lock()


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
            lib.udp_recv_batch.restype = ctypes.c_int
            lib.udp_recv_batch.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
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


def ip_to_u32(ip: str) -> int:
    return struct.unpack("!I", socket.inet_aton(ip))[0]


class UdpEngine:
    """One batched UDP socket (rtcp-mux style single port per engine)."""

    def __init__(self, port: int = 0, bind_ip: str = "0.0.0.0",
                 reuseport: bool = False, capacity: int = DEFAULT_CAPACITY,
                 max_batch: int = 1024, rcvbuf: int = 4 << 20):
        lib = _load()
        self.capacity = capacity
        self.max_batch = max_batch
        fd = lib.udp_create(bind_ip.encode(), port, int(reuseport), rcvbuf)
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd))
        self._fd = fd
        self.port = lib.udp_local_port(fd)
        self._buf = np.zeros((max_batch, capacity), dtype=np.uint8)
        self._len = np.zeros(max_batch, dtype=np.int32)
        self._sip = np.zeros(max_batch, dtype=np.uint32)
        self._sport = np.zeros(max_batch, dtype=np.uint16)

    @property
    def rcvbuf(self) -> int:
        """The receive buffer the kernel granted, in bytes."""
        return _load().udp_rcvbuf(self._fd)

    def recv_batch(self, timeout_ms: int = 1
                   ) -> Tuple[PacketBatch, np.ndarray, np.ndarray]:
        """One batching window: up to max_batch datagrams.

        Returns (batch, src_ip_u32, src_port), batch_size 0 on timeout;
        the batch is a copy the caller may keep.
        """
        n = _load().udp_recv_batch(
            self._fd, self._buf.ctypes.data, self.capacity, self.max_batch,
            self._len.ctypes.data, self._sip.ctypes.data,
            self._sport.ctypes.data, timeout_ms)
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        batch = PacketBatch(self._buf[:n].copy(), self._len[:n].copy(),
                            np.full(n, -1, dtype=np.int32))
        return batch, self._sip[:n].copy(), self._sport[:n].copy()

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
