"""TCP media connector — RFC 4571 framed RTP/RTCP over a stream socket.

Counterpart: `libjitsi_tpu/io/tcp.py` (copied onto the port's
`PacketBatch` and `io/udp.py`), with `TcpMediaEngine.send_rows` and
`recv_batch_view` added: the port's `MediaLoop` sends a masked subset
through `send_rows` and receives through `recv_batch_view` at depth > 1
(a TCP batch is a copy, so it carries no arena pin).

Parity target: `org.jitsi.impl.neomedia.RTPConnectorTCPImpl` (+
`RTPConnectorTCPInputStream/OutputStream`), the reference's fallback
transport when UDP is blocked (SURVEY §2.3 "RTP connector" row).  Framing
is RFC 4571: each RTP/RTCP packet is prefixed with a 16-bit big-endian
length.

Design note: TCP is the *cold* path — a handful of firewalled
endpoints, not the 10k-stream fan-out (that rides the batched C++ UDP
engine, `native/udp_engine.cpp`).  So this is plain non-blocking Python
sockets presenting the same batch interface as `UdpEngine`
(`recv_batch` -> PacketBatch, `send_batch`), so a `MediaLoop` can run
over either transport unchanged.
"""

from __future__ import annotations

import logging
import socket
import struct
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.udp import ip_to_u32, u32_to_ip

_log = logging.getLogger(__name__)

_MAX_FRAME = 65535


class _FrameBuffer:
    """Incremental RFC 4571 deframer over a stream of recv() chunks."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        out: List[bytes] = []
        while True:
            if len(self._buf) < 2:
                return out
            need = struct.unpack_from("!H", self._buf)[0]
            if len(self._buf) < 2 + need:
                return out
            out.append(bytes(self._buf[2:2 + need]))
            del self._buf[:2 + need]


def frame(packet: bytes) -> bytes:
    """RFC 4571 encapsulation of one RTP/RTCP packet."""
    if len(packet) > _MAX_FRAME:
        raise ValueError(f"packet of {len(packet)} bytes exceeds RFC 4571 "
                         "16-bit length prefix")
    return struct.pack("!H", len(packet)) + packet


class TcpConnector:
    """Batched media transport over TCP connections.

    Server mode (``listen=True``) accepts any number of peers; client
    mode (`connect()`) dials out.  Peers are keyed by ``(ip, port)`` just
    like the UDP engine's source addresses, so `MediaLoop`-style demux by
    SSRC works identically downstream.
    """

    def __init__(self, port: int = 0, bind_ip: str = "127.0.0.1",
                 listen: bool = False, max_batch: int = 256,
                 mtu: int = 1500, send_timeout_s: float = 5.0):
        self.max_batch = max_batch
        self.mtu = mtu
        self.send_timeout_s = send_timeout_s
        # packets legitimately framed larger than our batch row width
        # (RFC 4571 allows 64 KiB) are dropped but never silently
        self.dropped_oversize = 0
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._frames: Dict[Tuple[str, int], _FrameBuffer] = {}
        self._overflow: deque = deque()   # O(1) popleft on flood drain
        self._listener: Optional[socket.socket] = None
        if listen:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((bind_ip, port))
            s.listen(64)
            s.setblocking(False)
            self._listener = s

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else 0

    def connect(self, ip: str, port: int,
                timeout_s: float = 5.0) -> Tuple[str, int]:
        s = socket.create_connection((ip, port), timeout=timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        key = (ip, port)
        self._conns[key] = s
        self._frames[key] = _FrameBuffer()
        return key

    def _accept_pending(self) -> None:
        if self._listener is None:
            return
        while True:
            try:
                s, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
            self._conns[addr] = s
            self._frames[addr] = _FrameBuffer()

    def peers(self) -> List[Tuple[str, int]]:
        self._accept_pending()
        return list(self._conns)

    # -- batch interface (mirrors UdpEngine) --------------------------

    def recv_batch(self, timeout_ms: int = 1) -> Tuple[PacketBatch,
                                                       List[Tuple[str, int]]]:
        """Drain ready packets into a PacketBatch + per-row source addrs."""
        self._accept_pending()
        deadline = time.monotonic() + timeout_ms / 1e3
        payloads: List[bytes] = []
        addrs: List[Tuple[str, int]] = []
        # packets deframed beyond max_batch on a previous call queue here
        # so the max_batch contract holds even when one recv() chunk
        # yields thousands of small frames
        while self._overflow and len(payloads) < self.max_batch:
            key, pkt = self._overflow.popleft()
            payloads.append(pkt)
            addrs.append(key)
        while len(payloads) < self.max_batch:
            progressed = False
            for key, s in list(self._conns.items()):
                try:
                    chunk = s.recv(65536)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    chunk = b""
                if not chunk:           # orderly close or error: drop peer
                    self._drop(key)
                    continue
                progressed = True
                for pkt in self._frames[key].feed(chunk):
                    if len(pkt) > self.mtu:
                        self.dropped_oversize += 1
                        _log.warning(
                            "dropping %d-byte framed packet from %s "
                            "(> row width %d; raise TcpConnector(mtu=...) "
                            "to accept)", len(pkt), key, self.mtu)
                    elif len(payloads) < self.max_batch:
                        payloads.append(pkt)
                        addrs.append(key)
                    else:
                        self._overflow.append((key, pkt))
            if not progressed:
                if payloads or time.monotonic() >= deadline:
                    break
                time.sleep(0.0002)
        if not payloads:
            return PacketBatch.empty(0, self.mtu), []
        return PacketBatch.from_payloads(payloads, capacity=self.mtu), addrs

    def send_batch(self, batch: PacketBatch, dst: Tuple[str, int]) -> int:
        """Send every row of `batch` to one peer; returns packets sent."""
        s = self._conns.get(dst)
        if s is None:
            raise KeyError(f"no TCP connection to {dst}")
        blob = b"".join(frame(batch.to_bytes(i))
                        for i in range(batch.batch_size))
        # bounded blocking send: a peer that stopped reading (zero TCP
        # window) must not wedge the media loop forever — on timeout the
        # peer is dropped like any dead connection
        s.settimeout(self.send_timeout_s)
        try:
            s.sendall(blob)
        except (socket.timeout, OSError):
            self._drop(dst)
            raise ConnectionError(f"peer {dst} stalled/failed; dropped")
        finally:
            try:
                s.settimeout(0)         # back to non-blocking
            except OSError:
                pass                    # already closed by _drop
        return batch.batch_size

    def _drop(self, key: Tuple[str, int]) -> None:
        conn = self._conns.pop(key, None)
        self._frames.pop(key, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        for key in list(self._conns):
            self._drop(key)
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class TcpMediaEngine:
    """UdpEngine-signature adapter: run a MediaLoop over TCP unchanged.

    The reference swaps `RTPConnectorUDPImpl` for `RTPConnectorTCPImpl`
    under the same `AbstractRTPConnector` surface; this is the same
    move for our batch interface — `recv_batch` returns (batch, src_ip
    u32 array, src_port array) and `send_batch(batch, ip, port)`
    resolves the peer connection, so `MediaLoop` cannot tell the
    transports apart (address latching and all).
    """

    def __init__(self, connector: TcpConnector):
        self.connector = connector
        self.send_failures = 0    # peers dropped mid-fan-out

    @property
    def port(self) -> int:
        return self.connector.port

    def recv_batch(self, timeout_ms: int = 1):
        batch, addrs = self.connector.recv_batch(timeout_ms)
        sip = np.array([ip_to_u32(ip) for ip, _ in addrs], dtype=np.uint32)
        sport = np.array([p for _, p in addrs], dtype=np.uint16)
        return batch, sip, sport

    #: the deep loop's zero-copy receive: a TCP batch is a copy already
    recv_batch_view = recv_batch

    def send_rows(self, batch: PacketBatch, rows, dst_ip, dst_port) -> int:
        """Send the selected rows; `dst_ip` / `dst_port` are scalars or
        per-selected-row arrays (the port loop's masked egress)."""
        rows = np.asarray(rows, dtype=np.int64)
        return self.send_batch(
            PacketBatch(batch.data[rows], np.asarray(batch.length)[rows],
                        np.asarray(batch.stream)[rows]), dst_ip, dst_port)

    def send_batch(self, batch: PacketBatch, dst_ip, dst_port) -> int:
        """dst_ip/dst_port may be scalars or per-row arrays (MediaLoop
        sends with latched per-row addresses); rows are grouped per
        peer connection.  One dead/stalled peer must not abort the
        fan-out or crash the loop (UDP never raises per-peer, and the
        adapter's contract is that MediaLoop can't tell transports
        apart) — its failure is counted and the other peers still get
        their rows."""
        n = batch.batch_size
        if n == 0:
            return 0
        if isinstance(dst_ip, str):
            ips = np.full(n, ip_to_u32(dst_ip), dtype=np.uint64)
        else:
            ips = np.broadcast_to(
                np.asarray(dst_ip, dtype=np.uint64), (n,))
        ports = np.broadcast_to(np.asarray(dst_port, dtype=np.uint64),
                                (n,))
        keys = (ips << 16) | ports
        sent = 0
        for key in np.unique(keys):
            rows = np.nonzero(keys == key)[0]
            dst = (u32_to_ip(int(key >> 16)), int(key & 0xFFFF))
            sub = PacketBatch(batch.data[rows],
                              np.asarray(batch.length)[rows],
                              np.asarray(batch.stream)[rows])
            try:
                sent += self.connector.send_batch(sub, dst)
            except (ConnectionError, KeyError, OSError) as e:
                self.send_failures += 1
                _log.warning("dropping %d rows for TCP peer %s: %s",
                             len(rows), dst, e)
        return sent

    def close(self) -> None:
        self.connector.close()
