"""The host I/O loop: UDP batches in, transform chains, UDP batches out.

Counterpart: `libjitsi_tpu/io/loop.py` `MediaLoop`, classic depth-1
serial tick.  One tick (1) drains a recvmmsg batching window, (2) splits
DTLS from media by first byte, (3) splits RTCP from RTP (rtcp-mux),
(4) maps SSRCs to stream rows and latches each row's sender address,
(5) runs the shared reverse chain once for the whole batch, (6) hands
the decrypted media to a sink, and (7) protects and sends whatever the
sink returns — two device launches per tick regardless of stream count.

Each stage runs inside a `torch.profiler.record_function` span
(ingress, reverse_chain, forward_chain, egress), so a profiler trace of
the loop shows where a tick's time goes.  Streams on hold (an SFU
endpoint staged but not yet committed) queue their RTP and drop their
RTCP until released, as in the JAX loop.  The JAX loop's pipelining,
fanout-only rows, shard-major reordering, pcap, flight recorder and
metrics registry are not part of the port yet.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
from torch.profiler import record_function

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.udp import UdpEngine


def is_dtls(first_byte: np.ndarray) -> np.ndarray:
    """RFC 5764 §5.1.2 demux: first byte in [20..63] = DTLS record.  The
    rule of `libjitsi_tpu/control/dtls.py` `is_dtls`, applied to the
    first bytes of a whole batch at once."""
    return (first_byte >= 20) & (first_byte <= 63)


def _is_rtcp(data: np.ndarray, length: np.ndarray) -> np.ndarray:
    """RFC 5761 demux: full second byte in [192, 223] marks RTCP on a
    muxed port (RTCP PTs 200..207 occupy the M-bit+PT bit positions)."""
    return (length >= 8) & (data[:, 1] >= 192) & (data[:, 1] <= 223)


def _rows(batch: PacketBatch, rows: np.ndarray) -> PacketBatch:
    return PacketBatch(batch.data[rows], np.asarray(batch.length)[rows],
                       batch.stream[rows])


class MediaLoop:
    """One engine's receive/transmit tick loop.

    Wire-in handlers:
      on_dtls(datagram, addr) -> [reply datagrams]
      on_media(batch, ok_mask) -> optional PacketBatch to send
      on_rtcp(batch, ok_mask) -> None
    Addresses: (ip_u32, port) per row; senders' addresses are learned
    per stream row (latching, like the reference's target discovery).
    """

    def __init__(self, engine: UdpEngine, registry,
                 on_media: Optional[Callable] = None,
                 on_rtcp: Optional[Callable] = None,
                 on_dtls: Optional[Callable] = None,
                 chain=None, recv_window_ms: int = 1):
        self.engine = engine
        self.registry = registry
        self.on_media = on_media
        self.on_rtcp = on_rtcp
        self.on_dtls = on_dtls
        self.chain = chain
        self.recv_window_ms = recv_window_ms
        # learned (ip, port) per stream row (latched from last packet)
        self.addr_ip = np.zeros(registry.capacity, dtype=np.uint32)
        self.addr_port = np.zeros(registry.capacity, dtype=np.uint16)
        self.ticks = 0
        self.rx_packets = 0
        self.tx_packets = 0
        self.dtls_packets = 0
        self.unknown_ssrc_dropped = 0
        self.reverse_dropped = 0
        # streams on hold: their RTP is queued, their RTCP dropped
        self._hold_mask = np.zeros(registry.capacity, dtype=bool)
        self._hold_q: Dict[int, deque] = {}

    # ------------------------------------------------------------- holds
    def hold_stream(self, sid: int, max_packets: int = 64) -> None:
        self._hold_mask[sid] = True
        self._hold_q[sid] = deque(maxlen=max_packets)

    def discard_stream(self, sid: int) -> None:
        """Drop a held stream's queue without replay (endpoint left)."""
        self._hold_mask[sid] = False
        self._hold_q.pop(sid, None)

    def release_stream(self, sid: int) -> int:
        """Replay a held stream's queued packets through the normal
        receive path (chain + on_media); returns the packet count."""
        self._hold_mask[sid] = False
        q = self._hold_q.pop(sid, None)
        if not q:
            return 0
        batch = PacketBatch.from_payloads(list(q), stream=[sid] * len(q))
        if self.chain is not None:
            batch, ok = self.chain.rtp_transformer.reverse_transform(batch)
        else:
            ok = np.ones(batch.batch_size, bool)
        if self.on_media is not None:
            reply = self.on_media(batch, ok)
            if reply is not None:
                self.send_media(reply)
        return len(q)

    def tick(self) -> int:
        """One batching window; returns packets received."""
        with record_function("ingress"):
            batch, sip, sport = self.engine.recv_batch(self.recv_window_ms)
        n = batch.batch_size
        self.ticks += 1
        if n:
            self.rx_packets += n
            self._ingest(batch, sip, sport)
        return n

    def _ingest(self, batch: PacketBatch, sip, sport) -> None:
        # 1. split DTLS (first byte 20..63) from media
        dtls = is_dtls(batch.data[:, 0])
        if dtls.any():
            rows = np.nonzero(dtls)[0]
            self.dtls_packets += len(rows)
            if self.on_dtls is not None:
                for i in rows:
                    addr = (int(sip[i]), int(sport[i]))
                    replies = self.on_dtls(batch.to_bytes(int(i)), addr)
                    if replies:
                        self.engine.send_batch(
                            PacketBatch.from_payloads(replies,
                                                      batch.capacity),
                            addr[0], addr[1])
            media = np.nonzero(~dtls)[0]
            if not len(media):
                return
            batch, sip, sport = _rows(batch, media), sip[media], sport[media]

        # 2. RTCP vs RTP split (rtcp-mux), then ssrc -> stream row (the
        # SSRC field sits at different offsets in the two formats)
        rtcp = _is_rtcp(batch.data, np.asarray(batch.length))
        sids = np.full(batch.batch_size, -1, dtype=np.int64)
        for sel, demux in ((~rtcp, self.registry.demux),
                           (rtcp, self.registry.demux_rtcp)):
            rows = np.nonzero(sel)[0]
            if len(rows):
                sids[rows] = demux(_rows(batch, rows))
        batch.stream[:] = sids
        known = sids >= 0
        self.unknown_ssrc_dropped += int((~known).sum())
        self.addr_ip[sids[known]] = sip[known]
        self.addr_port[sids[known]] = sport[known]

        rtp_rows = np.nonzero(~rtcp & known)[0]
        rtcp_rows = np.nonzero(rtcp & known)[0]
        if self._hold_q:
            held = self._hold_mask[sids[rtp_rows]]
            lens = np.asarray(batch.length)
            for i in rtp_rows[held]:
                self._hold_q[int(sids[i])].append(
                    batch.data[i, :lens[i]].tobytes())
            rtp_rows = rtp_rows[~held]
            rtcp_rows = rtcp_rows[~self._hold_mask[sids[rtcp_rows]]]
        if len(rtp_rows):
            rtp = (batch if len(rtp_rows) == batch.batch_size
                   else _rows(batch, rtp_rows))
            with record_function("reverse_chain"):
                if self.chain is not None:
                    rtp, ok = self.chain.rtp_transformer.reverse_transform(rtp)
                else:
                    ok = np.ones(rtp.batch_size, bool)
            self.reverse_dropped += int((~ok).sum())
            if self.on_media is not None:
                reply = self.on_media(rtp, ok)
                if reply is not None:
                    self.send_media(reply)
        if len(rtcp_rows) and self.on_rtcp is not None:
            rb = _rows(batch, rtcp_rows)
            with record_function("reverse_chain"):
                if self.chain is not None:
                    rb, okc = self.chain.rtcp_transformer.reverse_transform(
                        rb)
                else:
                    okc = np.ones(rb.batch_size, bool)
            self.on_rtcp(rb, okc)

    def send_media(self, batch: PacketBatch) -> int:
        """Protect (forward chain) + send a batch; rows route to each
        stream row's latched address."""
        if batch.batch_size == 0:
            return 0
        with record_function("forward_chain"):
            if self.chain is not None:
                batch, ok = self.chain.rtp_transformer.transform(batch)
            else:
                ok = np.ones(batch.batch_size, bool)
        with record_function("egress"):
            rows = np.nonzero(ok)[0]
            sids = np.clip(np.asarray(batch.stream)[rows], 0,
                           self.registry.capacity - 1)
            sent = self.engine.send_rows(batch, rows, self.addr_ip[sids],
                                         self.addr_port[sids])
        self.tx_packets += sent
        return sent
