"""The host I/O loop: UDP batches in, transform chains, UDP batches out.

Counterpart: `libjitsi_tpu/io/loop.py` `MediaLoop`.  One tick (1) drains
a recvmmsg batching window, (2) splits DTLS from media by first byte,
(3) splits RTCP from RTP (rtcp-mux), (4) maps SSRCs to stream rows and
latches each row's sender address, (5) runs the shared reverse chain
once for the whole batch, (6) hands the decrypted media to a sink, and
(7) protects and sends whatever the sink returns — two device launches
per tick regardless of stream count.

Pipelining (`pipeline_depth`, `pipelined`), as in the JAX loop:
  - `pipelined`: the sink's replies are dispatched only
    (`send_media_async`: the chain's `transform_async`, kernel C
    launched, its rows copied back behind a CUDA event) and sent at the
    top of the next tick (`flush_sends`), so the protect overlaps the
    next recv window.
  - `pipeline_depth` D > 1 (implies `pipelined`): the receive path too.
    Tick N's unprotect is dispatched only (`reverse_transform_async`)
    and materializes D - 1 ticks later (`_materialize_rx`, FIFO), its
    ingress held in a pinned zero-copy arena view of the UDP engine
    until then.  `commit_inflight` runs before each new async
    unprotect, so the replay window's updates land in dispatch order.
  - Order of work in a tick: receive, flush the egress dispatched on
    earlier ticks, materialize the receive work that came due, then
    ingest the new batch; an idle window (nothing received) collapses
    the pipeline (`drain`).  `drain()` is also the barrier that
    checkpoint and lifecycle points run behind.
  - Journeys: each ingress batch gets a trace id and an arrival stamp
    (`journey_origin`); whatever leaves is observed against the origin
    of the tick it arrived on (`note_journey_at`), so the pipelining
    delay counts, in the `packet_journey_seconds{hop="local"}`
    histogram (OpenMetrics exemplars carry the trace id).

Drain rings (`add_ring`): SO_REUSEPORT siblings of the primary engine
on the same port, the kernel spreading flows over them by hash.  Each
tick the primary ring waits out the batching window and the siblings
poll (their packets arrived during the wait); every non-empty batch runs
the same ingest body, and DTLS replies and arena pins stay with the ring
they came in on.  A ring added with a `sink` is a control ring: drained
in the same ingress span by copy, its datagrams go to `sink(batch, sip,
sport)` and never reach the RTP body.  `loop_ingest_syscalls` sums the
rings' native calls (`_sync_ingest_counters`, by deltas each tick).

Kernel arrival stamps: with an engine made with `kernel_timestamps`, the
rings receive through `recv_batch_ts(_view)`, and `last_rtp_arrival_ns`
holds the stamps of the rows `on_media` is handed, row for row (reset
each tick; at depth >= 2 each in-flight entry carries its rows' `ats`).

The ingest body, in the JAX order: the pcap tap (`pcap_tap`, every
ingress batch), DTLS split, RTCP/RTP demux, the supervisor's inbound
drop mask (`inbound_drop`, counted in `inbound_dropped` a row and
`inbound_dropped_total`; before the address latch), holds, fanout-only
rows (`set_fanout_only`: their RTP dropped, `fanout_rtp_dropped`, their
RTCP passing), shard-major order (`enable_shard_major(rows_per_shard)`:
a stable sort of the RTP rows by `sid // rows_per_shard`,
`shard_major_reorders`), then the reverse chain.

Each stage runs in a `PipelineTracer` span (ingress, reverse_chain,
forward_chain, egress: a stage timing ring and a `record_function`
range for profiler traces); `perf` (`PhaseProfiler`) splits sampled
ticks into idle, dispatch, h2d, device compute, d2h and host phases;
`flight` (a `FlightRecorder`, optional) samples each tick's RTP headers.
Streams on hold (an SFU endpoint staged but not committed) queue their
RTP and drop their RTCP until released.  The loop reads whichever ingest
engine its primary ring runs (`engine_mode`: recvmmsg or io_uring);
`loop_engine_io_uring` reads 1 under the ring, and
`loop_ingest_ring_reaps` sums the rings' ring-side reaps.  Any engine
with the `UdpEngine` batch surface serves, `io/tcp.py`'s
`TcpMediaEngine` among them.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.pcap import PcapWriter
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.utils.flight import FlightRecorder
from libjitsi_tpu_torch.utils.logging import get_logger
from libjitsi_tpu_torch.utils.metrics import MetricsRegistry
from libjitsi_tpu_torch.utils.perf import PhaseProfiler
from libjitsi_tpu_torch.utils.tracing import PipelineTracer

_log = get_logger("io.loop")

#: wire datagram sizes: 64-byte keepalives up to MTU-sized video
PACKET_SIZE_BUCKETS = (64, 128, 256, 512, 768, 1024, 1280, 1500)

#: packet journey (ingress arrival -> egress send), seconds; 0.02 is the
#: tick / ptime budget
JOURNEY_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
                   0.1, 0.25, 1.0, 5.0)


def is_dtls(first_byte: np.ndarray) -> np.ndarray:
    """RFC 5764 §5.1.2 demux: first byte in [20..63] = DTLS record.  The
    rule of `libjitsi_tpu_torch.control.dtls.is_dtls`, applied to the
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
                 chain=None, recv_window_ms: int = 1,
                 pipelined: bool = False,
                 pipeline_depth: int = 1,
                 flight: Optional[FlightRecorder] = None,
                 phase_sample_every: int = 16,
                 pcap_tap: Optional[PcapWriter] = None):
        self.engine = engine
        # drain rings: the primary engine and the siblings `add_ring`
        # attaches; parallel to it, a sink a ring (None: the RTP body)
        self.rings: List[UdpEngine] = [engine]
        self.ring_sinks: List[Optional[Callable]] = [None]
        self.registry = registry
        self.on_media = on_media
        self.on_rtcp = on_rtcp
        self.on_dtls = on_dtls
        self.chain = chain
        self.recv_window_ms = recv_window_ms
        # how many ticks' receive work may be in flight; depth > 1 implies
        # pipelined replies
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipelined = pipelined or self.pipeline_depth > 1
        # dispatched sends: (pending, mask, journey origin, dispatch tick)
        self._inflight: List[Tuple[object, np.ndarray, tuple, int]] = []
        # dispatched receive work, FIFO by tick: {pend, tick, origin,
        # ats, token, eng, n}
        self._rx_inflight: List[dict] = []
        # the engine's kernel stamps ride along; after each media
        # handling `last_rtp_arrival_ns` lines up with on_media's rows
        self.use_kernel_ts = bool(getattr(engine, "kernel_timestamps",
                                          False))
        self.last_rtp_arrival_ns: Optional[np.ndarray] = None
        self.pcap = pcap_tap
        self.metrics = MetricsRegistry()
        self.tracer = PipelineTracer(self.metrics)
        self.flight = flight
        self.pkt_size_hist = self.metrics.histogram(
            "packet_size_bytes", PACKET_SIZE_BUCKETS,
            help_="received datagram sizes")
        self.journey_vec = self.metrics.histogram_vec(
            "packet_journey_seconds", JOURNEY_BUCKETS, "hop",
            help_="ingress-arrival to egress-send packet latency",
            exemplars=True)
        self.journey_hist = self.journey_vec.labels("local")
        self.trace_id = 0
        self._trace_t0: Optional[float] = None
        # learned (ip, port) per stream row (latched from last packet)
        self.addr_ip = np.zeros(registry.capacity, dtype=np.uint32)
        self.addr_port = np.zeros(registry.capacity, dtype=np.uint16)
        self.ticks = 0
        self.rx_packets = 0
        self.tx_packets = 0
        self.dtls_packets = 0
        self.unknown_ssrc_dropped = 0
        self.reverse_dropped = 0
        self.metrics.register_scalar(
            "loop_unknown_ssrc_dropped", lambda: self.unknown_ssrc_dropped,
            help_="packets dropped for unmapped SSRCs", kind="counter")
        # streams on hold: their RTP is queued, their RTCP dropped
        self._hold_mask = np.zeros(registry.capacity, dtype=bool)
        self._hold_q: Dict[int, deque] = {}
        # the supervisor's inbound drop mask (quarantine, shedding): a
        # masked row's packets go before any state is touched
        self.inbound_drop = np.zeros(registry.capacity, dtype=bool)
        self.inbound_dropped = np.zeros(registry.capacity, dtype=np.int64)
        self.inbound_dropped_total = 0
        # fanout-only rows (broadcast listeners): their uplink RTP is
        # dropped, their RTCP still flows
        self.fanout_only = np.zeros(registry.capacity, dtype=bool)
        self._fanout_only_n = 0
        self.fanout_rtp_dropped = 0
        self.metrics.register_scalar(
            "loop_fanout_rtp_dropped", lambda: self.fanout_rtp_dropped,
            help_="uplink RTP packets dropped on fanout-only "
                  "(broadcast listener) rows", kind="counter")
        # shard-major order (0: off)
        self.rows_per_shard = 0
        self.shard_major_reorders = 0
        self.metrics.register_scalar(
            "loop_shard_major_reorders", lambda: self.shard_major_reorders,
            help_="RTP batches re-sorted into shard-major order before "
                  "dispatch", kind="counter")
        # the rings' native calls, by deltas each tick (a ring added or
        # closed cannot skew the totals)
        self.ingest_syscalls = 0
        self.ingest_ring_reaps = 0
        self._ingest_enters_seen = 0
        self._ingest_reaps_seen = 0
        self.metrics.register_scalar(
            "loop_ingest_syscalls", lambda: self.ingest_syscalls,
            help_="ingest/egress batches that entered the kernel "
                  "(recvmmsg/sendmmsg calls)", kind="counter")
        self.metrics.register_scalar(
            "loop_ingest_ring_reaps", lambda: self.ingest_ring_reaps,
            help_="io_uring completions reaped ring-side without "
                  "entering the kernel", kind="counter")
        self.metrics.register_scalar(
            "loop_engine_io_uring",
            lambda: 1.0 if self.engine_mode == "io_uring" else 0.0,
            help_="1 when the primary drain ring runs the io_uring "
                  "engine, 0 for recvmmsg")
        self.metrics.register_scalar(
            "loop_ingest_rings", lambda: float(len(self.rings)),
            help_="attached SO_REUSEPORT drain rings")
        # age in ticks of the oldest dispatch, noted at each tick
        self.dispatch_inflight_ticks = 0
        self.perf = PhaseProfiler(
            self.metrics, sample_every=phase_sample_every,
            inflight_fn=lambda: self._inflight_age(),
            device=getattr(registry, "device", None), tracer=self.tracer)

    # ------------------------------------------------------ drain rings
    @property
    def engine_mode(self) -> str:
        """The primary ring's engine mode."""
        return getattr(self.engine, "engine_mode", "recvmmsg")

    def add_ring(self, engine: UdpEngine,
                 sink: Optional[Callable] = None) -> None:
        """Attach a drain ring: an SO_REUSEPORT sibling engine on the same
        port (it polls each tick, after the primary's window), or with
        `sink` a control ring whose datagrams go, copied, to
        `sink(batch, sip, sport)` and never to the RTP body."""
        self.rings.append(engine)
        self.ring_sinks.append(sink)

    def _sync_ingest_counters(self) -> None:
        """Fold the rings' call counters into the loop's, by deltas."""
        enters = sum(int(getattr(e, "syscall_enters", 0)) for e in self.rings)
        reaps = sum(int(getattr(e, "ring_reaps", 0)) for e in self.rings)
        self.ingest_syscalls += enters - self._ingest_enters_seen
        self.ingest_ring_reaps += reaps - self._ingest_reaps_seen
        self._ingest_enters_seen = enters
        self._ingest_reaps_seen = reaps

    # ---------------------------------------------------- dispatch order
    def enable_shard_major(self, rows_per_shard: int) -> None:
        """Sort each RTP batch into shard-major row order (stable, by
        `sid // rows_per_shard`) before the reverse chain; RTP rows are
        independent, so only their order changes."""
        if rows_per_shard <= 0:
            raise ValueError("rows_per_shard must be positive")
        self.rows_per_shard = int(rows_per_shard)

    def set_fanout_only(self, sid: int, on: bool = True) -> None:
        """Mark or unmark a row fanout-only (a broadcast listener): its
        uplink RTP is dropped, its RTCP passes.  Flipped between ticks."""
        sid = int(sid)
        if bool(self.fanout_only[sid]) != bool(on):
            self.fanout_only[sid] = bool(on)
            self._fanout_only_n += 1 if on else -1

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
        self.last_rtp_arrival_ns = None      # no kernel stamps for these
        batch = PacketBatch.from_payloads(list(q), stream=[sid] * len(q))
        if self.chain is not None:
            batch, ok = self.chain.rtp_transformer.reverse_transform(batch)
        else:
            ok = np.ones(batch.batch_size, bool)
        if self.on_media is not None:
            reply = self.on_media(batch, ok)
            if reply is not None:
                self._reply(reply)
        return len(q)

    def _reply(self, batch: PacketBatch, origin=None) -> None:
        if self.pipelined:
            self.send_media_async(batch, origin=origin)
        else:
            self.send_media(batch, origin=origin)

    # -------------------------------------------------------------- tick
    def tick(self) -> int:
        """One batching window; returns packets received."""
        self.perf.begin_tick()
        try:
            return self._tick_inner()
        finally:
            self._sync_ingest_counters()
            self.perf.end_tick()

    def _recv_ring(self, eng, window_ms, use_view):
        """One ring's window: (batch, sip, sport, ats, token)."""
        if self.use_kernel_ts:
            recv = eng.recv_batch_ts_view if use_view else eng.recv_batch_ts
            batch, sip, sport, ats = recv(window_ms)
        else:
            recv = eng.recv_batch_view if use_view else eng.recv_batch
            batch, sip, sport = recv(window_ms)
            ats = None
        return batch, sip, sport, ats, getattr(batch, "arena_token", None)

    def _tick_inner(self) -> int:
        # set again only where this tick hands RTP rows to on_media
        self.last_rtp_arrival_ns = None
        deep = (self.pipeline_depth > 1 and self.chain is not None
                and hasattr(self.chain.rtp_transformer,
                            "reverse_transform_async"))
        got = []
        with self.tracer.span("ingress"):
            with self.perf.phase("idle"):   # the socket wait
                for k, eng in enumerate(self.rings):
                    if self.ring_sinks[k] is None:
                        # the primary waits out the window, siblings poll
                        got.append((eng, self._recv_ring(
                            eng, self.recv_window_ms if k == 0 else 0,
                            deep)))
            for k, eng in enumerate(self.rings):
                sink = self.ring_sinks[k]
                if sink is not None:
                    cb, csip, csport = eng.recv_batch(0)
                    if cb.batch_size:
                        sink(cb, csip, csport)
        # the window just closed: what this tick's packets send later is
        # measured against this instant
        self.trace_id += 1
        self._trace_t0 = time.perf_counter()
        todo = [(eng, rb) for eng, rb in got if rb[0].batch_size]
        n = sum(rb[0].batch_size for _eng, rb in todo)
        self.ticks += 1
        self._note_inflight_age()
        try:
            # egress dispatched on earlier ticks first, then the receive
            # work that reached its depth (its replies dispatch now)
            if self._inflight:
                self.flush_sends()
            if self._rx_inflight:
                self._materialize_rx(due_only=True)
            if n == 0:
                # idle window: nothing to overlap with, collapse the
                # pipeline
                if self._rx_inflight or self._inflight:
                    self.drain()
                return 0
            self.rx_packets += n
            while todo:
                eng, (batch, sip, sport, ats, token) = todo.pop(0)
                self._ingest(eng, batch, sip, sport, ats, token, deep)
            return n
        finally:
            # the pins of windows a raising step never reached
            for eng, rb in todo:
                self._release(rb[4], eng)

    def _ingest(self, eng, batch: PacketBatch, sip, sport, ats, token,
                deep) -> None:
        """Demux and hand on one ring's received window.  The arena pin
        (`token`, deep path only) goes with the dispatched receive work,
        and is dropped here on every other way out, a raising handler
        included."""
        try:
            self.pkt_size_hist.observe_array(np.asarray(batch.length))
            if self.pcap is not None:
                self.pcap.write_batch(batch)
            # 1. split DTLS (first byte 20..63) from media; replies
            # gather into one batch a peer, sent on the ring they came in
            dtls = is_dtls(batch.data[:, 0])
            if dtls.any():
                rows = np.nonzero(dtls)[0]
                self.dtls_packets += len(rows)
                if self.on_dtls is not None:
                    by_addr: Dict[tuple, list] = {}
                    for i in rows:
                        addr = (int(sip[i]), int(sport[i]))
                        replies = self.on_dtls(batch.to_bytes(int(i)), addr)
                        if replies:
                            by_addr.setdefault(addr, []).extend(replies)
                    for addr, reps in by_addr.items():
                        eng.send_batch(
                            PacketBatch.from_payloads(reps, batch.capacity),
                            addr[0], addr[1])
                media = np.nonzero(~dtls)[0]
                if not len(media):
                    return
                batch = _rows(batch, media)
                sip, sport = sip[media], sport[media]
                if ats is not None:
                    ats = ats[media]

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
            if not known.all():
                self.unknown_ssrc_dropped += int((~known).sum())
                _log.warn("unknown_ssrc_drop", count=int((~known).sum()),
                          tick=self.ticks, total=self.unknown_ssrc_dropped)
            if self.inbound_drop.any():
                # before the address latch: a quarantined sender cannot
                # redirect its row's return media
                shed = known & self.inbound_drop[
                    np.clip(sids, 0, len(self.inbound_drop) - 1)]
                if shed.any():
                    np.add.at(self.inbound_dropped, sids[shed], 1)
                    self.inbound_dropped_total += int(shed.sum())
                    known &= ~shed
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
            if len(rtp_rows) and self._fanout_only_n:
                fo = self.fanout_only[sids[rtp_rows]]
                if fo.any():
                    self.fanout_rtp_dropped += int(fo.sum())
                    rtp_rows = rtp_rows[~fo]
            reordered = False
            if self.rows_per_shard and len(rtp_rows) > 1:
                shard = sids[rtp_rows] // self.rows_per_shard
                if np.any(shard[:-1] > shard[1:]):
                    rtp_rows = rtp_rows[np.argsort(shard, kind="stable")]
                    self.shard_major_reorders += 1
                    reordered = True
            if len(rtp_rows):
                if len(rtp_rows) == batch.batch_size and not reordered:
                    rtp, rtp_ats = batch, ats
                else:
                    rtp = _rows(batch, rtp_rows)
                    rtp_ats = None if ats is None else ats[rtp_rows]
                if self.flight is not None:
                    d = rtp.data
                    seqs = (d[:, 2].astype(np.int64) << 8) | d[:, 3]
                    self.flight.record_headers(
                        rtp.stream, seqs, np.asarray(rtp.length),
                        tick=self.ticks, trace=self.trace_id)
                if deep:
                    token = self._dispatch_rx(rtp, token, rtp_ats, eng)
                else:
                    self.last_rtp_arrival_ns = rtp_ats
                    self._receive(rtp)
            if len(rtcp_rows) and self.on_rtcp is not None:
                rb = _rows(batch, rtcp_rows)
                with self.tracer.span("reverse_chain"):
                    if self.chain is not None:
                        rb, okc = (self.chain.rtcp_transformer
                                   .reverse_transform(rb))
                    else:
                        okc = np.ones(rb.batch_size, bool)
                self.on_rtcp(rb, okc)
        finally:
            # `_dispatch_rx` took the pin (token None) or it drops here
            self._release(token, eng)

    def _receive(self, rtp: PacketBatch) -> None:
        """The serial receive path: unprotect now, deliver, reply."""
        with self.tracer.span("reverse_chain"):
            if self.chain is not None:
                self.perf.note_h2d(rtp.data.nbytes
                                   + np.asarray(rtp.length).nbytes)
                self.perf.probe_h2d((rtp.data,))
                # the sync call blends dispatch, compute and d2h
                with self.perf.phase("device_compute"):
                    rtp, ok = self.chain.rtp_transformer.reverse_transform(
                        rtp)
                self.perf.note_d2h(rtp.data.nbytes)
            else:
                ok = np.ones(rtp.batch_size, bool)
        self._deliver(rtp, ok, None)

    def _dispatch_rx(self, rtp: PacketBatch, token, ats, eng):
        """The deep path: dispatch the unprotect only; the arena pin and
        the rows' arrival stamps go with the in-flight entry, the pin
        released on the ring it came from when the entry materializes."""
        tr = self.chain.rtp_transformer
        with self.tracer.span("reverse_chain"):
            self.perf.note_h2d(rtp.data.nbytes
                               + np.asarray(rtp.length).nbytes)
            self.perf.probe_h2d((rtp.data,))
            # the previous window's replay-state commit, a wait on device
            # work already dispatched: here, so the dispatch below times
            # only the new launch
            commit = getattr(tr, "commit_inflight", None)
            if commit is not None:
                with self.perf.phase("device_compute"):
                    commit()
            with self.perf.phase("dispatch"):
                pend = tr.reverse_transform_async(rtp)
        self._rx_inflight.append({
            "pend": pend, "tick": self.ticks,
            "origin": self.journey_origin(),
            # a copy: the entry outlives the arena's pin
            "ats": None if ats is None else np.array(ats),
            "token": token, "eng": eng, "n": rtp.batch_size})
        return None

    def _deliver(self, rtp: PacketBatch, ok: np.ndarray, origin) -> None:
        dropped = int((~ok).sum())
        if dropped:
            self.reverse_dropped += dropped
            _log.warn("reverse_chain_drop", count=dropped, tick=self.ticks)
        if self.on_media is not None:
            reply = self.on_media(rtp, ok)
            if reply is not None:
                self._reply(reply, origin=origin)

    def _release(self, token, eng=None) -> None:
        if token is not None:
            (self.engine if eng is None else eng).release_arena(token)

    # --------------------------------------------------- deep pipeline
    def _inflight_age(self) -> int:
        """Age in ticks of the oldest dispatch not yet materialized, over
        both pipelines, computed live (a scrape between ticks sees the
        current depth, zero after a drain)."""
        return max(
            max((self.ticks - t for _p, _m, _o, t in self._inflight),
                default=0),
            max((self.ticks - e["tick"] for e in self._rx_inflight),
                default=0))

    def _note_inflight_age(self) -> None:
        self.dispatch_inflight_ticks = self._inflight_age()

    def _materialize_rx(self, due_only: bool = True) -> int:
        """Materialize in-flight receive work, FIFO: deliver the media to
        the sink, dispatch its reply, release the arena pin.  With
        `due_only`, only entries `pipeline_depth - 1` ticks old."""
        if not self._rx_inflight:
            return 0
        if due_only:
            horizon = self.pipeline_depth - 1
            due = [e for e in self._rx_inflight
                   if self.ticks - e["tick"] >= horizon]
            if not due:
                return 0
            self._rx_inflight = [e for e in self._rx_inflight
                                 if self.ticks - e["tick"] < horizon]
        else:
            due, self._rx_inflight = self._rx_inflight, []
        return sum(self._finish_rx(e) for e in due)

    def _finish_rx(self, e: dict) -> int:
        pend = e["pend"]
        with self.tracer.span("reverse_chain"):
            self.perf.fence(pend)
            with self.perf.phase("d2h_transfer"):
                rtp, ok = pend.result()
        self.perf.note_d2h(rtp.data.nbytes)
        # the arena's bytes were last read inside result() (failed rows
        # keep their original bytes)
        self._release(e["token"], e["eng"])
        self.last_rtp_arrival_ns = e["ats"]
        # replies charge their journey to the arrival tick
        self._deliver(rtp, ok, e["origin"])
        return e["n"]

    def drain(self) -> int:
        """Pipeline barrier: materialize every in-flight receive dispatch
        (delivering media, committing replay state) and flush every
        dispatched send.  Checkpoints and lifecycle commits run behind
        it."""
        done = self._materialize_rx(due_only=False)
        if self._inflight:
            self.flush_sends()
        self._note_inflight_age()
        return done

    # ----------------------------------------------------------- journey
    def journey_origin(self) -> Tuple[int, Optional[float]]:
        """The current tick's (trace id, arrival time), taken at dispatch
        by senders whose bytes leave on a later tick."""
        return self.trace_id, self._trace_t0

    def note_journey_at(self, origin: Tuple[int, Optional[float]],
                        n: int, sids=None) -> Optional[float]:
        """Observe `n` packets leaving now against an ingress origin; a
        journey past the top bucket marks the shipped streams priority in
        the flight recorder (their next header sample keeps the tail)."""
        trace, t0 = origin
        if n <= 0 or t0 is None:
            return None
        dt = time.perf_counter() - t0
        tail = self.journey_hist.observe_same(
            dt, int(n), exemplar={"trace_id": str(trace)})
        if tail and self.flight is not None and sids is not None:
            for sid in set(int(s) for s in np.asarray(sids).ravel()):
                if sid >= 0:
                    self.flight.mark_priority(sid)
        return dt

    # -------------------------------------------------------------- send
    def _send_masked(self, out: PacketBatch, mask: np.ndarray) -> int:
        """Send the mask's rows of a protected batch, each to its stream
        row's latched address, in one sendmmsg."""
        rows = np.nonzero(mask)[0]
        if len(rows) == 0:
            return 0
        sids = np.clip(np.asarray(out.stream)[rows], 0,
                       self.registry.capacity - 1)
        return self.engine.send_rows(out, rows, self.addr_ip[sids],
                                     self.addr_port[sids])

    def send_media(self, batch: PacketBatch, origin=None) -> int:
        """Protect (forward chain) + send a batch; rows route to each
        stream row's latched address.  `origin` overrides the journey
        origin (pipelined callers charge the arrival tick)."""
        if batch.batch_size == 0:
            return 0
        with self.tracer.span("forward_chain"):
            if self.chain is not None:
                tr = self.chain.rtp_transformer
                self.perf.note_h2d(batch.data.nbytes
                                   + np.asarray(batch.length).nbytes)
                if self.perf.sampled and hasattr(tr, "transform_async"):
                    # sampled tick: the same work through the async seam,
                    # so dispatch, device compute and d2h split out
                    with self.perf.phase("dispatch"):
                        pending, ok = tr.transform_async(batch)
                    self.perf.fence(pending)
                    with self.perf.phase("d2h_transfer"):
                        batch = pending.result()
                else:
                    batch, ok = tr.transform(batch)
                self.perf.note_d2h(batch.data.nbytes)
            else:
                ok = np.ones(batch.batch_size, bool)
        with self.tracer.span("egress"):
            sent = self._send_masked(batch, ok)
            self.note_journey_at(
                self.journey_origin() if origin is None else origin, sent,
                sids=np.asarray(batch.stream)[np.nonzero(ok)[0]])
        self.tx_packets += sent
        return sent

    def send_media_async(self, batch: PacketBatch, origin=None) -> int:
        """Dispatch the forward chain without waiting; the protected bytes
        leave on the next tick's flush (or an explicit `flush_sends`)."""
        if batch.batch_size == 0:
            return 0
        if self.chain is None:
            return self.send_media(batch, origin=origin)
        with self.tracer.span("forward_chain"):
            self.perf.note_h2d(batch.data.nbytes
                               + np.asarray(batch.length).nbytes)
            with self.perf.phase("dispatch"):
                pending, mask = self.chain.rtp_transformer.transform_async(
                    batch)
        self._inflight.append((
            pending, mask,
            self.journey_origin() if origin is None else origin,
            self.ticks))
        return batch.batch_size

    def flush_sends(self) -> int:
        """Materialize and send every dispatched batch."""
        sent = 0
        inflight, self._inflight = self._inflight, []
        with self.tracer.span("egress"):
            for pending, mask, origin, _tick in inflight:
                self.perf.fence(pending)
                with self.perf.phase("d2h_transfer"):
                    out = pending.result()
                self.perf.note_d2h(out.data.nbytes)
                k = self._send_masked(out, mask)
                self.note_journey_at(
                    origin, k,
                    sids=np.asarray(out.stream)[np.nonzero(mask)[0]])
                sent += k
        self.tx_packets += sent
        return sent
