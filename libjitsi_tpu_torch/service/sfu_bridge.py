"""SfuBridge — the videobridge-style forwarding conference as one object.

Counterpart: `libjitsi_tpu/service/sfu_bridge.py` `SfuBridge`, the audio
path.  Reference: Jitsi Videobridge on the reference's `RTPTranslatorImpl`
+ `CachingTransformer` + RTCP termination (SURVEY §3.4, §2.2, §2.3).  A
tick, kernels in brackets:

    loop.tick()            recvmmsg -> demux (RTP / RTCP) -> latch
      _on_media            rx unprotect_rtp(return_index) [D]
                           -> recovery.observe_rx, BWE feed
                           -> abs-send-time stamp
                           -> RtpTranslator.translate [H]
                           -> per-leg PacketCache insert -> sendmmsg
      _on_rtcp             rx unprotect_rtcp [J] -> RtcpTermination;
                           NACK -> retransmit from the cache under the
                           RTX token bucket
    emit_feedback(now)     RR + REMB + NACK + PLI per sender
                           -> tx protect_rtcp [I] -> sendmmsg

Endpoints both send and receive: `add_endpoint(ssrc, rx_key, tx_key)`
installs the sender-side SRTP row (what they send us), the SRTCP row
of what we send them, and their receiver leg in the translator; routing
is a full mesh, scoped to conferences where `stage_endpoints` gave
conference ids.  The loop's tracer spans `reverse_chain` (SRTP/SRTCP
unprotect), `recovery`, `forward_chain` (the fan-out) and `egress` split
a tick, beside the loop's `ingress`, in the stage ledger and in a
profiler trace.  Profiles: AES-CM, AES-F8 and NULL with HMAC-SHA1, and
AEAD_AES_128_GCM (the fan-out on kernel H's instance for the cipher; under
GCM the SRTP and SRTCP tables run kernels M and N).  `device` None means the
card; the tests pass device="cpu".

Pipelined (`pipelined=True` or `pipeline_depth` > 1, as in the JAX
bridge): `_on_media` dispatches the fan-out (`translate_async`) and its
copies are cached and sent at the start of the next media handling, or
at the end of a tick that handled none, so kernel H and the copies'
read-back overlap the next recv window; each copy's journey is charged
to the tick its packet arrived on.  Every entry point that mutates the
bridge (adding, staging, committing or removing endpoints) and
`snapshot` ship the fan-out in flight first (`_quiesce_fanout`).  The
SFU unprotects inside `_on_media` (the loop has no chain), so the loop's
deep receive pipeline does not engage; depth > 1 pipelines the fan-out.

Ingest rings (`ingest_rings` N > 1): the primary engine binds with
SO_REUSEPORT and N - 1 sibling engines on the same port join the loop
(`MediaLoop.add_ring`), the kernel spreading the senders' flows over
them by hash; every ring drains each tick.  With `kernel_timestamps`
every engine takes SO_TIMESTAMPNS stamps, and the receive-side GCC
(`_feed_bwe`) takes each packet's arrival time from
`loop.last_rtp_arrival_ns`, row for row, instead of the tick's clock.
`engine_mode` ("auto", "recvmmsg" or "io_uring") picks every ring's
ingest engine (`io/udp.py`); `snapshot()` records `ingest_rings` and
`engine_mode`; `restore()` takes them unless the caller passes its own.

DTLS-SRTP joins (`add_endpoint_dtls`, as in the JAX bridge): the row is
allocated and its SSRC mapped at once, a `control.dtls.DtlsAssociationTable`
takes the loop's DTLS datagrams (`on_dtls`) and drives the handshake, and
media racing it is held on the loop and replayed when the exported keys
install (`_install_dtls`; `stage_dtls_keys` is the staged twin for a
lifecycle plane).  A row without installed keys (pending, or refused on a
fingerprint mismatch) is kept out of the routes and snapshots.
`set_conference` scopes a joined row to a conference id (the port's; the
JAX bridge scopes only `stage_endpoints` rows).

Not ported, each raising `NotImplementedError` with its ROADMAP Queue 1
item: video and SVC tracks with RTX encapsulation (item 9), mesh mode,
cascade trunks, broadcast conferences and endpoint migration (item 12).
The JAX bridge's `config` argument is not taken.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.bwe.batched import BatchedRemoteBitrateEstimator
from libjitsi_tpu_torch.control.dtls import DtlsAssociationTable
from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import UdpEngine, check_engine_mode
from libjitsi_tpu_torch.rtp import ext as rtp_ext
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.sfu.cache import PacketCache
from libjitsi_tpu_torch.sfu.recovery import RecoveryConfig, RecoveryController
from libjitsi_tpu_torch.sfu.rtcp_termination import RtcpTermination
from libjitsi_tpu_torch.sfu.translator import RtpTranslator
from libjitsi_tpu_torch.transform.header_ext import AbsSendTimeEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


class SfuBridge:
    """Secure selective-forwarding bridge on one UDP port."""

    def __init__(self, port: int = 0, capacity: int = 256,
                 profile: SrtpProfile =
                 SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 recv_window_ms: int = 1,
                 kernel_timestamps: bool = False,
                 abs_send_time_ext_id: int = 3,
                 pipelined: bool = False,
                 pipeline_depth: int = 1,
                 mesh=None,
                 recovery_config: Optional[RecoveryConfig] = None,
                 engine_mode: str = "auto",
                 ingest_rings: int = 1,
                 device: DeviceLike = None):
        check_engine_mode(engine_mode)
        if mesh is not None:
            raise _not_ported("mesh mode", 12)
        self.device = resolve_device(device)
        self.capacity = capacity
        self.profile = profile
        self.engine_mode = engine_mode
        self.ingest_rings = max(1, int(ingest_rings))
        self.pipelined = pipelined or pipeline_depth > 1
        # dispatched fan-outs: (PendingTranslate, journey origin)
        self._pending_fanout: list = []
        self._media_ran = False
        self.ast_ext_id = abs_send_time_ext_id
        self.registry = StreamRegistry(capacity, device=self.device)
        # rx_table: what endpoints SEND us (media + their SRTCP);
        # tx_table: what we send THEM (our SRTCP feedback; media forward
        # crypto is the translator's per-leg fan-out)
        self.rx_table = SrtpStreamTable(capacity, profile, self.device)
        self.tx_table = SrtpStreamTable(capacity, profile, self.device)
        self.translator = RtpTranslator(capacity, profile, self.device)
        self.cache = PacketCache()
        self.rtcp_term = RtcpTermination(bridge_ssrc=0x5F0BFF)
        # end-to-end loss recovery: uplink gap detection -> upstream
        # NACKs, budgeted NACK service, adaptive FEC on egress legs.
        # Transient, like the cache: a restored bridge re-learns it.
        self.recovery = RecoveryController(recovery_config)
        self.loop = MediaLoop(
            UdpEngine(port=port, max_batch=4 * capacity,
                      kernel_timestamps=kernel_timestamps,
                      engine_mode=engine_mode,
                      reuseport=self.ingest_rings > 1), self.registry,
            on_media=self._on_media, on_rtcp=self._on_rtcp,
            on_dtls=lambda d, a: self._dtls.on_dtls(d, a), chain=None,
            recv_window_ms=recv_window_ms, pipeline_depth=pipeline_depth)
        self.port = self.loop.engine.port
        # pending DTLS-SRTP associations: routing of their datagrams,
        # flight retransmission and the early-media hold
        self._dtls = DtlsAssociationTable(self.loop, profile,
                                          self._install_dtls)
        # SO_REUSEPORT siblings on the same port, drained every tick
        for _ in range(self.ingest_rings - 1):
            self.loop.add_ring(UdpEngine(
                port=self.port, reuseport=True, max_batch=4 * capacity,
                kernel_timestamps=kernel_timestamps,
                engine_mode=engine_mode))
        self._ssrc_of: Dict[int, int] = {}     # sid -> sender ssrc
        # rows keyed by stage_endpoints but not yet committed: their
        # media queues on the loop's hold and the routes leave them out
        self._staged: set = set()
        self.stream_names: Dict[int, str] = {}
        self.forwarded = 0
        self.retransmitted = 0
        # overload degradation: suppress the RTCP feedback while media
        # forwarding keeps flowing
        self.degraded = False
        # receive-side GCC over each sender->bridge leg, fed from the
        # senders' abs-send-time stamps (reference:
        # RemoteBitrateEstimatorAbsSendTime on the translator's receive
        # path, SURVEY §2.3)
        self.bwe = BatchedRemoteBitrateEstimator(capacity=capacity)
        self._bwe_fed = np.zeros(capacity, dtype=bool)
        # egress abs-send-time stamp, on the bridge's clock
        self._ast = AbsSendTimeEngine(abs_send_time_ext_id,
                                      clock=lambda: self._now)
        self._now = time.time()
        self._rx_keys: Dict[int, Tuple[bytes, bytes]] = {}
        self._tx_keys: Dict[int, Tuple[bytes, bytes]] = {}
        self._recv_bw: Dict[int, float] = {}   # recv sid -> REMB bps
        # BWE transport row per stream row
        self._transport_of = np.arange(capacity, dtype=np.int64)
        # conference scoping: sid -> conference id.  Rows without one
        # (direct add_endpoint) form one shared mesh.
        self._conf_of: Dict[int, int] = {}

    # ---------------------------------------------------------- endpoints
    def add_endpoint(self, ssrc: int, rx_key: Tuple[bytes, bytes],
                     tx_key: Tuple[bytes, bytes],
                     name: Optional[str] = None) -> int:
        if ssrc in self._ssrc_of.values():
            raise ValueError(f"ssrc {ssrc:#x} already joined")
        self._quiesce_fanout()
        sid = self.registry.alloc(self)
        if name is not None:
            self.stream_names[sid] = name
        self.rx_table.add_stream(sid, *rx_key)
        self.tx_table.add_stream(sid, *tx_key)
        self.translator.add_receiver(sid, *tx_key)
        self.registry.map_ssrc(ssrc, sid)
        self._ssrc_of[sid] = ssrc & 0xFFFFFFFF
        self._rx_keys[sid] = tuple(rx_key)
        self._tx_keys[sid] = tuple(tx_key)
        self._rebuild_routes()
        return sid

    def remove_endpoint(self, sid: int) -> None:
        self.remove_endpoints([sid])

    def remove_endpoints(self, sids) -> None:
        """Batched leave: one `remove_streams` pass per SRTP table and
        one route rebuild, however many legs leave."""
        sids = [int(s) for s in sids]
        if not sids:
            return
        self._quiesce_fanout()
        rx_rows: list = []
        tx_rows: list = []
        gone_ssrcs: list = []
        for sid in sids:
            ssrc = self._ssrc_of.pop(sid, None)
            if ssrc is not None:
                self.registry.unmap_ssrc(ssrc)
                gone_ssrcs.append(ssrc)
            if self.rx_table.active[sid]:
                rx_rows.append(sid)
            if self.tx_table.active[sid]:
                tx_rows.append(sid)
            self.translator.disconnect(sid)
            self.translator.remove_receiver(sid)
            self.rtcp_term.forget_receiver(sid)
            self._bwe_fed[sid] = False
            self._rx_keys.pop(sid, None)
            self._tx_keys.pop(sid, None)
            self._recv_bw.pop(sid, None)
            self._conf_of.pop(sid, None)
            self._dtls.forget(sid)
            if sid in self._staged:
                # left before its admit flipped live: drop held media
                self._staged.discard(sid)
                self.loop.discard_stream(sid)
            self.loop.addr_ip[sid] = 0
            self.loop.addr_port[sid] = 0
            self.stream_names.pop(sid, None)
            self.registry.release(sid)
        self.rx_table.remove_streams(rx_rows)
        self.tx_table.remove_streams(tx_rows)
        self.bwe.reset_rows(sids)
        self.recovery.forget_ssrcs(gone_ssrcs)
        self.recovery.forget_legs(sids)
        self._rebuild_routes()

    # ---------------------------------------------------- lifecycle plane
    def stage_endpoints(self, specs, sids=None,
                        conferences=None) -> List[int]:
        """Off-tick half of a batched admit: allocate rows, install both
        SRTP tables and the translator legs in one vectorized pass each,
        map the SSRCs (media racing the admit queues on the loop's hold)
        and leave the rows staged until `commit_endpoints`.

        specs: iterable of (ssrc, (rx_mk, rx_ms), (tx_mk, tx_ms), name);
        `sids` pins specific rows; `conferences` scopes each endpoint's
        forwarding to its conference id.  Returns the sids in spec order.
        """
        specs = list(specs)
        if not specs:
            return []
        for ssrc, _rx, _tx, _name in specs:
            if ssrc in self._ssrc_of.values():
                raise ValueError(f"ssrc {ssrc:#x} already joined")
        self._quiesce_fanout()
        if sids is None:
            sids = [self.registry.alloc(self) for _ in specs]
        else:
            sids = [int(s) for s in sids]
            if len(sids) != len(specs):
                raise ValueError("sids/specs length mismatch")
            self.registry.reserve_many(sids, self)
        if conferences is not None:
            for sid, conf in zip(sids, conferences):
                if conf is not None:
                    self._conf_of[sid] = int(conf)
        arr = np.asarray(sids, dtype=np.int64)

        def keys(k, part):
            return np.stack([np.frombuffer(s[k][part], np.uint8)
                             for s in specs])

        self.rx_table.add_streams(arr, keys(1, 0), keys(1, 1))
        self.tx_table.add_streams(arr, keys(2, 0), keys(2, 1))
        self.translator.add_receivers(sids, [s[2][0] for s in specs],
                                      [s[2][1] for s in specs])
        for sid, (ssrc, rx, tx, name) in zip(sids, specs):
            self.registry.map_ssrc(ssrc, sid)
            self._ssrc_of[sid] = ssrc & 0xFFFFFFFF
            self._rx_keys[sid] = tuple(rx)
            self._tx_keys[sid] = tuple(tx)
            if name is not None:
                self.stream_names[sid] = name
            self.loop.hold_stream(sid)
            self._staged.add(sid)
        return sids

    def commit_endpoints(self, sids) -> None:
        """Between-ticks commit: flip staged rows live with one route
        rebuild, then replay their held media through the receive
        path."""
        sids = [int(s) for s in sids if int(s) in self._staged]
        if not sids:
            return
        self._quiesce_fanout()
        self._staged.difference_update(sids)
        self._rebuild_routes()
        for sid in sids:
            self.loop.release_stream(sid)

    def _rebuild_routes(self) -> None:
        """Full mesh within each conference: every sender forwards to
        every OTHER live endpoint.  Rows without leg keys stay out: a
        DTLS row until its keys install (the JAX bridge's pending
        exclusion) and for good once its handshake was refused (the JAX
        bridge routes such a row again, under keys never installed);
        staged rows stay out until their commit."""
        sids = [s for s in sorted(self._ssrc_of)
                if s in self._tx_keys and s not in self._staged]
        if self._conf_of:
            groups: Dict[int, list] = {}
            for s in sids:
                groups.setdefault(self._conf_of.get(s, -1), []).append(s)
            for grp in groups.values():
                for s in grp:
                    self.translator.connect(s, [r for r in grp if r != s])
        else:
            for s in sids:
                self.translator.connect(s, [r for r in sids if r != s])

    def set_conference(self, sid: int, conference: Optional[int]) -> None:
        """Scope a joined row's forwarding to `conference` (None: the
        shared mesh of rows without one), as `stage_endpoints`'
        `conferences` does for its rows."""
        if sid not in self._ssrc_of:
            raise ValueError(f"sid {sid} has not joined")
        if conference is None:
            self._conf_of.pop(sid, None)
        else:
            self._conf_of[sid] = int(conference)
        if sid in self._tx_keys and sid not in self._staged:
            self._quiesce_fanout()
            self._rebuild_routes()

    # ------------------------------------------------------------- DTLS
    def add_endpoint_dtls(self, ssrc: int, role: str = "server",
                          remote_fingerprint: Optional[str] = None,
                          cookie_exchange: bool = False,
                          remote_addr=None):
        """Join keyed by DTLS-SRTP instead of direct keys: allocates the
        row and starts an association; media arriving before the
        handshake finishes is queued (`MediaLoop.hold_stream`) and
        replayed once keys install.  Returns (sid, endpoint): publish
        `endpoint.local_fingerprint` through signaling, and pass
        `remote_addr` (ip as u32, port) when signaling knows the peer's
        5-tuple (with several unbound joins at once, a datagram from an
        unknown address is dropped rather than guessed onto a row).  A
        `role="client"` endpoint's first flight is the caller's to send
        (`endpoint.handshake_packets()`).  Reference: DtlsControlImpl
        started by MediaStream.start (SURVEY §3.5)."""
        if ssrc in self._ssrc_of.values():
            raise ValueError(f"ssrc {ssrc:#x} already joined")
        sid = self.registry.alloc(self)
        self.registry.map_ssrc(ssrc, sid)
        self._ssrc_of[sid] = ssrc & 0xFFFFFFFF
        ep = self._dtls.join(sid, role, remote_fingerprint,
                             cookie_exchange, remote_addr)
        return sid, ep

    def _install_dtls(self, sid: int, ep) -> None:
        """The association table's install hook (inline mode): the
        exported keys into both SRTP tables and the translator leg, then
        one route rebuild that takes the row in."""
        self._quiesce_fanout()
        self._land_dtls_keys(sid, ep)
        self._rebuild_routes()

    def stage_dtls_keys(self, sid: int, ep) -> None:
        """Staged landing for a completed DTLS handshake (a lifecycle
        plane's deferred table): install the exported keys for the
        already-allocated row and leave it staged; `commit_endpoints`
        flips it live between ticks and replays its held media."""
        self._land_dtls_keys(sid, ep)
        self._staged.add(sid)

    def _land_dtls_keys(self, sid: int, ep) -> None:
        _profile, tk, tsalt, rk, rsalt = ep.srtp_keys()
        self.rx_table.add_stream(sid, rk, rsalt)
        self.tx_table.add_stream(sid, tk, tsalt)
        self.translator.add_receiver(sid, tk, tsalt)
        self._rx_keys[sid] = (rk, rsalt)
        self._tx_keys[sid] = (tk, tsalt)

    # ------------------------------------------------ not ported entries
    def add_video_track(self, *args, **kwargs):
        raise _not_ported("simulcast video tracks and RTX", 9)

    def add_svc_track(self, *args, **kwargs):
        raise _not_ported("VP9 SVC tracks and RTX", 9)

    def attach_trunk(self, *args, **kwargs):
        raise _not_ported("cascade trunks", 12)

    def set_broadcast_speakers(self, *args, **kwargs):
        raise _not_ported("broadcast conferences", 12)

    def migrate_endpoints(self, *args, **kwargs):
        raise _not_ported("endpoint migration", 12)

    # --------------------------------------------------------------- tick
    def _on_media(self, batch: PacketBatch, _ok) -> None:
        """Decrypt once, fan out, cache per-leg copies, send; pipelined,
        the fan-out is dispatched here and shipped by the next call (or
        at the end of the next tick)."""
        self._media_ran = True
        loop = self.loop
        perf = loop.perf
        if self._pending_fanout:
            self._flush_fanout()
        perf.note_h2d(batch.data.nbytes + np.asarray(batch.length).nbytes)
        with loop.tracer.span("reverse_chain"):
            # the sync unprotect blends dispatch, compute and d2h
            with perf.phase("device_compute"):
                dec, ok, idx = self.rx_table.unprotect_rtp(
                    batch, return_index=True)
        perf.note_d2h(dec.data.nbytes)
        rows = np.nonzero(ok)[0]
        if len(rows) == 0:
            return None
        sub = PacketBatch(dec.data[rows], np.asarray(dec.length)[rows],
                          dec.stream[rows])
        hdr = rtp_header.parse(sub)
        # uplink loss detection: gaps in each sender's seq space queue
        # upstream NACKs (drained toward the sender by emit_feedback)
        with loop.tracer.span("recovery"):
            self.recovery.observe_rx(hdr.ssrc, hdr.seq, self._now)
        self._feed_bwe(sub, rows, hdr)
        # the bridge's own abs-send-time, before the fan-out, so every
        # receiver leg can run receive-side GCC on its downlink
        sub, _ = self._ast.rtp_transformer.transform(sub)
        with loop.tracer.span("forward_chain"):
            if self.pipelined:
                # the copies leave on a later tick: charge their journey
                # to this one, when the packets arrived
                with perf.phase("dispatch"):
                    pend = self.translator.translate_async(sub, idx[rows])
                self._pending_fanout.append((pend, loop.journey_origin()))
                return None
            with perf.phase("device_compute"):
                wire, recv = self.translator.translate(sub, idx[rows])
        self._emit_fanout(wire, recv)
        return None

    def _quiesce_fanout(self) -> None:
        """Ship the fan-out in flight before mutating state it may still
        read: a recycled row must not receive a departed endpoint's
        copies, and a snapshot must not miss copies already made."""
        if self._pending_fanout:
            self._flush_fanout()

    def _flush_fanout(self) -> None:
        perf = self.loop.perf
        pending, self._pending_fanout = self._pending_fanout, []
        for pend, origin in pending:
            perf.fence(pend)
            with perf.phase("d2h_transfer"):
                wire, recv = pend.result()
            self._emit_fanout(wire, recv, origin=origin)

    def _emit_fanout(self, wire: PacketBatch, recv: np.ndarray,
                     origin=None) -> None:
        if wire.batch_size == 0:
            return
        # a just-joined leg has no latched address yet: sending to
        # 0.0.0.0:0 would fail the whole sendmmsg
        ready = self.loop.addr_port[recv] != 0
        if not ready.any():
            return
        rr = np.nonzero(ready)[0]
        wire = PacketBatch(wire.data[rr], np.asarray(wire.length)[rr],
                           wire.stream[rr])
        recv = recv[rr]
        # cache each leg's protected copy for NACK service, keyed by
        # (leg sid, SENDER ssrc) + original seq
        hdr = rtp_header.parse(wire)
        copies = [wire.to_bytes(i) for i in range(wire.batch_size)]
        self.cache.insert_batch(
            (recv.astype(np.int64) << 32) | hdr.ssrc.astype(np.int64),
            hdr.seq, copies, now=self._now)
        with self.loop.tracer.span("egress"):
            sent = self.loop.engine.send_batch(
                wire, self.loop.addr_ip[recv], self.loop.addr_port[recv])
            self.loop.note_journey_at(
                origin if origin is not None
                else self.loop.journey_origin(), sent, sids=recv)
        self.forwarded += sent
        # adaptive FEC over the PROTECTED per-leg copies (a recovered
        # packet still passes the receiver's SRTP auth); one FEC stream
        # per (leg, sender ssrc)
        if self.recovery.fec_active():
            fec_out, fec_addr = [], []
            for j, pkt in enumerate(copies):
                fec = self.recovery.fec_protect(int(recv[j]),
                                                int(hdr.ssrc[j]), pkt)
                if fec is not None:
                    fec_out.append(fec)
                    fec_addr.append(int(recv[j]))
            if fec_out:
                fa = np.asarray(fec_addr, dtype=np.int64)
                with self.loop.tracer.span("egress"):
                    self.loop.engine.send_batch(
                        PacketBatch.from_payloads(fec_out),
                        self.loop.addr_ip[fa], self.loop.addr_port[fa])

    def _feed_bwe(self, sub: PacketBatch, rows: np.ndarray, hdr) -> None:
        """Drive the receive-side GCC from the senders' abs-send-time
        stamps.  `rows` are `sub`'s rows in the batch `on_media` was
        handed: arrival times are the engine's kernel stamps
        (`loop.last_rtp_arrival_ns`, row-aligned with that batch) when it
        has them, else the tick's clock."""
        off, dlen, found = rtp_ext.find_one_byte_ext(sub, hdr,
                                                     self.ast_ext_id)
        f = np.nonzero(found & (dlen == 3))[0]
        if len(f) == 0:
            return
        d = sub.data
        o = off[f]
        ast24 = ((d[f, o].astype(np.int64) << 16)
                 | (d[f, o + 1].astype(np.int64) << 8)
                 | d[f, o + 2].astype(np.int64))
        ats = self.loop.last_rtp_arrival_ns
        if ats is not None:
            arrival_ms = ats[rows][f].astype(np.float64) / 1e6
        else:
            arrival_ms = np.full(len(f), self._now * 1000.0)
        tids = self._transport_of[sub.stream[f].astype(np.int64)]
        self.bwe.incoming_batch(tids, arrival_ms, ast24,
                                np.asarray(sub.length)[f])
        self._bwe_fed[tids] = True

    def own_estimate_bps(self, sid: int) -> Optional[float]:
        """The bridge's receive-side estimate for a sender leg (None
        until its abs-send-time stamps have fed it)."""
        if not self._bwe_fed[sid]:
            return None
        return float(self.bwe.bitrate[sid])

    def _on_rtcp(self, batch: PacketBatch, _ok) -> None:
        """SRTCP-authenticate, then: NACK -> retransmit from the per-leg
        cache; everything else feeds RTCP termination.  Unauthenticated
        control packets are dropped: a spoofed NACK is a retransmission
        amplifier and a spoofed REMB caps the conference bitrate."""
        with self.loop.tracer.span("reverse_chain"):
            dec, ok = self.rx_table.unprotect_rtcp(batch)
        for i in np.nonzero(np.asarray(ok))[0]:
            sid = int(batch.stream[i])
            try:
                pkts = rtcp.parse_compound(dec.to_bytes(int(i)))
            except ValueError:
                continue
            self.rtcp_term.on_receiver_rtcp(sid, pkts)
            for p in pkts:
                if isinstance(p, rtcp.Nack):
                    self._serve_nack(sid, p)
                elif isinstance(p, rtcp.Remb):
                    self._recv_bw[sid] = float(p.bitrate_bps)
                elif isinstance(p, (rtcp.ReceiverReport,
                                    rtcp.SenderReport)):
                    # reported downlink loss drives the FEC ratio
                    for rb in p.reports:
                        self.recovery.on_receiver_report(rb.fraction_lost)

    def _serve_nack(self, sid: int, nack: "rtcp.Nack") -> None:
        key = (sid << 32) | (nack.media_ssrc & 0xFFFFFFFF)
        copies, missing = self.cache.lookup_nack(key, nack.lost_seqs,
                                                 return_missing=True)
        self.recovery.rtx_cache_miss += len(missing)
        if not copies:
            return
        if not self.recovery.allow_rtx(sum(len(c) for c in copies),
                                       self._now):
            return      # over the retransmission-bandwidth budget
        out = PacketBatch.from_payloads(copies)
        with self.loop.tracer.span("egress"):
            sent = self.loop.engine.send_batch(
                out, self.loop.addr_ip[sid], self.loop.addr_port[sid])
        self.retransmitted += sent
        self.recovery.rtx_requests_served += len(copies)

    def emit_feedback(self, now: Optional[float] = None) -> int:
        """Drain RTCP termination toward each media sender: aggregated
        RR + min-REMB + merged NACKs + rate-limited PLI, SRTCP-protected
        with the sender leg's keys — every sender's compound in one
        launch of kernel I, sent in one sendmmsg, in the JAX bridge's
        order and bytes."""
        if self.degraded:
            return 0
        now = time.time() if now is None else now
        if self._bwe_fed.any():
            self.bwe.update_estimate(now * 1000.0)
        with self.loop.tracer.span("recovery"):
            upstream = self.recovery.collect_upstream_nacks(now)
        for ssrc, seqs in upstream.items():
            self.rtcp_term.queue_nack(ssrc, seqs)
        blobs, rows = [], []
        for sid, ssrc in list(self._ssrc_of.items()):
            own = self.own_estimate_bps(sid)
            fb = self.rtcp_term.make_sender_feedback(ssrc, now=now,
                                                     own_bps=own)
            if self.loop.addr_port[sid] == 0 or not fb:
                continue
            blobs.append(rtcp.build_compound(fb))
            rows.append(sid)
        if not blobs:
            return 0
        wire = self.tx_table.protect_rtcp(
            PacketBatch.from_payloads(blobs, stream=rows))
        addr = np.asarray(rows, dtype=np.int64)
        with self.loop.tracer.span("egress"):
            return self.loop.engine.send_batch(
                wire, self.loop.addr_ip[addr], self.loop.addr_port[addr])

    def tick(self, now: Optional[float] = None) -> dict:
        self._now = time.time() if now is None else now
        self._media_ran = False
        rx = self.loop.tick()
        if self._pending_fanout and not self._media_ran:
            # no media this tick to ship it: flush here (a fan-out
            # dispatched this tick keeps its overlap with the next window)
            self._flush_fanout()
        if self._dtls.pending and not self._dtls.deferred:
            # the flight pass (a deferred table's runs off-tick)
            self._dtls.tick()
        return {"rx": rx, "forwarded": self.forwarded,
                "retransmitted": self.retransmitted}

    # ----------------------------------------------------------- resume
    def snapshot(self) -> dict:
        """Checkpoint the conference's durable state in the JAX bridge's
        format: SRTP indices and replay windows of both tables, the BWE
        bank, endpoint rows, keys and SSRCs, receiver REMBs, conference
        ids and latched addresses.  The caches and recovery state are
        transient, as in the JAX bridge."""
        self._quiesce_fanout()
        keyed = {sid: ssrc for sid, ssrc in self._ssrc_of.items()
                 if sid in self._tx_keys}
        return {
            "capacity": self.capacity,
            "profile": self.profile.name,
            "sharded": False,
            "ast_ext_id": self.ast_ext_id,
            "engine_mode": self.engine_mode,
            "ingest_rings": self.ingest_rings,
            "rx_table": self.rx_table.snapshot(),
            "tx_table": self.tx_table.snapshot(),
            "bwe": self.bwe.snapshot(),
            "bwe_fed": self._bwe_fed.copy(),
            "ssrc_of": keyed,
            "rx_keys": dict(self._rx_keys),
            "tx_keys": dict(self._tx_keys),
            "recv_bw": {s: bw for s, bw in self._recv_bw.items()
                        if s in keyed},
            "conf_of": {s: c for s, c in self._conf_of.items()
                        if s in keyed},
            "bcast_speakers": {},
            "addr_ip": self.loop.addr_ip.copy(),
            "addr_port": self.loop.addr_port.copy(),
        }

    @classmethod
    def restore(cls, snap: dict, port: int = 0, device: DeviceLike = None,
                **kwargs) -> "SfuBridge":
        """Resume a snapshotted conference (of either package) on a fresh
        socket.  Endpoint rows reoccupy their old sids, so the restored
        SRTP tables and the SSRC demux line up; the translator derives
        its leg keys again from the stored master keys.  The snapshot's
        `engine_mode` and `ingest_rings` apply unless `kwargs` gives
        them."""
        if snap.get("sharded"):
            raise _not_ported("restoring a mesh bridge", 12)
        if snap.get("bcast_speakers"):
            raise _not_ported("broadcast conferences", 12)
        kwargs.setdefault("engine_mode", snap.get("engine_mode", "auto"))
        kwargs.setdefault("ingest_rings", snap.get("ingest_rings", 1))
        bridge = cls(port=port, capacity=snap["capacity"],
                     profile=SrtpProfile[snap["profile"]],
                     abs_send_time_ext_id=snap["ast_ext_id"],
                     device=device, **kwargs)
        bridge.rx_table = SrtpStreamTable.restore(snap["rx_table"],
                                                  bridge.device)
        bridge.tx_table = SrtpStreamTable.restore(snap["tx_table"],
                                                  bridge.device)
        bridge.bwe = BatchedRemoteBitrateEstimator.restore(snap["bwe"])
        bridge._bwe_fed = np.asarray(snap["bwe_fed"]).copy()
        bridge._rx_keys = dict(snap["rx_keys"])
        bridge._tx_keys = dict(snap["tx_keys"])
        bridge._recv_bw = dict(snap["recv_bw"])
        bridge._conf_of = {int(s): int(c) for s, c in
                           snap.get("conf_of", {}).items()}
        sids = sorted(snap["ssrc_of"])
        bridge.registry.reserve_many(sids, bridge)
        for sid in sids:
            ssrc = snap["ssrc_of"][sid]
            bridge.registry.map_ssrc(ssrc, sid)
            bridge._ssrc_of[sid] = ssrc
        bridge.translator.add_receivers(
            sids, [bridge._tx_keys[s][0] for s in sids],
            [bridge._tx_keys[s][1] for s in sids])
        bridge._rebuild_routes()
        # per-row state copies only onto reserved rows: anything else
        # comes back zeroed, so a later alloc inherits nothing stale
        keep = np.zeros(snap["capacity"], dtype=bool)
        keep[sids] = True
        bridge.loop.addr_ip[:] = np.where(keep, snap["addr_ip"], 0)
        bridge.loop.addr_port[:] = np.where(keep, snap["addr_port"], 0)
        bridge._bwe_fed &= keep
        stale = np.nonzero(~keep)[0]
        if len(stale):
            bridge.bwe.reset_rows(stale)
        return bridge

    def close(self) -> None:
        if self._pending_fanout:
            self._flush_fanout()     # the last tick's media still ships
        for eng in self.loop.rings:
            eng.close()
