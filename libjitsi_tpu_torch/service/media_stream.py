"""MediaStream — one RTP session leg as a row in shared batched state.

Counterpart: `libjitsi_tpu/service/media_stream.py` (`Direction`,
`StreamRegistry`, `MediaStream`, `create_media_stream`).

The reference's `org.jitsi.impl.neomedia.MediaStreamImpl` (~4k lines) owns
sockets, an FMJ Processor, a TransformEngineChain and per-stream stats
objects; 10k streams = 10k heavyweight object graphs.  Here a stream is a
*row id* into dense tables owned by a shared `StreamRegistry` (crypto
contexts on one device, stats on the host) plus a small host control
block (ssrc, seq/ts counters, direction, format map).  The transform
chain is shared and batched: a stream's `send` is one protect launch
(kernel C, or M under AEAD-GCM) and its `receive` one unprotect launch
(D, or N), and any number of streams' packets ride one launch through
`StreamRegistry.demux` and a chain on the registry's own tables.

The registry hands out rows from a free list kept exactly as the JAX
registry keeps it, so both hand out the same sids in the same order.

API shape mirrors `org.jitsi.service.neomedia.MediaStream`:
`set_direction`, `add_dynamic_rtp_payload_type`, `set_remote_ssrc`,
`start`/`close`, plus batched `send`/`receive` (the connector read/write
surface that the io/ layer drives).
"""

from __future__ import annotations

import enum
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from libjitsi_tpu_torch.bwe.send_side import SendSideBandwidthEstimation
from libjitsi_tpu_torch.control.sdes import SdesControl
from libjitsi_tpu_torch.core.config import ConfigurationService
from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.rtp.stats import StreamStatsTable
from libjitsi_tpu_torch.rtp.stats2 import StatsPoller
from libjitsi_tpu_torch.transform.engine import (TransformEngine,
                                                 TransformEngineChain)
from libjitsi_tpu_torch.transform.header_ext import TransportCCEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile


class Direction(enum.Enum):
    """Reference: org.jitsi.service.neomedia.MediaDirection."""

    SENDRECV = "sendrecv"
    SENDONLY = "sendonly"
    RECVONLY = "recvonly"
    INACTIVE = "inactive"

    @property
    def allows_sending(self) -> bool:
        return self in (Direction.SENDRECV, Direction.SENDONLY)

    @property
    def allows_receiving(self) -> bool:
        return self in (Direction.SENDRECV, Direction.RECVONLY)


class StreamRegistry:
    """Shared batch domain: SSRC demux, dense per-stream stats and
    per-profile (tx, rx) SRTP tables on one device (None means the card).

    One registry per media service; all its streams' packets can share
    device launches.  Reference analog: the MediaServiceImpl-owned
    machinery each MediaStreamImpl hooks into.
    """

    def __init__(self, capacity: int = 1024, device: DeviceLike = None,
                 config: Optional[ConfigurationService] = None):
        self.config = config if config is not None else ConfigurationService()
        self.capacity = capacity
        self.device = resolve_device(device)
        self.stats = StreamStatsTable(capacity)
        # MediaStreamStats2-shaped pull API (rates for all rows close in
        # one vectorized poll; streams read per-track views from it)
        self.stats2 = StatsPoller(self.stats)
        self._srtp: Dict[SrtpProfile,
                         Tuple[SrtpStreamTable, SrtpStreamTable]] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._ssrc_to_sid: Dict[int, int] = {}
        self.streams: Dict[int, object] = {}

    @property
    def free_slots(self) -> int:
        """Rows available to alloc (admission control's capacity gate)."""
        return len(self._free)

    def alloc(self, stream) -> int:
        """Claim the lowest free row for `stream` (its owner)."""
        if not self._free:
            raise RuntimeError("stream capacity exhausted")
        sid = self._free.pop()
        self.streams[sid] = stream
        return sid

    def reserve(self, sid: int, stream) -> None:
        """Claim a SPECIFIC row (checkpoint restore: a resumed bridge
        must reoccupy its old sids so SRTP rows and demux keep lining
        up).  Raises if the row is already taken."""
        self.reserve_many([sid], stream)

    def reserve_many(self, sids, stream) -> None:
        """Bulk `reserve`: one pass over the free list however many rows
        a restore reclaims."""
        want = {int(s) for s in sids}
        taken = want - set(self._free)
        if taken:
            raise ValueError(f"sids not free: {sorted(taken)}")
        self._free = [s for s in self._free if s not in want]
        for s in want:
            self.streams[s] = stream

    def release(self, sid: int) -> None:
        """Return a row to the free list, removing its SRTP rows from the
        registry's own tables and zeroing its stats."""
        self.streams.pop(sid, None)
        for tx, rx in self._srtp.values():
            if tx.active[sid]:
                tx.remove_stream(sid)
            if rx.active[sid]:
                rx.remove_stream(sid)
        self.stats.reset(sid)  # a recycled row must not inherit counters
        self.stats2.reset(sid)
        self._free.append(sid)

    def srtp_tables(self, profile: SrtpProfile
                    ) -> Tuple[SrtpStreamTable, SrtpStreamTable]:
        if profile not in self._srtp:
            self._srtp[profile] = (
                SrtpStreamTable(self.capacity, profile, self.device),
                SrtpStreamTable(self.capacity, profile, self.device),
            )
        return self._srtp[profile]

    # ------------------------------------------------------------- demux
    def map_ssrc(self, ssrc: int, sid: int) -> None:
        self._ssrc_to_sid[ssrc & 0xFFFFFFFF] = sid

    def unmap_ssrc(self, ssrc: int) -> None:
        self._ssrc_to_sid.pop(ssrc & 0xFFFFFFFF, None)

    def _lookup(self, ssrc: np.ndarray) -> np.ndarray:
        m = self._ssrc_to_sid
        return np.fromiter((m.get(int(s), -1) for s in ssrc),
                           dtype=np.int64, count=len(ssrc))

    def demux(self, batch: PacketBatch) -> np.ndarray:
        """Fill batch.stream from each packet's RTP SSRC; returns the ids
        (-1 where unknown — the reference drops packets of unknown SSRC
        unless discovery is enabled)."""
        sids = self._lookup(rtp_header.parse(batch).ssrc)
        batch.stream[:] = sids
        return sids

    def demux_rtcp(self, batch: PacketBatch) -> np.ndarray:
        """Same, for RTCP rows (sender SSRC sits at byte offset 4)."""
        sids = self._lookup(rtp_header.read_u32(batch.data, 4))
        batch.stream[:] = sids
        return sids


class MediaStream:
    """One RTP session leg (reference: MediaStreamImpl).

    Use via `MediaService.create_media_stream`.  Typical life cycle::

        s = media_service().create_media_stream(profile=..., registry=...)
        s.add_dynamic_rtp_payload_type(96, "opus", 48000)
        s.set_remote_ssrc(0x1234)
        offer = s.sdes.create_offer()        # -> signaling
        s.sdes.accept_answer(answer_line)
        s.start()
        wire = s.send([payload0, payload1])  # protected RTP bytes out
        pkts, ok = s.receive(incoming)       # decrypted payloads in
    """

    def __init__(self, registry: StreamRegistry,
                 profile: SrtpProfile = SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 direction: Direction = Direction.SENDRECV,
                 local_ssrc: Optional[int] = None,
                 extra_engines: Sequence[TransformEngine] = ()):
        self.registry = registry
        self.profile = profile
        self.direction = direction
        self.sid = registry.alloc(self)
        self.local_ssrc = (int.from_bytes(os.urandom(4), "big")
                           if local_ssrc is None else local_ssrc) & 0xFFFFFFFF
        self.remote_ssrc: Optional[int] = None
        self.sdes = SdesControl(profiles=[profile])
        self._formats: Dict[int, Tuple[str, int]] = {}  # pt -> (name, rate)
        self._tx_seq = int.from_bytes(os.urandom(2), "big")
        self._tx_ts = int.from_bytes(os.urandom(4), "big")
        self._extra = list(extra_engines)
        self._chain: Optional[TransformEngineChain] = None
        self._started = False
        self._rtcp_listeners: list = []
        # send-side BWE (reference: BandwidthEstimatorImpl on the
        # stream): fed by handle_rtcp from RR loss, REMB caps and TCC
        # feedback (the latter via a TransportCCEngine when one is in
        # the chain's extra engines)
        self.bwe = SendSideBandwidthEstimation()
        self._tcc_engine: Optional[TransportCCEngine] = next(
            (e for e in self._extra
             if isinstance(e, TransportCCEngine)), None)

    # ------------------------------------------------------------ control
    def add_dynamic_rtp_payload_type(self, pt: int, encoding: str,
                                     clock_rate: int) -> None:
        """Reference: MediaStream.addDynamicRTPPayloadType."""
        self._formats[pt] = (encoding, clock_rate)
        self.registry.stats.clock_rate[self.sid] = clock_rate

    def set_direction(self, d: Direction) -> None:
        self.direction = d

    def set_remote_ssrc(self, ssrc: int) -> None:
        if self.remote_ssrc is not None:
            self.registry.unmap_ssrc(self.remote_ssrc)
        self.remote_ssrc = ssrc & 0xFFFFFFFF
        self.registry.map_ssrc(self.remote_ssrc, self.sid)

    def start(self, srtp_control=None) -> None:
        """Install negotiated keys and build the transform chain.

        `srtp_control`: any COMPLETED keying control exposing
        ``srtp_keys() -> (profile, tx_key, tx_salt, rx_key, rx_salt)``;
        default is the stream's own SDES negotiation.  Reference:
        MediaStreamImpl.start() wiring the TransformEngineChain with
        whichever SrtpControl signaling chose.
        """
        if self._started:
            return
        tx_tab, rx_tab = self.registry.srtp_tables(self.profile)
        if srtp_control is not None:
            profile, tk, tsalt, rk, rsalt = srtp_control.srtp_keys()
            if profile != self.profile:
                raise ValueError(
                    f"control negotiated {profile.name}, stream built "
                    f"for {self.profile.name}")
            tx_tab.add_stream(self.sid, tk, tsalt)
            rx_tab.add_stream(self.sid, rk, rsalt)
        elif self.sdes.negotiated:
            lo, re = self.sdes.local, self.sdes.remote
            tx_tab.add_stream(self.sid, lo.master_key, lo.master_salt)
            rx_tab.add_stream(self.sid, re.master_key, re.master_salt)
        else:
            raise RuntimeError(
                "no keys negotiated; complete SDES, or pass a completed "
                "keying control to start()")
        engines = list(self._extra) + [SrtpTransformEngine(tx_tab, rx_tab)]
        self._chain = TransformEngineChain(engines)
        self._started = True

    def close(self) -> bytes:
        """Tear down; returns an RTCP BYE to send (reference emits BYE)."""
        bye = rtcp.build_bye(rtcp.Bye([self.local_ssrc]))
        if self.remote_ssrc is not None:
            self.registry.unmap_ssrc(self.remote_ssrc)
        self.registry.release(self.sid)
        self._started = False
        return bye

    # --------------------------------------------------------------- send
    def send(self, payloads: Sequence[bytes], pt: int = 96,
             ts_step: int = 960, marker=None) -> List[bytes]:
        """Packetize + run the send chain; returns wire-ready datagrams.

        ts_step defaults to 20 ms at 48 kHz.  Reference path: FMJ
        packetizer -> RTPConnectorOutputStream.write -> chain loop
        (SURVEY §3.2).
        """
        if not self.direction.allows_sending:
            raise RuntimeError(f"direction {self.direction.value} cannot send")
        if not self._started:
            raise RuntimeError("start() first")
        n = len(payloads)
        seqs = [(self._tx_seq + i) & 0xFFFF for i in range(n)]
        tss = [(self._tx_ts + i * ts_step) & 0xFFFFFFFF for i in range(n)]
        self._tx_seq = (self._tx_seq + n) & 0xFFFF
        self._tx_ts = (self._tx_ts + n * ts_step) & 0xFFFFFFFF
        batch = rtp_header.build(payloads, seqs, tss, self.local_ssrc, pt,
                                 marker=marker, stream=[self.sid] * n)
        out, mask = self._chain.rtp_transformer.transform(batch)
        self.registry.stats.on_sent(out.stream[mask],
                                    np.asarray(out.length)[mask])
        return [out.to_bytes(i) for i in np.nonzero(mask)[0]]

    # ------------------------------------------------------------ receive
    def receive(self, datagrams: Sequence[bytes],
                arrival: Optional[float] = None
                ) -> Tuple[PacketBatch, np.ndarray]:
        """Run the receive chain on raw datagrams for this stream.

        Returns (batch, ok): decrypted packets and per-row verdicts.
        Multi-stream ingest goes through `StreamRegistry.demux` + the
        shared chain instead (io layer / SFU path).
        """
        if not self.direction.allows_receiving:
            raise RuntimeError(f"direction {self.direction.value} cannot receive")
        if not self._started:
            raise RuntimeError("start() first")
        batch = PacketBatch.from_payloads(datagrams,
                                          stream=[self.sid] * len(datagrams))
        out, ok = self._chain.rtp_transformer.reverse_transform(batch)
        hdr = rtp_header.parse(out)
        if np.any(ok):
            now = time.time() if arrival is None else arrival
            self.registry.stats.on_received(
                out.stream[ok], hdr.seq[ok], hdr.ts[ok],
                np.asarray(out.length)[ok],
                np.full(int(ok.sum()), now))
        return out, ok

    # --------------------------------------------------------------- rtcp
    def make_rtcp_report(self, now: Optional[float] = None) -> bytes:
        """Compound SR/RR + SDES CNAME (reference: RTCP report generation
        the stream's RTPManager schedules)."""
        st = self.registry.stats
        sending = self.direction.allows_sending and st.tx_packets[self.sid] > 0
        blocks = []
        if self.remote_ssrc is not None and st.rx_packets[self.sid] > 0:
            blocks = [st.make_report_block(self.sid, self.remote_ssrc, now)]
        if sending:
            sr = st.make_sr(self.sid, self.local_ssrc, self._tx_ts,
                            reports=blocks, now=now)
            main = rtcp.build_sr(sr)
        else:
            main = rtcp.build_rr(rtcp.ReceiverReport(self.local_ssrc, blocks))
        cname = f"libjitsi-tpu-{self.local_ssrc:08x}".encode()
        sdes = rtcp.build_sdes([rtcp.SdesChunk(self.local_ssrc, [(1, cname)])])
        return rtcp.build_compound([main, sdes])

    def handle_rtcp(self, blob: bytes, now: Optional[float] = None) -> list:
        """Feed an incoming (already-unprotected) compound RTCP packet to
        stats; returns the parsed packets for upper layers (BWE etc.).
        Registered RTCP listeners (reference: RTCPPacketListener on
        MediaStreamStats2) see every parsed packet."""
        pkts = rtcp.parse_compound(blob)
        st = self.registry.stats
        now_ms = (time.time() if now is None else now) * 1000.0
        for p in pkts:
            if isinstance(p, rtcp.SenderReport):
                st.on_sr_received(self.sid, p, arrival=now)
                for rb in p.reports:
                    if rb.ssrc == self.local_ssrc:
                        st.on_rr_received(self.sid, rb, now=now)
                        self.bwe.on_receiver_report(rb.fraction_lost,
                                                    now_ms)
            elif isinstance(p, rtcp.ReceiverReport):
                for rb in p.reports:
                    if rb.ssrc == self.local_ssrc:
                        st.on_rr_received(self.sid, rb, now=now)
                        self.bwe.on_receiver_report(rb.fraction_lost,
                                                    now_ms)
            elif isinstance(p, rtcp.Remb):
                self.bwe.on_remb(p.bitrate_bps)
            elif isinstance(p, rtcp.TccFeedback) and \
                    self._tcc_engine is not None:
                sts = [self._tcc_engine.lookup_send_time(
                           (p.base_seq + i) & 0xFFFF)
                       for i in range(len(p.received))]
                self.bwe.on_tcc_feedback(
                    p, [None if t is None else t * 1000.0 for t in sts],
                    now_ms)
        for fn in list(self._rtcp_listeners):   # listeners may remove
            for p in pkts:                      # themselves mid-callback
                fn(self, p)
        return pkts

    def add_rtcp_listener(self, fn) -> None:
        """fn(stream, parsed_rtcp_packet) per incoming RTCP packet."""
        self._rtcp_listeners.append(fn)

    def remove_rtcp_listener(self, fn) -> None:
        self._rtcp_listeners.remove(fn)

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Flat snapshot for this stream (see `send_stats` /
        `receive_stats` for the typed MediaStreamStats2 views)."""
        st = self.registry.stats
        i = self.sid
        return {
            "tx_packets": int(st.tx_packets[i]),
            "tx_bytes": int(st.tx_bytes[i]),
            "rx_packets": int(st.rx_packets[i]),
            "rx_bytes": int(st.rx_bytes[i]),
            "cumulative_lost": st.cumulative_lost(i),
            "jitter_rtp_units": float(st.jitter[i]),
            "rtt_seconds": float(st.rtt[i]),
        }

    def send_stats(self):
        """Typed per-track send stats (reference: `stats.SendTrackStats`
        via MediaStreamStats2.getSendStats).  Rates reflect the
        registry poller's last closed interval — call
        `registry.stats2.poll()` periodically."""
        return self.registry.stats2.send_stats(self.sid)

    def receive_stats(self):
        """Typed per-track receive stats (reference:
        `stats.ReceiveTrackStats` via getReceiveStats)."""
        return self.registry.stats2.receive_stats(self.sid)


def create_media_stream(config: Optional[ConfigurationService] = None,
                        registry: Optional[StreamRegistry] = None,
                        **kwargs) -> MediaStream:
    if registry is None:
        raise ValueError("a StreamRegistry is required "
                         "(MediaService owns the default)")
    return MediaStream(registry, **kwargs)
