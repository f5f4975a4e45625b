"""End-to-end loss-recovery ladder: NACK -> RTX -> FEC -> PLC.

This layer makes the *media path* survive the network: the Generic
NACK codec (`rtp/rtcp.py`), the retransmission `PacketCache`
(`sfu/cache.py`) and ulpfec (`transform/fec.py`) are wired into one
closed loop (reference:
`RetransmissionRequesterImpl` + `CachingTransformer` + `FECSender`
around RTCP termination, SURVEY §2.2/§2.3):

- **NackScheduler** (receiver side): pending-loss table fed from
  `rtp/loss.py` gap detection.  Per-stream NACK budgets, dedup,
  exponential holdoff between re-NACKs, and playout-deadline awareness:
  a packet that cannot arrive before its scheduled playout is never
  (re-)NACKed — it falls through to concealment instead
  (`nacks_suppressed_deadline`), and whatever is still missing at the
  deadline is handed to the caller to conceal (audio PLC / frame skip).
- **TokenBucket** (sender side): a retransmission-bandwidth budget in
  front of the cache — a NACK storm must not let RTX starve live media.
- **AdaptiveFecSender**: ulpfec group size k tracks the reported loss
  rate (RTCP RR fraction-lost / the BWE loss signal): FEC overhead is
  ~2x the loss rate, off below `fec_off_below_loss`, clamped to RFC
  5109's 16-packet mask.
- **RecoveryController**: the bridge-side composition, with the
  overload rungs a supervisor drives (`shed_fec`, `throttle_rtx`):
  under overload FEC sheds first, then the RTX budget shrinks.
- **RecoveringReceiver**: the endpoint-side composition at the wire
  layer (pre-SRTP): gap tracking, deadline-aware NACK emission, FEC
  recovery of protected wire packets, and PLC accounting for what the
  ladder could not bring back in time.

FEC rides a separate stream per protected SSRC (RFC 5109
separate-stream variant): SSRC = media_ssrc ^ "FEC", own PT and seq
space.  The bridge XORs the *SRTP-protected* wire packets, so a
recovered packet re-enters the receiver's normal unprotect path and is
still authenticated by SRTP — forged FEC cannot inject media, it can
only fail auth.

Counterpart: `libjitsi_tpu/sfu/recovery.py` (copied whole; host only):
`RecoveryConfig`, `TokenBucket`, `NackScheduler`, `AdaptiveFecSender`,
`RecoveryController` with its `register_metrics` and flight-recorder
events (`flight`, `sid_of`, `_rec`: `nack_queued`, `nack_upstream`,
`rtx_budget_drop`, `fec_shed`, `rtx_throttle`; the bridge records
`rtx_served` and `rtx_cache_miss`), and `RecoveringReceiver` with its
`register_metrics`, and the `info` log lines of the two supervisor
rungs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp.loss import LossTracker
from libjitsi_tpu_torch.transform.fec import FecReceiver, build_fec
from libjitsi_tpu_torch.utils.logging import get_logger

_log = get_logger("sfu.recovery")

#: SSRC of a stream's FEC companion stream ("FEC" xor, like _VideoTrack's
#: RTX_SSRC_XOR convention).
FEC_SSRC_XOR = 0x00464543


@dataclass
class RecoveryConfig:
    """Knobs for the whole ladder (seconds unless suffixed)."""

    # receiver-side NACK generation
    nack_budget_per_stream: int = 16   # seqs NACKed per stream per round
    nack_max_attempts: int = 3         # NACK + re-NACKs per lost seq
    holdoff_base_s: float = 0.03       # first re-NACK delay
    holdoff_factor: float = 2.0        # exponential re-NACK backoff
    rtt_s: float = 0.05                # assumed RTT until measured
    max_gap: int = 64                  # larger jump = reset, not loss
    # sender-side retransmission budget
    rtx_budget_bps: float = 1_000_000.0
    rtx_burst_bytes: int = 32 << 10
    rtx_throttle_scale: float = 0.25   # supervisor rung: budget shrink
    # adaptive FEC
    fec_enabled: bool = True
    fec_pt: int = 127
    fec_min_k: int = 2                 # heaviest protection: 1 FEC per 2
    fec_max_k: int = 16                # RFC 5109 mask limit
    fec_off_below_loss: float = 0.02   # not worth the overhead under 2%
    loss_ewma_alpha: float = 0.3       # reported-loss smoothing


class TokenBucket:
    """Byte token bucket for the retransmission-bandwidth budget.

    Deterministic (caller supplies `now`): chaos tests replay exactly.
    `set_scale` is the supervisor's throttle — it scales both rate and
    burst so an overloaded bridge's RTX ceiling drops immediately.
    """

    def __init__(self, rate_bps: float, burst_bytes: int):
        self.rate_bytes = rate_bps / 8.0
        self.burst = float(burst_bytes)
        self._tokens = float(burst_bytes)
        self._last: Optional[float] = None
        self._scale = 1.0

    def set_scale(self, scale: float) -> None:
        self._scale = float(scale)
        self._tokens = min(self._tokens, self.burst * self._scale)

    def allow(self, nbytes: int, now: float) -> bool:
        if self._last is None:
            self._last = now
        dt = max(0.0, now - self._last)
        self._last = now
        cap = self.burst * self._scale
        self._tokens = min(cap, self._tokens + dt * self.rate_bytes
                           * self._scale)
        if nbytes <= self._tokens:
            self._tokens -= nbytes
            return True
        return False


class _Pending:
    __slots__ = ("first", "attempts", "next_at", "deadline", "suppressed")

    def __init__(self, now: float, deadline: Optional[float]):
        self.first = now
        self.attempts = 0
        self.next_at = now          # first NACK is immediate
        self.deadline = deadline
        self.suppressed = False


class NackScheduler:
    """Pending-loss table -> budgeted, deduped, deadline-aware NACKs.

    Keys are opaque (a media SSRC, or any composite); each key is one
    NACK target stream.  `collect(now)` returns

        (nacks: {key: [seq, ...]}, expired: {key: [seq, ...]})

    where `nacks` is what to send this round (per-key budget applied,
    exponential holdoff between attempts on the same seq) and `expired`
    is what passed its playout deadline unrecovered — the caller's PLC
    moment.  A seq whose NEXT attempt could not complete before the
    deadline (now + rtt > deadline) is suppressed rather than re-NACKed
    (`nacks_suppressed_deadline`) and waits for FEC or a late arrival
    until the deadline expires it.
    """

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig()
        self._pending: Dict[object, Dict[int, _Pending]] = {}
        self.nacks_sent = 0
        self.nacks_suppressed_deadline = 0
        self.nacks_abandoned = 0
        self.recovered_late = 0

    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def on_losses(self, key, seqs, now: float,
                  deadline: Optional[float] = None) -> None:
        if not seqs:
            return
        entries = self._pending.setdefault(key, {})
        for s in seqs:
            s = int(s) & 0xFFFF
            if s not in entries:                   # dedup
                entries[s] = _Pending(now, deadline)

    def on_arrival(self, key, seq: int) -> bool:
        """A pending seq arrived (RTX, FEC recovery, or plain reorder)."""
        entries = self._pending.get(key)
        if entries is None:
            return False
        e = entries.pop(int(seq) & 0xFFFF, None)
        if e is None:
            return False
        if not entries:
            del self._pending[key]
        self.recovered_late += 1
        return True

    def collect(self, now: float) -> Tuple[Dict[object, List[int]],
                                           Dict[object, List[int]]]:
        cfg = self.cfg
        nacks: Dict[object, List[int]] = {}
        expired: Dict[object, List[int]] = {}
        for key in list(self._pending):
            entries = self._pending[key]
            send: List[int] = []
            for seq in list(entries):
                e = entries[seq]
                if e.deadline is not None and now >= e.deadline:
                    # playout passed: conceal, never re-request
                    expired.setdefault(key, []).append(seq)
                    del entries[seq]
                    continue
                if now < e.next_at:
                    continue
                if e.attempts >= cfg.nack_max_attempts:
                    if e.deadline is None:
                        # no playout clock (bridge uplink): give up
                        del entries[seq]
                        self.nacks_abandoned += 1
                    continue      # with a deadline: wait for FEC/late rx
                if e.deadline is not None and \
                        now + cfg.rtt_s > e.deadline:
                    # a retransmission cannot beat playout: suppress
                    if not e.suppressed:
                        e.suppressed = True
                        self.nacks_suppressed_deadline += 1
                    continue
                if len(send) >= cfg.nack_budget_per_stream:
                    continue      # over budget this round; stays pending
                send.append(seq)
                e.attempts += 1
                e.next_at = now + cfg.holdoff_base_s * (
                    cfg.holdoff_factor ** (e.attempts - 1))
            if send:
                self.nacks_sent += len(send)
                nacks[key] = send
            if not entries:
                del self._pending[key]
        return nacks, expired


class AdaptiveFecSender:
    """Group outgoing wire packets per key, emit FEC payloads with a
    protection ratio that tracks the reported loss rate.

    `update_loss(loss)` maps smoothed loss to the group size:
    overhead ~ 2x the loss rate (k ~= 1/(2*loss)), clamped to
    [fec_min_k, fec_max_k]; off below `fec_off_below_loss`.  Groups
    restart on a seq discontinuity — RFC 5109's mask assumes the
    protected seqs are consecutive, so a gap (uplink loss) must not be
    papered over by a lying mask.
    """

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig()
        self.k = 0                      # 0 = off
        self.shed = False               # supervisor rung
        self.fec_packets_sent = 0
        self._groups: Dict[object, List[bytes]] = {}
        self._base: Dict[object, int] = {}

    @property
    def active(self) -> bool:
        return self.cfg.fec_enabled and not self.shed and self.k > 0

    def update_loss(self, loss: float) -> int:
        cfg = self.cfg
        if not cfg.fec_enabled or loss < cfg.fec_off_below_loss:
            self.k = 0
        else:
            self.k = int(min(max(round(1.0 / (2.0 * loss)),
                                 cfg.fec_min_k), cfg.fec_max_k))
        return self.k

    def set_shed(self, shed: bool) -> None:
        self.shed = shed
        if shed:
            self._groups.clear()
            self._base.clear()

    def push(self, key, rtp_packet: bytes) -> Optional[bytes]:
        """Returns a FEC *payload* when `key`'s group completes."""
        if not self.active:
            if self._groups:
                self._groups.clear()
                self._base.clear()
            return None
        seq = int.from_bytes(rtp_packet[2:4], "big")
        group = self._groups.get(key)
        if group is None or seq != (
                (self._base[key] + len(group)) & 0xFFFF):
            group = []                  # discontinuity: restart group
            self._groups[key] = group
            self._base[key] = seq
        group.append(rtp_packet)
        if len(group) >= self.k:
            fec = build_fec(group, self._base[key])
            self._groups.pop(key, None)
            self._base.pop(key, None)
            self.fec_packets_sent += 1
            return fec
        return None


class RecoveryController:
    """Bridge-side recovery composition (one per SfuBridge).

    Uplink: `observe_rx` feeds arriving (ssrc, seq) pairs from the
    decrypt path; gaps become upstream NACKs drained by
    `collect_upstream_nacks` into RTCP termination.  Downlink:
    `allow_rtx` budgets NACK service from the per-leg caches, and
    `fec_protect` wraps the adaptive FEC sender with the per-leg FEC
    stream bookkeeping (seq space + derived SSRC).  Loss reports from
    receivers (`on_receiver_report`) drive the FEC ratio.

    Supervisor coupling (`shed_fec` / `throttle_rtx`): recovery
    overhead is the bridge's *elastic* bandwidth — it sheds before any
    stream does.
    """

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig()
        self.nacks = NackScheduler(self.cfg)
        self.fec = AdaptiveFecSender(self.cfg)
        self.rtx_bucket = TokenBucket(self.cfg.rtx_budget_bps,
                                      self.cfg.rtx_burst_bytes)
        self._trackers: Dict[int, LossTracker] = {}
        self._fec_seq: Dict[object, int] = {}
        self.loss_ewma = 0.0
        self.rtx_requests_served = 0
        self.rtx_cache_miss = 0
        self.rtx_budget_dropped = 0
        self.fec_shed = False
        self.rtx_throttled = False
        # optional flight recorder (`utils/flight.FlightRecorder`):
        # ladder transitions and NACK/RTX actions leave forensic events
        self.flight = None
        # optional ssrc -> leg sid resolver (the SfuBridge's): with it,
        # nack_queued events land in the stream's own ring
        self.sid_of = None

    def _rec(self, kind: str, sid: Optional[int] = None,
             **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, sid=sid, **fields)

    # ------------------------------------------------------------ uplink
    def observe_rx(self, ssrcs, seqs, now: float) -> None:
        """Feed one decrypted batch's (ssrc, seq) pairs; newly-detected
        gaps are queued for upstream NACKing (no playout deadline — the
        bridge forwards, it does not play out; abandonment is
        attempt-bounded instead)."""
        for ssrc, seq in zip(ssrcs, seqs):
            ssrc = int(ssrc) & 0xFFFFFFFF
            tr = self._trackers.get(ssrc)
            if tr is None:
                tr = self._trackers[ssrc] = LossTracker(self.cfg.max_gap)
            losses, advanced = tr.observe(int(seq))
            if losses:
                self.nacks.on_losses(ssrc, losses, now)
                sid = self.sid_of(ssrc) if self.sid_of is not None \
                    else None
                self._rec("nack_queued", sid=sid, ssrc=ssrc,
                          n=len(losses))
            elif not advanced:
                self.nacks.on_arrival(ssrc, int(seq))

    def collect_upstream_nacks(self, now: float) -> Dict[int, List[int]]:
        nacks, _expired = self.nacks.collect(now)
        if nacks:
            self._rec("nack_upstream", streams=len(nacks),
                      seqs=sum(len(v) for v in nacks.values()))
        return nacks

    # ---------------------------------------------------------- downlink
    def on_receiver_report(self, fraction_lost_255: int) -> None:
        """RTCP RR loss signal -> smoothed loss -> FEC ratio (the same
        fraction-lost that drives `bwe/send_side.py`'s loss-based
        estimator)."""
        loss = (int(fraction_lost_255) & 0xFF) / 255.0
        a = self.cfg.loss_ewma_alpha
        self.loss_ewma += a * (loss - self.loss_ewma)
        self.fec.update_loss(self.loss_ewma)

    def allow_rtx(self, nbytes: int, now: float) -> bool:
        if self.rtx_bucket.allow(nbytes, now):
            return True
        self.rtx_budget_dropped += 1
        self._rec("rtx_budget_drop", nbytes=int(nbytes))
        return False

    def fec_active(self) -> bool:
        return self.fec.active

    def fec_protect(self, leg_sid: int, media_ssrc: int,
                    wire_packet: bytes) -> Optional[bytes]:
        """Feed one leg's protected wire packet; returns a complete FEC
        RTP packet (own SSRC/PT/seq space) when the group completes."""
        key = (int(leg_sid) << 32) | (int(media_ssrc) & 0xFFFFFFFF)
        payload = self.fec.push(key, wire_packet)
        if payload is None:
            return None
        seq = self._fec_seq.get(key, 0)
        self._fec_seq[key] = (seq + 1) & 0xFFFF
        fec_ssrc = (int(media_ssrc) ^ FEC_SSRC_XOR) & 0xFFFFFFFF
        b = rtp_header.build([payload], [seq], [0], [fec_ssrc],
                             [self.cfg.fec_pt], stream=[0])
        return b.to_bytes(0)

    # --------------------------------------------- lifecycle coupling
    def forget_ssrcs(self, ssrcs) -> None:
        """Evict hook: drop a departed sender's uplink loss trackers and
        any pending upstream NACKs for it, so churn cannot grow recovery
        state without bound (streams are mortal)."""
        for ssrc in ssrcs:
            ssrc = int(ssrc) & 0xFFFFFFFF
            self._trackers.pop(ssrc, None)
            self.nacks._pending.pop(ssrc, None)

    def forget_legs(self, leg_sids) -> None:
        """Evict hook: drop per-receiver-leg FEC groups and seq spaces
        (keyed `(leg_sid << 32) | media_ssrc`) for departed legs."""
        legs = {int(s) for s in leg_sids}
        for d in (self.fec._groups, self.fec._base, self._fec_seq):
            for key in [k for k in d
                        if isinstance(k, int) and (k >> 32) in legs]:
                del d[key]

    # ------------------------------------------- supervisor coupling
    def shed_fec(self, shed: bool) -> None:
        """Escalation rung: FEC overhead is the first bandwidth shed."""
        self.fec_shed = shed
        self.fec.set_shed(shed)
        self._rec("fec_shed", shed=bool(shed))
        _log.info("recovery_fec_shed", shed=shed)

    def throttle_rtx(self, throttled: bool) -> None:
        """Escalation rung: shrink the retransmission budget before any
        stream is dropped."""
        self.rtx_throttled = throttled
        self.rtx_bucket.set_scale(
            self.cfg.rtx_throttle_scale if throttled else 1.0)
        self._rec("rtx_throttle", throttled=bool(throttled))
        _log.info("recovery_rtx_throttle", throttled=throttled)

    # --------------------------------------------------- observability
    def register_metrics(self, registry, prefix: str = "recovery") -> None:
        registry.register_counters(self, (
            ("rtx_requests_served",
             "NACKed packets retransmitted within budget"),
            ("rtx_cache_miss",
             "NACKed seqs not found in the retransmission cache"),
            ("rtx_budget_dropped",
             "NACK bursts dropped by the retransmission budget"),
        ), prefix=prefix)
        registry.register_counters(self.nacks, (
            ("nacks_sent", "lost seqs NACKed upstream"),
            ("nacks_suppressed_deadline",
             "NACKs suppressed because playout would pass first"),
            ("nacks_abandoned", "lost seqs given up after max attempts"),
            ("recovered_late", "pending seqs recovered before abandon"),
        ), prefix=prefix)
        registry.register_scalar(
            f"{prefix}_fec_packets_sent",
            lambda: self.fec.fec_packets_sent,
            help_="FEC packets emitted on egress legs", kind="counter")
        registry.register_scalar(
            f"{prefix}_fec_k", lambda: self.fec.k,
            help_="current FEC group size (0 = off)")
        registry.register_scalar(
            f"{prefix}_loss_ewma", lambda: self.loss_ewma,
            help_="smoothed reported loss rate driving the FEC ratio")
        registry.register_scalar(
            f"{prefix}_fec_shed", lambda: int(self.fec_shed),
            help_="1 while the supervisor has shed FEC")
        registry.register_scalar(
            f"{prefix}_rtx_throttled", lambda: int(self.rtx_throttled),
            help_="1 while the supervisor has shrunk the RTX budget")


class RecoveringReceiver:
    """Endpoint-side recovery at the wire layer (pre-SRTP).

    Feed every arriving wire packet through `on_wire`; it classifies by
    SSRC (media vs the stream's FEC companion), tracks gaps, buffers
    wire packets for FEC, and returns the packets newly available to
    the decrypt path — the arriving packet itself and/or an FEC
    recovery.  `poll(now)` drives the NACK schedule: it returns the
    {media_ssrc: [seq]} lists to send upstream and conceals (PLC) what
    passed its playout deadline unrecovered.

    The playout deadline of a lost packet is `detection + playout_delay`
    — the jitter-buffer depth a real receiver would run.  Recovery that
    lands after that is useless, so it is never requested
    (`nacks_suppressed_deadline`) and the frame is concealed
    (`plc_frames`).
    """

    def __init__(self, cfg: Optional[RecoveryConfig] = None,
                 playout_delay_s: float = 0.2):
        self.cfg = cfg or RecoveryConfig()
        self.playout_delay = playout_delay_s
        self.nacks = NackScheduler(self.cfg)
        self._trackers: Dict[int, LossTracker] = {}
        self._fec_rx: Dict[int, FecReceiver] = {}
        self._media_of_fec: Dict[int, int] = {}
        self.plc_frames = 0
        self.rtx_recovered = 0

    def add_stream(self, media_ssrc: int,
                   fec_ssrc: Optional[int] = None) -> None:
        media_ssrc = int(media_ssrc) & 0xFFFFFFFF
        self._trackers[media_ssrc] = LossTracker(self.cfg.max_gap)
        self._fec_rx[media_ssrc] = FecReceiver()
        if fec_ssrc is None:
            fec_ssrc = (media_ssrc ^ FEC_SSRC_XOR) & 0xFFFFFFFF
        self._media_of_fec[int(fec_ssrc) & 0xFFFFFFFF] = media_ssrc

    @property
    def fec_recovered(self) -> int:
        return sum(fr.recovered for fr in self._fec_rx.values())

    def on_wire(self, ssrc: int, seq: int, packet: bytes,
                now: float) -> List[bytes]:
        """One arriving wire packet -> packets ready for unprotect."""
        ssrc = int(ssrc) & 0xFFFFFFFF
        media = self._media_of_fec.get(ssrc)
        if media is not None:
            return self._on_fec(media, packet, now)
        tr = self._trackers.get(ssrc)
        if tr is None:
            return [packet]                       # untracked stream
        losses, advanced = tr.observe(int(seq))
        if losses:
            self.nacks.on_losses(ssrc, losses, now,
                                 deadline=now + self.playout_delay)
        elif not advanced:
            if self.nacks.on_arrival(ssrc, int(seq)):
                self.rtx_recovered += 1
        self._fec_rx[ssrc].push_media(packet)
        return [packet]

    def _on_fec(self, media_ssrc: int, fec_packet: bytes,
                now: float) -> List[bytes]:
        # bridge FEC packets carry a bare 12-byte RTP header
        recovered = self._fec_rx[media_ssrc].push_fec(fec_packet[12:],
                                                      media_ssrc)
        if recovered is None:
            return []
        seq = int.from_bytes(recovered[2:4], "big")
        self.nacks.on_arrival(media_ssrc, seq)
        tr = self._trackers.get(media_ssrc)
        if tr is not None:
            tr.observe(seq)                       # late-arrival bookkeeping
        return [recovered]

    def poll(self, now: float) -> Dict[int, List[int]]:
        """Collect this round's NACK lists; conceal expired losses."""
        nacks, expired = self.nacks.collect(now)
        self.plc_frames += sum(len(v) for v in expired.values())
        return nacks

    def register_metrics(self, registry,
                         prefix: str = "recv_recovery") -> None:
        registry.register_counters(self.nacks, (
            ("nacks_sent", "lost seqs NACKed toward the bridge"),
            ("nacks_suppressed_deadline",
             "NACKs suppressed: recovery could not beat playout"),
            ("recovered_late", "pending seqs recovered in time"),
        ), prefix=prefix)
        registry.register_scalar(
            f"{prefix}_fec_recovered", lambda: self.fec_recovered,
            help_="packets rebuilt from FEC", kind="counter")
        registry.register_scalar(
            f"{prefix}_plc_frames", lambda: self.plc_frames,
            help_="frames concealed after the ladder ran out",
            kind="counter")
        registry.register_scalar(
            f"{prefix}_rtx_recovered", lambda: self.rtx_recovered,
            help_="pending seqs recovered by retransmission",
            kind="counter")
