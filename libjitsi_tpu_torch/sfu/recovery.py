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

FEC rides a separate stream per protected SSRC (RFC 5109
separate-stream variant): SSRC = media_ssrc ^ "FEC", own PT and seq
space.  The bridge XORs the *SRTP-protected* wire packets, so a
recovered packet re-enters the receiver's normal unprotect path and is
still authenticated by SRTP — forged FEC cannot inject media, it can
only fail auth.

Counterpart: `libjitsi_tpu/sfu/recovery.py` (copied; host only):
`RecoveryConfig`, `TokenBucket`, `NackScheduler`, `AdaptiveFecSender` and
`RecoveryController`.  Not copied: the endpoint-side
`RecoveringReceiver`, the metrics registration and the flight-recorder
events, which the port does not have yet (ROADMAP Queue 1, items 4 and
9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp.loss import LossTracker
from libjitsi_tpu_torch.transform.fec import build_fec
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
            elif not advanced:
                self.nacks.on_arrival(ssrc, int(seq))

    def collect_upstream_nacks(self, now: float) -> Dict[int, List[int]]:
        nacks, _expired = self.nacks.collect(now)
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

    def throttle_rtx(self, throttled: bool) -> None:
        """Escalation rung: shrink the retransmission budget before any
        stream is dropped."""
        self.rtx_throttled = throttled
        self.rtx_bucket.set_scale(
            self.cfg.rtx_throttle_scale if throttled else 1.0)
