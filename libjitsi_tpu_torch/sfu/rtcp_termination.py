"""RTCP termination for translator scenarios (reference:
`org.jitsi.impl.neomedia.rtcp.*` termination strategies used by
RTPTranslator/Jitsi Videobridge — SURVEY §2.3 "RTCP termination").

An SFU must not blindly fan RTCP both ways: N receivers' reports about
one forwarded sender are *terminated* at the bridge and re-originated:

- receiver reports aggregate into one RR (worst fraction lost, summed
  cumulative loss, max jitter);
- REMB aggregates as the minimum over receivers (the bottleneck
  receiver governs what the sender may send);
- PLI/FIR dedupe with a per-ssrc rate limit (a keyframe request storm
  from 10k receivers must reach the sender once);
- NACKs merge their lost-seq sets within the aggregation window.

Counterpart: `libjitsi_tpu/sfu/rtcp_termination.py` (copied; host only).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from libjitsi_tpu_torch.rtp import rtcp


class RtcpTermination:
    def __init__(self, bridge_ssrc: int, pli_interval_s: float = 0.5):
        self.bridge_ssrc = bridge_ssrc & 0xFFFFFFFF
        self.pli_interval = pli_interval_s
        # per media-ssrc aggregation state
        self._reports: Dict[int, List[rtcp.ReportBlock]] = {}
        self._remb: Dict[int, Dict[int, float]] = {}  # ssrc -> {recv: bps}
        self._nacks: Dict[int, Set[int]] = {}
        self._pli_pending: Set[int] = set()
        self._last_pli: Dict[int, float] = {}

    # ------------------------------------------------------------- intake
    def on_receiver_rtcp(self, receiver_id: int, packets: list) -> None:
        """Feed parsed RTCP arriving FROM a receiver leg (about media we
        forward to it).  Nothing is forwarded directly."""
        for p in packets:
            if isinstance(p, rtcp.ReceiverReport) or \
                    isinstance(p, rtcp.SenderReport):
                for rb in p.reports:
                    self._reports.setdefault(rb.ssrc, []).append(rb)
            elif isinstance(p, rtcp.Remb):
                for ssrc in p.ssrcs:
                    self._remb.setdefault(ssrc, {})[receiver_id] = \
                        p.bitrate_bps
            elif isinstance(p, rtcp.Nack):
                self._nacks.setdefault(p.media_ssrc, set()).update(
                    p.lost_seqs)
            elif isinstance(p, (rtcp.Pli, rtcp.Fir)):
                self._pli_pending.add(p.media_ssrc)

    def queue_nack(self, media_ssrc: int, seqs) -> None:
        """Queue bridge-originated lost seqs (the RecoveryController's
        uplink gap detection) for the next feedback round toward the
        sender.  Merges with receiver-relayed NACKs — the aggregation
        window dedups either source."""
        if seqs:
            self._nacks.setdefault(media_ssrc & 0xFFFFFFFF, set()).update(
                int(s) & 0xFFFF for s in seqs)

    # ------------------------------------------------------------- output
    def make_sender_feedback(self, media_ssrc: int,
                             now: Optional[float] = None,
                             own_bps: Optional[float] = None
                             ) -> List[bytes]:
        """Drain aggregated feedback to send toward the media sender.

        own_bps: the bridge's OWN receive-side estimate for this sender
        (abs-send-time GCC over the sender->bridge leg).  The advertised
        REMB is the min of it and every receiver's REMB — whichever hop
        is the bottleneck governs, as the reference's
        RemoteBitrateEstimatorAbsSendTime + REMB merge does.
        """
        now = time.time() if now is None else now
        out: List[bytes] = []

        blocks = self._reports.pop(media_ssrc, [])
        if blocks:
            agg = rtcp.ReportBlock(
                ssrc=media_ssrc,
                fraction_lost=max(b.fraction_lost for b in blocks),
                cumulative_lost=max(b.cumulative_lost for b in blocks),
                highest_seq=max(b.highest_seq for b in blocks),
                jitter=max(b.jitter for b in blocks),
                lsr=blocks[-1].lsr, dlsr=blocks[-1].dlsr)
            out.append(rtcp.build_rr(
                rtcp.ReceiverReport(self.bridge_ssrc, [agg])))

        rembs = self._remb.get(media_ssrc)
        caps = list(rembs.values()) if rembs else []
        if own_bps is not None:
            caps.append(float(own_bps))
        if caps:
            out.append(rtcp.build_remb(rtcp.Remb(
                self.bridge_ssrc, int(min(caps)), [media_ssrc])))

        lost = self._nacks.pop(media_ssrc, None)
        if lost:
            out.append(rtcp.build_nack(rtcp.Nack(
                self.bridge_ssrc, media_ssrc, sorted(lost))))

        if media_ssrc in self._pli_pending:
            last = self._last_pli.get(media_ssrc, -1e18)
            if now - last >= self.pli_interval:
                out.append(rtcp.build_pli(
                    rtcp.Pli(self.bridge_ssrc, media_ssrc)))
                self._last_pli[media_ssrc] = now
                self._pli_pending.discard(media_ssrc)
        return out

    def request_keyframe(self, media_ssrc: int) -> None:
        """Queue a rate-limited PLI toward a sender (e.g. a simulcast
        layer switch waiting on the target layer's keyframe)."""
        self._pli_pending.add(media_ssrc & 0xFFFFFFFF)

    def min_remb(self, media_ssrc: int) -> Optional[float]:
        rembs = self._remb.get(media_ssrc)
        return min(rembs.values()) if rembs else None

    def forget_receiver(self, receiver_id: int) -> None:
        """A leaving receiver must stop capping the sender's bitrate."""
        for per in self._remb.values():
            per.pop(receiver_id, None)
