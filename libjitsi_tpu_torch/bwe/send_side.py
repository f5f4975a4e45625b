"""Send-side bandwidth estimation (reference:
`org.jitsi.impl.neomedia.rtp.sendsidebandwidthestimation.
{SendSideBandwidthEstimation,BandwidthEstimatorImpl}` — WebRTC's
loss-based controller):

- RTCP RR fraction-lost drives loss-based up/down moves;
- a delay-based estimate (from TCC feedback run through the same GCC
  filters as the receive side) caps the result;
- REMB from the remote receiver caps it too.

Counterpart: `libjitsi_tpu/bwe/send_side.py` (copied).
"""

from __future__ import annotations

from typing import Optional

from libjitsi_tpu_torch.bwe.remote_estimator import RemoteBitrateEstimator
from libjitsi_tpu_torch.rtp.rtcp import TccFeedback


class SendSideBandwidthEstimation:
    LOW_LOSS = 0.02
    HIGH_LOSS = 0.10

    def __init__(self, min_bitrate_bps: float = 30_000,
                 start_bitrate_bps: float = 300_000,
                 max_bitrate_bps: float = 30e6):
        self.min_bitrate = min_bitrate_bps
        self.max_bitrate = max_bitrate_bps
        self.bitrate = start_bitrate_bps
        self.remb_cap: Optional[float] = None
        self._last_decrease_ms = -1e18
        self._last_loss_ms = -1e18
        # smoothed reported loss: the BWE loss signal consumed by the
        # adaptive FEC sender (sfu/recovery.py) — same RR stream that
        # drives the loss-based rate moves below
        self.loss_estimate = 0.0
        self.last_fraction_lost = 0
        # delay-based estimator over TCC feedback (send times are ours,
        # arrival deltas are the remote's)
        self._delay = RemoteBitrateEstimator(min_bitrate_bps,
                                             start_bitrate_bps)
        self.delay_cap: Optional[float] = None

    # ------------------------------------------------------------- inputs
    def on_receiver_report(self, fraction_lost_255: int, now_ms: float
                           ) -> float:
        """Loss-based update from an RTCP RR (reference:
        SendSideBandwidthEstimation.updateReceiverBlock)."""
        loss = fraction_lost_255 / 255.0
        self.last_fraction_lost = int(fraction_lost_255) & 0xFF
        self.loss_estimate += 0.3 * (loss - self.loss_estimate)
        if loss < self.LOW_LOSS:
            # 8% per second, compounded by elapsed time
            dt = min(max(now_ms - self._last_loss_ms, 0.0), 1000.0) \
                if self._last_loss_ms > -1e17 else 1000.0
            self.bitrate *= 1.08 ** (dt / 1000.0)
            self.bitrate += 1000.0
        elif loss > self.HIGH_LOSS:
            if now_ms - self._last_decrease_ms > 300:
                self.bitrate *= (1 - 0.5 * loss)
                self._last_decrease_ms = now_ms
        self._last_loss_ms = now_ms
        return self._clamp()

    def on_remb(self, bitrate_bps: float) -> float:
        self.remb_cap = bitrate_bps
        return self._clamp()

    def on_tcc_feedback(self, fb: TccFeedback, send_times_ms, now_ms: float
                        ) -> float:
        """Delay-based update from transport-wide-cc feedback.

        send_times_ms: our recorded send time (ms) per seq in the
        feedback range (NaN/None where unknown) — from
        TransportCCEngine.lookup_send_time.
        """
        base_ms = fb.reference_time * 64.0
        for i, rec in enumerate(fb.received):
            if not rec:
                continue
            st = send_times_ms[i]
            if st is None:
                continue
            arrival = base_ms + fb.arrival_250us[i] * 0.25
            # reuse the GCC filter chain with real send times: feed the
            # 6.18 fixed-point encoding it expects
            ast24 = int((st / 1000.0) * (1 << 18)) & 0xFFFFFF
            self._delay.incoming_packet(arrival, ast24, 1200)
        self.delay_cap = self._delay.update_estimate(now_ms)
        return self._clamp()

    # ------------------------------------------------------------- output
    def _clamp(self) -> float:
        b = self.bitrate
        if self.remb_cap is not None:
            b = min(b, self.remb_cap)
        if self.delay_cap is not None:
            b = min(b, self.delay_cap)
        b = min(max(b, self.min_bitrate), self.max_bitrate)
        # floor the INTERNAL state too: sustained loss must not drive it
        # toward zero, or recovery would compound up from ~nothing
        self.bitrate = min(max(self.bitrate, self.min_bitrate),
                           self.max_bitrate)
        return b

    @property
    def estimate_bps(self) -> float:
        return self._clamp()
