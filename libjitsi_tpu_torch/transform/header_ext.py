"""Header-extension stamping engines (batched, host-side byte rewrites).

Counterpart: `libjitsi_tpu/transform/header_ext.py` (copied, all five
engines).

Rebuilds the reference's hot-path header engines:

- `AbsSendTimeEngine` (org.jitsi.impl.neomedia.transform.AbsSendTimeEngine):
  stamps the 24-bit abs-send-time extension (6.18 fixed-point seconds,
  http://webrtc.org abs-send-time) at send time — feeds REMB-style BWE.
- `TransportCCEngine` (org.jitsi.impl.neomedia.transform.TransportCCEngine):
  stamps a transport-wide sequence number (2 bytes) shared across all
  SSRCs of the transport and remembers send times for TCC feedback
  matching (send-side BWE).
- `CsrcAudioLevelEngine` (reference `.csrc.CsrcTransformEngine` +
  `CsrcAudioLevelDispatcher`): stamps RFC 6464 ssrc-audio-level on send
  (levels come straight from the mixer kernel's by-product) and extracts
  per-row levels on receive.
- `PayloadTypeTransformEngine` (reference `.pt.PayloadTypeTransformEngine`)
  and `SsrcRewriteEngine` (reference `.SsrcTransformEngine`): per-stream
  payload-type and SSRC rewrites.

Timestamps are taken on the host at stamp time — the one thing that must
NOT happen ahead of time on the device (SURVEY §2.2).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.core.rtp_math import seq_delta
from libjitsi_tpu_torch.rtp import ext as rtp_ext
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.engine import PacketTransformer, TransformEngine


class _RtpOnlyEngine(TransformEngine):
    @property
    def rtp_transformer(self):
        return self._rtp


class AbsSendTimeEngine(_RtpOnlyEngine):
    """Stamp abs-send-time (24-bit 6.18 fixed-point) on outgoing RTP."""

    def __init__(self, ext_id: int, clock: Callable[[], float] = time.time):
        self.ext_id = ext_id
        self.clock = clock
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                now = eng.clock()
                # 6.18 fixed point of seconds within a 64 s window
                v = int(round(now * (1 << 18))) & 0xFFFFFF
                pay = np.tile(np.array(
                    [(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
                    dtype=np.uint8), (batch.batch_size, 1))
                out = rtp_ext.set_one_byte_ext(batch, hdr, eng.ext_id, pay,
                                               enable=mask)
                return out, (np.ones(batch.batch_size, bool)
                             if mask is None else mask)

        self._rtp = _T()


class TransportCCEngine(_RtpOnlyEngine):
    """Stamp transport-wide seq numbers; record send times for feedback.

    One counter per transport (not per SSRC), as RFC draft-holmer-rmcat
    -transport-wide-cc-extensions specifies and the reference implements.
    `sent_times` is a bounded ring of (twseq -> send time) used when a
    TCC feedback packet arrives (bwe/send side).
    """

    HISTORY = 1 << 12

    def __init__(self, ext_id: int, clock: Callable[[], float] = time.time):
        self.ext_id = ext_id
        self.clock = clock
        # 64-bit EXTENDED counter (the `_ext` suffix is the rtp-mod16
        # naming contract for unwrapped counters): only the 16-bit fold
        # `& 0xFFFF` at stamp time touches the wire
        self.next_seq_ext = 0
        self.sent_seq = np.full(self.HISTORY, -1, dtype=np.int64)
        self.sent_time = np.zeros(self.HISTORY, dtype=np.float64)
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                n = batch.batch_size
                live = (np.ones(n, bool) if mask is None
                        else np.asarray(mask, bool))
                k = int(live.sum())
                # masked rows (padding, dropped upstream) must not consume
                # transport-wide seqs: a gap reads as loss at the receiver
                seqs = np.zeros(n, dtype=np.int64)
                seqs[live] = eng.next_seq_ext + np.arange(k, dtype=np.int64)
                eng.next_seq_ext += k
                now = eng.clock()
                slot = seqs[live] % eng.HISTORY
                eng.sent_seq[slot] = seqs[live]
                eng.sent_time[slot] = now
                w = seqs & 0xFFFF
                pay = np.stack([(w >> 8) & 0xFF, w & 0xFF],
                               axis=1).astype(np.uint8)
                hdr = rtp_header.parse(batch)
                out = rtp_ext.set_one_byte_ext(batch, hdr, eng.ext_id, pay,
                                               enable=mask)
                return out, (np.ones(n, bool) if mask is None else mask)

        self._rtp = _T()

    def lookup_send_time(self, twseq: int) -> Optional[float]:
        """twseq is the 16-bit wire value (TCC feedback); unwrap it
        against the full counter before the slot lookup."""
        base = self.next_seq_ext - 1
        if base < 0:
            return None
        ext = base + int(seq_delta(twseq, base & 0xFFFF))
        if ext < 0:
            return None
        slot = ext % self.HISTORY
        if self.sent_seq[slot] == ext:
            return float(self.sent_time[slot])
        return None


class CsrcAudioLevelEngine(_RtpOnlyEngine):
    """RFC 6464 ssrc-audio-level: stamp on send, extract on receive.

    `level_of` maps stream-id rows to current levels (0..127, 127 =
    silence) — typically the mixer kernel's levels array.  Received
    levels land in `last_levels[stream]` and go to the optional
    dispatcher callback (reference: CsrcAudioLevelDispatcher posting to
    AudioLevelListener).
    """

    def __init__(self, ext_id: int, capacity: int = 1024,
                 level_of: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 on_levels: Optional[Callable[[np.ndarray, np.ndarray], None]]
                 = None):
        self.ext_id = ext_id
        self.level_of = level_of
        self.on_levels = on_levels
        self.last_levels = np.full(capacity, 127, dtype=np.uint8)
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                n = batch.batch_size
                stream = np.asarray(batch.stream, dtype=np.int64)
                if eng.level_of is None:
                    return batch, (np.ones(n, bool) if mask is None else mask)
                lv = np.asarray(eng.level_of(stream), dtype=np.uint8) & 0x7F
                hdr = rtp_header.parse(batch)
                out = rtp_ext.set_one_byte_ext(
                    batch, hdr, eng.ext_id, lv[:, None], enable=mask)
                return out, (np.ones(n, bool) if mask is None else mask)

            def reverse_transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                off, _ln, found = rtp_ext.find_one_byte_ext(
                    batch, hdr, eng.ext_id)
                safe = np.clip(off, 0, batch.capacity - 1).astype(np.int32)
                lv = np.take_along_axis(
                    batch.data, safe[:, None], axis=1)[:, 0] & 0x7F
                stream = np.asarray(batch.stream, dtype=np.int64)
                sel = found & (stream >= 0) & (stream < len(eng.last_levels))
                eng.last_levels[stream[sel]] = lv[sel]
                if eng.on_levels is not None and np.any(sel):
                    eng.on_levels(stream[sel], lv[sel])
                return batch, (np.ones(batch.batch_size, bool)
                               if mask is None else mask)

        self._rtp = _T()


class PayloadTypeTransformEngine(_RtpOnlyEngine):
    """PT remapping via a 128-entry LUT per stream (reference:
    `.pt.PayloadTypeTransformEngine`'s per-stream mappings, applied as one
    vectorized gather)."""

    def __init__(self, capacity: int = 1024):
        # identity maps until a mapping is installed
        self.lut = np.tile(np.arange(128, dtype=np.uint8), (capacity, 1))
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                stream = np.clip(np.asarray(batch.stream, np.int64), 0,
                                 eng.lut.shape[0] - 1)
                new_pt = eng.lut[stream, hdr.pt]
                data = batch.data.copy()
                rtp_header.set_pt(data, np.where(
                    np.ones_like(new_pt, bool) if mask is None else mask,
                    new_pt, hdr.pt))
                return (PacketBatch(data, batch.length, batch.stream),
                        np.ones(batch.batch_size, bool)
                        if mask is None else mask)

        self._rtp = _T()

    def add_mapping(self, sid: int, from_pt: int, to_pt: int) -> None:
        self.lut[sid, from_pt] = to_pt


class SsrcRewriteEngine(_RtpOnlyEngine):
    """Per-stream SSRC rewrite (reference: `.SsrcTransformEngine` — used
    in translator scenarios).  target_ssrc[sid] = -1 passes through."""

    def __init__(self, capacity: int = 1024):
        self.target_ssrc = np.full(capacity, -1, dtype=np.int64)
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                stream = np.clip(np.asarray(batch.stream, np.int64), 0,
                                 len(eng.target_ssrc) - 1)
                tgt = eng.target_ssrc[stream]
                hdr = rtp_header.parse(batch)
                use = tgt >= 0
                if mask is not None:
                    use &= mask
                data = batch.data.copy()
                rtp_header.set_ssrc(data, np.where(use, tgt, hdr.ssrc))
                return (PacketBatch(data, batch.length, batch.stream),
                        np.ones(batch.batch_size, bool)
                        if mask is None else mask)

        self._rtp = _T()

    def set_mapping(self, sid: int, ssrc: int) -> None:
        self.target_ssrc[sid] = ssrc
