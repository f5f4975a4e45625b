"""Header-extension engines (batched host rewrites).

Counterpart: `libjitsi_tpu/transform/header_ext.py`, two of its engines:

- `AbsSendTimeEngine` (reference `AbsSendTimeEngine`): stamps the 24-bit
  abs-send-time extension (6.18 fixed-point seconds) at send time, the
  SFU's egress stamp that lets every receiver run its own receive-side
  bandwidth estimate;
- `CsrcAudioLevelEngine` (reference `.csrc.CsrcTransformEngine` +
  `CsrcAudioLevelDispatcher`): stamps RFC 6464 ssrc-audio-level on send
  (levels come straight from the mixer kernel's by-product) and extracts
  per-row levels on receive.

The JAX module's transport-cc, payload-type and SSRC rewrite engines are
not ported (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from libjitsi_tpu_torch.rtp import ext as rtp_ext
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.engine import PacketTransformer, TransformEngine


class AbsSendTimeEngine(TransformEngine):
    """Stamp abs-send-time (24-bit 6.18 fixed-point) on outgoing RTP; the
    clock is read once per batch, on the host."""

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

    @property
    def rtp_transformer(self):
        return self._rtp


class CsrcAudioLevelEngine(TransformEngine):
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

    @property
    def rtp_transformer(self):
        return self._rtp
