"""Simulcast layer forwarding with seamless stream rewriting.

Parity target: the reference's simulcast forwarding built on the track/
encoding model (`MediaStreamTrackDesc`/`RTPEncodingDesc`/`FrameDesc`,
SURVEY §2.3) — an SFU receives a sender's 3 spatial layers as separate
SSRCs and forwards exactly ONE of them to each receiver, switching
layers as bandwidth allows.  The receiver must see a single coherent
RTP stream, so on every forwarded packet the SFU rewrites:

- SSRC   -> the receiver-facing SSRC (constant across switches),
- seq    -> delta-rewritten into a continuous output space (a DELTA per
  anchor, not an arrival counter, so upstream reordering/duplicates
  keep their relative positions and die in the receiver's dedup),
- ts     -> delta-rewritten per layer (each simulcast SSRC has its own
  random RFC 3550 timestamp base; forwarding wire ts verbatim would
  jump arbitrarily at every switch and can read as a backward move),
- VP8 picture id -> a continuous 15-bit space (decoders treat a jump
  as loss), preserving the packet's descriptor layout.

Switches land only on a keyframe of the target layer (a delta frame
from a new layer is undecodable), exactly the reference's behavior;
until one arrives the forwarder stays on the current layer and reports
that a keyframe request (PLI/FIR) should go upstream.

Counterpart: `libjitsi_tpu/sfu/simulcast.py` (copied; host NumPy).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.codecs import vp8
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header


class SimulcastForwarder:
    """Per-receiver single-layer projection of a simulcast track."""

    def __init__(self, layer_ssrcs, out_ssrc: int,
                 initial_layer: int = 0, ts_switch_step: int = 3000):
        self.tracker = vp8.SimulcastReceiver(layer_ssrcs)
        self.layer_ssrcs = [int(s) & 0xFFFFFFFF for s in layer_ssrcs]
        self.out_ssrc = out_ssrc & 0xFFFFFFFF
        if not (0 <= initial_layer < len(self.layer_ssrcs)):
            raise IndexError(f"layer {initial_layer} out of range")
        self.current_layer = initial_layer
        self.target_layer = initial_layer
        # nominal RTP ts advance presented at a layer switch (one frame
        # at 30 fps / 90 kHz by default; only the at-switch gap uses it,
        # in-layer spacing is preserved exactly by the delta rewrite)
        self.ts_switch_step = ts_switch_step
        self._seq_delta: Optional[int] = None      # wire seq -> out seq
        self._ts_delta: Optional[int] = None       # wire ts  -> out ts
        self._pic_id_delta: Optional[int] = None   # wire pid -> out pid
        self._last_out_seq = -1                    # newest out seq sent
        self._last_out_ts = -1                     # newest out ts sent
        self._last_out_pid = -1
        self.forwarded = 0
        self.switches = 0

    # ------------------------------------------------------------ control
    def request_layer(self, layer: int) -> bool:
        """Ask to switch; returns True if an upstream keyframe request
        (PLI/FIR on the target layer) is needed to complete it."""
        if not (0 <= int(layer) < len(self.layer_ssrcs)):
            # a bad index would wait forever for an impossible keyframe
            raise IndexError(
                f"layer {layer} out of range 0..{len(self.layer_ssrcs)-1}")
        self.target_layer = int(layer)
        return self.target_layer != self.current_layer

    @property
    def awaiting_keyframe(self) -> bool:
        return self.target_layer != self.current_layer

    # ------------------------------------------------------------ forward
    def forward(self, batch: PacketBatch) -> List[bytes]:
        """Project one decrypted sender batch to this receiver's stream.

        Returns rewritten wire-ready (pre-SRTP) packets of the single
        forwarded layer, in order.
        """
        hdr = rtp_header.parse(batch)
        desc = vp8.parse_descriptors(batch, hdr=hdr)
        self.tracker.ingest(batch, hdr=hdr, desc=desc)  # parse once
        out: List[bytes] = []
        for i in range(batch.batch_size):
            if not desc.valid[i]:
                continue
            layer = self.tracker.layer_of.get(int(hdr.ssrc[i]))
            if layer is None:
                continue
            # pending switch completes on the target layer's keyframe
            if (self.target_layer != self.current_layer
                    and layer == self.target_layer
                    and desc.is_keyframe[i]
                    and desc.start_of_partition[i] == 1):
                self.current_layer = self.target_layer
                self.switches += 1
                # re-anchor every continuity delta to the new layer
                self._seq_delta = None
                self._ts_delta = None
                self._pic_id_delta = None
            if layer != self.current_layer:
                continue
            out.append(self._rewrite(batch, hdr, desc, i))
            self.forwarded += 1
        return out

    @staticmethod
    def _newer16(a: int, b: int) -> bool:
        """True if seq a is newer than b in mod-2^16 arithmetic."""
        return b < 0 or ((a - b) & 0xFFFF) < 0x8000

    @staticmethod
    def _newer32(a: int, b: int) -> bool:
        return b < 0 or ((a - b) & 0xFFFFFFFF) < 0x80000000

    def _rewrite(self, batch: PacketBatch, hdr, desc, i: int) -> bytes:
        raw = bytearray(batch.to_bytes(i))
        wire_seq = int(hdr.seq[i])
        wire_ts = int(hdr.ts[i])
        # delta rewrites: relative order of reordered/duplicated input
        # packets is preserved (an arrival counter would renumber dups
        # as fresh packets and scramble fragments at the receiver)
        if self._seq_delta is None:
            self._seq_delta = ((self._last_out_seq + 1) - wire_seq) & 0xFFFF
        if self._ts_delta is None:
            self._ts_delta = ((self._last_out_ts + self.ts_switch_step)
                              - wire_ts) & 0xFFFFFFFF if \
                self._last_out_ts >= 0 else 0
        seq = (wire_seq + self._seq_delta) & 0xFFFF
        ts = (wire_ts + self._ts_delta) & 0xFFFFFFFF
        if self._newer16(seq, self._last_out_seq):
            self._last_out_seq = seq
        if self._newer32(ts, self._last_out_ts):
            self._last_out_ts = ts
        raw[2:4] = seq.to_bytes(2, "big")
        raw[4:8] = ts.to_bytes(4, "big")
        raw[8:12] = self.out_ssrc.to_bytes(4, "big")
        wire_pid = int(desc.picture_id[i])
        if wire_pid >= 0:
            if self._pic_id_delta is None:
                nxt = (self._last_out_pid + 1) & 0x7FFF
                self._pic_id_delta = (nxt - wire_pid) & 0x7FFF
            out_pid = (wire_pid + self._pic_id_delta) & 0x7FFF
            if self._last_out_pid < 0 or \
                    ((out_pid - self._last_out_pid) & 0x7FFF) < 0x4000:
                self._last_out_pid = out_pid
            self._patch_picture_id(raw, int(hdr.payload_off[i]), out_pid)
        return bytes(raw)

    @staticmethod
    def _patch_picture_id(raw: bytearray, payload_off: int,
                          out_pid: int) -> None:
        """Rewrite the descriptor's PictureID in place (RFC 7741 §4.2).

        The field width is preserved (patching a 7-bit field with a
        15-bit value would shift the payload): a 15-bit (M=1) field
        takes out_pid mod 2^15, a 7-bit field takes out_pid mod 2^7 —
        both stay continuous because the rewrite delta is constant, so
        wire wraps map to output wraps at the same modulus.
        """
        b0 = raw[payload_off]
        if not (b0 & 0x80):          # no extension byte -> no picture id
            return
        xb = raw[payload_off + 1]
        if not (xb & 0x80):          # no I bit
            return
        pic_off = payload_off + 2
        if raw[pic_off] & 0x80:      # 15-bit
            raw[pic_off] = 0x80 | ((out_pid >> 8) & 0x7F)
            raw[pic_off + 1] = out_pid & 0xFF
        else:                        # 7-bit
            raw[pic_off] = out_pid & 0x7F
