"""VP8 RTP payload descriptor handling (RFC 7741) — vectorized.

Rebuilds `org.jitsi.impl.neomedia.codec.video.vp8.DePacketizer`'s header
logic (the part BASELINE config #4 needs — simulcast layer bookkeeping):
payload-descriptor parse (X/N/S/PID, PictureID, TL0PICIDX, TID/KEYIDX),
keyframe detection from the VP8 payload header P bit, and frame-start
accounting, all as batched array ops over a PacketBatch.  Actual VP8
bitstream decode stays on libvpx (host, verification only).

Counterpart: `libjitsi_tpu/codecs/vp8.py` (copied; host NumPy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header


@dataclasses.dataclass
class Vp8Descriptors:
    """Parsed per-row VP8 payload descriptor fields (-1 where absent)."""

    desc_len: np.ndarray      # descriptor size in bytes
    start_of_partition: np.ndarray  # S bit
    partition_id: np.ndarray  # PID
    picture_id: np.ndarray    # 7/15-bit, -1 if no I
    tl0picidx: np.ndarray     # -1 if no L
    tid: np.ndarray           # temporal layer, -1 if no T
    keyidx: np.ndarray        # -1 if no K
    is_keyframe: np.ndarray   # bool: S, PID 0 and payload P bit == 0
    valid: np.ndarray


def parse_descriptors(batch: PacketBatch, hdr=None) -> Vp8Descriptors:
    """Vectorized RFC 7741 §4.2 parse over the batch's RTP payloads.

    Pass pre-parsed RTP headers via `hdr` to avoid re-parsing on paths
    that already have them (the SFU forwarder parses once per batch).
    """
    if hdr is None:
        hdr = rtp_header.parse(batch)
    d = batch.data
    n, cap = d.shape
    ln = np.asarray(batch.length, dtype=np.int64)
    off = hdr.payload_off.astype(np.int64)

    def byte_at(pos):
        return rtp_header.byte_at(d, pos)

    b0 = byte_at(off)
    x = (b0 >> 7) & 1
    s = (b0 >> 4) & 1
    pid = b0 & 0x07
    cur = off + 1

    xb = np.where(x == 1, byte_at(cur), 0)
    cur = cur + x  # X byte present
    i_bit = (xb >> 7) & 1
    l_bit = (xb >> 6) & 1
    t_bit = (xb >> 5) & 1
    k_bit = (xb >> 4) & 1

    pic_b0 = byte_at(cur)
    m = (pic_b0 >> 7) & 1  # 15-bit picture id
    pic7 = pic_b0 & 0x7F
    pic15 = ((pic_b0 & 0x7F) << 8) | byte_at(cur + 1)
    picture_id = np.where(i_bit == 1, np.where(m == 1, pic15, pic7), -1)
    cur = cur + np.where(i_bit == 1, 1 + m, 0)

    tl0 = np.where(l_bit == 1, byte_at(cur), -1)
    cur = cur + l_bit

    tk = byte_at(cur)
    has_tk = ((t_bit == 1) | (k_bit == 1)).astype(np.int64)
    tid = np.where((t_bit == 1) & (has_tk == 1), (tk >> 6) & 0x03, -1)
    keyidx = np.where((k_bit == 1) & (has_tk == 1), tk & 0x1F, -1)
    cur = cur + has_tk

    desc_len = cur - off
    # VP8 payload header P bit (inverse keyframe flag), RFC 7741 §4.3
    p_bit = byte_at(cur) & 0x01
    is_key = (s == 1) & (pid == 0) & (p_bit == 0)
    valid = (ln > off) & (off + desc_len < ln) & (hdr.valid)

    return Vp8Descriptors(
        desc_len=desc_len.astype(np.int32),
        start_of_partition=s.astype(np.int32),
        partition_id=pid.astype(np.int32),
        picture_id=picture_id.astype(np.int64),
        tl0picidx=tl0.astype(np.int64),
        tid=tid.astype(np.int32),
        keyidx=keyidx.astype(np.int32),
        is_keyframe=(is_key & valid),
        valid=valid,
    )


def build_descriptor(start: bool, picture_id: int = -1, tl0picidx: int = -1,
                     tid: int = -1, keyidx: int = -1) -> bytes:
    """Packetizer counterpart (reference: vp8.Packetizer) — one-byte
    required part + optional extensions."""
    need_x = picture_id >= 0 or tl0picidx >= 0 or tid >= 0 or keyidx >= 0
    b0 = (0x10 if start else 0) | (0x80 if need_x else 0)
    out = bytearray([b0])
    if need_x:
        xb = ((0x80 if picture_id >= 0 else 0)
              | (0x40 if tl0picidx >= 0 else 0)
              | (0x20 if tid >= 0 else 0)
              | (0x10 if keyidx >= 0 else 0))
        out.append(xb)
        if picture_id >= 0:
            if picture_id > 0x7F:
                out += bytes([0x80 | (picture_id >> 8), picture_id & 0xFF])
            else:
                out.append(picture_id)
        if tl0picidx >= 0:
            out.append(tl0picidx & 0xFF)
        if tid >= 0 or keyidx >= 0:
            out.append(((tid & 0x03) << 6 if tid >= 0 else 0)
                       | (keyidx & 0x1F if keyidx >= 0 else 0))
    return bytes(out)


class SimulcastReceiver:
    """Per-(ssrc-layer) frame bookkeeping for 3-layer VP8 simulcast
    (reference: MediaStreamTrackDesc/RTPEncodingDesc/FrameDesc).

    Tracks, per spatial layer: latest picture id, TL0PICIDX continuity,
    keyframe seen, and frame starts — what the SFU's layer-selection
    logic needs before forwarding."""

    def __init__(self, layer_ssrcs):
        self.layer_of = {int(s) & 0xFFFFFFFF: i
                         for i, s in enumerate(layer_ssrcs)}
        n = len(layer_ssrcs)
        self.last_picture_id = np.full(n, -1, dtype=np.int64)
        self.last_tl0 = np.full(n, -1, dtype=np.int64)
        self.keyframe_seen = np.zeros(n, dtype=bool)
        self.frames = np.zeros(n, dtype=np.int64)

    def ingest(self, batch: PacketBatch, hdr=None,
               desc: "Vp8Descriptors" = None) -> Vp8Descriptors:
        if hdr is None:
            hdr = rtp_header.parse(batch)
        if desc is None:
            desc = parse_descriptors(batch, hdr=hdr)
        for i in range(batch.batch_size):
            if not desc.valid[i]:
                continue
            layer = self.layer_of.get(int(hdr.ssrc[i]))
            if layer is None:
                continue
            if desc.start_of_partition[i] == 1 and desc.partition_id[i] == 0:
                self.frames[layer] += 1
                if desc.picture_id[i] >= 0:
                    self.last_picture_id[layer] = desc.picture_id[i]
                if desc.tl0picidx[i] >= 0:
                    self.last_tl0[layer] = desc.tl0picidx[i]
                if desc.is_keyframe[i]:
                    self.keyframe_seen[layer] = True
        return desc

    def select_layer(self, target_bps: float, layer_rates) -> int:
        """Highest layer whose rate fits the target and has a keyframe."""
        best = 0
        for i, r in enumerate(layer_rates):
            if r <= target_bps and self.keyframe_seen[i]:
                best = i
        return best


def packetize(frame: bytes, picture_id: int = -1,
              max_payload: int = 1200, tl0picidx: int = -1,
              tid: int = -1) -> list:
    """Split one VP8 frame into RTP payloads (descriptor + fragment).

    Reference: `...codec.video.vp8.Packetizer` — S bit set on the first
    fragment only; every fragment of a frame carries the same extension
    fields; the RTP marker (set by the sender on the last fragment) ends
    the frame.
    """
    if not frame:
        raise ValueError("empty frame")
    # descriptor length is the same for every fragment (the S bit does
    # not change the size), so budget it out of max_payload up front —
    # emitted payloads must not exceed the caller's MTU allowance
    desc_len = len(build_descriptor(start=True, picture_id=picture_id,
                                    tl0picidx=tl0picidx, tid=tid))
    chunk = max_payload - desc_len
    if chunk <= 0:
        raise ValueError(f"max_payload {max_payload} cannot fit the "
                         f"{desc_len}-byte descriptor")
    out = []
    for pos in range(0, len(frame), chunk):
        desc = build_descriptor(start=(pos == 0), picture_id=picture_id,
                                tl0picidx=tl0picidx, tid=tid)
        out.append(desc + frame[pos:pos + chunk])
    return out


class FrameAssembler:
    """Reassemble complete VP8 frames from depacketized RTP.

    Reference: the DePacketizer's frame-reassembly half — fragments
    share an RTP timestamp; the S-bit fragment starts the frame, the
    marker-bit fragment ends it, and the frame is complete when every
    sequence number in between has arrived (out-of-order tolerant).
    `push_batch` ingests a decrypted PacketBatch; `pop_frames` yields
    (rtp_ts, picture_id, is_keyframe, frame_bytes) in timestamp order.
    """

    # A 16 KiB-fragment frame at 512 fragments is ~8 MB — far beyond any
    # real VP8 frame.  Larger start→end seq spans can only come from
    # corrupt/hostile S-bit/marker packets; without the bound a forged
    # span of up to 65536 makes every _is_complete call walk the span
    # (quadratic across calls) before eviction engages.
    MAX_FRAGMENTS = 512

    def __init__(self, max_pending: int = 32):
        self.max_pending = max_pending
        # keys are UNWRAPPED timestamps (the 32-bit RTP ts starts at a
        # random value and wraps within hours — minutes under loss —
        # so min()/sorted() over raw values would misorder across the
        # wrap and evict the wrong frames)
        self._pending: dict = {}      # uts -> {seq: payload}
        self._meta: dict = {}         # uts -> [start_seq, end_seq, pid, key]
        self._ts_high: int = 0        # unwrap epoch (multiples of 2^32)
        self._ts_last: int = -1       # last wire ts seen
        self._delivered_ts: int = -1  # newest uts handed to the caller
        self.dropped_incomplete = 0   # evicted waiting on lost packets
        self.dropped_backlog = 0      # complete but never popped (4x cap)
        self.dropped_late = 0         # completed after a newer delivery
        self.dropped_corrupt = 0      # start→end span > MAX_FRAGMENTS

    def _unwrap_ts(self, ts: int) -> int:
        if self._ts_last >= 0:
            delta = (ts - self._ts_last) & 0xFFFFFFFF
            if delta < 0x80000000:            # forward move
                if ts < self._ts_last:        # wrapped past zero
                    self._ts_high += 1 << 32
            elif ts > self._ts_last:          # backward move across wrap
                return self._ts_high - (1 << 32) + ts
        self._ts_last = ts
        return self._ts_high + ts

    def push_batch(self, batch: PacketBatch) -> None:
        hdr = rtp_header.parse(batch)
        desc = parse_descriptors(batch)
        for i in range(batch.batch_size):
            if not desc.valid[i]:
                continue
            ts = self._unwrap_ts(int(hdr.ts[i]))
            seq = int(hdr.seq[i])
            frag = batch.to_bytes(i)[int(hdr.payload_off[i]
                                         + desc.desc_len[i]):]
            slot = self._pending.setdefault(ts, {})
            meta = self._meta.setdefault(ts, [None, None, -1, False])
            slot[seq] = frag
            if len(slot) > self.MAX_FRAGMENTS:
                # fragment flood on one ts (unique seqs, no S/marker pair
                # to trip the span check): a real frame never has this
                # many fragments, so drop the whole entry
                del self._pending[ts]
                del self._meta[ts]
                self.dropped_corrupt += 1
                continue
            if desc.start_of_partition[i] == 1 and desc.partition_id[i] == 0:
                meta[0] = seq
                meta[2] = int(desc.picture_id[i])
                meta[3] = bool(desc.is_keyframe[i])
            if hdr.marker[i]:
                meta[1] = seq
            if (meta[0] is not None and meta[1] is not None
                    and ((meta[1] - meta[0]) & 0xFFFF) + 1
                    > self.MAX_FRAGMENTS):
                del self._pending[ts]
                del self._meta[ts]
                self.dropped_corrupt += 1
                continue
        # bound memory two-tier: INCOMPLETE frames older than the newest
        # entry (stalled gaps) evict oldest-first at max_pending — the
        # newest frame is still arriving and is never a victim below the
        # cap; COMPLETE frames, which a burst can accumulate faster than
        # the caller pops, only give way at a 4x hard cap (counted
        # separately: that is caller backlog, not packet loss).
        if len(self._pending) > self.max_pending:
            ordered = sorted(self._pending)
            for t in ordered[:-1]:
                if len(self._pending) <= self.max_pending:
                    break
                if not self._is_complete(t):
                    del self._pending[t]
                    del self._meta[t]
                    self.dropped_incomplete += 1
            while len(self._pending) > 4 * self.max_pending:
                t = min(self._pending)
                del self._pending[t]
                del self._meta[t]
                self.dropped_backlog += 1

    def _is_complete(self, ts: int) -> bool:
        start, end, _pid, _key = self._meta[ts]
        if start is None or end is None:
            return False
        n = ((end - start) & 0xFFFF) + 1
        if n > self.MAX_FRAGMENTS:    # corrupt span; never completes
            return False
        slot = self._pending[ts]
        return all(((start + k) & 0xFFFF) in slot for k in range(n))

    def pop_frames(self) -> list:
        done = []
        for ts in sorted(self._pending):
            if not self._is_complete(ts):
                continue
            start, end, pid, key = self._meta[ts]
            slot = self._pending[ts]
            del self._pending[ts]
            del self._meta[ts]
            if ts <= self._delivered_ts:
                # completed only after a newer frame was already handed
                # out — delivering it now would feed the decoder frames
                # backwards; drop it (the decoder PLCs the gap)
                self.dropped_late += 1
                continue
            n = ((end - start) & 0xFFFF) + 1
            done.append((ts, pid, key,
                         b"".join(slot[(start + k) & 0xFFFF]
                                  for k in range(n))))
            self._delivered_ts = ts
        return done
