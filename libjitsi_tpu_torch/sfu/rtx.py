"""RTX retransmission format (RFC 4588) — encapsulate/decapsulate.

Parity target: the reference's RTX handling around the retransmission
cache (`.caching.CachingTransformer` serving NACKs, SURVEY §2.2
"Retransmission cache" row; RTX stream rewriting done by consumers).
RFC 4588 sends a retransmitted packet on a separate RTX stream: its own
SSRC and payload type, its own continuous sequence space, and the
Original Sequence Number (OSN) spliced in as the first two payload
bytes.  Receivers map the RTX stream back to the protected stream and
restore the original header.

Batched design: encapsulation/decapsulation are vectorized header/byte
rewrites over a PacketBatch (one `np` pass for a whole NACK burst);
`RtxSender`/`RtxReceiver` hold the tiny per-stream state (seq counters
and the ssrc/pt association maps from SDP's ``apt=`` parameter).

Counterpart: `libjitsi_tpu/sfu/rtx.py` (copied; host NumPy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header


def encapsulate_batch(batch: PacketBatch, rtx_ssrc: int, rtx_pt: int,
                      first_rtx_seq: int) -> PacketBatch:
    """Rewrite a batch of cached original packets as RTX packets.

    Each row gets the RTX SSRC/PT, consecutive RTX sequence numbers
    starting at `first_rtx_seq`, and its original seq spliced in as the
    2-byte OSN ahead of the payload (header extensions/CSRCs, if any,
    stay with the header).
    """
    hdr = rtp_header.parse(batch)
    n = batch.batch_size
    lens = np.asarray(batch.length, dtype=np.int64)
    cap = batch.capacity
    if int(lens.max(initial=0)) + 2 > cap:
        cap = int(lens.max(initial=0)) + 2
    off = hdr.payload_off.astype(np.int64)
    # header part [0, off) verbatim, then OSN, then payload shifted by 2
    cols = np.arange(cap, dtype=np.int64)[None, :]
    src = batch.data[:, :cap] if batch.capacity >= cap else np.pad(
        batch.data, ((0, 0), (0, cap - batch.capacity)))
    in_header = cols < off[:, None]
    shifted = np.take_along_axis(
        src, np.broadcast_to(np.maximum(cols - 2, 0), src.shape), axis=1)
    in_payload = (cols >= (off[:, None] + 2)) & (cols < (lens[:, None] + 2))
    data = np.where(in_header, src, np.where(in_payload, shifted, 0))
    # OSN bytes at [off, off+1]
    rows = np.arange(n)
    data[rows, off] = (hdr.seq >> 8).astype(np.uint8)
    data[rows, off + 1] = (hdr.seq & 0xFF).astype(np.uint8)
    data = rtp_header.set_ssrc(data, np.full(n, rtx_ssrc, dtype=np.int64))
    data = rtp_header.set_pt(data, np.full(n, rtx_pt, dtype=np.int64))
    data = rtp_header.set_seq(
        data, (first_rtx_seq + np.arange(n)) & 0xFFFF)
    return PacketBatch(data, (lens + 2).astype(np.int32),
                       np.asarray(batch.stream).copy())


def decapsulate_batch(batch: PacketBatch, orig_ssrc: int, orig_pt: int
                      ) -> Tuple[PacketBatch, np.ndarray]:
    """Restore original packets from RTX rows.

    Returns (batch with original SSRC/PT/seq and the OSN removed,
    osn array [B]).  Rows too short to carry an OSN are zero-length
    in the output (callers drop them via the returned lengths).
    """
    hdr = rtp_header.parse(batch)
    n = batch.batch_size
    lens = np.asarray(batch.length, dtype=np.int64)
    off = hdr.payload_off.astype(np.int64)
    ok = lens >= off + 2
    rows = np.arange(n)
    osn_off = np.minimum(off, batch.capacity - 2)
    osn = (batch.data[rows, osn_off].astype(np.int64) << 8) \
        | batch.data[rows, osn_off + 1]
    cols = np.arange(batch.capacity, dtype=np.int64)[None, :]
    pulled = np.take_along_axis(
        batch.data,
        np.broadcast_to(np.minimum(cols + 2, batch.capacity - 1),
                        batch.data.shape), axis=1)
    in_header = cols < off[:, None]
    in_payload = (cols >= off[:, None]) & (cols < (lens[:, None] - 2))
    data = np.where(in_header, batch.data,
                    np.where(in_payload, pulled, 0)).astype(np.uint8)
    data = rtp_header.set_ssrc(data, np.full(n, orig_ssrc, dtype=np.int64))
    data = rtp_header.set_pt(data, np.full(n, orig_pt, dtype=np.int64))
    data = rtp_header.set_seq(data, osn & 0xFFFF)
    out_len = np.where(ok, lens - 2, 0).astype(np.int32)
    return PacketBatch(data, out_len, np.asarray(batch.stream).copy()), \
        np.where(ok, osn, -1)


class RtxSender:
    """Serve NACKs from a PacketCache as RFC 4588 RTX packets.

    One per protected (media ssrc -> rtx ssrc) association; keeps the
    RTX stream's own continuous sequence space the way the reference's
    consumers pair the cache with an RTX SSRC from signaling.
    """

    def __init__(self, cache, media_ssrc: int, rtx_ssrc: int, rtx_pt: int):
        self.cache = cache
        self.media_ssrc = media_ssrc & 0xFFFFFFFF
        self.rtx_ssrc = rtx_ssrc & 0xFFFFFFFF
        self.rtx_pt = rtx_pt
        self._rtx_seq = 0
        self.served = 0

    def on_nack(self, lost_seqs: Sequence[int]) -> Optional[PacketBatch]:
        """Cache hits for `lost_seqs`, RTX-encapsulated; None if all miss."""
        hits = self.cache.lookup_nack(self.media_ssrc, lost_seqs)
        if not hits:
            return None
        batch = PacketBatch.from_payloads(hits)
        out = encapsulate_batch(batch, self.rtx_ssrc, self.rtx_pt,
                                self._rtx_seq)
        self._rtx_seq = (self._rtx_seq + out.batch_size) & 0xFFFF
        self.served += out.batch_size
        return out


class RtxReceiver:
    """Demux + restore RTX streams (rtx ssrc -> media ssrc, apt pt map)."""

    def __init__(self):
        self._assoc: Dict[int, Tuple[int, int]] = {}  # rtx_ssrc -> (ssrc, pt)
        self.recovered = 0

    def add_association(self, rtx_ssrc: int, media_ssrc: int,
                        media_pt: int) -> None:
        self._assoc[rtx_ssrc & 0xFFFFFFFF] = (media_ssrc & 0xFFFFFFFF,
                                              media_pt)

    def restore(self, batch: PacketBatch) -> List[Tuple[int, bytes]]:
        """Restore RTX rows to (original_seq, original_packet_bytes);
        rows whose SSRC has no association (or too short) are skipped."""
        hdr = rtp_header.parse(batch)
        out: List[Tuple[int, bytes]] = []
        # group rows by rtx ssrc so each association restores as a batch
        ssrcs = hdr.ssrc.astype(np.int64)
        for rtx_ssrc in np.unique(ssrcs):
            assoc = self._assoc.get(int(rtx_ssrc))
            if assoc is None:
                continue
            rows = np.nonzero(ssrcs == rtx_ssrc)[0]
            # fancy-index slice, no per-row Python byte round trips
            sub = PacketBatch(batch.data[rows],
                              np.asarray(batch.length)[rows],
                              np.asarray(batch.stream)[rows])
            restored, osn = decapsulate_batch(sub, assoc[0], assoc[1])
            for j in range(restored.batch_size):
                if osn[j] >= 0:
                    out.append((int(osn[j]), restored.to_bytes(j)))
                    self.recovered += 1
        return out
