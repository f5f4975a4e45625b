"""RED — RFC 2198 redundant audio encoding (reference:
`org.jitsi.impl.neomedia.transform.red.REDTransformEngine`).

Counterpart: `libjitsi_tpu/transform/red.py` (copied).

Encapsulation: the RED payload carries N-1 redundant blocks (4-byte
headers: F=1 | PT | 14-bit ts offset | 10-bit length) followed by one
primary block (1-byte header: F=0 | PT), then the block data oldest
first.  The engine keeps the last `distance` payloads per stream and
wraps each outgoing packet; on receive it extracts the primary block
(and exposes redundant blocks for loss recovery).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.engine import PacketTransformer, TransformEngine


def encode_red(primary: bytes, primary_pt: int,
               redundant: List[Tuple[int, int, bytes]]) -> bytes:
    """redundant: [(pt, ts_offset, data)] oldest first."""
    out = bytearray()
    for pt, off, data in redundant:
        if not (0 <= off < (1 << 14)) or len(data) >= (1 << 10):
            raise ValueError("redundant block exceeds RFC 2198 field limits")
        out += bytes([
            0x80 | (pt & 0x7F),
            (off >> 6) & 0xFF,
            ((off & 0x3F) << 2) | (len(data) >> 8),
            len(data) & 0xFF,
        ])
    out.append(primary_pt & 0x7F)
    for _, _, data in redundant:
        out += data
    out += primary
    return bytes(out)


def decode_red(payload: bytes) -> List[Tuple[int, int, bytes]]:
    """-> [(pt, ts_offset, data)] oldest first; primary last (offset 0)."""
    hdrs = []
    off = 0
    while off < len(payload):
        b = payload[off]
        if b & 0x80:
            if off + 4 > len(payload):
                raise ValueError("truncated RED block header")
            pt = b & 0x7F
            ts_off = (payload[off + 1] << 6) | (payload[off + 2] >> 2)
            ln = ((payload[off + 2] & 0x03) << 8) | payload[off + 3]
            hdrs.append((pt, ts_off, ln))
            off += 4
        else:
            hdrs.append((b & 0x7F, 0, None))  # primary: length = remainder
            off += 1
            break
    out = []
    for pt, ts_off, ln in hdrs:
        if ln is None:
            out.append((pt, 0, payload[off:]))
            off = len(payload)
        else:
            out.append((pt, ts_off, payload[off:off + ln]))
            off += ln
    return out


class RedTransformEngine(TransformEngine):
    """Wrap outgoing payloads with redundancy; unwrap incoming.

    `red_pt` is the negotiated RED payload type; `distance` = number of
    previous payloads to attach (1 is the interop default).
    """

    def __init__(self, red_pt: int, distance: int = 1, capacity: int = 1024):
        self.red_pt = red_pt
        self.distance = distance
        # per-stream history: [(pt, rtp_ts, payload)]
        self._hist: Dict[int, List[Tuple[int, int, bytes]]] = {}
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                pkts = []
                for i in range(batch.batch_size):
                    raw = batch.to_bytes(i)
                    ho, pt, ts = int(hdr.payload_off[i]), int(hdr.pt[i]), \
                        int(hdr.ts[i])
                    sid = int(batch.stream[i])
                    h = eng._hist.setdefault(sid, [])
                    red = [(p, (ts - t) & 0x3FFF, d) for p, t, d in
                           h[-eng.distance:]]
                    payload = raw[ho:]
                    new_payload = encode_red(payload, pt, red)
                    pkt = bytearray(raw[:ho]) + new_payload
                    pkt[1] = (pkt[1] & 0x80) | (eng.red_pt & 0x7F)
                    h.append((pt, ts, payload))
                    del h[:-8]
                    pkts.append(bytes(pkt))
                out = PacketBatch.from_payloads(pkts, batch.capacity,
                                                np.asarray(batch.stream))
                return out, (np.ones(batch.batch_size, bool)
                             if mask is None else mask)

            def reverse_transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                ok = np.ones(batch.batch_size, bool) if mask is None \
                    else mask.copy()
                pkts = []
                for i in range(batch.batch_size):
                    raw = batch.to_bytes(i)
                    if int(hdr.pt[i]) != eng.red_pt or not ok[i]:
                        pkts.append(raw)
                        continue
                    ho = int(hdr.payload_off[i])
                    try:
                        blocks = decode_red(raw[ho:])
                    except ValueError:
                        ok[i] = False
                        pkts.append(raw)
                        continue
                    pt, _, primary = blocks[-1]
                    pkt = bytearray(raw[:ho]) + primary
                    pkt[1] = (pkt[1] & 0x80) | (pt & 0x7F)
                    pkts.append(bytes(pkt))
                out = PacketBatch.from_payloads(pkts, batch.capacity,
                                                np.asarray(batch.stream))
                return out, ok

        self._rtp = _T()

    @property
    def rtp_transformer(self):
        return self._rtp
