"""DTMF — RFC 4733 telephone-event insertion/extraction (reference:
`org.jitsi.impl.neomedia.transform.dtmf.DtmfTransformEngine` +
`DtmfRawPacket`).

Counterpart: `libjitsi_tpu/transform/dtmf.py` (copied).

Payload: event (1B) | E R volume (1B) | duration (2B, timestamp units).
Sending replaces outgoing audio packets while a tone is active (same
timestamp for the whole event, duration growing, marker on the first
packet, E-bit set on the last three retransmitted end packets).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.engine import PacketTransformer, TransformEngine

EVENTS = "0123456789*#ABCD"


@dataclasses.dataclass
class DtmfEvent:
    event: int          # 0-15
    end: bool
    volume: int         # 0..63 (-dBm0)
    duration: int       # timestamp units


def encode_event(ev: DtmfEvent) -> bytes:
    return struct.pack("!BBH", ev.event & 0xFF,
                       ((1 if ev.end else 0) << 7) | (ev.volume & 0x3F),
                       ev.duration & 0xFFFF)


def decode_event(payload: bytes) -> DtmfEvent:
    if len(payload) < 4:
        raise ValueError("short telephone-event payload")
    e, vb, dur = struct.unpack("!BBH", payload[:4])
    return DtmfEvent(e, bool(vb >> 7), vb & 0x3F, dur)


class DtmfTransformEngine(TransformEngine):
    """Replace outgoing audio with telephone-events while a tone plays;
    extract events on receive.

    `start_tone(sid, '5')` queues a tone for that stream; subsequent
    outgoing packets of the stream morph into event packets until
    `stop_tone` (plus the RFC's 3 end-packet retransmissions).
    """

    END_REPEATS = 3

    def __init__(self, dtmf_pt: int = 101, capacity: int = 1024,
                 on_event=None):
        self.dtmf_pt = dtmf_pt
        self.on_event = on_event
        # per-stream sending state
        self._tone: Dict[int, int] = {}       # sid -> event code
        self._ts: Dict[int, int] = {}         # sid -> event start ts
        self._dur: Dict[int, int] = {}
        self._end_left: Dict[int, int] = {}
        self.received: List[DtmfEvent] = []
        eng = self

        class _T(PacketTransformer):
            def transform(self, batch, mask=None):
                if not eng._tone and not eng._end_left:
                    return batch, (np.ones(batch.batch_size, bool)
                                   if mask is None else mask)
                hdr = rtp_header.parse(batch)
                pkts = []
                for i in range(batch.batch_size):
                    sid = int(batch.stream[i])
                    raw = batch.to_bytes(i)
                    active = sid in eng._tone
                    ending = eng._end_left.get(sid, 0) > 0
                    if not active and not ending:
                        pkts.append(raw)
                        continue
                    ho = int(hdr.payload_off[i])
                    ts_step = 160  # 20 ms @ 8k tel-evt clock; config later
                    if active and sid not in eng._ts:
                        eng._ts[sid] = int(hdr.ts[i])
                        eng._dur[sid] = 0
                        marker = 1
                    else:
                        marker = 0
                    eng._dur[sid] = eng._dur.get(sid, 0) + ts_step
                    ev = DtmfEvent(eng._tone.get(sid, eng._last_code(sid)),
                                   ending, 10, eng._dur[sid])
                    pkt = bytearray(raw[:ho]) + encode_event(ev)
                    pkt[1] = (marker << 7) | (eng.dtmf_pt & 0x7F)
                    # event packets share the event-start timestamp
                    pkt[4:8] = struct.pack("!I", eng._ts[sid] & 0xFFFFFFFF)
                    pkts.append(bytes(pkt))
                    if ending:
                        eng._end_left[sid] -= 1
                        if eng._end_left[sid] == 0:
                            del eng._end_left[sid]
                            eng._ts.pop(sid, None)
                out = PacketBatch.from_payloads(pkts, batch.capacity,
                                                np.asarray(batch.stream))
                return out, (np.ones(batch.batch_size, bool)
                             if mask is None else mask)

            def reverse_transform(self, batch, mask=None):
                hdr = rtp_header.parse(batch)
                ok = np.ones(batch.batch_size, bool) if mask is None else mask
                is_evt = hdr.pt == eng.dtmf_pt
                for i in np.nonzero(is_evt & ok)[0]:
                    raw = batch.to_bytes(int(i))
                    ho = int(hdr.payload_off[i])
                    try:
                        ev = decode_event(raw[ho:])
                    except ValueError:
                        continue
                    eng.received.append(ev)
                    if eng.on_event is not None:
                        eng.on_event(int(batch.stream[i]), ev)
                # event packets are consumed, not passed to the decoder
                return batch, ok & ~is_evt

        self._rtp = _T()
        self._last = {}

    def _last_code(self, sid: int) -> int:
        return self._last.get(sid, 0)

    @property
    def rtp_transformer(self):
        return self._rtp

    def start_tone(self, sid: int, tone: str) -> None:
        code = EVENTS.index(tone)
        self._tone[sid] = code
        self._last[sid] = code
        self._ts.pop(sid, None)

    def stop_tone(self, sid: int) -> None:
        if sid in self._tone:
            del self._tone[sid]
            # only emit end packets if the tone actually made it onto the
            # wire (a start/stop with no intervening send has no event
            # timestamp to end)
            if sid in self._ts:
                self._end_left[sid] = self.END_REPEATS
