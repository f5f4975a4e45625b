"""EncodingConfiguration — the codec/encoding registry.

Counterpart: `libjitsi_tpu/service/encodings.py` (copied).  Its
availability probes are the JAX ones (ctypes loads of libopus, libspeex
and libgsm), so both packages list the same encodings on one machine.

Rebuilds `org.jitsi.impl.neomedia.codec.EncodingConfigurationImpl` (API
`org.jitsi.service.neomedia.codec.EncodingConfiguration`) and the role of
`FMJPlugInConfiguration`: one place that knows every supported encoding,
its RTP clock rate, static/dynamic payload typing, a preference order the
application can adjust, and which host codec implementation (if any)
backs it — so offer/answer layers and `MediaStream.
add_dynamic_rtp_payload_type` draw from a single table, as the reference
does at `MediaServiceImpl` init.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Encoding:
    name: str
    media_type: str          # "audio" | "video"
    clock_rate: int
    channels: int = 1
    static_pt: Optional[int] = None   # RFC 3551 static assignment
    available: Callable[[], bool] = lambda: True


def _opus_ok():
    from libjitsi_tpu_torch.codecs import opus_available
    return opus_available()


def _speex_ok():
    from libjitsi_tpu_torch.codecs import speex_available
    return speex_available()


def _gsm_ok():
    from libjitsi_tpu_torch.codecs import gsm_available
    return gsm_available()


# the reference's registerCustomCodecs() set, minus hardware-only entries
_KNOWN: List[Encoding] = [
    Encoding("opus", "audio", 48000, 2, None, _opus_ok),
    Encoding("PCMU", "audio", 8000, 1, 0),             # G.711 µ-law kernel
    Encoding("PCMA", "audio", 8000, 1, 8),             # G.711 A-law kernel
    Encoding("speex", "audio", 8000, 1, None, _speex_ok),
    Encoding("speex/16000", "audio", 16000, 1, None, _speex_ok),
    Encoding("GSM", "audio", 8000, 1, 3, _gsm_ok),
    # G.722's RTP clock rate is 8000 by RFC 3551 §4.5.2 historical
    # accident even though it samples at 16 kHz
    Encoding("G722", "audio", 8000, 1, 9),
    Encoding("telephone-event", "audio", 8000, 1, None),   # RFC 4733
    Encoding("VP8", "video", 90000, 1, None),
    Encoding("VP9", "video", 90000, 1, None),
    Encoding("H264", "video", 90000, 1, None),
]

_DYNAMIC_PT_FIRST = 96
_DYNAMIC_PT_LAST = 127


class EncodingConfiguration:
    """Preference-ordered registry of supported encodings.

    Priorities follow the reference's semantics: 0 disables an encoding,
    higher values sort earlier in `supported()`.
    """

    def __init__(self):
        self._encodings: Dict[str, Encoding] = {}
        self._priority: Dict[str, int] = {}
        base = 1000
        for i, e in enumerate(_KNOWN):
            self._encodings[e.name] = e
            self._priority[e.name] = base - i

    def register(self, enc: Encoding, priority: int = 1) -> None:
        self._encodings[enc.name] = enc
        self._priority[enc.name] = priority

    def set_priority(self, name: str, priority: int) -> None:
        if name not in self._encodings:
            raise KeyError(name)
        self._priority[name] = priority

    def priority(self, name: str) -> int:
        return self._priority.get(name, 0)

    def supported(self, media_type: Optional[str] = None) -> List[Encoding]:
        """Enabled encodings whose backing codec is present, sorted by
        descending priority (reference: getEnabledEncodings)."""
        out = [e for e in self._encodings.values()
               if self._priority[e.name] > 0 and e.available()
               and (media_type is None or e.media_type == media_type)]
        return sorted(out, key=lambda e: -self._priority[e.name])

    def assign_payload_types(self, media_type: Optional[str] = None
                             ) -> Dict[int, Encoding]:
        """PT -> encoding table: static PTs keep their RFC 3551 numbers,
        dynamic ones are assigned 96.. in priority order (what an SDP
        offer advertises)."""
        table: Dict[int, Encoding] = {}
        supported = self.supported(media_type)
        for e in supported:
            # supported() is descending priority: first claimant of a
            # shared static PT (the higher-priority encoding) keeps it
            if e.static_pt is not None and e.static_pt not in table:
                table[e.static_pt] = e
        next_dyn = _DYNAMIC_PT_FIRST
        for e in supported:
            if e.static_pt is not None:
                continue
            while next_dyn in table:        # a static PT may sit in 96..127
                next_dyn += 1
            if next_dyn > _DYNAMIC_PT_LAST:
                continue                    # dynamic space full; statics stay
            table[next_dyn] = e
            next_dyn += 1
        return table

    def apply_to_stream(self, stream, media_type: str) -> Dict[int, Encoding]:
        """Install the PT table on a MediaStream
        (MediaStream.addDynamicRTPPayloadType in the reference).

        Installed lowest-priority first: add_dynamic_rtp_payload_type also
        sets the stream's single jitter clock rate, and the PRIMARY
        (highest-priority) encoding's rate must be the one that sticks.
        """
        table = self.assign_payload_types(media_type)
        by_prio = sorted(table.items(),
                         key=lambda kv: self._priority[kv[1].name])
        for pt, e in by_prio:
            stream.add_dynamic_rtp_payload_type(pt, e.name, e.clock_rate)
        return table
