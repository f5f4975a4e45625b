"""Typed stream API: audio and video specializations.

Counterpart: `libjitsi_tpu/service/typed_streams.py` (`AudioMediaStream`,
`VideoMediaStream`, whose `set_simulcast_layers` builds a
`codecs/vp8.SimulcastReceiver`).

Mirrors the reference's `org.jitsi.service.neomedia.AudioMediaStream`
(DTMF sending, per-stream audio-level listeners — backed by
`AudioMediaStreamImpl`) and `VideoMediaStream` (keyframe requests,
simulcast accessors — `VideoMediaStreamImpl`), as thin facades over the
shared batched machinery: the DTMF engine and level extraction are
chain engines; keyframe requests are RTCP PLI/FIR builders.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.service.media_stream import MediaStream
from libjitsi_tpu_torch.transform.dtmf import DtmfTransformEngine
from libjitsi_tpu_torch.transform.header_ext import CsrcAudioLevelEngine


class AudioMediaStream(MediaStream):
    """Reference: AudioMediaStream.startSendingDTMF / addDTMFListener /
    setLocalUserAudioLevelListener."""

    def __init__(self, *args, dtmf_pt: int = 101, level_ext_id: int = 1,
                 **kwargs):
        self._dtmf = DtmfTransformEngine(dtmf_pt=dtmf_pt,
                                         on_event=self._dispatch_dtmf)
        self._levels = CsrcAudioLevelEngine(ext_id=level_ext_id)
        self._dtmf_listeners = []
        self._level_listeners = []
        self._levels.on_levels = self._dispatch_levels
        extra = list(kwargs.pop("extra_engines", ()))
        # audio-level stamping runs before DTMF morphing, both before SRTP
        kwargs["extra_engines"] = [self._levels, self._dtmf] + extra
        super().__init__(*args, **kwargs)

    # ------------------------------------------------------------- DTMF
    def start_sending_dtmf(self, tone: str) -> None:
        self._dtmf.start_tone(self.sid, tone)

    def stop_sending_dtmf(self) -> None:
        self._dtmf.stop_tone(self.sid)

    def add_dtmf_listener(self, fn: Callable) -> None:
        self._dtmf_listeners.append(fn)

    def _dispatch_dtmf(self, sid: int, event) -> None:
        for fn in self._dtmf_listeners:
            fn(sid, event)

    # ------------------------------------------------------------ levels
    def set_level_source(self, level_of: Callable[[np.ndarray], np.ndarray]
                         ) -> None:
        """Install the per-row level source stamped into RFC 6464 exts
        (typically `lambda sids: mixer_levels[sids]`)."""
        self._levels.level_of = level_of

    def add_audio_level_listener(self, fn: Callable) -> None:
        self._level_listeners.append(fn)

    def _dispatch_levels(self, sids, levels) -> None:
        for fn in self._level_listeners:
            fn(sids, levels)

    @property
    def last_received_level(self) -> int:
        return int(self._levels.last_levels[self.sid])


class VideoMediaStream(MediaStream):
    """Reference: VideoMediaStream (keyframe request via RTCP feedback,
    simulcast bookkeeping via the track model)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.simulcast = None  # SimulcastReceiver, set via set_layers
        self._fir_seq_n = 0

    def set_simulcast_layers(self, layer_ssrcs: Sequence[int]) -> None:
        from libjitsi_tpu_torch.codecs.vp8 import SimulcastReceiver

        self.simulcast = SimulcastReceiver(layer_ssrcs)

    def request_keyframe(self, use_fir: bool = False) -> bytes:
        """Build the PLI (or FIR) to send toward the remote sender
        (reference: RTCPFeedbackMessageSender.sendPLI/FIR)."""
        if self.remote_ssrc is None:
            raise RuntimeError("no remote ssrc to request a keyframe from")
        if use_fir:
            return rtcp.build_fir(rtcp.Fir(
                self.local_ssrc, self.remote_ssrc,
                [(self.remote_ssrc, self._next_fir_seq())]))
        return rtcp.build_pli(rtcp.Pli(self.local_ssrc, self.remote_ssrc))

    def _next_fir_seq(self) -> int:
        self._fir_seq_n = (self._fir_seq_n + 1) & 0xFF
        return self._fir_seq_n
