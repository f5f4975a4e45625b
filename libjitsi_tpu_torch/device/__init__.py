"""Synthetic device framework (SURVEY §2.5 L3 obligation).

Counterpart: `libjitsi_tpu/device/` (copied onto the port's mixer, config
and rtpdump reader).

Reference: `org.jitsi.impl.neomedia.device.*` + the offline fixture
protocols (`audiosilence`, `rtpdumpfile`, `ivffile`).  See system.py.
"""

from libjitsi_tpu_torch.device.sinks import (AudioSink, NullSink,
                                             PcmFileSink, WavFileSink)
from libjitsi_tpu_torch.device.sources import (AudioSource, IvfReader,
                                               IvfWriter, MixerCaptureSource,
                                               NoiseSource, PcmFileSource,
                                               RtpdumpCaptureDevice,
                                               SilenceSource, ToneSource)
from libjitsi_tpu_torch.device.system import (AudioMixerMediaDevice,
                                              AudioSystem, DataFlow,
                                              DeviceSystem, MediaDevice)

__all__ = [
    "AudioSource", "SilenceSource", "ToneSource", "NoiseSource",
    "PcmFileSource", "MixerCaptureSource", "RtpdumpCaptureDevice",
    "IvfReader", "IvfWriter",
    "AudioSink", "NullSink", "PcmFileSink", "WavFileSink",
    "DataFlow", "MediaDevice", "AudioSystem", "DeviceSystem",
    "AudioMixerMediaDevice",
]
