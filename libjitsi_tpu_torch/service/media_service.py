"""MediaService — the top-level factory of the public API.

Counterpart: `libjitsi_tpu/service/media_service.py`.  The service owns
one device (None means the card, and raises where there is none): its
default `StreamRegistry` keeps its SRTP tables there and its
`audio_mixer` mixes there.  `device_system` and `audio_mixer_device`
need the synthetic device layer (`device/`), which the port does not
have yet: they raise `NotImplementedError` naming ROADMAP Queue 1,
item 9.

Mirrors the surface of the reference's
`org.jitsi.service.neomedia.MediaService` /
`org.jitsi.impl.neomedia.MediaServiceImpl`: stream creation and access to
the shared batch domain (StreamRegistry) and conferencing devices.
"""

from __future__ import annotations

from libjitsi_tpu_torch.core.config import ConfigurationService
from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device
from libjitsi_tpu_torch.service.aux_services import DEVICE_LAYER


class MediaService:
    def __init__(self, config: ConfigurationService,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self._registry = None
        self._mixer = None
        self._encodings = None

    @property
    def encoding_configuration(self):
        """The codec/encoding registry (reference:
        MediaService.getCurrentEncodingConfiguration)."""
        if self._encodings is None:
            from libjitsi_tpu_torch.service.encodings import \
                EncodingConfiguration

            self._encodings = EncodingConfiguration()
        return self._encodings

    @property
    def registry(self):
        """The default shared StreamRegistry (dense per-stream tables)."""
        if self._registry is None:
            from libjitsi_tpu_torch.service.media_stream import StreamRegistry

            cap = self.config.get_int("libjitsi_tpu.stream_capacity", 1024)
            self._registry = StreamRegistry(cap, device=self.device,
                                            config=self.config)
        return self._registry

    def create_media_stream(self, media_type: str = "generic", **kwargs):
        """Reference: MediaService.createMediaStream(device, mediaType).

        media_type: "audio" -> AudioMediaStream (DTMF + level API),
        "video" -> VideoMediaStream (keyframe API), anything else ->
        plain MediaStream.
        """
        from libjitsi_tpu_torch.service.media_stream import MediaStream

        kwargs.setdefault("registry", self.registry)
        registry = kwargs.pop("registry")
        if media_type == "audio":
            from libjitsi_tpu_torch.service.typed_streams import \
                AudioMediaStream

            return AudioMediaStream(registry, **kwargs)
        if media_type == "video":
            from libjitsi_tpu_torch.service.typed_streams import \
                VideoMediaStream

            return VideoMediaStream(registry, **kwargs)
        return MediaStream(registry, **kwargs)

    @property
    def device_system(self):
        """Reference: DeviceSystem.initializeDeviceSystems."""
        raise NotImplementedError(f"device_system: {DEVICE_LAYER}")

    def audio_mixer_device(self, frame_samples: int = 960):
        """Reference: MediaService.createMixer returning
        AudioMixerMediaDevice."""
        raise NotImplementedError(f"audio_mixer_device: {DEVICE_LAYER}")

    def audio_mixer(self, frame_samples: int = 960):
        """Shared conference mixer (reference: MediaService.createMixer),
        mixing on kernel E on the service's device."""
        if self._mixer is None:
            from libjitsi_tpu_torch.conference.mixer import AudioMixer

            self._mixer = AudioMixer(
                capacity=self.registry.capacity,
                frame_samples=frame_samples, device=self.device)
        return self._mixer
