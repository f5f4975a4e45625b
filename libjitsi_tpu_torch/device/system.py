"""Device framework — discovery, selection, hotplug for synthetic devices.

Counterpart: `libjitsi_tpu/device/system.py` (copied).  Its
`AudioMixerMediaDevice` runs over the port's `conference/mixer.AudioMixer`,
so each `tick()` is one launch of kernel E on the mixer's device.  The
selection keys are the JAX package's (`libjitsi_tpu.devices.audio.*`), so
one configuration serves both.

Rebuilds the shape of the reference's L3 device layer
(`org.jitsi.impl.neomedia.device.{DeviceSystem,AudioSystem,
MediaDeviceImpl,DeviceConfiguration}`, SURVEY §2.5) for a server: devices
are synthetic (silence/tone/noise/file/rtpdump/ivf — see sources.py), but
the framework semantics match the reference:

- `DeviceSystem.initialize_device_systems()` scans/registers systems and
  can re-initialize (the reference's hotplug path re-runs `initialize()`
  and fires property-change events; SURVEY §5 "failure detection" row).
- `AudioSystem` tracks a device list per role (CAPTURE / PLAYBACK /
  NOTIFY — the reference AudioSystem's three `DataFlow`s) with the
  selected device persisted through the ConfigurationService the way
  `DeviceConfiguration` persists `net.java.sip.communicator.*` keys.
- `MediaDevice` is the factory handle streams consume
  (`org.jitsi.service.neomedia.device.MediaDevice`): direction +
  media_type + `create_source()/create_sink()`.
- `AudioMixerMediaDevice` presents the conference mix as a capture
  device (`org.jitsi.impl.neomedia.device.AudioMixerMediaDevice`).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from libjitsi_tpu_torch.core.config import ConfigurationService
from libjitsi_tpu_torch.device import sinks as _sinks
from libjitsi_tpu_torch.device import sources as _sources


class DataFlow(enum.Enum):
    """Reference: AudioSystem.DataFlow — the three audio roles."""

    CAPTURE = "capture"
    PLAYBACK = "playback"
    NOTIFY = "notify"


class MediaDevice:
    """A named device handle: factory for sources (capture) / sinks
    (playback).  Reference: MediaDeviceImpl wrapping a JMF CaptureDeviceInfo.
    """

    def __init__(self, name: str, media_type: str = "audio",
                 direction: str = "sendrecv",
                 source_factory: Optional[Callable[[], object]] = None,
                 sink_factory: Optional[Callable[[], object]] = None):
        self.name = name
        self.media_type = media_type
        self.direction = direction
        self._source_factory = source_factory
        self._sink_factory = sink_factory

    def create_source(self):
        if self._source_factory is None:
            raise ValueError(f"device {self.name!r} is not a capture device")
        return self._source_factory()

    def create_sink(self):
        if self._sink_factory is None:
            raise ValueError(f"device {self.name!r} is not a playback device")
        return self._sink_factory()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"MediaDevice({self.name!r}, {self.media_type}, {self.direction})"


class AudioSystem:
    """Synthetic audio system: device lists per role + persisted selection.

    Reference: `org.jitsi.impl.neomedia.device.AudioSystem` (one per
    backend — portaudio, wasapi, ...); ours is the single "synthetic"
    backend.  Selection is stored under
    ``libjitsi_tpu.devices.audio.<role>`` mirroring DeviceConfiguration's
    property persistence, so a restart restores the same device.
    """

    CONFIG_PREFIX = "libjitsi_tpu.devices.audio"

    def __init__(self, config: ConfigurationService):
        self.config = config
        self._devices: Dict[DataFlow, List[MediaDevice]] = {
            f: [] for f in DataFlow}
        # app-registered devices survive re-initialization: unlike real
        # hardware they cannot be re-discovered by a scan, so a hotplug
        # rescan must not silently drop them (and their selection)
        self._app_devices: List[Tuple[MediaDevice, DataFlow]] = []
        self._listeners: List[Callable[[str], None]] = []
        self._in_builtin_scan = False
        self.initialize()

    # -- discovery ----------------------------------------------------

    def initialize(self) -> None:
        """(Re-)scan devices; reference AudioSystem.initialize() — the
        hotplug path calls this again and listeners hear about it."""
        for f in DataFlow:
            self._devices[f] = []
        self._register_builtins()
        for dev, flow in self._app_devices:
            self._devices[flow].append(dev)
        self._fire("initialized")

    def _register_builtins(self) -> None:
        self._in_builtin_scan = True
        try:
            self._do_register_builtins()
        finally:
            self._in_builtin_scan = False

    def _do_register_builtins(self) -> None:
        self.add_device(MediaDevice(
            "silence", "audio", "sendonly",
            source_factory=_sources.SilenceSource), DataFlow.CAPTURE)
        self.add_device(MediaDevice(
            "tone:440", "audio", "sendonly",
            source_factory=lambda: _sources.ToneSource(440.0)),
            DataFlow.CAPTURE)
        self.add_device(MediaDevice(
            "noise", "audio", "sendonly",
            source_factory=lambda: _sources.NoiseSource(0)),
            DataFlow.CAPTURE)
        null = MediaDevice("null", "audio", "recvonly",
                           sink_factory=_sinks.NullSink)
        self.add_device(null, DataFlow.PLAYBACK)
        self.add_device(null, DataFlow.NOTIFY)

    def add_device(self, device: MediaDevice, flow: DataFlow) -> None:
        """Register a device (tests/apps add file/rtpdump devices); the
        reference's CaptureDeviceListManager.add analog."""
        self._devices[flow].append(device)
        if not self._in_builtin_scan:
            self._app_devices.append((device, flow))
        self._fire(f"added:{flow.value}:{device.name}")

    def remove_device(self, name: str, flow: DataFlow) -> None:
        """Unplug (reference: hotplug removal events)."""
        self._devices[flow] = [d for d in self._devices[flow]
                               if d.name != name]
        self._app_devices = [(d, f) for d, f in self._app_devices
                             if not (f == flow and d.name == name)]
        if self.config.get_string(f"{self.CONFIG_PREFIX}.{flow.value}") \
                == name:
            self.config.remove(f"{self.CONFIG_PREFIX}.{flow.value}")
        self._fire(f"removed:{flow.value}:{name}")

    def devices(self, flow: DataFlow) -> List[MediaDevice]:
        return list(self._devices[flow])

    # -- selection ----------------------------------------------------

    def set_selected_device(self, flow: DataFlow, name: str) -> None:
        if not any(d.name == name for d in self._devices[flow]):
            raise KeyError(f"no {flow.value} device named {name!r}")
        self.config.set(f"{self.CONFIG_PREFIX}.{flow.value}", name)
        self._fire(f"selected:{flow.value}:{name}")

    def selected_device(self, flow: DataFlow) -> Optional[MediaDevice]:
        """Configured device, else the first registered (the reference
        falls back to the backend's default device)."""
        want = self.config.get_string(f"{self.CONFIG_PREFIX}.{flow.value}")
        devs = self._devices[flow]
        for d in devs:
            if d.name == want:
                return d
        return devs[0] if devs else None

    # -- events -------------------------------------------------------

    def add_listener(self, cb: Callable[[str], None]) -> None:
        self._listeners.append(cb)

    def _fire(self, event: str) -> None:
        for cb in list(self._listeners):
            cb(event)


class DeviceSystem:
    """Top-level registry of per-media-type systems.

    Reference: `DeviceSystem.initializeDeviceSystems(MediaType)` called
    from MediaServiceImpl's ctor (SURVEY §3.1).  Video capture is file-
    based only (IVF via sources.IvfReader); there is no camera system.
    """

    def __init__(self, config: ConfigurationService):
        self.config = config
        self.audio = AudioSystem(config)

    def reinitialize(self) -> None:
        """Hotplug analog: rescan all systems."""
        self.audio.initialize()


class AudioMixerMediaDevice:
    """The conference mix exposed as a capture device.

    Reference: `org.jitsi.impl.neomedia.device.AudioMixerMediaDevice` —
    a MediaStream whose device is the mixer captures the mix-minus of
    everyone else.  Tick flow here: deposit each participant's decoded
    frame (`push`), run `tick()` once per frame period, then each
    participant's `MixerCaptureSource` (from `capture_for`) pulls its own
    mix-minus row.
    """

    # bound on queued un-pulled frames per participant: an abandoned
    # consumer must not leak a frame per tick forever (50 Hz * days)
    MAX_QUEUED_FRAMES = 50

    def __init__(self, mixer):
        self.mixer = mixer
        self._out: Dict[int, List[np.ndarray]] = {}

    def add_participant(self, sid: int) -> None:
        self.mixer.add_participant(sid)
        self._out.setdefault(sid, [])

    def remove_participant(self, sid: int) -> None:
        self.mixer.remove_participant(sid)
        self._out.pop(sid, None)

    def push(self, sid: int, pcm: np.ndarray) -> None:
        self.mixer.push(sid, pcm)

    def tick(self):
        """One frame period: mix and queue per-participant output.
        Returns (out [N, F] int16, levels uint8 [N]) for observability."""
        out, levels = self.mixer.mix()
        for sid, q in self._out.items():
            # copy: a row view would pin the whole [capacity, F] tick
            # array alive for as long as it sits in the queue
            q.append(out[sid].copy())
            if len(q) > self.MAX_QUEUED_FRAMES:
                del q[0]          # drop oldest: late consumer hears "now"
        return out, levels

    def pull_frame(self, sid: int) -> Optional[np.ndarray]:
        q = self._out.get(sid)
        return q.pop(0) if q else None

    def capture_for(self, sid: int) -> _sources.MixerCaptureSource:
        if sid not in self._out:
            self.add_participant(sid)
        return _sources.MixerCaptureSource(self, sid)
