"""Auxiliary substrate services: file access and resources.

Counterpart: `libjitsi_tpu/service/aux_services.py` (copied):
`FileAccessService`, `ResourceManagementService`, and
`AudioNotifierService`, which renders tones through the synthetic device
layer (`device/`).

Reference (SURVEY §2.1 "File access / resources / audio notifier"):
`org.jitsi.service.fileaccess.FileAccessService`,
`org.jitsi.service.resources.ResourceManagementService`,
`org.jitsi.service.audionotifier.AudioNotifierService`.  These exist for
a desktop client (per-user config dirs, i18n bundles, notification
sounds); on a server they shrink to the pieces the rest of the framework
actually uses: a scoped data directory and key/value resource lookup.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np


class FileAccessService:
    """Scoped file access under one data directory.

    Reference: FileAccessServiceImpl resolves persistent files under the
    user's ~/.sip-communicator home; here the home is configurable
    (``libjitsi_tpu.data_dir``, default a temp dir) so recorders and
    packet logs have a sanctioned place to write.
    """

    def __init__(self, config=None):
        base = None
        if config is not None:
            base = config.get_string("libjitsi_tpu.data_dir")
        if base:
            self._base = os.path.abspath(base)
            os.makedirs(self._base, exist_ok=True)
        else:
            # fresh private dir (0700) — a fixed /tmp name would be
            # pre-creatable by another local user (CWE-379)
            self._base = tempfile.mkdtemp(prefix="libjitsi_tpu-")

    @property
    def data_dir(self) -> str:
        return self._base

    def get_private_file(self, name: str) -> str:
        """Path for a persistent file; parents created, traversal refused."""
        path = os.path.normpath(os.path.join(self._base, name))
        if not path.startswith(os.path.abspath(self._base) + os.sep) \
                and path != os.path.abspath(self._base):
            raise ValueError(f"path {name!r} escapes the data dir")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def create_temp_file(self, suffix: str = "") -> str:
        fd, path = tempfile.mkstemp(suffix=suffix, dir=self._base)
        os.close(fd)
        return path


class ResourceManagementService:
    """Key/value resource lookup (settings + strings).

    Reference: ResourceManagementService serves i18n strings, images and
    sound paths from bundle resources; server-side it is a dict with
    defaults — enough for components that look up tunables/messages by
    resource key.
    """

    def __init__(self, entries: Optional[Dict[str, Any]] = None):
        self._entries: Dict[str, Any] = dict(entries or {})

    def register(self, key: str, value: Any) -> None:
        self._entries[key] = value

    def get_setting(self, key: str, default: Any = None) -> Any:
        return self._entries.get(key, default)

    def get_string(self, key: str, default: Optional[str] = None):
        v = self._entries.get(key, default)
        return None if v is None else str(v)


class AudioNotifierService:
    """Render notification tones through the synthetic device layer.

    Reference: AudioNotifierService/SCAudioClip plays .wav notification
    sounds on the NOTIFY device; here `play` synthesizes the tone and
    writes it to the selected NOTIFY device's sink (NullSink by default),
    returning the PCM so tests and callers can assert on it.
    """

    def __init__(self, audio_system=None):
        self._audio_system = audio_system
        self.is_mute = False

    def set_mute(self, mute: bool) -> None:
        self.is_mute = bool(mute)

    def play(self, freq_hz: float = 440.0, duration_s: float = 0.2,
             sample_rate: int = 48000) -> np.ndarray:
        from libjitsi_tpu_torch.device.sources import ToneSource

        n = int(duration_s * sample_rate)
        if self.is_mute:
            return np.zeros(0, dtype=np.int16)
        pcm = ToneSource(freq_hz, sample_rate=sample_rate).read(n)
        if self._audio_system is not None:
            from libjitsi_tpu_torch.device.system import DataFlow

            dev = self._audio_system.selected_device(DataFlow.NOTIFY)
            if dev is not None:
                sink = dev.create_sink()
                try:
                    sink.write(pcm)
                finally:
                    sink.close()
        return pcm
