"""Auxiliary substrate services: file access and resources.

Counterpart: `libjitsi_tpu/service/aux_services.py`: `FileAccessService`
and `ResourceManagementService` (copied).  Its `AudioNotifierService`
renders tones through the synthetic device layer (`device/`), which the
port does not have yet: `AudioNotifierService` raises
`NotImplementedError` naming ROADMAP Queue 1, item 9.

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

DEVICE_LAYER = ("the synthetic device layer (device/) is not ported yet "
                "(ROADMAP Queue 1, item 9)")


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
    """Reference: AudioNotifierService; needs the device layer."""

    def __init__(self, audio_system=None):
        raise NotImplementedError(f"AudioNotifierService: {DEVICE_LAYER}")
