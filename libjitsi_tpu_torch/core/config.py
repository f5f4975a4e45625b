"""Typed configuration service.

Counterpart: `libjitsi_tpu/core/config.py` (copied: the port keeps its
own copy and imports nothing of the JAX package).

Rebuilds the reference's `org.jitsi.service.configuration.ConfigurationService`
/ `org.jitsi.impl.configuration.ConfigurationServiceImpl`: namespaced
string keys, default + override stores, system(env)-property overrides, and
change listeners.  Components read namespaced keys at init — the same
discipline as the reference's ``org.jitsi.*`` property names — so tunables
(SRTP window size, mixer frame ms, batch window µs) stay auditable.

Sources, in precedence order (highest wins):
  1. explicit `set()` calls / constructor overrides
  2. environment variables (``LIBJITSI_TPU_<KEY with . -> _ upper>``)
  3. registered defaults
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

ENV_PREFIX = "LIBJITSI_TPU_"


def _env_name(key: str) -> str:
    return ENV_PREFIX + key.replace(".", "_").replace("-", "_").upper()


class ConfigurationService:
    """Key-value config with defaults, env overrides and change listeners."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._lock = threading.RLock()
        self._defaults: Dict[str, Any] = {}
        self._store: Dict[str, Any] = dict(overrides or {})
        self._listeners: Dict[str, list] = {}

    # -- reference API shape: get/set/remove + typed getters ------------
    def set(self, key: str, value: Any) -> None:
        with self._lock:
            old = self.get(key)
            if value is None:
                self._store.pop(key, None)
            else:
                self._store[key] = value
            new = self.get(key)
        if old != new:
            for cb in self._listeners.get(key, []) + self._listeners.get("", []):
                cb(key, old, new)

    def remove(self, key: str) -> None:
        self.set(key, None)

    def register_default(self, key: str, value: Any) -> None:
        with self._lock:
            self._defaults[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._store:
                return self._store[key]
            env = os.environ.get(_env_name(key))
            if env:  # empty env string == unset
                return env
            if key in self._defaults:
                return self._defaults[key]
            return default

    def get_int(self, key: str, default: int = 0) -> int:
        # Unparseable values fall back to the default, matching the
        # reference's ConfigurationServiceImpl.getInt NumberFormatException
        # handling: one bad env var must not crash component init.
        v = self.get(key)
        try:
            return default if v is None else int(v)
        except (ValueError, TypeError):
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        try:
            return default if v is None else float(v)
        except (ValueError, TypeError):
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_string(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self.get(key)
        return default if v is None else str(v)

    def properties_by_prefix(self, prefix: str) -> Dict[str, Any]:
        """Reference: ConfigurationService.getPropertyNamesByPrefix."""
        with self._lock:
            keys = set(self._defaults) | set(self._store)
        env_prefix = _env_name(prefix)
        for name in os.environ:
            if name.startswith(env_prefix) and os.environ[name]:
                keys.add(prefix + name[len(env_prefix) :].lower().replace("_", "."))
        out = {}
        for k in keys:
            if k.startswith(prefix):
                out[k] = self.get(k)
        return out

    def add_listener(self, callback: Callable[[str, Any, Any], None], key: str = "") -> None:
        """`key=""` listens to all changes (reference: addPropertyChangeListener)."""
        self._listeners.setdefault(key, []).append(callback)

    def remove_listener(self, callback, key: str = "") -> None:
        if key in self._listeners and callback in self._listeners[key]:
            self._listeners[key].remove(callback)
