"""Structured, level-guarded, rate-limited logging for the media plane.

Counterpart: `libjitsi_tpu/utils/logging.py` (`MediaLogger`,
`get_logger`, `configure`), whole.  One logger per subsystem, stream and
batch identifiers carried as `k=v` fields, and a token bucket per
(logger, event) site: at most `burst` records, then `rate_hz`, with the
suppressed count carried on the next record, so a flood of bad packets
cannot flood the log.  `debug_enabled` / `info_enabled` are the level
guards a hot path reads before building fields.  Loggers live under
`libjitsi_tpu_torch`; `configure` is the opt-in root set-up (library code
never calls it).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

_ROOT = "libjitsi_tpu_torch"


class _Site:
    __slots__ = ("tokens", "last", "suppressed")

    def __init__(self, burst: float):
        self.tokens = burst
        self.last = 0.0
        self.suppressed = 0


class MediaLogger:
    """One per subsystem; stream ids travel as fields."""

    def __init__(self, name: str, rate_hz: float = 10.0, burst: int = 20):
        self._log = logging.getLogger(f"{_ROOT}.{name}")
        self.rate_hz = rate_hz
        self.burst = float(burst)
        self._sites: Dict[str, _Site] = {}

    # ------------------------------------------------------- level guards
    @property
    def debug_enabled(self) -> bool:
        return self._log.isEnabledFor(logging.DEBUG)

    @property
    def info_enabled(self) -> bool:
        return self._log.isEnabledFor(logging.INFO)

    # ------------------------------------------------------------ emitters
    def debug(self, event: str, **fields) -> None:
        if self._log.isEnabledFor(logging.DEBUG):
            self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields) -> None:
        if self._log.isEnabledFor(logging.INFO):
            self._emit(logging.INFO, event, fields)

    def warn(self, event: str, **fields) -> None:
        if self._log.isEnabledFor(logging.WARNING):
            self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        if self._log.isEnabledFor(logging.ERROR):
            self._emit(logging.ERROR, event, fields)

    def _emit(self, level: int, event: str, fields: dict,
              now: Optional[float] = None) -> None:
        site = self._sites.get(event)
        if site is None:
            site = self._sites[event] = _Site(self.burst)
        now = time.monotonic() if now is None else now
        if site.last:
            site.tokens = min(self.burst,
                              site.tokens + (now - site.last) * self.rate_hz)
        site.last = now
        if site.tokens < 1.0:
            site.suppressed += 1
            return
        site.tokens -= 1.0
        if site.suppressed:
            fields = dict(fields, suppressed=site.suppressed)
            site.suppressed = 0
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        self._log.log(level, "%s %s", event, kv)


_loggers: Dict[str, MediaLogger] = {}


def get_logger(subsystem: str, rate_hz: float = 10.0,
               burst: int = 20) -> MediaLogger:
    """The shared MediaLogger of a subsystem; a caller passing other
    limits re-tunes it (last caller wins)."""
    lg = _loggers.get(subsystem)
    if lg is None:
        lg = _loggers[subsystem] = MediaLogger(subsystem, rate_hz, burst)
    elif (rate_hz, float(burst)) != (lg.rate_hz, lg.burst):
        lg.rate_hz = rate_hz
        lg.burst = float(burst)
    return lg


def configure(level: int = logging.INFO, stream=None) -> None:
    """Opt-in root set-up of the `libjitsi_tpu_torch` logger tree: its
    level and one stream handler.  The tree stops propagating, so an
    application's root handler does not print every record twice."""
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler(stream)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s %(message)s"))
        root.addHandler(h)
    root.propagate = False
