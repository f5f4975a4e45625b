"""Per-stream flight recorder: bounded rings of structured events.

Counterpart: `libjitsi_tpu/utils/flight.py` `FlightRecorder`, the part
the media loop calls: `record`, the loop's per-tick RTP header samples
(`record_headers`, tail-biased for streams marked priority) and
`mark_priority` (a journey that overflowed the top latency bucket), with
`dump` to read a stream's ring back.  The JAX recorder's event kinds
that mark a stream priority by themselves (NACK, RTX, FEC, handshake)
come from modules the port's loop does not run, so `mark_priority` is
the only way in.  Events are plain JSON-ready dicts
with a monotone global sequence number; rings are bounded deques.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np


def _plain(value: Any) -> Any:
    """NumPy scalars and arrays -> Python, so events stay JSON-ready."""
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


class FlightRecorder:
    """Bounded per-stream and global event rings."""

    def __init__(self, per_stream: int = 64, global_events: int = 256,
                 max_headers: int = 16, clock=time.monotonic):
        self.per_stream = int(per_stream)
        self.max_headers = int(max_headers)
        self._clock = clock
        self._seq_ext = 0  # monotone event counter, not an RTP seq
        self._streams: Dict[int, Deque[dict]] = {}
        self._global: Deque[dict] = deque(maxlen=int(global_events))
        # streams whose next header sample keeps the burst's tail
        self._priority: set = set()
        self.events_recorded = 0

    def mark_priority(self, sid: int) -> None:
        self._priority.add(int(sid))

    def record(self, kind: str, sid: Optional[int] = None,
               tick: Optional[int] = None, **fields: Any) -> dict:
        """Append one event: to the stream's ring when `sid` is given, to
        the global ring otherwise."""
        self._seq_ext += 1
        self.events_recorded += 1
        ev = {"seq": self._seq_ext, "t": self._clock(), "kind": str(kind)}
        if sid is not None:
            ev["sid"] = int(sid)
        if tick is not None:
            ev["tick"] = int(tick)
        ev.update({k: _plain(v) for k, v in fields.items()})
        if sid is None:
            self._global.append(ev)
        else:
            ring = self._streams.get(int(sid))
            if ring is None:
                ring = self._streams[int(sid)] = deque(
                    maxlen=self.per_stream)
            ring.append(ev)
        return ev

    @staticmethod
    def _spread(n_rows: int, k: int) -> List[int]:
        """k row indices spread evenly over [0, n_rows), always with the
        last row."""
        if n_rows <= k:
            return list(range(n_rows))
        idx = np.linspace(0, n_rows - 1, num=k)
        return sorted({int(round(i)) for i in idx} | {n_rows - 1})

    def record_headers(self, sids, seqs, lengths,
                       tick: Optional[int] = None,
                       trace: Optional[int] = None) -> None:
        """One compact `hdr` event per stream for the tick's RTP headers,
        at most `max_headers` rows a stream: the last rows for a stream
        marked priority, an even spread with the last row otherwise.
        `trace` links the event to the tick's journey exemplar."""
        per: Dict[int, List[List[int]]] = {}
        for sid, seq, ln in zip(sids, seqs, lengths):
            per.setdefault(int(sid), []).append([int(seq), int(ln)])
        for sid, rows in per.items():
            if sid in self._priority:
                self._priority.discard(sid)
                sample = rows[-self.max_headers:]
                mode = "tail"
            else:
                sample = [rows[i] for i in self._spread(len(rows),
                                                        self.max_headers)]
                mode = "spread"
            extra = {} if trace is None else {"trace": int(trace)}
            self.record("hdr", sid=sid, tick=tick, n=len(sample),
                        total=len(rows), mode=mode, headers=sample, **extra)

    def dump(self, sid: int) -> dict:
        """One stream's event ring and the global ring, JSON-ready."""
        return {
            "sid": int(sid),
            "events": [dict(e) for e in self._streams.get(int(sid), ())],
            "global": [dict(e) for e in self._global],
        }
