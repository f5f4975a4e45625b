"""StreamRegistry — SSRC to stream-row demux and per-profile SRTP tables.

Counterpart: `libjitsi_tpu/service/media_stream.py` `StreamRegistry`
(alloc, reserve_many, release, map_ssrc, unmap_ssrc, demux,
demux_rtcp).  A stream is a row id into dense tables; the registry
hands out rows from a free list kept exactly as the JAX registry keeps
it, so both hand out the same sids in the same order, and maps each
packet's SSRC to its row.  The JAX registry's stats tables and the
`MediaStream` object are not ported (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile


class StreamRegistry:
    """Shared batch domain: SSRC demux plus per-profile (tx, rx) SRTP
    tables on one device (None means the card)."""

    def __init__(self, capacity: int = 1024, device: DeviceLike = None):
        self.capacity = capacity
        self.device = resolve_device(device)
        self._srtp: Dict[SrtpProfile,
                         Tuple[SrtpStreamTable, SrtpStreamTable]] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._ssrc_to_sid: Dict[int, int] = {}
        self.streams: Dict[int, object] = {}

    @property
    def free_slots(self) -> int:
        """Rows available to alloc."""
        return len(self._free)

    def alloc(self, stream) -> int:
        """Claim the lowest free row for `stream` (its owner)."""
        if not self._free:
            raise RuntimeError("stream capacity exhausted")
        sid = self._free.pop()
        self.streams[sid] = stream
        return sid

    def reserve_many(self, sids, stream) -> None:
        """Claim SPECIFIC rows (checkpoint restore: a resumed bridge must
        reoccupy its old sids so SRTP rows and demux keep lining up);
        one pass over the free list.  Raises if a row is taken."""
        want = {int(s) for s in sids}
        taken = want - set(self._free)
        if taken:
            raise ValueError(f"sids not free: {sorted(taken)}")
        self._free = [s for s in self._free if s not in want]
        for s in want:
            self.streams[s] = stream

    def release(self, sid: int) -> None:
        """Return a row to the free list, removing its SRTP rows from the
        registry's own tables."""
        self.streams.pop(sid, None)
        for tx, rx in self._srtp.values():
            if tx.active[sid]:
                tx.remove_stream(sid)
            if rx.active[sid]:
                rx.remove_stream(sid)
        self._free.append(sid)

    def srtp_tables(self, profile: SrtpProfile
                    ) -> Tuple[SrtpStreamTable, SrtpStreamTable]:
        if profile not in self._srtp:
            self._srtp[profile] = (
                SrtpStreamTable(self.capacity, profile, self.device),
                SrtpStreamTable(self.capacity, profile, self.device),
            )
        return self._srtp[profile]

    # ------------------------------------------------------------- demux
    def map_ssrc(self, ssrc: int, sid: int) -> None:
        self._ssrc_to_sid[ssrc & 0xFFFFFFFF] = sid

    def unmap_ssrc(self, ssrc: int) -> None:
        self._ssrc_to_sid.pop(ssrc & 0xFFFFFFFF, None)

    def _lookup(self, ssrc: np.ndarray) -> np.ndarray:
        m = self._ssrc_to_sid
        return np.fromiter((m.get(int(s), -1) for s in ssrc),
                           dtype=np.int64, count=len(ssrc))

    def demux(self, batch: PacketBatch) -> np.ndarray:
        """Fill batch.stream from each packet's RTP SSRC; returns the ids
        (-1 where unknown — the reference drops packets of unknown SSRC
        unless discovery is enabled)."""
        sids = self._lookup(rtp_header.parse(batch).ssrc)
        batch.stream[:] = sids
        return sids

    def demux_rtcp(self, batch: PacketBatch) -> np.ndarray:
        """Same, for RTCP rows (sender SSRC sits at byte offset 4)."""
        sids = self._lookup(rtp_header.read_u32(batch.data, 4))
        batch.stream[:] = sids
        return sids
