"""Retransmission cache (reference: `.caching.CachingTransformer` /
`RawPacketCache`): recently-sent packets keyed (ssrc, seq), serving
NACK-triggered retransmission (RFC 4585 NACK -> RFC 4588 RTX or verbatim
resend).

Host-side: NACKs are rare and tiny relative to media; an OrderedDict FIFO
with byte/age bounds matches the reference's size-limited cache without
device involvement.

Counterpart: `libjitsi_tpu/sfu/cache.py` (copied; host only).
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence, Tuple


class PacketCache:
    def __init__(self, max_bytes: int = 4 << 20, max_age: float = 1.0):
        self.max_bytes = max_bytes
        self.max_age = max_age
        self._store: "collections.OrderedDict[Tuple[int, int], Tuple[float, bytes]]" = (
            collections.OrderedDict())
        self._bytes = 0

    def insert(self, ssrc: int, seq: int, packet: bytes,
               now: Optional[float] = None) -> None:
        """`ssrc` is the cache namespace: a plain 32-bit SSRC for the
        single-stream RTX case, or any wider composite key (e.g. the
        SFU's (leg_sid << 32) | sender_ssrc) — it is NOT masked, so
        composite namespaces never collide."""
        now = time.time() if now is None else now
        key = (int(ssrc), seq & 0xFFFF)
        old = self._store.pop(key, None)
        if old is not None:
            self._bytes -= len(old[1])
        self._store[key] = (now, packet)
        self._bytes += len(packet)
        self._evict(now)

    def insert_batch(self, ssrcs, seqs, packets: Sequence[bytes],
                     now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for ssrc, seq, pkt in zip(ssrcs, seqs, packets):
            self.insert(int(ssrc), int(seq), pkt, now)

    def get(self, ssrc: int, seq: int) -> Optional[bytes]:
        e = self._store.get((int(ssrc), seq & 0xFFFF))
        return e[1] if e is not None else None

    def lookup_nack(self, ssrc: int, lost_seqs: Sequence[int],
                    return_missing: bool = False):
        """Packets available for retransmission out of a NACK's list.

        Deduplicates and serves in *circular* seq order: a NACK whose
        list straddles 65535->0 parses (sorted numerically) as e.g.
        [0, 1, 65534, 65535] — a plain sort would retransmit the wrap
        side first and re-scramble the very packets the receiver is
        trying to repair.  The serve order is anchored just after the
        largest mod-2^16 gap between the requested seqs, which is
        where the circular sequence "starts".

        With `return_missing=True` returns `(packets, missing_seqs)` so
        the caller can count cache misses.
        """
        ss = sorted({int(s) & 0xFFFF for s in lost_seqs})
        if len(ss) > 1:
            gaps = [(ss[i] - ss[i - 1]) & 0xFFFF for i in range(len(ss))]
            k = gaps.index(max(gaps))     # i=0 wraps to ss[-1]
            ss = ss[k:] + ss[:k]
        out: List[bytes] = []
        missing: List[int] = []
        for s in ss:
            p = self.get(ssrc, s)
            if p is not None:
                out.append(p)
            else:
                missing.append(s)
        if return_missing:
            return out, missing
        return out

    def _evict(self, now: float) -> None:
        while self._store:
            (key, (t, pkt)) = next(iter(self._store.items()))
            if self._bytes > self.max_bytes or now - t > self.max_age:
                self._store.popitem(last=False)
                self._bytes -= len(pkt)
            else:
                break

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._store)
