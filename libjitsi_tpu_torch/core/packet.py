"""PacketBatch — the struct-of-arrays currency of the framework.

Counterpart: `libjitsi_tpu/core/packet.py` (copied; host NumPy).

The reference's `RawPacket` (org/jitsi/service/neomedia/RawPacket.java) is a
zero-copy ``byte[] + offset + length`` view over one UDP datagram, mutated in
place by each `PacketTransformer`.  Here the per-packet object inverts into
one dense batch: a ``uint8 [B, capacity]`` payload matrix plus int32 vectors
for lengths and parsed header fields.  Every transform is a batched function
``PacketBatch -> PacketBatch``; a "packet" is a row index.

Capacity is fixed (default MTU-sized 1504, a multiple of 8); variable sizes
are handled by the `length` vector and masking, with size-class bucketing
(`bucket_by_size` below) applied inside the SRTP table's protect/unprotect
— the device boundary — NOT around whole transform chains (engines may
grow packets or keep order-sensitive state).  The batch stays NumPy on the
host; tensors appear only at the crypto boundary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_CAPACITY = 1504  # >= Ethernet MTU payload, multiple of 8

# RTP fixed header (RFC 3550 §5.1)
RTP_FIXED_HEADER_LEN = 12
RTP_VERSION = 2


@dataclasses.dataclass
class PacketBatch:
    """A batch of packets as dense host arrays (NumPy).

    Attributes
    ----------
    data : uint8 [B, capacity]
        Raw datagram bytes, zero-padded past `length`.
    length : int32 [B]
        Valid byte count per row.
    stream : int32 [B]
        Owning stream id (row into the framework's per-stream state
        tables); -1 when unmapped.  This replaces the reference's
        per-`MediaStreamImpl` object identity.
    """

    data: np.ndarray
    length: np.ndarray
    stream: np.ndarray

    # ---- constructors -------------------------------------------------
    @staticmethod
    def empty(batch: int, capacity: int = DEFAULT_CAPACITY) -> "PacketBatch":
        return PacketBatch(
            data=np.zeros((batch, capacity), dtype=np.uint8),
            length=np.zeros((batch,), dtype=np.int32),
            stream=np.full((batch,), -1, dtype=np.int32),
        )

    @staticmethod
    def from_payloads(
        payloads: Sequence[bytes],
        capacity: int = DEFAULT_CAPACITY,
        stream: Optional[Sequence[int]] = None,
    ) -> "PacketBatch":
        b = PacketBatch.empty(len(payloads), capacity)
        for i, p in enumerate(payloads):
            if len(p) > capacity:
                raise ValueError(f"packet {i} ({len(p)}B) exceeds capacity {capacity}")
            b.data[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
            b.length[i] = len(p)
        if stream is not None:
            b.stream[:] = np.asarray(stream, dtype=np.int32)
        return b

    # ---- accessors ----------------------------------------------------
    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.data.shape[1])

    def to_bytes(self, i: int) -> bytes:
        return bytes(np.asarray(self.data[i, : int(self.length[i])]))

    def to_payloads(self) -> List[bytes]:
        return [self.to_bytes(i) for i in range(self.batch_size)]

    def copy(self) -> "PacketBatch":
        return PacketBatch(self.data.copy(), self.length.copy(), self.stream.copy())

    def mask(self) -> np.ndarray:
        """bool [B, capacity]: True where a byte is within `length`."""
        idx = np.arange(self.capacity, dtype=np.int32)[None, :]
        return idx < np.asarray(self.length)[:, None]


# ---------------------------------------------------------------------------
# Size-class bucketing (SURVEY §7 "variable packet sizes: bucket into size
# classes to bound padding waste").  Device cost scales with batch width
# (AES blocks = width/16), so mixed traffic is split into a few fixed shape
# classes: audio packets run 12 AES blocks instead of 94.  The classes are
# the JAX package's, so both packages pad and reassemble identically.
#
# Used INSIDE the SRTP table's protect/unprotect (the device boundary) —
# not around whole transform chains, whose engines may grow packets or
# keep order-sensitive state.  Row padding REPEATS the last real row,
# which is SRTP-state-safe: a duplicate packet index leaves the
# per-stream max unchanged on protect and dies in replay dedup on
# unprotect; callers drop rows >= n_real.
# ---------------------------------------------------------------------------

LENGTH_CLASSES = (192, 512, DEFAULT_CAPACITY)
ROW_CLASSES = (16, 64, 256, 1024, 4096)
CLASS_HEADROOM = 32   # room for auth tag + SRTCP index word growth


def _round_rows(n: int) -> int:
    for r in ROW_CLASSES:
        if n <= r:
            return r
    # beyond the table: round up to a multiple of the largest class so
    # big batches still land on a bounded set of compiled shapes (a raw
    # row count here would jit-compile fresh for EVERY distinct batch
    # size — cache churn that melts a production tick)
    top = ROW_CLASSES[-1]
    return (n + top - 1) // top * top


def bucket_by_size(batch: "PacketBatch",
                   length_classes=LENGTH_CLASSES,
                   headroom: int = CLASS_HEADROOM):
    """Split a batch into width/row-class sub-batches.

    Returns a list of (orig_rows, sub_batch, n_real): `orig_rows` are the
    source row indices (length n_real); `sub_batch` has capacity
    class+headroom and its row count padded up to a ROW_CLASSES size by
    CYCLING the real rows (see module comment for why repeating real
    rows is SRTP-state-safe).  Cycling — rather than repeating one row —
    keeps per-stream multiplicity within 2x, so the GCM grouped-GHASH
    grid's skew statistics see the real distribution, not a pad
    artifact (a single repeated row used to read as one hot stream and
    force the per-row path).
    """
    ln = np.asarray(batch.length)
    out = []
    assigned = np.zeros(len(ln), dtype=bool)
    classes = [c for c in length_classes if c < batch.capacity]
    classes.append(batch.capacity)          # terminal class: full width
    for cls in classes:
        rows = np.nonzero(~assigned & (ln <= cls))[0]
        assigned[rows] = True
        if not len(rows):
            continue
        cap = cls + headroom
        n_real = len(rows)
        n_pad = _round_rows(n_real)
        idx = np.resize(rows, n_pad)     # pads cycle the real rows
        data = np.zeros((n_pad, cap), dtype=np.uint8)
        take = min(cap, batch.capacity)
        data[:, :take] = batch.data[idx, :take]
        out.append((rows,
                    PacketBatch(data, ln[idx].astype(np.int32),
                                np.asarray(batch.stream)[idx].copy()),
                    n_real))
    return out


def unbucket(parts, total_rows: int, min_capacity: int = 0, masks=None):
    """Reassemble bucket results into one batch (+ ok mask).

    parts: list of (orig_rows, sub_batch, n_real) AFTER processing.
    The output capacity grows to fit the longest processed row (protect
    appends tags — near-MTU packets must not be truncated).
    masks: optional per-part row masks (aligned with each sub_batch).
    """
    need = max([min_capacity] + [int(np.max(sub.length[:n], initial=0))
                                 for _, sub, n in parts])
    need = (need + 15) & ~15       # keep downstream shapes class-bounded
    out = PacketBatch.empty(total_rows, need)
    ok = np.zeros(total_rows, dtype=bool)
    for k, (rows, sub, n_real) in enumerate(parts):
        take = min(sub.capacity, need)
        out.data[rows, :take] = sub.data[:n_real, :take]
        out.length[rows] = sub.length[:n_real]
        out.stream[rows] = sub.stream[:n_real]
        if masks is not None:
            ok[rows] = masks[k][:n_real]
    return out, ok
