"""Transform pipeline core: batched engines and chain composition.

Rebuilds the reference's central plugin surface —
`org.jitsi.impl.neomedia.transform.{TransformEngine,PacketTransformer,
TransformEngineChain,SinglePacketTransformer}` — with the per-packet
virtual calls inverted into batched functions:

- a `PacketTransformer` maps a whole `PacketBatch` to a transformed batch
  plus a per-row keep mask (the reference signals "drop" by returning
  null from `transform()`; here a False row is the same verdict without
  losing batch shape);
- a `TransformEngine` pairs an RTP and an RTCP transformer;
- `TransformEngineChain` composes engines: send direction runs engines in
  order, receive direction in reverse order (reference:
  TransformEngineChain.getRTPTransformer's forward/reverse iteration).

Rows dropped by an earlier engine still flow through later engines (the
batch keeps its shape) but their mask bit is off and the I/O layer discards
them at scatter time; engines may use the mask to skip state updates.
An engine may change the batch size (fault injection duplicates rows):
it then returns a mask for the new shape with the incoming mask folded
in, and the chain takes that mask as it is (`_fold`).  The JAX chain's
per-engine drop counters are not kept.

Counterpart: `libjitsi_tpu/transform/engine.py`, with its dispatch-only
seams: `transform_async` and `reverse_transform_async` hand the chain's
SRTP end to the table's async calls and return pendings, and
`commit_inflight` commits an outstanding async unprotect.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from libjitsi_tpu_torch.core.packet import PacketBatch

Mask = np.ndarray  # bool [B]


class PacketTransformer:
    """Batched transformer: PacketBatch -> (PacketBatch, keep mask).

    Reference: org.jitsi.impl.neomedia.transform.PacketTransformer (the
    batch `RawPacket[]` variant — the reference's API is already plural;
    `SinglePacketTransformer` is its per-packet adapter, which has no
    analog here because everything is batched).
    """

    def transform(self, batch: PacketBatch,
                  mask: Optional[Mask] = None) -> Tuple[PacketBatch, Mask]:
        """Outbound direction.  Default: identity."""
        return batch, _ones(batch) if mask is None else mask

    def reverse_transform(self, batch: PacketBatch,
                          mask: Optional[Mask] = None
                          ) -> Tuple[PacketBatch, Mask]:
        """Inbound direction.  Default: identity."""
        return batch, _ones(batch) if mask is None else mask



def _ones(batch: PacketBatch) -> Mask:
    return np.ones(batch.batch_size, dtype=bool)


class TransformEngine:
    """An RTP + RTCP transformer pair (reference: TransformEngine)."""

    @property
    def rtp_transformer(self) -> Optional[PacketTransformer]:
        return None

    @property
    def rtcp_transformer(self) -> Optional[PacketTransformer]:
        return None


class _ChainTransformer(PacketTransformer):
    """Composes the per-engine transformers of a chain (reference:
    TransformEngineChain's packet loop)."""

    def __init__(self, transformers: Sequence[PacketTransformer]):
        self._ts = list(transformers)

    @staticmethod
    def _fold(mask, ok):
        """An engine that changed the batch size returns a mask for the
        new shape with the incoming mask already folded in."""
        if ok.shape != mask.shape:
            return ok.copy()
        return mask & ok

    def transform(self, batch, mask=None):
        mask = _ones(batch) if mask is None else mask.copy()
        for t in self._ts:
            batch, ok = t.transform(batch, mask)
            mask = self._fold(mask, ok)
        return batch, mask

    def reverse_transform(self, batch, mask=None):
        mask = _ones(batch) if mask is None else mask.copy()
        for t in reversed(self._ts):
            batch, ok = t.reverse_transform(batch, mask)
            mask = self._fold(mask, ok)
        return batch, mask

    def transform_async(self, batch, mask=None):
        """Dispatch-only outbound pass: every engine but the last runs
        sync (host header work); the last — SRTP, by chain discipline —
        is dispatched without waiting when it has `transform_async`.
        Returns (pending, mask); `pending.result()` gives the batch."""
        mask = _ones(batch) if mask is None else mask.copy()
        for t in self._ts[:-1]:
            batch, ok = t.transform(batch, mask)
            mask = self._fold(mask, ok)
        if not self._ts:
            return _DonePending(batch), mask
        last = self._ts[-1]
        if hasattr(last, "transform_async"):
            return last.transform_async(batch, mask), mask
        batch, ok = last.transform(batch, mask)
        return _DonePending(batch), self._fold(mask, ok)

    def reverse_transform_async(self, batch, mask=None):
        """Dispatch-only inbound pass, mirroring `transform_async`: the
        first engine of the receive direction (the chain's last, SRTP)
        is dispatched without waiting when it has
        `reverse_transform_async`; the other engines run sync when the
        caller materializes.  Returns a pending whose `.result()` gives
        (batch, mask)."""
        mask = _ones(batch) if mask is None else mask.copy()
        if not self._ts:
            return _DoneReverse((batch, mask))
        head = self._ts[-1]
        if not hasattr(head, "reverse_transform_async"):
            return _DoneReverse(self.reverse_transform(batch, mask))
        return _PendingReverse(self, head.reverse_transform_async(batch),
                               mask)

    def commit_inflight(self):
        """Commit every outstanding dispatch-only unprotect of the chain
        (see the SRTP transformer's `commit_inflight`)."""
        for t in self._ts:
            commit = getattr(t, "commit_inflight", None)
            if commit is not None:
                commit()


class _DonePending:
    """Degenerate pending of a chain without an async tail."""

    def __init__(self, batch):
        self._batch = batch

    def result(self):
        return self._batch

    def block_until_ready(self):
        return self


class _DoneReverse:
    """Degenerate reverse pending (no async head, or already done)."""

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out

    def block_until_ready(self):
        return self


class _PendingReverse:
    """An in-flight chain `reverse_transform_async`: the head engine's
    kernels are launched; the other engines run when the caller
    materializes.  Single-shot: result() caches."""

    def __init__(self, chain: "_ChainTransformer", pend, mask):
        self._chain = chain
        self._pend = pend
        self._mask = mask
        self._out = None

    def block_until_ready(self):
        if self._out is None:
            self._pend.block_until_ready()
        return self

    def result(self):
        if self._out is None:
            batch, ok = self._pend.result()
            mask = _ChainTransformer._fold(self._mask, ok)
            for t in reversed(self._chain._ts[:-1]):
                batch, ok = t.reverse_transform(batch, mask)
                mask = _ChainTransformer._fold(mask, ok)
            self._out = (batch, mask)
            self._pend = self._chain = None
        return self._out


class TransformEngineChain(TransformEngine):
    """Ordered engine composition (reference: TransformEngineChain).

    The send path runs `engines` first-to-last; the receive path runs
    them last-to-first — so with SRTP last, outgoing packets are
    encrypted as the final step and incoming are decrypted first, exactly
    the reference's chain discipline.
    """

    def __init__(self, engines: Sequence[TransformEngine]):
        self.engines = list(engines)
        self._rtp = _ChainTransformer(
            [e.rtp_transformer for e in self.engines
             if e.rtp_transformer is not None])
        self._rtcp = _ChainTransformer(
            [e.rtcp_transformer for e in self.engines
             if e.rtcp_transformer is not None])

    @property
    def rtp_transformer(self) -> PacketTransformer:
        return self._rtp

    @property
    def rtcp_transformer(self) -> PacketTransformer:
        return self._rtcp
