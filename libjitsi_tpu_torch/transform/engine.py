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
The JAX chain's per-engine drop counters and its handling of engines
that change the batch size (fault injection, RED) are not part of this
slice.

Counterpart: `libjitsi_tpu/transform/engine.py`, synchronous chain only;
the dispatch-only (async) seams wait for ROADMAP Queue 1 item 5.
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

    def transform(self, batch, mask=None):
        mask = _ones(batch) if mask is None else mask.copy()
        for t in self._ts:
            batch, ok = t.transform(batch, mask)
            mask = mask & ok
        return batch, mask

    def reverse_transform(self, batch, mask=None):
        mask = _ones(batch) if mask is None else mask.copy()
        for t in reversed(self._ts):
            batch, ok = t.reverse_transform(batch, mask)
            mask = mask & ok
        return batch, mask


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
