"""SRTP as a TransformEngine (reference: SRTPTransformer installed last in
the chain via `SrtpControl.getTransformEngine()`).

Counterpart: `libjitsi_tpu/transform/srtp/engine.py`, synchronous
RTP and RTCP.  Outbound `transform` protects, inbound
`reverse_transform` unprotects and reports per-row accept verdicts
through the chain mask — the batched equivalent of
SRTPTransformer.reverseTransform returning null on auth/replay failure.
"""

from __future__ import annotations

import numpy as np

from libjitsi_tpu_torch.transform.engine import PacketTransformer, TransformEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable


class _SrtpRtpTransformer(PacketTransformer):
    def __init__(self, tx: SrtpStreamTable, rx: SrtpStreamTable):
        self.tx = tx
        self.rx = rx

    def transform(self, batch, mask=None):
        out = self.tx.protect_rtp(batch)
        return out, (np.ones(batch.batch_size, bool) if mask is None else mask)

    def reverse_transform(self, batch, mask=None):
        out, ok = self.rx.unprotect_rtp(batch)
        if mask is not None:
            ok = ok & mask
        return out, ok


class _SrtpRtcpTransformer(PacketTransformer):
    def __init__(self, tx: SrtpStreamTable, rx: SrtpStreamTable):
        self.tx = tx
        self.rx = rx

    def transform(self, batch, mask=None):
        out = self.tx.protect_rtcp(batch)
        return out, (np.ones(batch.batch_size, bool) if mask is None else mask)

    def reverse_transform(self, batch, mask=None):
        out, ok = self.rx.unprotect_rtcp(batch)
        if mask is not None:
            ok = ok & mask
        return out, ok


class SrtpTransformEngine(TransformEngine):
    """Pairs a tx and an rx `SrtpStreamTable` (separate forward/reverse
    contexts, as the reference keeps separate maps)."""

    def __init__(self, tx: SrtpStreamTable, rx: SrtpStreamTable):
        self.tx = tx
        self.rx = rx
        self._rtp = _SrtpRtpTransformer(tx, rx)
        self._rtcp = _SrtpRtcpTransformer(tx, rx)

    @property
    def rtp_transformer(self):
        return self._rtp

    @property
    def rtcp_transformer(self):
        return self._rtcp
