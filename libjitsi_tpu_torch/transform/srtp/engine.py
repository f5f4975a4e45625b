"""SRTP as a TransformEngine (reference: SRTPTransformer installed last in
the chain via `SrtpControl.getTransformEngine()`).

Counterpart: `libjitsi_tpu/transform/srtp/engine.py`: RTP and RTCP,
RTP's dispatch-only seams (`transform_async`,
`reverse_transform_async`, `commit_inflight`) and the AEAD-GCM
keystream caches (`enable_keystream_cache`).  Outbound `transform`
protects, inbound `reverse_transform` unprotects and reports per-row
accept verdicts through the chain mask — the batched equivalent of
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

    def transform_async(self, batch, mask=None):
        """Dispatch-only protect (see SrtpStreamTable.protect_rtp_async):
        the chain's pipelined send path materializes it later."""
        return self.tx.protect_rtp_async(batch)

    def reverse_transform(self, batch, mask=None):
        out, ok = self.rx.unprotect_rtp(batch)
        if mask is not None:
            ok = ok & mask
        return out, ok

    def reverse_transform_async(self, batch, mask=None):
        """Dispatch-only unprotect (see
        SrtpStreamTable.unprotect_rtp_async): the chain's pipelined
        receive path materializes it, and commits its replay state,
        later.  The pending's result() is (batch, ok)."""
        return self.rx.unprotect_rtp_async(batch)

    def commit_inflight(self):
        """Commit the outstanding dispatch-only unprotect now (a wait on
        its kernels), which the next `reverse_transform_async` would do
        anyway, so a caller can count the wait as device time."""
        self.rx.commit_inflight()


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

    def enable_keystream_cache(self, **kwargs):
        """Attach keystream caches to both directions' tables (AEAD-GCM
        only; see `SrtpStreamTable.enable_keystream_cache`).  Returns the
        (tx, rx) caches, whose `fill()` runs between ticks."""
        return (self.tx.enable_keystream_cache(**kwargs),
                self.rx.enable_keystream_cache(**kwargs))

    @property
    def rtp_transformer(self):
        return self._rtp

    @property
    def rtcp_transformer(self):
        return self._rtcp
