"""Wrap-around RTP sequence-number / timestamp arithmetic, vectorized.

Counterpart: `libjitsi_tpu/core/rtp_math.py` (copied; host NumPy).

Rebuilds the semantics of the reference's `org.jitsi.util.RTPUtils`
(seq-number arithmetic mod 2^16, timestamp arithmetic mod 2^32) and the
RFC 3711 Appendix A packet-index estimation used by
`org.jitsi.impl.neomedia.transform.srtp.SRTPCryptoContext`, as pure
vectorized NumPy functions (dtype-stable integer math, no data-dependent
control flow).
"""

from __future__ import annotations

import numpy as np

SEQ_MOD = 1 << 16
TS_MOD = 1 << 32


def seq_delta(a, b):
    """Signed distance a-b on the mod-2^16 circle, in [-32768, 32767].

    Reference: RTPUtils.getSequenceNumberDelta.  Vectorized: `a`, `b` may be
    NumPy arrays.
    """
    d = (np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)) & 0xFFFF
    return np.where(d >= 0x8000, d - SEQ_MOD, d).astype(np.int32)


def is_newer_seq(a, b):
    """True where seq `a` is newer than `b` (reference: RTPUtils.isNewerSequenceNumberThan)."""
    return seq_delta(a, b) > 0


def is_older_seq(a, b):
    return seq_delta(a, b) < 0


def ts_delta(a, b):
    """Signed distance a-b on the mod-2^32 RTP-timestamp circle.

    Reference: RTPUtils.rtpTimestampDiff.
    """
    d = (np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)) & 0xFFFFFFFF
    return np.where(d >= 0x80000000, d - TS_MOD, d).astype(np.int64)


def as_seq(x):
    """Wrap into [0, 2^16)."""
    return np.asarray(x).astype(np.int64) % SEQ_MOD


def as_ts(x):
    """Wrap into [0, 2^32)."""
    return np.asarray(x).astype(np.int64) % TS_MOD


def estimate_packet_index(seq, s_l, roc):
    """RFC 3711 Appendix A: estimate the 48-bit SRTP packet index.

    Given received sequence numbers `seq` and per-stream state `s_l`
    (highest authenticated seq) and `roc` (rollover counter), returns
    ``(v, index)`` where `v` is the guessed ROC for each packet and
    ``index = v * 2^16 + seq``.

    All args broadcast; use per-packet `s_l[stream_id]` gathers to batch
    across streams.  Reference behavior:
    SRTPCryptoContext.guessIndex (impl.neomedia.transform.srtp).
    """
    seq = np.asarray(seq).astype(np.int64)
    s_l = np.asarray(s_l).astype(np.int64)
    roc = np.asarray(roc).astype(np.int64)
    # if s_l < 32768: v = roc-1 if seq - s_l > 32768 else roc
    # else:           v = roc+1 if s_l - 32768 > seq else roc
    v_lo = np.where(seq - s_l > 0x8000, roc - 1, roc)
    v_hi = np.where(s_l - 0x8000 > seq, roc + 1, roc)
    v = np.where(s_l < 0x8000, v_lo, v_hi)
    v = np.maximum(v, 0)  # ROC is unsigned; never guess below zero
    return v, v * SEQ_MOD + seq


def update_index_state(seq, v, s_l, roc):
    """Post-authentication state update for (s_l, roc) per RFC 3711 App. A.

    Returns updated ``(s_l, roc)``.  Scalar semantics (one packet of one
    stream); the batched host path applies this via a per-stream ordered
    reduce (see transform/srtp/context.py).
    Reference behavior: SRTPCryptoContext.update.
    """
    seq = int(seq)
    v = int(v)
    s_l = int(s_l)
    roc = int(roc)
    if v == roc:
        if seq > s_l:
            s_l = seq
    elif v == roc + 1:
        s_l = seq
        roc = v
    return s_l, roc


def _segments(stream):
    """Stable segmentation of a stream-id vector.

    Returns ``(order, s_o, first, grp, fpos)``: the stable sort order by
    stream id, sorted ids, first-of-segment flags, segment index per sorted
    position, and first-position of each segment.
    """
    stream = np.asarray(stream, dtype=np.int64)
    n = len(stream)
    order = np.lexsort((np.arange(n), stream))
    s_o = stream[order]
    first = np.ones(n, dtype=bool)
    first[1:] = s_o[1:] != s_o[:-1]
    grp = np.cumsum(first) - 1
    fpos = np.where(first)[0]
    return order, s_o, first, grp, fpos


def segment_ranks(stream):
    """Per-stream occurrence rank (0,1,2,...) in stable batch order.

    Used for batched per-stream sequencing (the dense jitter bank's
    in-batch insert waves).  stream: [B] -> rank [B] int64.
    """
    stream = np.asarray(stream, dtype=np.int64)
    n = len(stream)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order, _, _, grp, fpos = _segments(stream)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - fpos[grp]
    return rank


def chain_packet_indices(stream, seq, base_ext):
    """Batched per-stream sequential packet-index estimation (RFC 3711 App A).

    Estimating every packet of a batch against the *pre-batch* state breaks
    when one stream wraps its 16-bit seq inside a single batch (e.g. a stream
    whose random initial seq is near 65535).  This chains the estimate
    within the batch instead: each packet's 48-bit index extends from the
    previous packet of the *same stream* in the batch (the first one extends
    from `base_ext`, the pre-batch per-stream extended index, -1 = unseen).
    This reproduces the reference's strictly sequential
    `SRTPCryptoContext.guessIndex` behavior on a whole batch at once —
    O(B log B) sort + segment prefix-sum, no Python loop.

    stream/seq: [B]; base_ext: [S] int64.  Returns ext [B] int64 (>= 0).
    """
    stream = np.asarray(stream, dtype=np.int64)
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order, s_o, first, grp, fpos = _segments(stream)
    q_o = seq[order]
    d = np.zeros(n, dtype=np.int64)
    d[1:] = np.where(first[1:], 0, seq_delta(q_o[1:], q_o[:-1]))
    base = base_ext[np.maximum(s_o, 0)]
    start = np.where(base >= 0, base + seq_delta(q_o, base & 0xFFFF), q_o)
    c = np.cumsum(d)
    ext_o = start[fpos][grp] + (c - c[fpos][grp])
    ext = np.empty(n, dtype=np.int64)
    ext[order] = np.maximum(ext_o, 0)
    return ext


class SeqNumUnwrapper:
    """Extend 16-bit sequence numbers to a monotone 64-bit index.

    Reference: org.jitsi.util.RTPUtils / the seq unwrapping embedded in
    FMJ's RTP stack.  Scalar host-side helper used by jitter-buffer and
    stats bookkeeping; the batched analog is `estimate_packet_index`.
    """

    def __init__(self):
        self._last_ext = None

    def unwrap(self, seq: int) -> int:
        seq = int(seq) & 0xFFFF
        if self._last_ext is None:
            self._last_ext = seq
            return seq
        d = int(seq_delta(seq, self._last_ext & 0xFFFF))
        ext = self._last_ext + d
        if ext < 0:
            ext = 0  # pre-stream-start reordered packet: clamp, keep ordering
        if d > 0:
            self._last_ext = ext
        return ext
