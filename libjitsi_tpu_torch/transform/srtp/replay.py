"""Vectorized anti-replay windows (RFC 3711 §3.3.2), host-side.

The reference keeps a 64-bit `replayWindow` plus highest-index per
`SRTPCryptoContext`/`SRTCPCryptoContext` instance.  Here the state for all
S streams is two dense arrays — ``max_index [S] int64`` (highest
authenticated packet index; -1 = nothing seen) and ``mask [S] uint64``
(bit k set = index ``max_index - k`` seen) — and both check and update are
batched NumPy ops over a whole packet batch, including in-batch duplicate
detection (two copies of one packet arriving in the same batch window must
still yield exactly one accept).

Counterpart: `libjitsi_tpu/transform/srtp/replay.py` (copied; host NumPy).
"""

from __future__ import annotations

import numpy as np

WINDOW = 64


def check(max_index: np.ndarray, mask: np.ndarray, stream: np.ndarray,
          index: np.ndarray) -> np.ndarray:
    """Pre-auth replay check against the window.  True = NOT a replay.

    max_index/mask: per-stream state [S]; stream/index: per-packet [B].
    In-batch duplicates are NOT handled here: that must happen after
    authentication (`dedup_first` on the auth-passing rows), otherwise a
    forged copy front-running the genuine packet in the same batch would
    knock out the authentic one — the reference only marks indices seen
    *after* auth (SRTPCryptoContext.checkReplay/update order).
    """
    stream = np.asarray(stream, dtype=np.int64)
    index = np.asarray(index, dtype=np.int64)
    mx = max_index[stream]
    delta = mx - index  # >0: behind the leading edge
    behind = delta > 0
    too_old = delta >= WINDOW
    bit = (mask[stream] >> np.minimum(np.maximum(delta, 0), WINDOW - 1).astype(
        np.uint64)) & np.uint64(1)
    seen = behind & ((bit == 1) | too_old)
    dup_of_max = (mx >= 0) & (index == mx)  # leading edge itself was seen
    return ~(seen | dup_of_max)


def dedup_first(stream: np.ndarray, index: np.ndarray,
                candidate: np.ndarray) -> np.ndarray:
    """True where a row duplicates an EARLIER candidate row's (stream, index).

    Applied to the auth-passing rows of one batch so exactly one copy of a
    packet index is accepted; rows with candidate=False never block others
    and are never marked.
    """
    stream = np.asarray(stream, dtype=np.int64)
    index = np.asarray(index, dtype=np.int64)
    dup = np.zeros(len(stream), dtype=bool)
    rows = np.where(np.asarray(candidate, dtype=bool))[0]
    if len(rows) < 2:
        return dup
    s, i = stream[rows], index[rows]
    order = np.lexsort((rows, i, s))
    s_o, i_o = s[order], i[order]
    d = np.zeros(len(rows), dtype=bool)
    d[1:] = (s_o[1:] == s_o[:-1]) & (i_o[1:] == i_o[:-1])
    dup[rows[order]] = d
    return dup


def update(max_index: np.ndarray, mask: np.ndarray, stream: np.ndarray,
           index: np.ndarray, accept: np.ndarray) -> None:
    """Post-auth window update, in place, for packets with accept=True.

    Handles multiple packets per stream per batch: the window slides by the
    per-stream max accepted index, and every accepted index within WINDOW of
    the new edge gets its bit set.
    """
    stream = np.asarray(stream, dtype=np.int64)[accept]
    index = np.asarray(index, dtype=np.int64)[accept]
    if len(stream) == 0:
        return
    old_max = max_index.copy()
    np.maximum.at(max_index, stream, index)
    # slide masks for streams whose edge advanced
    touched = np.unique(stream)
    shift = (max_index[touched] - np.maximum(old_max[touched], 0)).astype(np.int64)
    shift = np.where(old_max[touched] < 0, np.int64(WINDOW), shift)  # first packets
    shifted = np.where(
        shift >= WINDOW, np.uint64(0),
        mask[touched] << np.minimum(shift, WINDOW - 1).astype(np.uint64))
    mask[touched] = shifted
    # set bits for each accepted index relative to the new edge
    pos = max_index[stream] - index
    in_win = pos < WINDOW
    bits = np.where(in_win, np.uint64(1) << pos.astype(np.uint64), np.uint64(0))
    np.bitwise_or.at(mask, stream, bits)
