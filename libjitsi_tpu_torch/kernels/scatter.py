"""Per-row byte scatter/gather, plain PyTorch.

Counterpart: `libjitsi_tpu/kernels/scatter.py`.  On the card these
operations live inside the fused SRTP kernels (`csrc/srtp_cm.cu`): the
tag write, the ROC word appended for the MAC and the stored-tag read
are shared-memory byte accesses there.  These plain versions are what
the plain SRTP functions use, with the JAX package's edge semantics.
"""

from __future__ import annotations

import torch


def scatter_bytes(data: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Write src[:, :n] ([B, >=n] uint8) into data [B, W] at per-row byte
    offset pos [B]; bytes that would land at or past W (or before 0) are
    dropped.  Returns a new tensor."""
    col = torch.arange(data.shape[1], device=data.device)[None, :]
    pos = pos.long()[:, None]
    out = data
    for k in range(n):
        out = torch.where(col == pos + k, src[:, k:k + 1], out)
    return out


def gather_span(data: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """Read n bytes at per-row byte offset `pos` -> [B, n], indices
    clamped to [0, W-1]."""
    idx = pos.long()[:, None] + torch.arange(n, device=data.device)[None, :]
    return data.gather(1, idx.clamp(0, data.shape[1] - 1))
