"""Tracing and profiling helpers.

Counterpart: `libjitsi_tpu/utils/profiling.py`, on `torch.profiler`:

- `trace(log_dir)`: profiles the enclosed block (host activities, and
  the card's kernels when one is present) and writes a Chrome / Perfetto
  trace (`trace.json`) into `log_dir`; open it in ui.perfetto.dev or
  chrome://tracing.
- `annotate(name)`: a `torch.profiler.record_function` range, so a host
  phase shows on the same timeline as the kernels.
- `device_memory(device)`: the caching allocator's live and peak bytes
  and its allocation retries for one device, under the JAX function's
  keys (`bytes_in_use`, `peak_bytes_in_use`, `num_allocs`).  On the CPU
  the keys are there and hold None, as the JAX function's are on a
  backend without memory stats.  On a CUDA device a `torch.cuda` error
  propagates: it is not read as "no stats".
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[torch.device] = None
          ) -> Iterator[str]:
    """Profile the enclosed block; yields `log_dir`, which holds
    `trace.json` afterwards.  `device` None profiles the card's
    activity when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Name a host-side phase on the profiler timeline."""
    return torch.profiler.record_function(name)


def device_memory(device=None) -> dict:
    """Live-buffer stats for one device (None: the current card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
        return {
            "device": str(dev),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "num_alloc_retries": int(stats.get("num_alloc_retries", 0)),
        }
    return {"device": str(dev), "bytes_in_use": None,
            "peak_bytes_in_use": None, "num_allocs": None,
            "num_alloc_retries": None}
