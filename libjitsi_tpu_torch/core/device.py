"""Where the port's tensors live.

Entry points take a `device` argument: None means the card
(`torch.device("cuda")`), and a card that is not there is an error —
there is no silent fallback to the CPU.  The CPU runs the plain PyTorch
versions of the kernels only when a caller asks for it
(`device="cpu"`, as the tests do).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host NumPy array: always a copy, never an alias of the
    host buffer, so later host writes cannot reach the device tensor."""
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device, copy=True)
