"""Polyphase audio resampler for the PyTorch port.

Counterpart: `libjitsi_tpu/kernels/resample.py` (K13b, `_resample_jit`, XLA
device code): a Kaiser-windowed sinc low-pass evaluated polyphase.  For a
conversion L/M (the rate ratio reduced by its gcd), output sample j sits at
upsampled position j*M = phase + L*base and takes the 16 input samples
base + 8 - k (k = 0..15, indices clamped to the row) against bank row
`phase`.

- `design`: the [L, taps] float32 bank, the JAX package's `_design`
  copied (NumPy float64, then a cast to float32), so both banks are equal
  bit for bit.
- `resample_plain`: the plain PyTorch version.  XLA on the CPU computes
  the JAX einsum as a float32 fused multiply-add chain over taps 0..15 in
  order, from 0; this version takes the same chain, each step in float64
  (a product of two float32 values is exact there) rounded back to
  float32, then rounds half to even and clamps to int16.
- `resample`: the wrapper of kernel R (`csrc/resample.cu`), which runs the
  same chain with `__fmaf_rn`: on instances of its own for L/M of 2/1,
  3/1, 6/1, 1/2, 1/3 and 1/6 at 16 taps (8k, 16k and 24k <-> 48k, and
  8k <-> 16k; the bank passed by value from the host), on its general
  instance for any other.  On a CUDA tensor it launches the
  kernel; on a CPU tensor it runs the plain version.  Equal rates return
  the input with no launch.
- `resample_to_frame`: `resample` trimmed or zero-padded to a frame, as
  the conference paths need.

Tolerance against the JAX package and between R and its plain version:
exact equality (a 1-LSB difference changes G.711 code bytes downstream).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.kernels import build as _k

#: the largest interpolation factor L the resampler takes (as in JAX)
MAX_L = 480
#: input samples each of the general instance's 4 warps stages
GEN_SPAN = 1024
#: shared memory kernel R's general instance may take (the bank, its rows
#: padded to an odd stride, and the warps' spans), the H100's block limit
MAX_SMEM = 232448


def design(l: int, m: int, taps_per_phase: int = 16,
           cutoff_scale: float = 0.9) -> np.ndarray:
    """[L, taps] polyphase bank of a Kaiser-windowed sinc low-pass."""
    ntaps = taps_per_phase * l
    cutoff = cutoff_scale * 0.5 / max(l, m)  # in units of upsampled rate
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(ntaps, beta=8.0)
    h *= l  # gain compensation for zero-stuffing
    # phase p takes taps h[p], h[p+L], ...
    bank = np.zeros((l, taps_per_phase), dtype=np.float32)
    for p in range(l):
        bank[p] = h[p::l][:taps_per_phase]
    return bank


@functools.lru_cache(maxsize=None)
def bank_host(l: int, m: int, taps: int) -> np.ndarray:
    """The bank as a float32 [L, taps] host array, kept for the launches
    that pass it by value."""
    return np.ascontiguousarray(design(l, m, taps))


@functools.lru_cache(maxsize=None)
def bank_tensor(l: int, m: int, taps: int, device: torch.device
                ) -> torch.Tensor:
    """The bank as a float32 [L, taps] tensor on `device`."""
    return to_device(bank_host(l, m, taps), device)


def ratio(rate_in: int, rate_out: int) -> tuple:
    """(L, M): the rate ratio reduced by its gcd; refuses L > MAX_L."""
    g = math.gcd(rate_in, rate_out)
    l, m = rate_out // g, rate_in // g
    if l > MAX_L:
        raise ValueError(f"unreasonable ratio {rate_out}/{rate_in}")
    return l, m


def resample_plain(pcm: torch.Tensor, l: int, m: int,
                   taps: int = 16) -> torch.Tensor:
    """int16 [B, T] -> int16 [B, T*L//M], the FMA chain of the JAX
    package's CPU result, in plain PyTorch on any device."""
    _k.plain_calls["resample"] += 1
    b, t = pcm.shape
    dev = pcm.device
    bank = bank_tensor(l, m, taps, dev)
    out_len = (t * l) // m
    pos = torch.arange(out_len, device=dev, dtype=torch.int64) * m
    phase, base = pos % l, pos // l
    x = pcm.to(torch.float32)
    y = torch.zeros((b, out_len), dtype=torch.float32, device=dev)
    for k in range(taps):
        idx = (base - k + taps // 2).clamp(0, max(t - 1, 0))
        win = x[:, idx].double()
        y = (y.double() + win * bank[phase, k].double()).float()
    return y.round().clamp(-32768, 32767).to(torch.int16)


def _launch(pcm: torch.Tensor, l: int, m: int, taps: int) -> torch.Tensor:
    dev = pcm.device
    _k.expect(pcm, "pcm", torch.int16, dev)
    if pcm.dim() != 2:
        raise ValueError(f"pcm: want [B, T], got {tuple(pcm.shape)}")
    b, t = pcm.shape
    out_len = (t * l) // m
    if b * out_len > _k.MAX_ELEMENTS:
        raise ValueError(f"out: {b * out_len} elements, the kernels take at "
                         f"most {_k.MAX_ELEMENTS}")
    if 4 * (l * (taps | 1) + 4 * GEN_SPAN) > MAX_SMEM or taps + 2 > GEN_SPAN:
        raise ValueError(f"kernel R stages a bank of {l} x {taps} taps and "
                         f"4 spans of {GEN_SPAN} samples in at most "
                         f"{MAX_SMEM} bytes")
    out = torch.empty((b, out_len), dtype=torch.int16, device=dev)
    if out.numel() == 0:
        return out
    rc = _k.library().ljt_resample(
        pcm.data_ptr(), bank_tensor(l, m, taps, dev).data_ptr(),
        bank_host(l, m, taps).ctypes.data, out.data_ptr(), b, t, out_len, l,
        m, taps, _k.stream_handle(dev))
    _k.check(rc, "resample")
    _k.launches["resample"] += 1
    return out


def resample(pcm, rate_in: int, rate_out: int, taps_per_phase: int = 16,
             device: DeviceLike = None) -> torch.Tensor:
    """int16 [B, T] at rate_in -> int16 [B, T*L//M] at rate_out.

    `pcm` is a tensor (it stays on its device unless `device` names
    another) or a host array (uploaded to `device`, None meaning the
    card).  Kernel R on a CUDA tensor, the plain version on a CPU one."""
    if isinstance(pcm, torch.Tensor):
        x = pcm if device is None else pcm.to(resolve_device(device))
        x = x.to(torch.int16)
    else:
        x = to_device(np.asarray(pcm, dtype=np.int16), resolve_device(device))
    if rate_in == rate_out:
        return x
    l, m = ratio(rate_in, rate_out)
    if _k.route(x) == "cpu":
        return resample_plain(x, l, m, taps_per_phase)
    return _launch(x.contiguous(), l, m, taps_per_phase)


def resample_to_frame(pcm, rate_in: int, rate_out: int, frame: int,
                      device: DeviceLike = None) -> np.ndarray:
    """`resample` pinned to an exact output frame width, read back to the
    host: L/M rounding can leave a sample short or long, so trim or
    zero-pad to `frame` (the deposit and egress paths share this)."""
    out = resample(pcm, rate_in, rate_out, device=device)
    if out.shape[1] > frame:
        out = out[:, :frame]
    elif out.shape[1] < frame:
        out = torch.nn.functional.pad(out, (0, frame - out.shape[1]))
    return out.cpu().numpy()
