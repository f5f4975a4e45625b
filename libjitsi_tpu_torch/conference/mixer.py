"""Conference audio mixer — N-way PCM mix-minus as one batched device op.

Counterpart: `libjitsi_tpu/conference/mixer.py` (`audio_levels`,
`mix_minus`, `mix_minus_many`, `MixerBridge`, `AudioMixer`).  Over an
`[N, F]` frame matrix per conference:

    total   = sum_j contrib_j                   (one reduction)
    out_i   = clip(total - contrib_i)           (broadcast subtract-self)
    level_i = RFC 6465 dBov from mean square    (by-product)

- Plain PyTorch versions: `mix_minus_many_plain` and `audio_levels`,
  from the JAX package's XLA twin.  The mean square is taken from an
  exact int64 sum of squares (`ms = float32(S) / F * 2**-30`), the form
  kernel E computes, so the two agree exactly on any split of the sum;
  against the JAX float32 mean the levels agree on every input the
  tests and `chip_smoke.py` hold them to.  Silence is `ms <= 1e-12`, a
  float test: a 960-sample frame whose only nonzero sample is ±1 reports
  127, at 160 samples it reports 112.
- `mix_minus_many`: the wrapper of kernel E (`csrc/mix_minus.cu`), which
  replaces the Pallas TPU kernel `mix_minus_pallas`.  On a CUDA tensor it
  launches the kernel (one thread block cluster a conference) or raises;
  on a CPU tensor it runs the plain version.
- `MixerBridge` and `AudioMixer` keep the JAX classes' host frame
  buffer, upload it each tick, read the results back and only then zero
  the buffer.  They take `device` (None means the card).  The JAX
  mixer's provider registry is not ported (ROADMAP Queue 1, item 11):
  on the card `AudioMixer.mix` launches kernel E, unless the caller
  passes its own `mix_fn`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.kernels import build as _k

I16_MIN = -32768
I16_MAX = 32767
MIX_REFUSED = -1                   # ljt_mix_minus: a shape E does not take


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device)
# ---------------------------------------------------------------------------

def _levels(pcm: torch.Tensor, active: Optional[torch.Tensor]
            ) -> torch.Tensor:
    x = pcm.to(torch.int64)
    ms = (x * x).sum(dim=-1).to(torch.float32) / pcm.shape[-1] * 2.0 ** -30
    db = 10.0 * torch.log10(torch.clamp(ms, min=1e-12))      # dBov, <= 0
    level = torch.clamp(torch.round(-db), 0, 127).to(torch.uint8)
    silent = ms <= 1e-12
    if active is not None:
        silent |= ~active.to(torch.bool)
    return torch.where(silent, torch.full_like(level, 127), level)


def audio_levels(pcm: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RFC 6465 audio level per participant: uint8 [..., N] in 0..127
    dBov of int16/int32 pcm [..., N, F].  Silence (ms <= 1e-12) and
    inactive rows report 127; 0 dBov is a full-scale square wave."""
    _k.plain_calls["mix_minus"] += 1
    return _levels(pcm, active)


def mix_minus_many_plain(pcm: torch.Tensor,
                         active: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix-minus over C conferences: pcm int16 [C, N, F], active bool
    [C, N] (None: all active) -> (out int16 [C, N, F], levels uint8
    [C, N]).  Inactive rows contribute nothing and receive the full mix."""
    _k.plain_calls["mix_minus"] += 1
    x = pcm.to(torch.int32)
    contrib = x if active is None else torch.where(
        active.to(torch.bool)[..., None], x, torch.zeros_like(x))
    total = contrib.sum(dim=-2, keepdim=True)               # [C, 1, F]
    out = torch.clamp(total - contrib, I16_MIN, I16_MAX).to(torch.int16)
    return out, _levels(pcm, active)


# ---------------------------------------------------------------------------
# Kernel E wrapper
# ---------------------------------------------------------------------------

def mix_minus_many(pcm: torch.Tensor,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix-minus over MANY conferences in one launch: pcm int16
    [C, N, F], active bool or uint8 [C, N] -> (out int16 [C, N, F],
    levels uint8 [C, N]).  Kernel E on a CUDA tensor, the plain version
    on a CPU one.  The kernel takes pcm contiguous from any int16-aligned
    address: 16-byte copies where pcm and out are 16-byte aligned and
    F % 8 == 0, 2-byte ones otherwise.  It refuses (ValueError) more than
    65,535 rows a conference (its int32 column sums), and a frame too wide
    for one row of a block's columns to fit in the shared memory of its
    widest cluster: over 78,528 samples (157,056 where C * 8 is below the
    card's SM count).  The JAX reference takes both."""
    if _k.route(pcm) == "cpu":
        return mix_minus_many_plain(pcm, active)
    dev = pcm.device
    if pcm.dim() != 3:
        raise ValueError("pcm must be [C, N, F]")
    c, n, f = pcm.shape
    _k.expect(pcm, "pcm", torch.int16, dev)
    if pcm.data_ptr() % pcm.element_size():
        raise ValueError("pcm: not aligned to its int16 elements")
    act = (torch.ones((c, n), dtype=torch.uint8, device=dev)
           if active is None else active.to(torch.uint8).contiguous())
    _k.expect(act, "active", torch.uint8, dev, (c, n))
    out = torch.empty_like(pcm)
    levels = torch.empty((c, n), dtype=torch.uint8, device=dev)
    if pcm.numel():
        rc = _k.library().ljt_mix_minus(
            pcm.data_ptr(), act.data_ptr(), out.data_ptr(),
            levels.data_ptr(), c, n, f, _k.stream_handle(dev))
        if rc == MIX_REFUSED:
            raise ValueError(f"mix_minus: kernel E does not take [{c}, {n}, "
                             f"{f}]: over 65,535 rows, or frames too wide")
        _k.check(rc, "mix_minus")
        _k.launches["mix_minus"] += 1
    return out, levels


def mix_minus(pcm: torch.Tensor, active: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix-minus over one frame: pcm int16 [N, F], active [N] ->
    (out int16 [N, F], levels uint8 [N]); the C = 1 case of
    `mix_minus_many`."""
    out, levels = mix_minus_many(
        pcm[None], None if active is None else active[None])
    return out[0], levels[0]


def _warm(device: torch.device) -> None:
    # build the kernels at setup: a 20 ms tick must never absorb nvcc
    if device.type == "cuda":
        _k.library()


class MixerBridge:
    """Whole-bridge mixing: C conferences ticked as one kernel launch.

    Deposit frames with ``push(cid, sid, pcm)``, call ``tick()`` once per
    frame period, read back each conference's mix-minus rows and RFC
    6465 levels.
    """

    def __init__(self, conferences: int = 64, capacity: int = 64,
                 frame_samples: int = 960, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.conferences = conferences
        self.capacity = capacity
        self.frame_samples = frame_samples
        self.active = np.zeros((conferences, capacity), dtype=bool)
        self._frame = np.zeros((conferences, capacity, frame_samples),
                               dtype=np.int16)
        self._in_use = np.zeros(conferences, dtype=bool)
        _warm(self.device)

    def alloc_conference(self) -> int:
        free = np.nonzero(~self._in_use)[0]
        if not len(free):
            raise RuntimeError(f"all {self.conferences} conference rows "
                               "in use")
        cid = int(free[0])
        self._in_use[cid] = True
        return cid

    def release_conference(self, cid: int) -> None:
        self._check(cid)     # stale/negative cid would clear another row
        self._in_use[cid] = False
        self.active[cid] = False
        self._frame[cid] = 0

    def _check(self, cid: int, sid: int = 0) -> None:
        # negative indices would silently wrap to another conference's
        # row; stale cids (released, possibly reallocated) would leak
        # audio across conferences — both must fail loudly
        if not (0 <= cid < self.conferences) or not self._in_use[cid]:
            raise KeyError(f"conference {cid} not allocated")
        if not (0 <= sid < self.capacity):
            raise IndexError(f"participant {sid} out of range")

    def add_participant(self, cid: int, sid: int) -> None:
        self._check(cid, sid)
        self.active[cid, sid] = True
        self._frame[cid, sid] = 0

    def remove_participant(self, cid: int, sid: int) -> None:
        self._check(cid, sid)
        self.active[cid, sid] = False
        self._frame[cid, sid] = 0

    def push(self, cid: int, sid: int, pcm: np.ndarray) -> None:
        self._check(cid, sid)
        f = np.asarray(pcm, dtype=np.int16)
        if f.shape != (self.frame_samples,):
            raise ValueError(
                f"frame must be [{self.frame_samples}] int16, got {f.shape}")
        self._frame[cid, sid] = f

    def tick(self) -> Tuple[np.ndarray, np.ndarray]:
        """One frame period for every conference: (out int16 [C, N, F],
        levels uint8 [C, N]); deposited frames are consumed."""
        out, levels = mix_minus_many(to_device(self._frame, self.device),
                                     to_device(self.active, self.device))
        # read back BEFORE zeroing the host buffer
        out_np, levels_np = out.cpu().numpy(), levels.cpu().numpy()
        self._frame[:] = 0
        return out_np, levels_np


class AudioMixer:
    """Host-facing mixer over a fixed participant capacity.

    Deposit each participant's decoded frame with `push()` (or
    `push_batch()`), call `mix()` once per frame tick, read back per-
    participant output and levels.  `mix_fn(pcm [N, F], active [N])`,
    both tensors on `device`, replaces kernel E when given.
    """

    def __init__(self, capacity: int = 256, frame_samples: int = 960,
                 mix_fn=None, device: DeviceLike = None):
        # 960 samples = 20 ms @ 48 kHz, the dominant Opus/RTP ptime
        self.device = resolve_device(device)
        self.capacity = capacity
        self.frame_samples = frame_samples
        self.active = np.zeros(capacity, dtype=bool)
        self._frame = np.zeros((capacity, frame_samples), dtype=np.int16)
        self._mix_fn = mix_fn if mix_fn is not None else mix_minus
        _warm(self.device)

    def add_participant(self, sid: int) -> None:
        self.active[sid] = True
        self._frame[sid] = 0

    def remove_participant(self, sid: int) -> None:
        self.active[sid] = False
        self._frame[sid] = 0

    def push(self, sid: int, pcm: np.ndarray) -> None:
        """Deposit one 20 ms frame for participant `sid` (int16 [F])."""
        f = np.asarray(pcm, dtype=np.int16)
        if f.shape != (self.frame_samples,):
            raise ValueError(
                f"frame must be [{self.frame_samples}] int16, got {f.shape}")
        self._frame[sid] = f

    def push_batch(self, sids: np.ndarray, frames: np.ndarray) -> None:
        """Deposit many participants' frames at once (int16 [K, F])."""
        frames = np.asarray(frames, dtype=np.int16)
        if frames.ndim != 2 or frames.shape[1] != self.frame_samples:
            raise ValueError(
                f"frames must be [K, {self.frame_samples}] int16, "
                f"got {frames.shape}")
        self._frame[np.asarray(sids, dtype=np.int64)] = frames

    def mix(self) -> Tuple[np.ndarray, np.ndarray]:
        """Run one frame tick: returns (out int16 [N, F], levels uint8 [N]).

        Frames are consumed: participants that miss the next tick
        contribute silence (a server mixer must never block on a slow
        sender).
        """
        out, levels = self._mix_fn(to_device(self._frame, self.device),
                                   to_device(self.active, self.device))
        # read back BEFORE zeroing the host buffer
        out_np, levels_np = out.cpu().numpy(), levels.cpu().numpy()
        self._frame[:] = 0
        return out_np, levels_np
