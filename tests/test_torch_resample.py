"""The port's polyphase resampler (K13b) against the JAX package, on the CPU.

The port's filter bank against JAX's `_design`, and its plain `resample`
and `resample_to_frame` against JAX's, at every L/M of the conference
rates (8, 16, 24, 32, 44.1 and 48 kHz, both ways), on full-scale noise
and on rows clipped at the rails; then the identity (no call of either
version) and the refusal of L > 480.  Kernel R itself is held against the
plain version in `tests/test_torch_cuda_emu.py` (emulated) and
`tests/test_torch_cuda.py` (on the card).  Tolerance: exact equality.
"""

import itertools

import numpy as np
import pytest
import torch

from libjitsi_tpu.kernels import resample as jrs
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import resample as rs
from test_torch_threads import one_torch_thread  # noqa: F401

RATES = (8000, 16000, 24000, 32000, 44100, 48000)
PAIRS = [p for p in itertools.permutations(RATES, 2)]


def _rows(seed, t):
    """Noise, a row clipped at the rails, noise scaled into the rails and
    a row of one constant: four rows of a 20 ms frame."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (4, t)).astype(np.int16)
    x[1] = np.where(np.arange(t) % 3, 32767, -32768)
    x[2] = np.clip(x[2].astype(np.int64) * 8, -32768, 32767)
    x[3] = -32768
    return x


def test_bank_equals_jax_design_at_every_conference_ratio():
    for ri, ro in PAIRS:
        l, m = rs.ratio(ri, ro)
        got, want = rs.design(l, m), jrs._design(l, m)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (ri, ro)


@pytest.mark.parametrize("ri,ro", PAIRS)
def test_plain_resample_equals_jax(ri, ro):
    x = _rows(ri + ro, ri // 50)
    want = np.asarray(jrs.resample(x, ri, ro))
    kbuild.reset_counts()
    got = rs.resample(torch.from_numpy(x), ri, ro)
    assert kbuild.plain_calls["resample"] == 1
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # a host array goes to the device it names
    assert np.array_equal(rs.resample(x, ri, ro, device="cpu").numpy(), want)


@pytest.mark.parametrize("ri,ro,frame", [(8000, 16000, 320),
                                         (16000, 8000, 160),
                                         (44100, 48000, 960),
                                         (48000, 44100, 880),
                                         (8000, 44100, 890)])
def test_resample_to_frame_equals_jax(ri, ro, frame):
    """Frames the ratio fills exactly, one it overfills (trimmed) and one
    it leaves short (zero-padded)."""
    x = _rows(frame, ri // 50)
    want = jrs.resample_to_frame(x, ri, ro, frame)
    got = rs.resample_to_frame(x, ri, ro, frame, device="cpu")
    assert got.dtype == np.int16 and got.shape == (4, frame)
    assert np.array_equal(got, want)


def test_identity_and_refused_ratio_as_in_jax():
    x = _rows(1, 160)
    kbuild.reset_counts()
    same = rs.resample(torch.from_numpy(x), 8000, 8000)
    assert np.array_equal(same.numpy(), np.asarray(jrs.resample(x, 8000,
                                                                8000)))
    assert kbuild.plain_calls["resample"] == 0
    assert np.array_equal(rs.resample_to_frame(x, 8000, 8000, 160,
                                               device="cpu"), x)
    for ri, ro in ((8000, 8001), (1000, 481)):
        with pytest.raises(ValueError, match="unreasonable ratio"):
            jrs.resample(x, ri, ro)
        with pytest.raises(ValueError, match="unreasonable ratio"):
            rs.resample(x, ri, ro, device="cpu")
    l, m = rs.ratio(1000, 480)                 # L = 12 is taken
    assert (l, m) == (12, 25)


def test_wrapper_refuses_a_device_without_a_kernel():
    x = torch.zeros((1, 160), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rs.resample(x, 8000, 16000)
