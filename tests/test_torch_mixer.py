"""The port's mixer against the JAX package, on the CPU.

The plain version of kernel E (`mix_minus_many_plain`, what a CPU tensor
runs) is held against the JAX XLA twin `mix_minus_many` and against the
Pallas TPU kernel `mix_minus_pallas` run in interpret mode, at
[3, 8, 960], [1, 32, 960] and [2, 5, 160], with inactive, all-zero,
near-silent (k samples of ±1) and saturating rows, then over a
constant-amplitude sweep of every amplitude at F = 160, and at a
conference of 65,540 rows (past kernel E's int32 column sums).
`AudioMixer` and `MixerBridge` are driven beside the JAX classes through
the same pushes, releases and errors.  Tolerance: exact equality, with
one documented exception: where a column total passes 2**31 - 1 the JAX
reference's int32 sum wraps, and the port keeps the exact clip.
"""

import numpy as np
import pytest
import torch

from libjitsi_tpu.conference import mixer as jmixer
from libjitsi_tpu.kernels.pallas_ops import mix_minus_pallas
from libjitsi_tpu_torch.conference import mixer
from libjitsi_tpu_torch.kernels import build as kbuild

T = torch.from_numpy


def edge_frames(c, n, f, seed):
    """Random int16 frames with the edge rows every test uses."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (c, n, f)).astype(np.int16)
    active = rng.random((c, n)) < 0.8
    pcm[:, 0] = 0                                       # silent, active
    active[:, 0] = True
    active[:, 1] = False                                # inactive
    pcm[:, 2] = 0
    pcm[:, 2, rng.choice(f, 1 + rng.integers(3), replace=False)] = 1
    active[:, 2] = True                                 # near-silent
    pcm[:, 3] = np.where(np.arange(f) % 2, 32767, -32768)
    active[:, 3] = True                                 # full scale
    if n > 5:
        pcm[:, 4] = 30000                               # saturates the mix
        pcm[:, 5] = 30000
        active[:, 4:6] = True
        pcm[:, 5, :f // 2] = -1                         # half near-silent
    return pcm, active


@pytest.mark.parametrize("shape", [(3, 8, 960), (1, 32, 960), (2, 5, 160)])
def test_plain_mix_equals_jax_twin_and_interpret_pallas(shape):
    pcm, active = edge_frames(*shape, seed=sum(shape))
    out, lv = mixer.mix_minus_many(T(pcm), T(active))
    out, lv = out.numpy(), lv.numpy()
    j_out, j_lv = jmixer.mix_minus_many(pcm, active)
    assert np.array_equal(out, np.asarray(j_out))
    assert np.array_equal(lv, np.asarray(j_lv))
    for c in range(shape[0]):
        p_out, p_lv = mix_minus_pallas(pcm[c], active[c], interpret=True)
        assert np.array_equal(out[c], np.asarray(p_out))
        assert np.array_equal(lv[c], np.asarray(p_lv))
    assert (lv[:, 1] == 127).all() and (lv[:, 0] == 127).all()
    assert (lv[:, 3] == 0).all()
    if shape[2] == 160:
        assert (lv[:, 2] < 127).all()       # 1-3 samples of ±1 at F = 160
    # no argument for `active`: every row counts
    a_out, a_lv = mixer.mix_minus_many(T(pcm))
    j_out, j_lv = jmixer.mix_minus_many(pcm)
    assert np.array_equal(a_out.numpy(), np.asarray(j_out))
    assert np.array_equal(a_lv.numpy(), np.asarray(j_lv))


def test_plain_mix_equals_jax_past_65535_rows():
    """[1, 65,540, 8] of random loud samples: more rows than kernel E's
    int32 path takes, every column total well inside int32, so the JAX
    twin's int32 sum is exact and the two agree."""
    pcm, active = edge_frames(1, 65540, 8, seed=65540)
    out, lv = mixer.mix_minus_many(T(pcm), T(active))
    j_out, j_lv = jmixer.mix_minus_many(pcm, active)
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    assert np.array_equal(lv.numpy(), np.asarray(j_lv))


def test_plain_mix_is_the_exact_clip_where_jax_wraps():
    """[1, 131,076, 1], every sample 32,767 but row 0's: each column total
    is 4,294,868,925.  The plain version (what kernel E computes) gives
    the exact clip, numpy's int64 sum clipped: 32,767 in every row.  The
    JAX reference sums in int32, wraps, and gives -32,768 (ROADMAP Queue
    3, faults of the reference)."""
    n = 131076
    pcm = np.full((1, n, 1), 32767, np.int16)
    pcm[0, 0] = 0
    x = pcm.astype(np.int64)
    exact = np.clip(x.sum(axis=1, keepdims=True) - x, -32768, 32767)
    out, lv = mixer.mix_minus_many(T(pcm))
    assert np.array_equal(out.numpy(), exact) and (exact == 32767).all()
    assert lv[0, 0] == 127 and (lv[0, 1:] == 0).all()
    j_out, j_lv = jmixer.mix_minus_many(pcm)
    assert (np.asarray(j_out) == -32768).all()
    assert np.array_equal(lv.numpy(), np.asarray(j_lv))


def test_levels_equal_jax_over_the_amplitude_sweep_at_160():
    amps = np.arange(1, 32768, dtype=np.int32)
    pcm = np.repeat(amps[:, None], 160, axis=1).astype(np.int16)
    pcm[1::2] *= -1
    got = mixer.audio_levels(T(pcm)).numpy()
    assert np.array_equal(got, np.asarray(jmixer.audio_levels(pcm)))
    assert got[0] == 90 and got[-1] == 0                 # ±1, full scale
    # one sample of ±1 is 112 dBov down in 160 samples, but in 960 it
    # falls below the float silence threshold (ms <= 1e-12)
    for f, want in ((160, 112), (960, 127)):
        lone = np.zeros((2, f), np.int16)
        lone[0, 17], lone[1, 0] = 1, -1
        assert mixer.audio_levels(T(lone)).tolist() == [want, want]
        assert np.asarray(jmixer.audio_levels(lone)).tolist() == [want, want]


def test_cpu_tensors_take_the_plain_version():
    kbuild.reset_counts()
    pcm, active = edge_frames(1, 8, 160, seed=2)
    out, lv = mixer.mix_minus(T(pcm[0]), T(active[0]))
    assert out.shape == (8, 160) and lv.shape == (8,)
    assert kbuild.plain_calls["mix_minus"] == 1
    assert kbuild.launches["mix_minus"] == 0


def test_audio_mixer_follows_jax_mixer():
    rng = np.random.default_rng(7)
    cap, f = 16, 960
    jm = jmixer.AudioMixer(capacity=cap, frame_samples=f)
    pm = mixer.AudioMixer(capacity=cap, frame_samples=f, device="cpu")
    for m in (jm, pm):
        for sid in (0, 2, 3, 9, 15):
            m.add_participant(sid)
    for tick in range(4):
        frames = rng.integers(-20000, 20000, (3, f)).astype(np.int16)
        for m in (jm, pm):
            m.push(2, frames[0])
            m.push_batch(np.array([9, 15]), frames[1:])
            if tick == 1:
                m.push(3, np.full(f, 32767, np.int16))
            if tick == 2:
                m.remove_participant(9)
        (jo, jl), (po, pl) = jm.mix(), pm.mix()
        assert np.array_equal(np.asarray(jo), po)
        assert np.array_equal(np.asarray(jl), pl)
    for m in (jm, pm):
        with pytest.raises(ValueError):
            m.push(0, np.zeros(f - 1, np.int16))
        with pytest.raises(ValueError):
            m.push_batch([0], np.zeros((1, f + 1), np.int16))


def test_mixer_bridge_follows_jax_bridge():
    rng = np.random.default_rng(11)
    conf, cap, f = 3, 4, 160
    jb = jmixer.MixerBridge(conf, cap, f)
    pb = mixer.MixerBridge(conf, cap, f, device="cpu")
    cids = {}
    for name, b in (("jax", jb), ("port", pb)):
        cids[name] = [b.alloc_conference(), b.alloc_conference()]
        for cid in cids[name]:
            for sid in range(3):
                b.add_participant(cid, sid)
    assert cids["jax"] == cids["port"] == [0, 1]
    for tick in range(3):
        frames = rng.integers(-32768, 32768, (2, 3, f)).astype(np.int16)
        for b in (jb, pb):
            for cid in (0, 1):
                for sid in range(3):
                    b.push(cid, sid, frames[cid, sid])
            if tick == 1:
                b.remove_participant(1, 2)
                b.release_conference(0)
                assert b.alloc_conference() == 0
                b.add_participant(0, 3)
        (jo, jl), (po, pl) = jb.tick(), pb.tick()
        assert np.array_equal(np.asarray(jo), po)
        assert np.array_equal(np.asarray(jl), pl)
    for b in (jb, pb):
        with pytest.raises(KeyError):
            b.push(2, 0, np.zeros(f, np.int16))       # never allocated
        with pytest.raises(KeyError):
            b.add_participant(-1, 0)
        with pytest.raises(IndexError):
            b.push(0, cap, np.zeros(f, np.int16))
        with pytest.raises(ValueError):
            b.push(0, 0, np.zeros(f + 1, np.int16))
        b.alloc_conference()
        with pytest.raises(RuntimeError):
            b.alloc_conference()
