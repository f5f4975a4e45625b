"""G.711 in the port against the JAX package, exhaustively, on the CPU.

Every int16 input goes through the JAX `ulaw_encode` / `alaw_encode` and
the port's plain encode (what kernel F computes); every uint8 code
through both decoders (kernel G's function).  Tolerance: exact equality,
with one documented exception: µ-law ±8060, where the JAX package takes
the segment exponent as floor(log2(float32(mag))) and XLA rounds
log2(8192) below 13, so JAX gives 47/175 (decoding to ∓4092) and the
spec, and the port, give 31/159 (∓8316).
"""

import numpy as np
import pytest
import torch

from libjitsi_tpu.kernels import g711 as jg711
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import g711
from test_torch_threads import one_torch_thread  # noqa: F401

ALL_PCM = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
ALL_CODES = np.arange(256, dtype=np.uint8)
ULAW_JAX_FAULT = {-8060: (47, 31), 8060: (175, 159)}   # pcm: (jax, spec)


def test_ulaw_encode_matches_jax_except_the_documented_fault():
    got = g711.ulaw_encode(torch.from_numpy(ALL_PCM)).numpy()
    want = np.asarray(jg711.ulaw_encode(ALL_PCM))
    diff = ALL_PCM[got != want].tolist()
    assert sorted(diff) == sorted(ULAW_JAX_FAULT)
    for pcm, (jax_code, spec_code) in ULAW_JAX_FAULT.items():
        i = pcm + 32768
        assert want[i] == jax_code and got[i] == spec_code
        # the spec code decodes back near the input, the JAX one does not
        back = int(np.asarray(jg711.ulaw_decode(np.uint8(spec_code))))
        assert abs(back - pcm) < 300
        assert abs(int(np.asarray(jg711.ulaw_decode(np.uint8(jax_code))))
                   - pcm) > 3000


def test_alaw_encode_matches_jax_on_every_input():
    got = g711.alaw_encode(torch.from_numpy(ALL_PCM)).numpy()
    assert np.array_equal(got, np.asarray(jg711.alaw_encode(ALL_PCM)))


@pytest.mark.parametrize("law", ["ulaw", "alaw"])
def test_decode_matches_jax_on_every_code(law):
    port = getattr(g711, f"{law}_decode")
    jax = getattr(jg711, f"{law}_decode")
    codes = np.stack([ALL_CODES, ALL_CODES[::-1]])         # [2, 256]
    got = port(torch.from_numpy(codes))
    assert got.dtype == torch.int16 and got.shape == (2, 256)
    assert np.array_equal(got.numpy(), np.asarray(jax(codes)))


def test_kernel_arguments_past_the_element_cap_are_refused():
    # an expanded view: 2**30 + 1 elements without the memory
    big = torch.zeros(1, dtype=torch.int16).expand(kbuild.MAX_ELEMENTS + 1)
    with pytest.raises(ValueError, match="at most"):
        kbuild.expect(big, "pcm", torch.int16, big.device)
    kbuild.expect(torch.zeros(4, dtype=torch.int16), "pcm", torch.int16,
                  big.device)


def test_cpu_tensors_take_the_plain_versions_and_round_trip():
    kbuild.reset_counts()
    pcm = torch.from_numpy(ALL_PCM[::97].copy()).reshape(1, -1)
    for law in (g711.ULAW, g711.ALAW):
        codes = g711.encode(pcm, law)
        back = g711.decode(codes, law)
        # G.711 keeps the sign and quantizes within its segment step
        err = (back.int() - pcm.int()).abs()
        assert int(err.max()) <= 1024
        assert torch.equal(g711.encode(back, law), codes)
    assert kbuild.plain_calls["g711_encode"] == 4
    assert kbuild.plain_calls["g711_decode"] == 2
    assert kbuild.launches["g711_encode"] == kbuild.launches["g711_decode"] == 0
