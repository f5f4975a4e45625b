"""The port's GHASH (`libjitsi_tpu_torch/kernels/ghash.py`) against the
JAX package's (`libjitsi_tpu/kernels/ghash.py`).

The host math (the GF(2^128) product, the matrix of H and its vectorized
batch form) against the JAX functions; the packing of the matrices into
the port's device form ([S, 128, 4] words, the JAX `_pack_bits` order)
and back; and `ghash_plain`, the Horner over packed matrices and per-row
block counts, against all three JAX device forms (`ghash`,
`ghash_grouped`, `ghash_grouped_packed`) at ragged block counts, a row
of no blocks among them, and against the host `ghash_ref`.  The JAX side
runs eagerly (`jax.disable_jit`).  Inputs are seeded numpy arrays;
tolerance: exact bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libjitsi_tpu.kernels import ghash as jghash
from libjitsi_tpu_torch.kernels import ghash
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _eager_jax():
    with jax.disable_jit():
        yield


def test_gf_mult_and_matrices_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(8):
        x, y = (int.from_bytes(rng.integers(0, 256, 16, np.uint8).tobytes(),
                               "big") for _ in range(2))
        assert ghash.gf_mult(x, y) == jghash.gf_mult(x, y)
    h = rng.integers(0, 256, (5, 16), np.uint8)
    m = jghash.ghash_matrix_batch(h)
    assert np.array_equal(ghash.ghash_matrix_batch(h), m)
    assert np.array_equal(ghash.ghash_matrix(bytes(h[2])),
                          jghash.ghash_matrix(bytes(h[2])))
    # packed: row i's bit j at bit 31 - j % 32 of word j // 32, as the
    # JAX `_pack_bits`; unpacking gives the JAX int8 form back
    packed = ghash.pack_matrices(m)
    want = np.asarray(jghash._pack_bits(jnp.asarray(m)))
    assert packed.dtype == np.uint32 and np.array_equal(packed, want)
    assert np.array_equal(ghash.unpack_matrices(packed), m.astype(np.int8))
    assert np.array_equal(ghash.unpack_matrices(packed.view(np.int32)),
                          m.astype(np.int8))
    assert np.array_equal(ghash.ghash_matrix_packed(h, chunk=2), packed)


@pytest.mark.parametrize("nblk", [[5, 1, 0, 3, 5, 2], [1], [7, 7, 4, 0]])
def test_ghash_plain_equals_every_jax_form(nblk):
    rng = np.random.default_rng(len(nblk) * 10 + sum(nblk))
    b, nmax = len(nblk), max(max(nblk), 1)
    h = rng.integers(0, 256, (b, 16), np.uint8)
    m = jghash.ghash_matrix_batch(h).astype(np.int8)
    data = rng.integers(0, 256, (b, nmax * 16), np.uint8)
    nb = np.asarray(nblk, np.int32)
    got = ghash.ghash_plain(T(ghash.pack_matrices(m).view(np.int32)),
                            T(data), T(nb)).numpy()
    want = np.asarray(jghash.ghash(jnp.asarray(m), jnp.asarray(data),
                                   jnp.asarray(nb), nmax))
    assert np.array_equal(got, want)
    for fn in (jghash.ghash_grouped, jghash.ghash_grouped_packed):
        g = np.asarray(fn(jnp.asarray(m), jnp.asarray(data[:, None]),
                          jnp.asarray(nb[:, None]), nmax))[:, 0]
        assert np.array_equal(got, g), fn.__name__
    for i in range(b):
        assert bytes(got[i]) == jghash.ghash_ref(
            bytes(h[i]), bytes(data[i, :16 * nblk[i]]))


def test_ghash_plain_shares_one_matrix_across_rows_as_grouped():
    """`ghash_grouped`'s case: one leg's matrix applied to many rows; the
    port gives each row its matrix (here the same one)."""
    rng = np.random.default_rng(5)
    h = rng.integers(0, 256, (1, 16), np.uint8)
    m = jghash.ghash_matrix_batch(h).astype(np.int8)
    p, nmax = 6, 4
    data = rng.integers(0, 256, (1, p, nmax * 16), np.uint8)
    nb = rng.integers(0, nmax + 1, (1, p)).astype(np.int32)
    want = np.asarray(jghash.ghash_grouped(jnp.asarray(m), jnp.asarray(data),
                                           jnp.asarray(nb), nmax))[0]
    pk = np.repeat(ghash.pack_matrices(m), p, axis=0).view(np.int32)
    got = ghash.ghash_plain(T(pk), T(data[0]), T(nb[0])).numpy()
    assert np.array_equal(got, want)
