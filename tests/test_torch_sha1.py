"""Plain PyTorch SHA-1 / HMAC-SHA1 and byte scatter/gather of the port
against the JAX package and the standard library.

`hmac_sha1` on CPU tensors (the plain version of kernel B) against the
JAX `hmac_sha1` and `hmac`/`hashlib`, including the RFC 2202 vectors and
the block-boundary lengths 55/56/64; `sha1` against `hashlib`;
`scatter_bytes`/`gather_span` against the JAX originals with edge
positions.  Inputs are seeded numpy arrays; tolerance: exact equality.
"""

import hashlib
import hmac

import numpy as np
import torch

from libjitsi_tpu.kernels import scatter as j_scatter
from libjitsi_tpu.kernels import sha1 as j_sha1
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import scatter as t_scatter
from libjitsi_tpu_torch.kernels import sha1 as t_sha1
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy

RFC2202 = [(b"\x0b" * 20, b"Hi There",
            "b617318655057264e28bc0b6fb378c8ef146be00"),
           (b"Jefe", b"what do ya want for nothing?",
            "effcdf6ae5eb2fa2d27416d5f184df9c259a7c79"),
           (b"\xaa" * 20, b"\xdd" * 50,
            "125d7342b9ac11cd91a39af48aa17b4f63f175d3"),
           (bytes(range(1, 26)), b"\xcd" * 50,
            "4c9007f4026250c6bc8414f9bf50c86c2d7235da"),
           (b"\xaa" * 80,
            b"Test Using Larger Than Block-Size Key - Hash Key First",
            "aa4ae5e15272d00e95705637ce8a3b55ed402112")]


def _mid(keys):
    return T(np.stack([t_sha1.hmac_precompute(k) for k in keys])
             .view(np.int32))


def test_rfc2202_vectors():
    keys = [k for k, _, _ in RFC2202]
    msgs = [m for _, m, _ in RFC2202]
    width = max(map(len, msgs))
    data = np.zeros((len(msgs), width), np.uint8)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for m in msgs], np.int32)
    tags = t_sha1.hmac_sha1(_mid(keys), T(data), T(lens)).numpy()
    for i, (_, _, want) in enumerate(RFC2202):
        assert bytes(tags[i]).hex() == want


def test_plain_hmac_matches_jax_and_stdlib():
    rng = np.random.default_rng(224)
    width = 224       # the SRTP table's narrowest row class (192 + 32)
    n = 33
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    mid = j_sha1.hmac_precompute_batch(keys)
    data = rng.integers(0, 256, (n, width), np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:5] = [0, 55, 56, 64, width]
    before = kbuild.plain_calls["hmac_sha1"]
    got = t_sha1.hmac_sha1(T(mid.view(np.int32)), T(data), T(lens)).numpy()
    assert kbuild.plain_calls["hmac_sha1"] == before + 1
    assert np.array_equal(got, np.asarray(j_sha1.hmac_sha1(mid, data, lens)))
    for i in range(n):
        assert bytes(got[i]) == hmac.new(
            bytes(keys[i]), bytes(data[i, :lens[i]]), hashlib.sha1).digest()


def test_plain_sha1_matches_hashlib():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (9, 130), np.uint8)
    lens = np.array([0, 1, 55, 56, 63, 64, 65, 119, 130], np.int32)
    got = t_sha1.sha1(T(data), T(lens)).numpy()
    for i in range(9):
        assert bytes(got[i]) == hashlib.sha1(bytes(data[i, :lens[i]])).digest()


def test_scatter_and_gather_match_jax():
    rng = np.random.default_rng(4)
    n, width = 40, 50
    data = rng.integers(0, 256, (n, width), np.uint8)
    src = rng.integers(0, 256, (n, 10), np.uint8)
    pos = rng.integers(-12, width + 4, n).astype(np.int32)
    pos[:4] = [0, width - 10, width - 3, width]
    for k in (4, 10):
        assert np.array_equal(
            t_scatter.scatter_bytes(T(data), T(pos), T(src), k).numpy(),
            np.asarray(j_scatter.scatter_bytes(data, pos, src, k)))
        assert np.array_equal(
            t_scatter.gather_span(T(data), T(pos), k).numpy(),
            np.asarray(j_scatter.gather_span(data, pos, k)))
