"""Plain PyTorch AES and AES-CTR of the port against the JAX package.

`aes_encrypt` (on a CPU tensor: the plain version of kernel A) against
`aes_encrypt_table`, `aes_encrypt_np` and FIPS-197; `ctr_crypt` against
`ctr_crypt_uniform` and `ctr_crypt_offset` at uniform and mixed
offsets (CSRC lists and header extensions), with counters that carry
across 32-bit limbs; the RFC 3711 B.2 and SP 800-38A F.5.1 keystreams.
Inputs are seeded numpy arrays; tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from libjitsi_tpu.kernels import aes as j_aes
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu_torch.kernels import aes as t_aes
from libjitsi_tpu_torch.kernels import build as kbuild
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy

FIPS197 = [("000102030405060708090a0b0c0d0e0f",
            "69c4e0d86a7b0430d8cdb78070b4c55a"),
           ("000102030405060708090a0b0c0d0e0f1011121314151617"
            "18191a1b1c1d1e1f", "8ea2b7ca516745bfeafc49904b496089")]


@pytest.mark.parametrize("key,ct", FIPS197)
def test_fips197_known_answers(key, ct):
    rk = t_aes.expand_key(bytes.fromhex(key))[None].copy()
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)[None].copy()
    assert bytes(t_aes.aes_encrypt(T(rk), T(pt)).numpy()[0]) == \
        bytes.fromhex(ct)


@pytest.mark.parametrize("key_len", [16, 32])
def test_plain_aes_matches_jax_table_core_and_numpy(key_len):
    rng = np.random.default_rng(key_len)
    rk = j_aes.expand_keys_batch(rng.integers(0, 256, (64, key_len),
                                              np.uint8))
    blocks = rng.integers(0, 256, (64, 16), np.uint8)
    want = np.asarray(j_aes.aes_encrypt_table(rk, blocks))
    before = kbuild.plain_calls["aes_encrypt"]
    got = t_aes.aes_encrypt(T(rk), T(blocks)).numpy()
    assert kbuild.plain_calls["aes_encrypt"] == before + 1
    assert np.array_equal(got, want)
    assert np.array_equal(got, j_aes.aes_encrypt_np(rk, blocks))
    # leading batch dims broadcast like the JAX core's [..., R, 16]
    rk4 = np.broadcast_to(rk[:8, None], (8, 3) + rk.shape[1:]).copy()
    bl4 = blocks[:24].reshape(8, 3, 16)
    assert np.array_equal(t_aes.aes_encrypt_plain(T(rk4), T(bl4)).numpy(),
                          np.asarray(j_aes.aes_encrypt_table(rk4, bl4)))


def test_ctr_crypt_matches_jax_uniform_and_offset_forms():
    rng = np.random.default_rng(7)
    n = 24
    payloads = [rng.integers(0, 256, k, np.uint8).tobytes()
                for k in rng.integers(0, 160, n)]
    csrcs = [list(range(k)) for k in rng.integers(0, 3, n)]
    ext = [None if k % 2 else (0xBEDE, b"\x10\x01") for k in range(n)]
    mixed = j_header.build(payloads, np.arange(n), 0, 7, 96, csrcs=csrcs,
                           ext=ext, capacity=224)
    off = j_header.parse(mixed).payload_off
    assert len(set(off.tolist())) > 1           # really mixed offsets
    rk = j_aes.expand_keys_batch(rng.integers(0, 256, (n, 16), np.uint8))
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[:6, 8:] = 0xFF                           # carries across limbs
    plen = (mixed.length - off).astype(np.int32)
    want = np.asarray(j_aes.ctr_crypt_offset(rk, iv, mixed.data, off, plen))
    got = t_aes.ctr_crypt(T(rk), T(iv), T(mixed.data), T(off), T(plen))
    assert np.array_equal(got.numpy(), want)
    # uniform offset (fixed 12-byte headers), AES-256
    rk2 = j_aes.expand_keys_batch(rng.integers(0, 256, (n, 32), np.uint8))
    data = rng.integers(0, 256, (n, 224), np.uint8)
    ln = rng.integers(-4, 230, n).astype(np.int32)
    want = np.asarray(j_aes.ctr_crypt_uniform(rk2, iv, data, 12, ln))
    got = t_aes.ctr_crypt(T(rk2), T(iv), T(data),
                          torch.full((n,), 12, dtype=torch.int32), T(ln))
    assert np.array_equal(got.numpy(), want)


def test_ctr_keystream_known_answers():
    # NIST SP 800-38A F.5.1 (CTR-AES128.Encrypt), first two blocks
    rk = t_aes.expand_key(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))
    iv = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"),
                       np.uint8)
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a"
                       "ae2d8a571e03ac9c9eb76fac45af8e51")
    ks = t_aes.ctr_keystream(T(rk[None].copy()), T(iv[None].copy()), 2)
    ct = bytes(a ^ b for a, b in zip(pt, ks.numpy()[0].tobytes()))
    assert ct == bytes.fromhex("874d6191b620e3261bef6864990db6ce"
                               "9806f66b7970fdff8617187bb9fffdff")
    # RFC 3711 Appendix B.2 AES-CM keystream
    rk = t_aes.expand_key(bytes.fromhex("2B7E151628AED2A6ABF7158809CF4F3C"))
    iv = np.frombuffer(bytes.fromhex("F0F1F2F3F4F5F6F7F8F9FAFBFCFD0000"),
                       np.uint8)
    ks = t_aes.ctr_keystream(T(rk[None].copy()), T(iv[None].copy()), 3)
    assert ks.numpy()[0].tobytes() == bytes.fromhex(
        "E03EAD0935C95E80E166B16DD92B4EB4"
        "D23513162B02D0F72A43A2FE4A5F97AB"
        "41E95B3BB0A2E8DD477901E4FCA894C0")
    assert np.array_equal(
        t_aes.ctr_keystream_np(rk, iv, 48),
        np.asarray(j_aes.ctr_keystream(rk[None], iv[None], 3))[0])


@pytest.mark.slow          # the Pallas interpret-mode compile takes minutes
def test_plain_aes_matches_pallas_kernel_interpret_mode():
    from libjitsi_tpu.kernels.aes_bitsliced import \
        aes_encrypt_pallas_bitsliced

    rng = np.random.default_rng(9)
    rk = j_aes.expand_keys_batch(rng.integers(0, 256, (16, 16), np.uint8))
    blocks = rng.integers(0, 256, (16, 16), np.uint8)
    want = np.asarray(aes_encrypt_pallas_bitsliced(rk, blocks,
                                                   interpret=True))
    assert np.array_equal(t_aes.aes_encrypt(T(rk), T(blocks)).numpy(), want)
