"""The port's SRTP protect/unprotect functions against the JAX kernels.

On CPU tensors `srtp_protect` / `srtp_unprotect` run the plain versions
of kernels C and D; they take the key tables plus stream ids, where the
JAX `srtp_protect` / `srtp_unprotect` take per-row gathered keys, so the
test gathers for the JAX side.  Rows include mixed payload offsets
(CSRC lists, header extensions, a forged offset past the row), payloads
shorter than the window, and tampered tags.  Valid rows must match
whole outputs; rows shorter than their tag must fail authentication
(the SRTP table's contract), whatever the JAX kernel computes for them.
Inputs are seeded numpy arrays; tolerance: exact equality.
"""

import numpy as np
import torch

from libjitsi_tpu.kernels.aes import expand_keys_batch
from libjitsi_tpu.kernels.sha1 import hmac_precompute_batch
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import kernel as j_kernel
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp import kernel as t_kernel
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
N, WIDTH = 16, 224


def _inputs(rng, key_len, streams=5):
    tab_rk = expand_keys_batch(rng.integers(0, 256, (streams, key_len),
                                            np.uint8))
    tab_mid = hmac_precompute_batch(rng.integers(0, 256, (streams, 20),
                                                 np.uint8))
    stream = rng.integers(0, streams, N).astype(np.int32)
    payloads = [rng.integers(0, 256, k, np.uint8).tobytes()
                for k in rng.integers(0, 170, N)]
    csrcs = [list(range(k)) for k in rng.integers(0, 3, N)]
    ext = [None if k % 3 else (0xBEDE, b"\x10\x01\x02") for k in range(N)]
    b = j_header.build(payloads, np.arange(N), 0, 9, 96, csrcs=csrcs,
                       ext=ext, capacity=WIDTH)
    off = j_header.parse(b).payload_off.astype(np.int32)
    off[3] = WIDTH + 8                # forged header length past the row
    iv = rng.integers(0, 256, (N, 16), np.uint8)
    iv[:4, 8:] = 0xFF                 # counters carry across 32-bit limbs
    roc = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    return tab_rk, tab_mid, stream, b.data, b.length, off, iv, roc


def _port_args(tab_rk, tab_mid, stream, data, length, off, iv, roc):
    return (T(tab_rk), T(tab_mid.view(np.int32)), T(stream), T(data),
            T(length.astype(np.int32)), T(off), T(iv), T(roc.view(np.int32)))


def test_protect_and_unprotect_match_jax_kernels():
    rng = np.random.default_rng(21)
    tab_rk, tab_mid, stream, data, length, off, iv, roc = _inputs(rng, 16)
    rk, mid = tab_rk[stream], tab_mid[stream]
    jd, jl = j_kernel.srtp_protect(data, length, off, rk, iv, mid, roc, 10)
    kbuild.reset_counts()
    td, tl = t_kernel.srtp_protect(
        *_port_args(tab_rk, tab_mid, stream, data, length, off, iv, roc), 10)
    assert kbuild.plain_calls["srtp_protect_cm"] == 1
    assert sum(kbuild.launches.values()) == 0
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tl.numpy(), np.asarray(jl))

    wire = td.numpy().copy()
    wire[1, 20] ^= 0x40                       # tampered payload
    wire[2, int(tl[2]) - 1] ^= 1               # tampered tag
    wlen = tl.numpy().copy()
    wlen[4] = 7                               # shorter than its tag
    jo, jm, jok = j_kernel.srtp_unprotect(wire, wlen, off, rk, iv, mid, roc,
                                          10)
    to, tm, tok = t_kernel.srtp_unprotect(
        *_port_args(tab_rk, tab_mid, stream, wire, wlen, off, iv, roc), 10)
    valid = wlen >= 10
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tok.numpy()[valid], np.asarray(jok)[valid])
    assert not tok.numpy()[~valid].any()
    assert np.array_equal(to.numpy()[valid], np.asarray(jo)[valid])
    ok = tok.numpy()
    assert not ok[1] and not ok[2] and ok[valid].sum() == valid.sum() - 2
    # decrypted payloads are the originals; tag bytes stay past mlen
    assert np.array_equal(to.numpy()[0, :length[0]], data[0, :length[0]])
    assert np.array_equal(to.numpy()[0, length[0]:length[0] + 10],
                          wire[0, length[0]:length[0] + 10])


def test_aes256_tag32_port_wire_authenticates_under_jax():
    """AES-256 / 32-bit tags: the port's protected rows authenticate and
    decrypt under the JAX unprotect, and both unprotects agree."""
    rng = np.random.default_rng(22)
    tab_rk, tab_mid, stream, data, length, off, iv, roc = _inputs(rng, 32)
    td, tl = t_kernel.srtp_protect(
        *_port_args(tab_rk, tab_mid, stream, data, length, off, iv, roc), 4)
    wire = td.numpy().copy()
    wire[6, 30] ^= 1
    rk, mid = tab_rk[stream], tab_mid[stream]
    jo, jm, jok = j_kernel.srtp_unprotect(wire, tl.numpy(), off, rk, iv,
                                          mid, roc, 4)
    to, tm, tok = t_kernel.srtp_unprotect(
        *_port_args(tab_rk, tab_mid, stream, wire, tl.numpy(), off, iv, roc),
        4)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    want = np.ones(N, bool)
    want[6] = False
    assert np.array_equal(tok.numpy(), want)
    for i in np.nonzero(want)[0]:
        assert np.array_equal(to.numpy()[i, :length[i]], data[i, :length[i]])
