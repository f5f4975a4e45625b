"""The port's SRTCP (kernels I and J, their plain versions on the CPU)
against the JAX package.

First the functions: the port's `srtcp_protect` makes the wire (E = 0
rows are made as a plaintext sender makes them, with the stdlib HMAC),
and the port's and the JAX `srtcp_unprotect` open it, a forged tag and
a tampered ciphertext among the rows; the JAX kernel authenticating the
port's rows and decrypting them to what was sent holds the port's
protect to JAX's bytes.  The port's functions take the key tables and
stream ids, the JAX ones per-row gathered keys.  Tags of 10 (tier-1) and
4 bytes and AES-256 (`slow`: each new key or tag size costs the eager
JAX side a few seconds of op compiles).  Then
the tables: the port's `protect_rtcp` → the JAX table's
`unprotect_rtcp` and the reverse, both tables adopted from one JAX
snapshot, with SRTCP indices and replay state equal afterwards, on the
80-bit-tag profile (tier-1) and the 32-bit one (`slow`).  The JAX
side runs eagerly (`jax.disable_jit`), op by op, at one shape.  Inputs are seeded numpy
arrays; tolerance: exact bytes.
"""

import hashlib
import hmac

import jax
import numpy as np
import pytest
import torch

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.kernels.aes import expand_keys_batch
from libjitsi_tpu.kernels.sha1 import hmac_precompute_batch
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu.transform.srtp import SrtpProfile
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu.transform.srtp import kernel as j_kernel
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp import kernel as t_kernel
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
# one shape for every JAX call here and in test_torch_sfu.py ([16, 224]:
# the JAX table pads batches to 16 rows, the JAX fan-out to 224 bytes),
# so the eager JAX side compiles each op once a process
N, WIDTH, STREAMS = 16, 224, 4
RTCP_STATE = ("rtcp_tx_index", "rtcp_rx_max", "rtcp_rx_mask", "auth_fail",
              "replay_reject")


@pytest.fixture(autouse=True)
def _eager_jax():
    """The JAX side runs op by op: jit-compiling each of its SRTP and
    SRTCP programs costs ~20 s on the CPU."""
    with jax.disable_jit():
        yield


def _tables(rng, key_len):
    tab_rk = expand_keys_batch(rng.integers(0, 256, (STREAMS, key_len),
                                            np.uint8))
    auth = rng.integers(0, 256, (STREAMS, 20), np.uint8)
    return tab_rk, hmac_precompute_batch(auth), auth


@pytest.mark.parametrize("key_len,tag_len", [
    (16, 10),
    # new op shapes for the eager JAX side, ~3-4 s each
    pytest.param(16, 4, marks=pytest.mark.slow),
    pytest.param(32, 10, marks=pytest.mark.slow)])
def test_srtcp_functions_match_jax_kernels(key_len, tag_len):
    rng = np.random.default_rng(key_len + tag_len)
    tab_rk, tab_mid, auth = _tables(rng, key_len)
    stream = rng.integers(0, STREAMS, N).astype(np.int32)
    data = np.zeros((N, WIDTH), np.uint8)
    length = rng.integers(8, WIDTH - 4 - tag_len, N).astype(np.int32)
    length[:3] = [8, 9, 60]                  # empty, one-byte, typical
    for i in range(N):
        data[i, :length[i]] = rng.integers(0, 256, length[i], np.uint8)
    iv = rng.integers(0, 256, (N, 16), np.uint8)
    iv[:3, 12:] = 0xFF                       # counters carry across limbs
    index = rng.integers(0, 2 ** 31, N)
    e = np.ones(N, np.int64)
    e[[1, 4, 7, 13]] = 0                     # sent unencrypted
    word = ((e << 31) | index).astype(np.uint32)
    rk, mid = tab_rk[stream], tab_mid[stream]
    kbuild.reset_counts()
    args = (T(tab_rk), T(tab_mid.view(np.int32)), T(stream))
    td, tl = t_kernel.srtcp_protect(*args, T(data), T(length), T(iv),
                                    T(word.view(np.int32)), tag_len)
    assert kbuild.plain_calls["srtcp_protect_cm"] == 1
    assert sum(kbuild.launches.values()) == 0
    assert np.array_equal(tl.numpy(), length + 4 + tag_len)

    wire = td.numpy().copy()
    wlen = tl.numpy().copy()
    wire[2, int(wlen[2]) - 1] ^= 0x01        # forged tag
    wire[3, 20] ^= 0x80                      # tampered ciphertext
    # E = 0 rows as a plaintext sender sends them: clear body, the word,
    # the tag over both (stdlib HMAC)
    for i in np.nonzero(e == 0)[0]:
        msg = data[i, :length[i]].tobytes() + int(word[i]).to_bytes(4, "big")
        tag = hmac.new(auth[stream[i]].tobytes(), msg,
                       hashlib.sha1).digest()[:tag_len]
        wire[i] = 0
        wire[i, :len(msg) + tag_len] = np.frombuffer(msg + tag, np.uint8)
    jo, jm, jok, je, ji = j_kernel.srtcp_unprotect(wire, wlen, rk, iv, mid,
                                                   tag_len)
    kbuild.reset_counts()
    to, tm, tok, te, ti = t_kernel.srtcp_unprotect(*args, T(wire), T(wlen),
                                                   T(iv), tag_len)
    assert kbuild.plain_calls["srtcp_unprotect_cm"] == 1
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert not tok[2] and not tok[3] and tok.sum() == N - 2
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(te.numpy(), np.asarray(je).astype(np.int32))
    assert np.array_equal(ti.numpy(), np.asarray(ji).astype(np.int32))
    # the JAX kernel authenticated the port's E = 1 rows and decrypted
    # them to what was sent: the port's ciphertext and tag are JAX's
    for i in np.nonzero(tok.numpy())[0]:
        assert np.array_equal(to.numpy()[i, :length[i]],
                              data[i, :length[i]])


def _compound(rng, ssrc):
    rr = j_rtcp.ReceiverReport(ssrc, [j_rtcp.ReportBlock(
        ssrc=int(rng.integers(1, 2 ** 31)), fraction_lost=13,
        cumulative_lost=2, highest_seq=1000, jitter=7, lsr=0, dlsr=0)])
    nack = j_rtcp.Nack(sender_ssrc=ssrc, media_ssrc=0x1234,
                       lost_seqs=[int(s) for s in rng.integers(0, 65536, 3)])
    return j_rtcp.build_compound([j_rtcp.build_rr(rr),
                                  j_rtcp.build_nack(nack)])


def _rtcp_batches(rng, streams):
    """The same compound RTCP rows as a port and a JAX batch, WIDTH wide."""
    blobs = [_compound(rng, 0x7000 + int(s)) for s in streams]
    return (blobs, PacketBatch.from_payloads(blobs, WIDTH, list(streams)),
            JaxBatch.from_payloads(blobs, WIDTH, list(streams)))


def _jax(b):
    return JaxBatch(np.asarray(b.data).copy(), np.asarray(b.length).copy(),
                    np.asarray(b.stream).copy())


@pytest.mark.parametrize("profile", [
    SrtpProfile.AES_CM_128_HMAC_SHA1_80,
    # SRTCP keeps the profile's 4-byte tag, as the JAX table does; new op
    # shapes for the eager JAX side (~5 s)
    pytest.param(SrtpProfile.AES_CM_128_HMAC_SHA1_32,
                 marks=pytest.mark.slow)])
def test_rtcp_tables_cross_protect_and_unprotect(profile):
    rng = np.random.default_rng(5)
    mks = rng.integers(0, 256, (STREAMS, 16), np.uint8)
    mss = rng.integers(0, 256, (STREAMS, 14), np.uint8)
    base = JaxTable(STREAMS, profile)
    base.add_streams(np.arange(STREAMS), mks, mss)
    base.rtcp_tx_index[:] = [5, 2 ** 31 - 9, -1, 70]   # index near its top
    snap = base.snapshot()
    j_tx, j_rx = JaxTable.restore(snap), JaxTable.restore(snap)
    t_tx = SrtpStreamTable.from_jax_state(snap, device="cpu")
    t_rx = SrtpStreamTable.from_jax_state(snap, device="cpu")

    def state_equal(a, b):
        for key in RTCP_STATE:
            assert np.array_equal(getattr(a, key), getattr(b, key)), key

    # two rows of one stream in a batch: sequential indices
    blobs, pb, jb = _rtcp_batches(rng, [0, 1, 1, 3, 2])
    wire_t = t_tx.protect_rtcp(pb)
    wire_j = j_tx.protect_rtcp(jb)
    assert np.array_equal(wire_t.data, np.asarray(wire_j.data))
    assert np.array_equal(wire_t.length, np.asarray(wire_j.length))
    state_equal(t_tx, j_tx)
    # the port's wire into the JAX rx table and into the port's
    tampered = wire_t.copy()
    tampered.data[4, 12] ^= 1
    dec_j, ok_j = j_rx.unprotect_rtcp(_jax(tampered))
    dec_t, ok_t = t_rx.unprotect_rtcp(tampered.copy())
    assert np.array_equal(ok_t, np.asarray(ok_j))
    assert ok_t.tolist() == [True, True, True, True, False]
    assert np.array_equal(dec_t.data, np.asarray(dec_j.data))
    assert np.array_equal(dec_t.length, np.asarray(dec_j.length))
    for i in range(4):
        assert dec_t.to_bytes(i) == blobs[i]
    state_equal(t_rx, j_rx)
    # a replay of the genuine rows: every row rejected by both
    _, ok_j = j_rx.unprotect_rtcp(_jax(wire_t))
    _, ok_t = t_rx.unprotect_rtcp(wire_t.copy())
    assert np.array_equal(ok_t, np.asarray(ok_j))
    assert ok_t.tolist() == [False] * 4 + [True]   # row 4 was tampered
    state_equal(t_rx, j_rx)
    # the reverse direction: JAX protect -> port unprotect
    blobs, _, jb = _rtcp_batches(rng, [3, 0])
    wire_j = j_tx.protect_rtcp(jb)
    dec_t, ok_t = t_rx.unprotect_rtcp(PacketBatch(
        np.asarray(wire_j.data).copy(), np.asarray(wire_j.length).copy(),
        np.asarray(wire_j.stream).copy()))
    assert ok_t.all() and [dec_t.to_bytes(i) for i in range(2)] == blobs
    tag = profile.policy.auth_tag_len
    assert wire_j.length.tolist() == [len(b) + 4 + tag for b in blobs]
