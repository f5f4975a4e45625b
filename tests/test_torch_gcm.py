"""The port's AEAD_AES_128_GCM (RFC 7714) against the JAX package.

First the functions (`libjitsi_tpu_torch/kernels/gcm.py` and the table
wrappers of `transform/srtp/kernel.py`, whose CPU route is the plain
version of kernels M and N): seal and open against the JAX `gcm_protect`
/ `gcm_unprotect` with per-row AADs and with `aad_const`, against the
grouped (`gcm_protect_grouped`) and cached (`gcm_protect_cached`)
forms, against `cryptography`'s AESGCM and the OpenSSL oracle's
`gcm_seal`; RFC 7714 §16.1.1; a tampered tag, ciphertext or AAD
refused; ct_len 0.  Then the tables: a JAX and a port GCM (tx, rx) pair
with the same master keys, batch for batch: sync and async RTP, SRTCP,
a ROC wrap, a replay, `snapshot` -> `from_jax_state`, `move_rows` and
`remove_streams`, with equal wire bytes, decrypted bytes, accept masks
and per-stream state; and twins of `tests/test_gcm.py`'s table cases,
the grouped-vs-per-row one included: the port's one path equals both
JAX paths.  The JAX side runs eagerly (`jax.disable_jit`).  Inputs are
seeded numpy arrays; tolerance: exact bytes.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.kernels import gcm as jgcm
from libjitsi_tpu.kernels import ghash as jghash
from libjitsi_tpu.native import oracle as joracle
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import aes, gcm, ghash
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp import kernel as sk
from libjitsi_tpu_torch.transform.srtp.context import (SrtpStreamTable,
                                                       ghash_tables)
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
GCM = SrtpProfile.AEAD_AES_128_GCM
STATE = ("tx_ext", "rx_max", "rx_mask", "rtcp_tx_index", "rtcp_rx_max",
         "rtcp_rx_mask", "auth_fail", "replay_reject")
RFC_KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
RFC_SALT = bytes.fromhex("517569642070726f2071756f")
RFC_PKT = bytes.fromhex("8040f17b8041f8d35501a0b247616c6c"
                        "696120657374206f6d6e697320646976"
                        "69736120696e207061727465732074726573")
RFC_WIRE = bytes.fromhex("8040f17b8041f8d35501a0b2f24de3a3"
                         "fb34de6cacba861c9d7e4bcabe633bd5"
                         "0d294e6f42a5f47a51c7d19b36de3adf"
                         "8833899d7f27beb16a9152cf765ee439"
                         "0cce")


@pytest.fixture(autouse=True)
def _eager_jax():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def gcm_seal_oracle(tmp_path_factory):
    """The JAX package's OpenSSL oracle (`libjitsi_tpu/native/oracle.py`
    `gcm_seal`), built from its source into this module's own directory:
    `oracle._load` builds into the package directory in place, which a
    concurrent test process may have mapped."""
    native = os.path.dirname(joracle.__file__)
    so = str(tmp_path_factory.mktemp("oracle") / "libcrypto_oracle.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", so,
                    os.path.join(native, "crypto_oracle.cpp"),
                    "/usr/lib/x86_64-linux-gnu/libcrypto.so.3"],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.oracle_gcm_seal.restype = ctypes.c_int
    lib.oracle_gcm_seal.argtypes = [u8p, u8p, u8p, ctypes.c_int, u8p,
                                    ctypes.c_int, u8p, u8p]

    def seal(key, iv12, aad, pt):
        ct = (ctypes.c_uint8 * max(1, len(pt)))()
        tag = (ctypes.c_uint8 * 16)()
        assert lib.oracle_gcm_seal(
            joracle._buf(key), joracle._buf(iv12), joracle._buf(aad),
            len(aad), joracle._buf(pt), len(pt), ct, tag) == 0
        return bytes(ct[:len(pt)]), bytes(tag)

    return seal


def _rows(rng, n, width, aads):
    """n rows: random keys, IVs, per-row AADs, lengths that leave tag room
    (a ct_len 0 row first)."""
    keys = rng.integers(0, 256, (n, 16), np.uint8)
    rk = aes.expand_keys_batch(keys)
    aad = np.asarray(aads, np.int32)
    length = (aad + rng.integers(0, width - 16 - aad.max() + 1, n)).astype(
        np.int32)
    length[0] = aad[0]
    data = rng.integers(0, 256, (n, width), np.uint8)
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    return keys, rk, data, length, aad, iv12


def _jax_gm(rk):
    h = aes.aes_encrypt_np(rk, np.zeros((len(rk), 16), np.uint8))
    return jghash.ghash_matrix_batch(h).astype(np.int8)


@pytest.mark.parametrize("aad_const", [None, 12])
def test_seal_and_open_equal_jax_cryptography_and_oracle(aad_const,
                                                        gcm_seal_oracle):
    rng = np.random.default_rng(3 if aad_const else 4)
    n, width = 9, 160
    aads = [12] * n if aad_const else [12, 8, 13, 28, 60, 12, 20, 12, 44]
    keys, rk, data, length, aad, iv12 = _rows(rng, n, width, aads)
    gm_j = _jax_gm(rk)
    gm = ghash.pack_matrices(gm_j).view(np.int32)
    out, out_len = gcm.gcm_protect(T(data), T(length), T(aad), T(rk), T(gm),
                                   T(iv12))
    j_out, j_len = jgcm.gcm_protect(data, length, aad, jnp.asarray(rk),
                                    jnp.asarray(gm_j), jnp.asarray(iv12),
                                    aad_const=aad_const)
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    assert np.array_equal(out_len.numpy(), np.asarray(j_len))
    for i in range(n):
        a, ln = int(aad[i]), int(length[i])
        ct = AESGCM(bytes(keys[i])).encrypt(bytes(iv12[i]),
                                            bytes(data[i, a:ln]),
                                            bytes(data[i, :a]))
        assert bytes(out[i, :ln + 16].numpy()) == bytes(data[i, :a]) + ct
        o_ct, o_tag = gcm_seal_oracle(bytes(keys[i]), bytes(iv12[i]),
                                      bytes(data[i, :a]),
                                      bytes(data[i, a:ln]))
        assert o_ct + o_tag == ct
    dec, mlen, ok = gcm.gcm_unprotect(out, out_len, T(aad), T(rk), T(gm),
                                      T(iv12))
    j_dec, j_mlen, j_ok = jgcm.gcm_unprotect(
        np.asarray(j_out), np.asarray(j_len), aad, jnp.asarray(rk),
        jnp.asarray(gm_j), jnp.asarray(iv12), aad_const=aad_const)
    assert ok.all() and np.array_equal(ok.numpy(), np.asarray(j_ok))
    assert np.array_equal(dec.numpy(), np.asarray(j_dec))
    assert np.array_equal(mlen.numpy(), np.asarray(j_mlen))
    assert np.array_equal(np.where(np.arange(width) < length[:, None],
                                   dec.numpy(), 0),
                          np.where(np.arange(width) < length[:, None],
                                   data, 0))


def test_grouped_and_cached_jax_forms_equal_the_ports_one_path():
    """JAX's grouped seal (one matrix a stream group) and its cached seal
    (keystream and tag masks given) give the same bytes as the port's
    `gcm_protect` and `gcm_protect_cached`."""
    rng = np.random.default_rng(9)
    n, width, s = 12, 128, 3
    keys = rng.integers(0, 256, (s, 16), np.uint8)
    rk_s = aes.expand_keys_batch(keys)
    stream = np.repeat(np.arange(s), n // s)
    rk = rk_s[stream]
    gm_j = _jax_gm(rk_s)
    gm = ghash.pack_matrices(gm_j).view(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = (12 + rng.integers(0, 90, n)).astype(np.int32)
    aad = np.full(n, 12, np.int32)
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    mine, mine_len = gcm.gcm_protect(T(data), T(length), T(aad), T(rk),
                                     T(gm[stream]), T(iv12))
    grid = np.arange(n, dtype=np.int32).reshape(s, n // s)
    inv = np.arange(n, dtype=np.int32)
    g_out, g_len = jgcm.gcm_protect_grouped(
        data, length, aad, jnp.asarray(rk), jnp.asarray(gm_j),
        jnp.asarray(iv12), jnp.asarray(grid), jnp.asarray(inv), aad_const=12)
    assert np.array_equal(mine.numpy(), np.asarray(g_out))
    assert np.array_equal(mine_len.numpy(), np.asarray(g_len))
    j0 = gcm.j0_blocks(T(iv12))
    ks = aes.ctr_keystream(T(rk), gcm.inc32(j0), 16)
    ek = aes.aes_encrypt_plain(T(rk), j0)
    c_out, _ = gcm.gcm_protect_cached(T(data), T(length), T(aad), ks, ek,
                                      T(gm[stream]))
    jc_out, _ = jgcm.gcm_protect_cached(
        data, length, ks.numpy(), ek.numpy(), jnp.asarray(gm_j[stream]),
        aad_const=12)
    assert np.array_equal(c_out.numpy(), np.asarray(jc_out))
    assert np.array_equal(c_out.numpy(), mine.numpy())
    jd, _, jok = jgcm.gcm_unprotect_cached(
        np.asarray(jc_out), length + 16, ks.numpy(), ek.numpy(),
        jnp.asarray(gm_j[stream]), aad_const=12)
    pd, _, pok = gcm.gcm_unprotect_cached(
        c_out, T(length + 16), T(aad), ks, ek, T(gm[stream]))
    assert np.asarray(jok).all() and pok.all()
    assert np.array_equal(pd.numpy(), np.asarray(jd))


def test_rfc7714_vector_and_tampering():
    """RFC 7714 §16.1.1 through the table wrappers (M and N's CPU route),
    then a flipped bit in the tag, the ciphertext and the AAD each
    refused, and a ct_len 0 row sealed and opened."""
    rk = aes.expand_key(RFC_KEY)[None]
    gm = T(ghash_tables(rk).view(np.int32))
    iv = gcm.srtp_gcm_iv(np.frombuffer(RFC_SALT, np.uint8)[None],
                         [int.from_bytes(RFC_PKT[8:12], "big")],
                         [int.from_bytes(RFC_PKT[2:4], "big")])
    n = 5
    data = np.zeros((n, 96), np.uint8)
    data[:, :len(RFC_PKT)] = np.frombuffer(RFC_PKT, np.uint8)
    length = np.full(n, len(RFC_PKT), np.int32)
    length[4] = 12                                  # ct_len 0
    args = (T(rk), gm, T(np.zeros(n, np.int32)))
    aad, ivs = T(np.full(n, 12, np.int32)), T(np.repeat(iv, n, 0))
    out, out_len = sk.srtp_gcm_protect(*args, T(data), T(length), aad, ivs)
    assert bytes(out[0, :int(out_len[0])].numpy()) == RFC_WIRE
    wire = out.clone()
    wire[1, len(RFC_WIRE) - 3] ^= 1                 # tag
    wire[2, 20] ^= 1                                # ciphertext
    wire[3, 5] ^= 1                                 # AAD
    dec, mlen, ok = sk.srtp_gcm_unprotect(*args, wire, out_len, aad, ivs)
    assert ok.tolist() == [True, False, False, False, True]
    assert bytes(dec[0, :int(mlen[0])].numpy()) == RFC_PKT
    assert int(mlen[4]) == 12 and int(out_len[4]) == 28


# ------------------------------------------------------------ the tables

def _pair(cls, n, profile, **kw):
    rng = np.random.default_rng(77)
    keys = rng.integers(0, 256, (n, 16), np.uint8)
    salts = rng.integers(0, 256, (n, 12), np.uint8)
    out = []
    for _ in range(2):
        t = cls(capacity=n, profile=profile, **kw)
        t.add_streams(np.arange(n), keys, salts)
        out.append(t)
    return out


def _rtp(seqs, streams, seed, ext=False):
    rng = np.random.default_rng(seed)
    pls = [rng.integers(0, 256, int(k), np.uint8).tobytes()
           for k in rng.integers(0, 120, len(seqs))]
    kw = {}
    if ext:
        kw["ext"] = [(0xBEDE, bytes([0x32, 1, 2, 3]))] * len(seqs)
    b = j_header.build(pls, list(seqs), [0] * len(seqs),
                       [0x3000 + int(s) for s in streams], [96] * len(seqs),
                       stream=[int(s) for s in streams], **kw)
    return b, PacketBatch(b.data.copy(), np.asarray(b.length).copy(),
                          np.asarray(b.stream).copy())


def _same_batch(jb, tb):
    assert np.array_equal(np.asarray(jb.length), tb.length)
    assert np.array_equal(np.asarray(jb.data), tb.data)


def _same_state(jt, tt):
    for f in STATE:
        assert np.array_equal(getattr(jt, f), getattr(tt, f)), f


def test_gcm_table_equals_jax_table_batch_for_batch():
    n = 4
    jtx, jrx = _pair(JaxTable, n, JaxProfile.AEAD_AES_128_GCM)
    ttx, trx = _pair(SrtpStreamTable, n, GCM, device="cpu")
    # a ROC wrap, mixed AADs (one batch carries a header extension), a
    # tampered row and a replay
    cases = [([65534, 65535, 0, 1, 7], [0, 0, 0, 0, 1], False),
             ([2, 8, 9, 3], [0, 1, 1, 2], True)]
    for k, (seqs, streams, ext) in enumerate(cases):
        jb, tb = _rtp(seqs, streams, k, ext)
        jw, tw = jtx.protect_rtp(jb), ttx.protect_rtp(tb)
        _same_batch(jw, tw)
        if k == 1:
            for w in (jw, tw):
                w.data[1, int(w.length[1]) - 1] ^= 0x10     # its tag
        (jd, jok), (td, tok) = jrx.unprotect_rtp(jw), trx.unprotect_rtp(tw)
        assert np.array_equal(jok, tok)
        _same_batch(jd, td)
        _same_state(jrx, trx)
        _same_state(jtx, ttx)
    # (the size-class padding repeats the tampered row: counted again)
    assert trx.rx_max[0] == (1 << 16) + 2 and trx.auth_fail[1] >= 1
    # SRTCP: E || index after the tag, AAD = header || word
    sr = j_rtcp.build_sr(j_rtcp.SenderReport(0x77, 1, 2, 3, 4, 5, []))
    jc = JaxBatch.from_payloads([sr, sr, sr + b"\x00" * 8], stream=[0, 1, 0],
                                capacity=192)
    tc = PacketBatch(jc.data.copy(), np.asarray(jc.length).copy(),
                     np.asarray(jc.stream).copy())
    jw, tw = jtx.protect_rtcp(jc), ttx.protect_rtcp(tc)
    _same_batch(jw, tw)
    assert np.all(tw.length == tc.length + 16 + 4)
    (jd, jok), (td, tok) = jrx.unprotect_rtcp(jw), trx.unprotect_rtcp(tw)
    assert tok.all() and np.array_equal(jok, tok)
    _same_batch(jd, td)
    _same_state(jrx, trx)
    _same_state(jtx, ttx)
    # (the port alone from here) the SRTCP wire again, and the first RTP
    # batch's: every row a replay
    assert not trx.unprotect_rtcp(tw)[1].any()
    tw = ttx.protect_rtp(_rtp(*cases[0][:2], 0)[1])
    assert not trx.unprotect_rtp(tw)[1].any()


def test_gcm_async_seams_equal_sync_and_jax():
    n = 4
    jtx, jrx = _pair(JaxTable, n, JaxProfile.AEAD_AES_128_GCM)
    ttx, trx = _pair(SrtpStreamTable, n, GCM, device="cpu")
    batches = [_rtp([10 + 2 * k, 11 + 2 * k, 10 + k], [0, 0, 2], 20 + k)
               for k in range(3)]
    pend = [ttx.protect_rtp_async(tb) for _, tb in batches]
    for (jb, _), p in zip(batches, pend):
        jw, tw = jtx.protect_rtp(jb), p.result()
        _same_batch(jw, tw)
        jd, jok = jrx.unprotect_rtp(jw)
        td, tok = trx.unprotect_rtp_async(tw).result()
        assert tok.all() and np.array_equal(jok, tok)
        _same_batch(jd, td)
    trx.commit_inflight()
    _same_state(jrx, trx)


def test_gcm_snapshot_crosses_to_the_port_and_moves_and_removes():
    """A JAX GCM table's snapshot (its [S, 128, 128] int8 matrices) is
    adopted by `from_jax_state`, and both tables then process the next
    batch identically; the port's snapshot gives the JAX format back.
    Then `remove_streams` and `move_rows` on both."""
    n = 4
    jtx, jrx = _pair(JaxTable, n, JaxProfile.AEAD_AES_128_GCM)
    jb, tb = _rtp([5, 6, 7], [0, 1, 2], 31)
    jw = jtx.protect_rtp(jb)
    jrx.unprotect_rtp(jw)
    snaps = (jtx.snapshot(), jrx.snapshot())
    ttx, trx = (SrtpStreamTable.from_jax_state(s, device="cpu")
                for s in snaps)
    for mine, theirs in ((ttx.snapshot(), snaps[0]),
                         (trx.snapshot(), snaps[1])):
        for key, val in theirs.items():
            if key not in ("profile", "masters"):
                assert np.array_equal(np.asarray(val), mine[key]), key
    jb, tb = _rtp([8, 9, 5], [0, 1, 0], 32)
    jw, tw = jtx.protect_rtp(jb), ttx.protect_rtp(tb)
    _same_batch(jw, tw)
    (jd, jok), (td, tok) = jrx.unprotect_rtp(jw), trx.unprotect_rtp(tw)
    assert np.array_equal(jok, tok) and jok.tolist() == [True, True, False]
    _same_batch(jd, td)
    for t in (jtx, jrx, ttx, trx):
        t.remove_streams([2, 3])
        t.move_rows([0, 1], [2, 3])
    jb, tb = _rtp([10, 11, 12], [2, 3, 2], 33)
    jw, tw = jtx.protect_rtp(jb), ttx.protect_rtp(tb)
    _same_batch(jw, tw)
    (jd, jok), (td, tok) = jrx.unprotect_rtp(jw), trx.unprotect_rtp(tw)
    assert tok.all() and np.array_equal(jok, tok)
    _same_batch(jd, td)
    _same_state(jrx, trx)
    for t in (ttx, trx):
        assert not t._gm_rtp[[0, 1]].any() and t._gm_rtp[2].any()
    with pytest.raises(KeyError):
        ttx.protect_rtp(_rtp([1], [0], 34)[1])


# ------------------------------------- twins of tests/test_gcm.py's tables

def _twin_tables(n=4):
    tabs = []
    for _ in range(2):
        t = SrtpStreamTable(capacity=n, profile=GCM, device="cpu")
        for i in range(n):
            t.add_stream(i, bytes(range(16)), bytes(range(100, 112)))
        tabs.append(t)
    return tabs


def _twin_batch(seqs, ssrc=0x4242, stream=0):
    b = j_header.build([b"gcm-payload-%02d" % s for s in seqs], list(seqs),
                       [0] * len(seqs), [ssrc] * len(seqs), [96] * len(seqs),
                       stream=[stream] * len(seqs))
    return PacketBatch(b.data.copy(), np.asarray(b.length).copy(),
                       np.asarray(b.stream).copy())


def test_twin_table_roundtrip_replay_tamper_and_wrap():
    tx, rx = _twin_tables()
    b = _twin_batch(range(100, 108))
    wire = tx.protect_rtp(b)
    assert np.all(wire.length == b.length + 16)
    dec, ok = rx.unprotect_rtp(wire)
    assert ok.all() and dec.to_payloads() == b.to_payloads()
    assert not rx.unprotect_rtp(wire)[1].any()
    bad = tx.protect_rtp(_twin_batch([200]))
    bad.data[0, 20] ^= 1
    assert not rx.unprotect_rtp(bad)[1].any()
    tx, rx = _twin_tables()
    seqs = [65534, 65535, 0, 1]
    dec, ok = rx.unprotect_rtp(tx.protect_rtp(_twin_batch(seqs, 0x99)))
    assert ok.all() and rx.rx_max[0] == (1 << 16) + 1


def test_twin_table_one_path_equals_jax_grouped_and_per_row():
    """tests/test_gcm.py's grouped-vs-per-row case: the JAX table's
    grouped and per-row paths, pinned through its registry, and the
    port's one path give the same wire on a mixed-stream batch that forms
    the JAX grouping grid (kernel M's CPU route), and the port opens it."""
    from libjitsi_tpu.kernels import registry
    from libjitsi_tpu.transform.srtp import context as jctx

    n_streams, per = 8, 6
    rng = np.random.default_rng(5)
    streams = np.repeat(np.arange(n_streams), per)
    rng.shuffle(streams)
    seqs = np.zeros(len(streams), np.int64)
    for s in range(n_streams):
        rows = np.nonzero(streams == s)[0]
        seqs[rows] = 100 + np.arange(len(rows))
    pls = [rng.integers(0, 256, int(rng.integers(8, 60)), np.uint8).tobytes()
           for _ in streams]
    jb = j_header.build(pls, list(seqs), [0] * len(streams),
                        [0x1000 + int(s) for s in streams],
                        [96] * len(streams), stream=list(streams))
    tb = PacketBatch(jb.data.copy(), np.asarray(jb.length).copy(),
                     np.asarray(jb.stream).copy())
    assert jctx._gcm_grid(np.asarray(streams, np.int64)) is not None
    keys = (bytes(range(16)), bytes(range(100, 112)))
    wires = {}
    mk = np.tile(np.frombuffer(keys[0], np.uint8), (n_streams, 1))
    ms = np.tile(np.frombuffer(keys[1], np.uint8), (n_streams, 1))
    try:
        for path in ("grouped", "per_row"):
            registry.force("gcm_rtp_protect", path)
            jt = JaxTable(capacity=n_streams,
                          profile=JaxProfile.AEAD_AES_128_GCM)
            jt.add_streams(np.arange(n_streams), mk, ms)
            wires[path] = jt.protect_rtp(jb)
    finally:
        registry.force("gcm_rtp_protect", None)
    tx, rx = _twin_tables(n_streams)
    mine = tx.protect_rtp(tb)
    for path, w in wires.items():
        _same_batch(w, mine)
    before = kbuild.plain_calls["srtp_gcm_open"]
    dec, ok = rx.unprotect_rtp(mine)
    assert ok.all() and dec.to_payloads() == tb.to_payloads()
    assert kbuild.plain_calls["srtp_gcm_open"] > before
