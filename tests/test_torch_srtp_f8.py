"""The port's AES-F8 and NULL SRTP profiles against the JAX package.

First the F8 keystream: the port's `f8_keystream_plain` and
`f8_crypt_plain` against the JAX `f8_keystream` / `f8_crypt_offset` and
the OpenSSL oracle `f8_keystream_np` (RFC 3711 §4.1.2, written from the
RFC separately).  Then the tables: a JAX and a port (tx, rx) pair of
`F8_128_HMAC_SHA1_80` and of `NULL_HMAC_SHA1_80` tables with the same
master keys protect and unprotect one RTP batch (a tampered row beside
genuine ones) and one SRTCP batch (a tampered row), with equal wire
bytes, decrypted bytes, accept masks and per-stream state after every
step; the replays that follow run on the port alone.  Then each
table's snapshot crosses to the other package, array for array; and
(`slow`) an F8 table adopted from a JAX snapshot by `from_jax_state`
protects the next batch exactly as the JAX table does.

The port runs on the CPU (the plain versions of kernels K, L and the F8
and NULL instances of C, D, I and J); the JAX side runs eagerly
(`jax.disable_jit`), at the JAX table's one padded shape ([16, 224]), so
its ops compile once a process.  Inputs are seeded numpy arrays;
tolerance: exact bytes.
"""

import jax
import numpy as np
import pytest
import torch

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.kernels import aes as jaes
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import aes
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
STREAMS = 4
STATE = ("tx_ext", "rx_max", "rx_mask", "rtcp_tx_index", "rtcp_rx_max",
         "rtcp_rx_mask", "auth_fail", "replay_reject")


@pytest.fixture(autouse=True)
def _eager_jax():
    """The JAX side runs op by op: jit-compiling each of its SRTP
    programs costs ~20 s on the CPU."""
    with jax.disable_jit():
        yield


def _f8_schedules(keys, salts):
    rk = np.stack([aes.expand_key(k.tobytes()) for k in keys])
    rkf = np.stack([aes.expand_key(bytes(
        a ^ b for a, b in zip(k.tobytes(), aes.f8_m(k.tobytes(),
                                                     s.tobytes()))))
        for k, s in zip(keys, salts)])
    return rk, rkf


def test_f8_keystream_matches_jax_and_openssl_oracle():
    """16 rows of 14 blocks: the shape the JAX table's F8 keystream takes
    at its [16, 224] class (224 - 12 bytes), so the eager ops are shared
    with the table test below."""
    rng = np.random.default_rng(1)
    n, nblocks = 16, 14
    keys = rng.integers(0, 256, (n, 16), np.uint8)
    salts = rng.integers(0, 256, (n, 14), np.uint8)
    ivs = rng.integers(0, 256, (n, 16), np.uint8)
    ivs[:3, 12:] = 0xFF                 # j is XORed, never carried
    rk, rkf = _f8_schedules(keys, salts)
    got = aes.f8_keystream_plain(T(rk), T(rkf), T(ivs), nblocks).numpy()
    want = np.asarray(jaes.f8_keystream(rk, rkf, ivs, nblocks))
    assert np.array_equal(got, want)
    for i in range(n):
        assert got[i].tobytes() == jaes.f8_keystream_np(
            keys[i].tobytes(), salts[i].tobytes(), ivs[i].tobytes(),
            nblocks * 16)
    # the crypt form (JAX `f8_crypt_offset` is this keystream through
    # `_xor_window_offset`): per-row windows, off a word, past the row
    data = rng.integers(0, 256, (n, 224), np.uint8)
    off = np.full(n, 12, np.int32)
    off[1], off[2], off[3] = 13, 30, 230
    ln = rng.integers(0, 224, n).astype(np.int32) - off
    got = aes.f8_crypt_plain(T(rk), T(rkf), T(ivs), T(data), T(off),
                             T(ln)).numpy()
    want = np.asarray(jaes._xor_window_offset(data, want, off, ln))
    assert np.array_equal(got, want)


class Tables:
    """A JAX (tx, rx) and a port (tx, rx) of one profile, same keys."""

    def __init__(self, profile: str, seed: int):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.mks = rng.integers(0, 256, (STREAMS, 16), np.uint8)
        self.mss = rng.integers(0, 256, (STREAMS, 14), np.uint8)
        self.jax = (JaxTable(STREAMS, JaxProfile(profile)),
                    JaxTable(STREAMS, JaxProfile(profile)))
        self.port = (SrtpStreamTable(STREAMS, SrtpProfile(profile), "cpu"),
                     SrtpStreamTable(STREAMS, SrtpProfile(profile), "cpu"))
        for t in self.jax + self.port:
            t.add_streams(np.arange(STREAMS), self.mks, self.mss)

    def check_state(self):
        for j, p in zip(self.jax, self.port):
            for f in STATE:
                assert np.array_equal(getattr(j, f), getattr(p, f)), f

    def rtp(self, seq0, n=8):
        streams = np.arange(n) % STREAMS
        pls = [self.rng.integers(0, 256, int(k), np.uint8).tobytes()
               for k in self.rng.integers(1, 170, n)]
        return j_header.build(pls, (seq0 + np.arange(n)) & 0xFFFF,
                              1000 + np.arange(n), 0xA000 + streams, 96,
                              marker=np.arange(n) % 2, stream=streams)

    def protect(self, batch):
        a = self.jax[0].protect_rtp(batch.copy())
        b = self.port[0].protect_rtp(PacketBatch(batch.data.copy(),
                                                 batch.length.copy(),
                                                 batch.stream.copy()))
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.length, b.length)
        self.check_state()
        return b

    def unprotect(self, wire):
        a, ok_a = self.jax[1].unprotect_rtp(JaxBatch(
            wire.data.copy(), wire.length.copy(), wire.stream.copy()))
        b, ok_b = self.port[1].unprotect_rtp(wire.copy())
        assert np.array_equal(ok_a, ok_b)
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.length, b.length)
        self.check_state()
        return b, ok_b

    def rtcp_roundtrip(self):
        """Three SRs and an RR through both tx tables, then both rx
        tables with one tampered row; then the port's rx alone sees the
        batch again (a replay).  Rows of the RTP part's width, so the
        eager JAX side reuses the RTP part's compiled shapes."""
        sr = [bytes([0x80, 200, 0, 6]) + (0x1234 + i).to_bytes(4, "big")
              + self.rng.integers(0, 256, 24, np.uint8).tobytes()
              for i in range(3)]
        rr = bytes([0x80, 201, 0, 1]) + (0x99).to_bytes(4, "big")
        blobs = sr + [rr]
        batch = PacketBatch.from_payloads(blobs, capacity=224,
                                          stream=[0, 1, 2, 3])
        a = self.jax[0].protect_rtcp(JaxBatch(
            batch.data.copy(), batch.length.copy(), batch.stream.copy()))
        b = self.port[0].protect_rtcp(batch.copy())
        assert np.array_equal(a.length, b.length)
        assert np.array_equal(a.data, b.data)
        self.check_state()
        wire = b.copy()
        wire.data[1, 10] ^= 0x20                  # tampered
        da, oka = self.jax[1].unprotect_rtcp(JaxBatch(
            wire.data.copy(), wire.length.copy(), wire.stream.copy()))
        db, okb = self.port[1].unprotect_rtcp(wire.copy())
        assert oka.tolist() == okb.tolist() == [True, False, True, True]
        assert np.array_equal(da.data, db.data)
        assert [db.to_bytes(i) for i in (0, 2, 3)] == [blobs[i]
                                                       for i in (0, 2, 3)]
        self.check_state()
        _, ok = self.port[1].unprotect_rtcp(b.copy())      # replayed
        assert ok.tolist() == [False, True, False, False]
        assert self.port[1].replay_reject.tolist() == [1, 0, 1, 1]
        return b


@pytest.mark.parametrize("profile", ["F8_128_HMAC_SHA1_80",
                                     "NULL_HMAC_SHA1_80"])
def test_profile_tables_match_jax(profile):
    """RTP and SRTCP byte-equal to the JAX tables, with a tamper and a
    replay; then the snapshots both ways, array for array: the port
    adopts the JAX tx table's (`from_jax_state`) and the JAX table
    restores the port's."""
    p = Tables(profile, 5)
    plain = p.rtp(65533)                 # the ROC wraps inside the batch
    wire = p.protect(plain)
    if profile.startswith("F8"):
        # ciphertext differs from plaintext; the 12-byte header stays
        assert wire.data[0, 12:20].tobytes() != plain.data[0, 12:20].tobytes()
    else:
        n = int(plain.length[0])
        assert wire.to_bytes(0)[:n] == plain.to_bytes(0)
    tampered = wire.copy()
    tampered.data[5, 13] ^= 0x01
    dec, ok = p.unprotect(tampered)
    assert ok.tolist() == [True] * 5 + [False] + [True] * 2
    assert all(dec.to_bytes(i) == plain.to_bytes(i) for i in range(8)
               if i != 5)
    wire_rtcp = p.rtcp_roundtrip()
    _, ok = p.port[1].unprotect_rtp(wire)  # replays; row 5 now genuine
    assert ok.tolist() == [False] * 5 + [True] + [False] * 2
    # the SRTCP E bit: set under F8, clear under NULL (RFC 3711 §3.4)
    e = wire_rtcp.data[0, int(wire_rtcp.length[0]) - 14] >> 7
    assert e == (1 if profile.startswith("F8") else 0)
    snap = p.jax[0].snapshot()
    if profile.startswith("F8"):
        assert snap["rk_f8_rtp"].shape == (STREAMS, 11, 16)
    adopted = SrtpStreamTable.from_jax_state(snap, "cpu")
    for table_a, table_b in ((adopted, p.jax[0]),
                             (JaxTable.restore(p.port[1].snapshot()),
                              p.port[1])):
        a, b = table_a.snapshot(), table_b.snapshot()
        assert a.keys() == b.keys() and a["masters"] == b["masters"] == {}
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(b[k], v), k


@pytest.mark.slow        # a second JAX-side F8 case: ~3 s of eager ops
def test_f8_table_adopted_from_jax_protects_the_next_batch_alike():
    p = Tables("F8_128_HMAC_SHA1_80", 6)
    p.protect(p.rtp(100))
    adopted = SrtpStreamTable.from_jax_state(p.jax[0].snapshot(), "cpu")
    nxt = p.rtp(108)
    a = p.jax[0].protect_rtp(nxt.copy())
    b = adopted.protect_rtp(PacketBatch(nxt.data.copy(), nxt.length.copy(),
                                        nxt.stream.copy()))
    assert np.array_equal(a.data, b.data)
