"""The port's SrtpStreamTable against the JAX SrtpStreamTable.

Both tables get the same master keys; every batch is protected by both
tx tables and unprotected by both rx tables, and the test asserts equal
wire bytes, decrypted bytes, lengths, accept masks and per-stream state
(tx_ext, rx_max, rx_mask, auth_fail, replay_reject) after every step.
Scenarios: ROC wrap, the replay window, in-batch duplicates, a forged
front-runner, multi-stream isolation, tampered rows, and adopting the
JAX table's snapshot mid-stream.  The port runs on the CPU (the plain
versions of kernels C and D).  To bound JAX compile time every tier-1
batch is one width class (payloads <= 180 bytes) of <= 16 rows, so all
tests share one compiled protect and one unprotect; the mixed-class run
is marked slow.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

CAP = 8
STATE = ("tx_ext", "rx_max", "rx_mask", "auth_fail", "replay_reject")


class Pair:
    """A JAX (tx, rx) and a port (tx, rx) holding the same streams."""

    def __init__(self, seed=0, n_streams=CAP):
        rng = np.random.default_rng(seed)
        self.mks = rng.integers(0, 256, (n_streams, 16), np.uint8)
        self.mss = rng.integers(0, 256, (n_streams, 14), np.uint8)
        sids = np.arange(n_streams)
        self.jax = (JaxTable(CAP), JaxTable(CAP))
        self.port = (SrtpStreamTable(CAP, device="cpu"),
                     SrtpStreamTable(CAP, device="cpu"))
        for t in self.jax + self.port:
            t.add_streams(sids, self.mks, self.mss)
        self.rng = rng

    def protect(self, batch):
        a = self.jax[0].protect_rtp(batch.copy())
        b = self.port[0].protect_rtp(batch.copy())
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.length, b.length)
        self.check_state()
        return b

    def unprotect(self, wire):
        a, ok_a = self.jax[1].unprotect_rtp(wire.copy())
        b, ok_b = self.port[1].unprotect_rtp(wire.copy())
        assert np.array_equal(ok_a, ok_b)
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.length, b.length)
        self.check_state()
        return b, ok_b

    def check_state(self):
        for j, p in zip(self.jax, self.port):
            for f in STATE:
                assert np.array_equal(getattr(j, f), getattr(p, f)), f


def rtp(rng, streams, seqs, sizes=(20, 100, 170)):
    streams = np.asarray(streams)
    pls = [rng.integers(0, 256, int(rng.choice(sizes)), np.uint8).tobytes()
           for _ in streams]
    return j_header.build(pls, np.asarray(seqs) & 0xFFFF, 0,
                          0xA000 + streams, 96, stream=streams)


def test_roc_wrap_across_batches():
    p = Pair(1)
    seq = 65530
    for _ in range(3):
        streams = np.array([0, 1, 0, 1, 2, 0])
        seqs = seq + np.array([0, 0, 1, 1, 0, 2])
        wire = p.protect(rtp(p.rng, streams, seqs))
        dec, ok = p.unprotect(wire)
        assert ok.all()
        seq += 3
    assert (p.port[1].rx_max[:2] >> 16 == 1).all()      # ROC advanced


def test_replay_window_and_in_batch_duplicates():
    p = Pair(2)
    wire = p.protect(rtp(p.rng, [0] * 12, 100 + np.arange(12)))
    # in-batch duplicate of row 3, out of order inside the window
    rows = np.array([5, 3, 3, 0, 11, 1])
    first = type(wire)(wire.data[rows], wire.length[rows], wire.stream[rows])
    _, ok = p.unprotect(first)
    assert ok.tolist() == [True, True, False, True, True, True]
    _, ok = p.unprotect(wire)                     # replays of seen rows
    assert ok.tolist() == [False, False, True, False, True, False,
                           True, True, True, True, True, False]
    _, ok = p.unprotect(wire)                     # the whole batch again
    assert not ok.any()
    _, ok = p.unprotect(p.protect(rtp(p.rng, [0], [182])))
    assert ok.all()
    # never seen, but 67 behind the leading edge: outside the window
    _, ok = p.unprotect(p.protect(rtp(p.rng, [0, 0], [115, 150])))
    assert ok.tolist() == [False, True]


def test_forged_front_runner_does_not_block_genuine_copy():
    p = Pair(3)
    wire = p.protect(rtp(p.rng, [4, 4], [7, 8]))
    forged = wire.copy()
    forged.data[0, int(forged.length[0]) - 1] ^= 0xFF     # bad tag
    rows = np.array([0, 0, 1])
    mixed = type(wire)(np.concatenate([forged.data[:1], wire.data[rows[1:]]]),
                       wire.length[rows].copy(), wire.stream[rows].copy())
    dec, ok = p.unprotect(mixed)
    assert ok.tolist() == [False, True, True]
    # bucket padding repeats the forged row, so the count exceeds 1
    # (the JAX table counts the same: check_state compared them)
    assert p.port[1].auth_fail[4] >= 1


def test_multi_stream_isolation_and_tampered_rows():
    p = Pair(4)
    streams = np.arange(CAP).repeat(2)
    plain = rtp(p.rng, streams, 50 + np.arange(16))
    wire = p.protect(plain)
    wire.stream[3] = 5                  # stream 1's packet under 5's keys
    wire.data[8, 12] ^= 1               # payload byte
    wire.data[10, 2] ^= 1               # header byte (seq)
    wire.stream[12] = -1                # unmapped row
    dec, ok = p.unprotect(wire)
    want = np.ones(16, bool)
    want[[3, 8, 10, 12]] = False
    assert np.array_equal(ok, want)
    # failed rows keep their original (still protected) bytes
    for i in np.nonzero(~ok)[0]:
        n = int(wire.length[i])
        assert np.array_equal(dec.data[i, :n], wire.data[i, :n])
    assert p.port[1].auth_fail[[4, 5]].tolist() == [1, 2]
    # accepted rows decrypt to the sent packets
    for i in np.nonzero(ok)[0]:
        n = int(plain.length[i])
        assert dec.length[i] == n
        assert np.array_equal(dec.data[i, :n], plain.data[i, :n])
    kbuild.reset_counts()
    p.port[0].protect_rtp(rtp(p.rng, [0], [99]))
    assert kbuild.plain_calls["srtp_protect_cm"] == 1
    assert sum(kbuild.launches.values()) == 0


def test_removed_row_rejects_then_serves_new_keys():
    p = Pair(7)
    wire = p.protect(rtp(p.rng, [2, 3], [40, 40]))
    for t in p.jax + p.port:
        t.remove_streams([2])
    _, ok = p.unprotect(wire)
    assert ok.tolist() == [False, True]
    for t in p.jax + p.port:
        with pytest.raises(KeyError):
            t.protect_rtp(rtp(p.rng, [2], [41]))
    # the recycled row authenticates only under the new stream's keys
    mk, ms = bytes(range(16)), bytes(range(14))
    for t in p.jax + p.port:
        t.remove_stream(3)
        t.add_stream(2, mk, ms)
    _, ok = p.unprotect(p.protect(rtp(p.rng, [2], [5])))
    assert ok.all() and not p.port[1].active[3]
    p.check_state()


def test_from_jax_state_continues_identically():
    p = Pair(5)
    wire = p.protect(rtp(p.rng, [0, 1, 2, 1], [65534, 65535, 9, 0]))
    p.unprotect(wire)
    port_tx = SrtpStreamTable.from_jax_state(p.jax[0].snapshot(), "cpu")
    port_rx = SrtpStreamTable.from_jax_state(p.jax[1].snapshot(), "cpu")
    for j, t in zip(p.jax, (port_tx, port_rx)):
        for f in STATE:
            assert np.array_equal(getattr(j, f), getattr(t, f))
    p.port = (port_tx, port_rx)
    wire = p.protect(rtp(p.rng, [1, 0, 2, 2], [1, 2, 10, 11]))
    _, ok = p.unprotect(wire)
    assert ok.all()
    # and the port's own snapshot restores to the same table
    again = SrtpStreamTable.restore(port_rx.snapshot(), "cpu")
    snap_a, snap_b = port_rx.snapshot(), again.snapshot()
    assert snap_a.keys() == snap_b.keys()
    for k in snap_a:
        if isinstance(snap_a[k], np.ndarray):
            assert np.array_equal(snap_a[k], snap_b[k]), k


def test_unported_paths_raise_and_default_device_is_the_card():
    # every profile is ported: AEAD-GCM (whose keystream cache a
    # profile without GCM refuses), F8 and NULL tables, kdr
    # streams, the dispatch-only seams and move_rows
    for prof, cipher in ((SrtpProfile.F8_128_HMAC_SHA1_80, "f8"),
                         (SrtpProfile.NULL_HMAC_SHA1_80, "null"),
                         (SrtpProfile.AEAD_AES_128_GCM, "gcm")):
        assert SrtpStreamTable(4, prof, device="cpu").cipher == cipher
    with pytest.raises(ValueError, match="GCM"):
        SrtpStreamTable(4, device="cpu").enable_keystream_cache()
    t = SrtpStreamTable(4, SrtpProfile.AES_256_CM_HMAC_SHA1_32, device="cpu")
    t.add_stream(0, bytes(32), bytes(14), kdr=1 << 16)
    assert t.kdr[0] == 1 << 16 and 0 in t.snapshot()["masters"]
    rtp = PacketBatch.from_payloads([bytes([0x80, 96, 0, 7]) + bytes(8)
                                     + b"pay"], stream=[0])
    wire = t.protect_rtp_async(rtp).result()
    assert wire.length[0] == 15 + 4
    t.move_rows([0], [2])
    assert t.active.tolist() == [False, False, True, False]
    pend = t.unprotect_rtp_async(PacketBatch(wire.data, wire.length,
                                             np.array([2], np.int32)))
    t.commit_inflight()
    dec, ok = pend.result()             # the moved row kept its keys
    assert ok[0] and dec.to_bytes(0) == rtp.to_bytes(0)
    # SRTCP is ported (kernels I and J): a round trip on this profile
    blob = bytes([0x80, 201, 0, 1]) + (0x1234).to_bytes(4, "big")
    rx = SrtpStreamTable(4, SrtpProfile.AES_256_CM_HMAC_SHA1_32,
                         device="cpu")
    for tab in (t, rx):
        tab.add_stream(1, bytes(range(32)), bytes(14))
    wire = t.protect_rtcp(PacketBatch.from_payloads([blob], stream=[1]))
    dec, ok = rx.unprotect_rtcp(wire)
    assert ok.all() and dec.to_bytes(0) == blob
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SrtpStreamTable(4)


@pytest.mark.slow              # three width classes: three JAX compiles
def test_mixed_width_classes_match():
    p = Pair(6)
    streams = p.rng.integers(0, CAP, 64)
    wire = p.protect(rtp(p.rng, streams, 30000 + np.arange(64),
                         sizes=(100, 400, 950)))
    wire.data[7, 15] ^= 1
    _, ok = p.unprotect(wire)
    assert ok.sum() == 63 and not ok[7]
