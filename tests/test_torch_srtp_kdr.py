"""Key derivation rate epochs in the port's SRTP table (RFC 3711 §4.3;
reference: BaseSRTPCryptoContext.keyDerivationRate).

The twins of `tests/test_kdr.py` on the port's table: session keys are
derived again every KDR packets, a batch spanning an epoch boundary runs
in waves, tx and rx agree, kdr = 0 streams and unmapped rows are left
alone, and snapshots carry the epochs and master keys.  Their oracle is
written from the RFC apart from the table: the session keys of a
packet's epoch (`derive_session_keys(kdr, index)`), the host NumPy
AES-CM keystream and the stdlib HMAC.  Then SRTCP across an epoch, and
one parity case against the JAX table (eager, `jax.disable_jit`) across
an epoch boundary: equal wire bytes, epochs, masters and tx state.
The port runs on the CPU (the plain versions of kernels C and D, I and
J).  Tolerance: exact bytes.
"""

import hashlib
import hmac

import jax
import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels.aes import ctr_keystream_np, expand_key
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.kdf import derive_session_keys
from test_torch_threads import one_torch_thread  # noqa: F401

MK = bytes(range(16))
MS = bytes(range(50, 64))
KDR = 16            # derive again every 16 packets
SSRC = 9


def _table(capacity=1):
    return SrtpStreamTable(capacity, device="cpu")


def _pkt(seq, payload=b"kdrpayload" * 8):
    return rtp_header.build([payload], [seq], [0], [SSRC], [96],
                            stream=[0]).to_bytes(0)


def _oracle_kdr(pkt: bytes, index: int, kdr: int = KDR) -> bytes:
    """RFC 3711 protect of one packet under the session keys of epoch
    index DIV kdr: AES-CM over the payload, HMAC-SHA1-80 over the packet
    || ROC."""
    ks = derive_session_keys(MK, MS, kdr=kdr, index=index)
    iv = np.zeros(16, np.uint8)
    iv[:14] = np.frombuffer(ks.rtp_salt, np.uint8)
    iv[4:8] ^= np.frombuffer(int.from_bytes(pkt[8:12], "big")
                             .to_bytes(4, "big"), np.uint8)
    iv[8:14] ^= np.frombuffer(index.to_bytes(6, "big"), np.uint8)
    stream = ctr_keystream_np(expand_key(ks.rtp_enc), iv, len(pkt) - 12)
    ct = pkt[:12] + bytes(np.frombuffer(pkt[12:], np.uint8) ^ stream)
    roc = (index >> 16).to_bytes(4, "big")
    return ct + hmac.new(ks.rtp_auth, ct + roc, hashlib.sha1).digest()[:10]


def test_kdr_rekeys_across_epochs_single_packets():
    tx = _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    for seq in (0, 15, 16, 17, 31, 32, 39):    # epochs 0, 1, 2
        b = PacketBatch.from_payloads([_pkt(seq)], stream=[0])
        assert tx.protect_rtp(b).to_bytes(0) == _oracle_kdr(_pkt(seq), seq)
    assert (derive_session_keys(MK, MS, kdr=KDR, index=15).rtp_enc
            != derive_session_keys(MK, MS, kdr=KDR, index=16).rtp_enc)
    assert tx._epoch_rtp[0] == 2


def test_kdr_batch_spanning_epoch_boundary():
    tx = _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    pkts = [_pkt(s) for s in range(12, 20)]       # spans 15 | 16
    out = tx.protect_rtp(PacketBatch.from_payloads(pkts, stream=[0] * 8))
    for i, s in enumerate(range(12, 20)):
        assert out.to_bytes(i) == _oracle_kdr(pkts[i], s), f"seq {s}"
    assert tx._epoch_rtp[0] == 1


def test_kdr_roundtrip_tx_rx():
    tx, rx = _table(), _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    rx.add_stream(0, MK, MS, kdr=KDR)
    highest = -1
    for start in (0, 8, 14, 16, 30):              # batches cross epochs
        pkts = [_pkt(s) for s in range(start, start + 4)]
        prot = tx.protect_rtp(PacketBatch.from_payloads(pkts,
                                                        stream=[0] * 4))
        dec, ok = rx.unprotect_rtp(prot)
        for i, s in enumerate(range(start, start + 4)):
            if s > highest:                        # fresh: must pass
                assert ok[i] and dec.to_bytes(i) == pkts[i], s
            else:                                  # replayed: dropped
                assert not ok[i], s
        highest = max(highest, start + 3)
    assert rx._epoch_rtp[0] == 2


def test_kdr_zero_streams_unaffected():
    tx = _table(2)
    tx.add_stream(0, MK, MS, kdr=KDR)
    tx.add_stream(1, MK, MS)                       # kdr = 0
    batch = rtp_header.build([b"x" * 50, b"x" * 50], [20, 20], [0, 0],
                             [SSRC, SSRC], [96, 96], stream=[0, 1])
    out = tx.protect_rtp(batch)
    assert out.length[0] == out.length[1]
    assert tx._epoch_rtp.tolist() == [1, 0]
    assert out.to_bytes(0) == _oracle_kdr(batch.to_bytes(0), 20)
    # kdr 0: the keys of epoch 0 at index 20
    assert out.to_bytes(1) == _oracle_kdr(batch.to_bytes(1), 20, kdr=0)


def test_kdr_snapshot_restore():
    tx = _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    tx.protect_rtp(PacketBatch.from_payloads([_pkt(17)], stream=[0]))
    t2 = SrtpStreamTable.restore(tx.snapshot(), "cpu")
    assert t2._epoch_rtp[0] == 1 and t2.kdr[0] == KDR
    assert t2.snapshot()["masters"] == {0: (MK, MS)}
    a = tx.protect_rtp(PacketBatch.from_payloads([_pkt(18)], stream=[0]))
    b = t2.protect_rtp(PacketBatch.from_payloads([_pkt(18)], stream=[0]))
    assert a.to_bytes(0) == b.to_bytes(0)
    # the restored table crosses the next epoch too (masters survived)
    p40 = PacketBatch.from_payloads([_pkt(40)], stream=[0])
    assert t2.protect_rtp(p40).to_bytes(0) == _oracle_kdr(_pkt(40), 40)


def test_kdr_one_every_packet_epoch_no_recursion():
    """kdr = 1 (a new key every packet, RFC-legal) over a 12-packet
    batch: 12 waves, one epoch a row, each wave one level deep."""
    tx, rx = _table(), _table()
    tx.add_stream(0, MK, MS, kdr=1)
    rx.add_stream(0, MK, MS, kdr=1)
    n = 12
    pkts = [_pkt(s, payload=bytes([s]) * 40) for s in range(n)]
    prot = tx.protect_rtp(PacketBatch.from_payloads(pkts, stream=[0] * n))
    dec, ok = rx.unprotect_rtp(prot)
    assert ok.all()
    assert [dec.to_bytes(i) for i in range(n)] == pkts
    assert prot.to_bytes(n - 1) == _oracle_kdr(pkts[-1], n - 1, kdr=1)
    assert tx._epoch_rtp[0] == n - 1 == rx._epoch_rtp[0]


def test_kdr_unmapped_rows_do_not_fragment_batches():
    """stream = -1 rows ride wave 0 and force no epoch split."""
    tx, rx = _table(), _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    rx.add_stream(0, MK, MS, kdr=KDR)
    prot = tx.protect_rtp(PacketBatch.from_payloads(
        [_pkt(3), _pkt(4)], stream=[0, 0]))
    junk = rtp_header.build([b"j" * 50], [40000], [0], [0xBAD], [96],
                            stream=[-1])
    mixed = PacketBatch.from_payloads(
        [prot.to_bytes(0), junk.to_bytes(0), prot.to_bytes(1)],
        stream=[0, -1, 0])
    stream = np.asarray(mixed.stream, np.int64)
    waves, _ = rx._epoch_plan(stream, rx._estimate_rx_indices(
        stream, rtp_header.parse(mixed).seq), rtcp=False)
    assert waves is None
    _, ok = rx.unprotect_rtp(mixed)
    assert ok.tolist() == [True, False, True]


def test_kdr_srtcp_crosses_an_epoch():
    """SRTCP indices 14..17 under KDR = 16: two waves, the RTCP keys of
    each epoch (the RTP plane keeps its own epoch), tag by the stdlib."""
    tx, rx = _table(), _table()
    tx.add_stream(0, MK, MS, kdr=KDR)
    rx.add_stream(0, MK, MS, kdr=KDR)
    rr = bytes([0x80, 201, 0, 1]) + SSRC.to_bytes(4, "big")
    tx.rtcp_tx_index[0] = 13
    wire = tx.protect_rtcp(PacketBatch.from_payloads([rr] * 4,
                                                     stream=[0] * 4))
    assert tx._epoch_rtcp[0] == 1 and tx._epoch_rtp[0] == 0
    for i, index in enumerate(range(14, 18)):
        ks = derive_session_keys(MK, MS, kdr=KDR, srtcp_index=index)
        pkt = wire.to_bytes(i)
        word = ((1 << 31) | index).to_bytes(4, "big")
        assert pkt[-14:-10] == word
        assert pkt[-10:] == hmac.new(ks.rtcp_auth, pkt[:-10],
                                     hashlib.sha1).digest()[:10]
    dec, ok = rx.unprotect_rtcp(wire)
    assert ok.all() and dec.to_payloads() == [rr] * 4
    assert rx._epoch_rtcp[0] == 1


def test_kdr_tables_match_jax_across_an_epoch():
    """Two kdr streams (16, 8) and a kdr = 0 one, a batch of seqs 12-19
    (across 15 | 16 and 15 | 16 of kdr 8: two waves) through the JAX and
    the port tx tables: equal wire bytes, epochs and state; the port's rx
    table opens the wire."""
    rng = np.random.default_rng(4)
    mks = rng.integers(0, 256, (3, 16), np.uint8)
    mss = rng.integers(0, 256, (3, 14), np.uint8)
    kdr = np.array([KDR, 8, 0])
    jax_tx, tx, rx = JaxTable(3), _table(3), _table(3)
    for t in (jax_tx, tx, rx):
        t.add_streams(np.arange(3), mks, mss, kdr=kdr)
    seqs = np.arange(12, 20)
    streams = np.arange(len(seqs)) % 3
    pls = [rng.integers(0, 256, 60, np.uint8).tobytes() for _ in seqs]
    b = rtp_header.build(pls, seqs, 0, 0x40 + streams, 96, stream=streams)
    with jax.disable_jit():
        a = jax_tx.protect_rtp(JaxBatch(b.data.copy(), b.length.copy(),
                                        b.stream.copy()))
    w = tx.protect_rtp(b.copy())
    assert np.array_equal(a.data, w.data)
    for f in ("tx_ext", "kdr", "_epoch_rtp", "_epoch_rtcp"):
        assert np.array_equal(getattr(jax_tx, f), getattr(tx, f)), f
    assert jax_tx._masters == tx._masters
    # seqs 18 // 16 and 19 // 8: both kdr streams crossed epochs
    assert tx._epoch_rtp.tolist() == [1, 2, 0]
    dec, ok = rx.unprotect_rtp(w)
    assert ok.all() and dec.to_payloads() == b.to_payloads()
    assert rx._epoch_rtp.tolist() == [1, 2, 0]
