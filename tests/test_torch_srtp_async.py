"""The port's dispatch-only SRTP seams and `move_rows`, against the sync
path and the JAX table.

- The twins of `tests/test_srtp.py`'s async cases: three protects in
  flight give the sync path's bytes and TX state, and a key install and
  a removal while a protect is pending leave its result on the old keys.
- An unprotect pipeline (dispatch n + 1 before n's result; a tampered
  row and a replayed batch among them) whose results and commits match
  the JAX table's `unprotect_rtp_async` pipeline: masks, bytes and
  `rx_max`, `rx_mask`, `auth_fail`, `replay_reject` after every step,
  with the table's commit barrier forced by a new dispatch, a key
  install, a snapshot and `commit_inflight`.
- `move_rows` bit for bit against the JAX table's: the JAX table
  restores the port's snapshot (kdr streams and epochs included), both
  move the same rows, and their snapshots agree array for array; the
  refusals agree too.
- The transform chain's async seams give its sync results.

The port runs on the CPU; the JAX side eagerly (`jax.disable_jit`).
Tolerance: exact bytes and state.
"""

import jax
import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.engine import (PacketTransformer,
                                                 TransformEngine,
                                                 TransformEngineChain)
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from test_torch_threads import one_torch_thread  # noqa: F401

MK = bytes(range(16))
MS = bytes(range(30, 44))
RX_STATE = ("rx_max", "rx_mask", "auth_fail", "replay_reject")


def _table(n=4):
    t = SrtpStreamTable(n, device="cpu")
    for i in range(n):
        t.add_stream(i, MK, MS)
    return t


def _batch(rng, seq0, n=12, streams=4, sizes=(30, 70, 110)):
    sids = np.arange(n) % streams
    pls = [rng.integers(0, 256, sizes[i % len(sizes)], np.uint8).tobytes()
           for i in range(n)]
    return rtp_header.build(pls, (seq0 + np.arange(n) // streams) & 0xFFFF,
                            0, 0x2000 + sids, 96, stream=sids)


def test_protect_rtp_async_matches_sync():
    """Three batches in flight materialize to the sync path's bytes, with
    the same TX state."""
    rng = np.random.default_rng(21)
    t_sync, t_async = _table(), _table()
    batches = [_batch(rng, 200 + 3 * k) for k in range(3)]
    pendings = [t_async.protect_rtp_async(b) for b in batches]
    for b, p in zip(batches, pendings):
        want = t_sync.protect_rtp(b)
        got = p.block_until_ready().result()
        assert got.to_payloads() == want.to_payloads()
        assert p.result() is got            # single-shot cache
    assert np.array_equal(t_sync.tx_ext, t_async.tx_ext)


def test_key_mutation_while_protect_pending_is_safe():
    """A key install and a removal while a protect is pending leave the
    dispatched batch on the old keys."""
    rng = np.random.default_rng(30)
    t, ref = _table(), _table()
    b = _batch(rng, 700, n=8)
    want = ref.protect_rtp(b)
    pend = t.protect_rtp_async(b)
    t.add_stream(2, bytes(range(50, 66)), bytes(range(70, 84)))
    t.remove_stream(3)
    assert pend.result().to_payloads() == want.to_payloads()


def _jb(b):
    return JaxBatch(b.data.copy(), b.length.copy(), b.stream.copy())


def test_unprotect_pipeline_commits_match_jax():
    rng = np.random.default_rng(7)
    tx = _table()
    wires = [tx.protect_rtp(_batch(rng, 65533 + 3 * k)) for k in range(2)]
    wires[1].data[5, 20] ^= 1                # a tampered row
    wires.append(wires[0].copy())            # a replayed batch
    port, jx = _table(), JaxTable(4)
    for i in range(4):
        jx.add_stream(i, MK, MS)

    def same_state():
        for f in RX_STATE:
            assert np.array_equal(getattr(port, f), getattr(jx, f)), f

    with jax.disable_jit():
        pend = [(port.unprotect_rtp_async(wires[0].copy()),
                 jx.unprotect_rtp_async(_jb(wires[0])))]
        for w in wires[1:]:
            # dispatch n + 1 first: it commits n, in order
            pend.append((port.unprotect_rtp_async(w.copy(), True),
                         jx.unprotect_rtp_async(_jb(w), True)))
            same_state()
        port.commit_inflight()
        jx.commit_inflight()
        same_state()
        for k, (p, j) in enumerate(pend):
            got, want = p.result(), j.result()
            assert np.array_equal(got[1], want[1]), k
            assert np.array_equal(got[0].data, want[0].data), k
            if k:
                assert np.array_equal(got[2], want[2])
        oks = [p.result()[1] for p, _ in pend]
        assert oks[0].all() and not oks[2].any()
        assert oks[1].sum() == 11 and not oks[1][5]
        assert (port.rx_max >> 16).tolist() == [1] * 4      # ROC wrapped
        # a key install and a snapshot force the pending commit
        p, j = (port.unprotect_rtp_async(wires[1].copy()),
                jx.unprotect_rtp_async(_jb(wires[1])))
        port.add_stream(3, MK, MS)
        jx.add_stream(3, MK, MS)
        same_state()
        assert port.snapshot()["rx_max"].tolist() == \
            jx.snapshot()["rx_max"].tolist()
        assert np.array_equal(p.result()[1], j.result()[1])
    same_state()


def _busy_table(rng):
    """A table with keys, counters, replay windows and kdr epochs in it."""
    t = SrtpStreamTable(8, device="cpu")
    mks = rng.integers(0, 256, (5, 16), np.uint8)
    mss = rng.integers(0, 256, (5, 14), np.uint8)
    t.add_streams(np.arange(5), mks, mss, kdr=np.array([0, 4, 0, 0, 8]))
    rx = SrtpStreamTable(8, device="cpu")
    rx.add_streams(np.arange(5), mks, mss, kdr=np.array([0, 4, 0, 0, 8]))
    wire = t.protect_rtp(_batch(rng, 10, n=20, streams=5))
    wire.data[2, 15] ^= 1
    rx.unprotect_rtp(wire)
    rx.unprotect_rtp(wire)
    return t, rx, mks, mss


def test_move_rows_matches_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    tx, rx, _, _ = _busy_table(rng)
    for port in (tx, rx):
        jx = JaxTable.restore(port.snapshot())
        src, dst = [1, 3, 4], [6, 5, 7]
        port.move_rows(src, dst)
        jx.move_rows(src, dst)
        a, b = port.snapshot(), jx.snapshot()
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert np.array_equal(a[k], b[k]), k
        assert a["masters"] == b["masters"] and sorted(a["masters"]) == [6, 7]
        assert not port.active[src].any() and port.active[dst].all()
        assert not port._rk_rtp[src].any() and not port._mid_rtcp[src].any()
        for bad in (([0], [1, 2]), ([2], [0]), ([1], [0])):
            with pytest.raises(ValueError):
                port.move_rows(*bad)
            with pytest.raises(ValueError):
                jx.move_rows(*bad)
    # the moved rows go on: the next packets of streams 1 and 4 (seq 14,
    # under kdr 4 and 8) authenticate at their new rows
    b = _batch(rng, 14, n=5, streams=5)
    for i, (old, new) in enumerate(((1, 6), (4, 7))):
        row = b.stream == old
        sub = PacketBatch(b.data[row].copy(), b.length[row].copy(),
                          np.full(row.sum(), new, np.int32))
        dec, ok = rx.unprotect_rtp(tx.protect_rtp(sub))
        assert ok.all() and dec.to_payloads() == sub.to_payloads()


class _Tag(PacketTransformer):
    """A host engine before SRTP: sets the marker bit on send and keeps
    rows with an even sequence number on receive."""

    def transform(self, batch, mask=None):
        out = batch.copy()
        out.data[:, 1] |= 0x80
        return out, np.ones(batch.batch_size, bool) if mask is None else mask

    def reverse_transform(self, batch, mask=None):
        keep = (batch.data[:, 3] & 1) == 0
        return batch, keep if mask is None else mask & keep


class _TagEngine(TransformEngine):
    @property
    def rtp_transformer(self):
        return _Tag()


def test_chain_async_seams_match_sync():
    rng = np.random.default_rng(5)
    sync = TransformEngineChain([_TagEngine(), SrtpTransformEngine(
        _table(), _table())]).rtp_transformer
    asyn = TransformEngineChain([_TagEngine(), SrtpTransformEngine(
        _table(), _table())]).rtp_transformer
    plain = _batch(rng, 40)
    want, mask = sync.transform(plain)
    pend, amask = asyn.transform_async(plain)
    got = pend.result()
    assert got.to_payloads() == want.to_payloads()
    assert np.array_equal(mask, amask)
    want = sync.reverse_transform(want)
    rp = asyn.reverse_transform_async(got)
    asyn.commit_inflight()
    got = rp.block_until_ready().result()
    assert np.array_equal(got[1], want[1]) and got[1].sum() == 8
    assert got[0].to_payloads() == want[0].to_payloads()
