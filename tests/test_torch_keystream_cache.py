"""Twins of `tests/test_keystream_cache.py` for the port's keystream cache
(`libjitsi_tpu_torch/transform/srtp/keystream.py`), on the CPU.

1. A claimed slot is never claimable again: not by a retransmit, not
   after a whole-cache invalidation and refill; a rekey starts a new key
   epoch, which the serve log tells apart.  The port's claims, slots and
   serve log equal the JAX cache's on the same calls.
2. In-batch duplicate slots are served only to exact aliases (the
   size-class padding); any other duplicate misses wholesale, consuming
   nothing.  Equal to the JAX cache's verdicts.
3. Never serve twice under chaos: a tx and an rx cache driven through
   real port tables under seeded loss, reorder, retransmit and a rekey
   (a shorter run than the JAX test's) end with serve logs that hold no
   (key epoch, stream, ssrc, index) twice.
4. Cached unprotect equals stock across a ROC wrap: a cache-enabled rx
   table (N's cached instance, plain version) and the JAX table's stock
   path, fed the same faulted wire (loss, corruption), accept the same
   rows with the same bytes; the cached run hits.
5. Cached protect equals stock across a ROC wrap: the port's cached
   protect (M's cached instance) gives the JAX table's stock wire.
6. Kernel O's plain version fills the slot tables as the JAX package's
   device fill does (`keystream._fill_dev`), byte for byte, on rows of
   mixed streams written to slots out of order.

Kernel O's plain version fills the slots.  The JAX side runs eagerly
(`jax.disable_jit`).  Tolerance: exact bytes and verdicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import keystream as j_keystream
from libjitsi_tpu.transform.srtp import SrtpProfile as JaxProfile
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
import torch

from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import aes as t_aes
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import gcm as t_gcm
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

SEQ0 = 65526          # crosses the ROC wrap mid-run
SSRCS = (0x4242, 0x5353, 0x6464)


@pytest.fixture(autouse=True)
def _eager_jax():
    with jax.disable_jit():
        yield


def _keys(b):
    return bytes([b]) * 16, bytes([b + 1]) * 12


def _table(n=8, jax_table=False):
    t = (JaxTable(capacity=n, profile=JaxProfile.AEAD_AES_128_GCM)
         if jax_table else
         SrtpStreamTable(n, SrtpProfile.AEAD_AES_128_GCM, device="cpu"))
    for i in range(len(SSRCS)):
        t.add_stream(i, *_keys(0x10 * (i + 1)))
    return t


def _batch(tick, streams=range(len(SSRCS))):
    streams = list(streams)
    return j_header.build(
        [bytes([s, tick & 0xFF]) * 40 for s in streams],
        [(SEQ0 + tick) & 0xFFFF] * len(streams),
        [160 * (tick + 1)] * len(streams), [SSRCS[s] for s in streams],
        [96] * len(streams), stream=streams)


def _port(b):
    return PacketBatch(np.asarray(b.data).copy(), np.asarray(b.length).copy(),
                       np.asarray(b.stream).copy())


def _both(fn):
    """fn(cache) on a port and a JAX cache of twin tables; the results
    side by side."""
    out = []
    for jt in (False, True):
        t = _table(jax_table=jt)
        out.append(fn(t, t.enable_keystream_cache(window=32, debug=True)))
    return out


def _slots(got):
    return None if got is None else np.asarray(got[2]).tolist()


def test_claimed_slot_never_claimable_again():
    def run(t, c):
        c.prime(np.array([0]), np.array([SSRCS[0]]), start=100)
        args = (np.array([0]), np.array([SSRCS[0]]), np.array([100]),
                np.array([64]), True)
        res = [_slots(c.claim(*args)), _slots(c.claim(*args))]
        c.invalidate()
        c.fill()
        res += [_slots(c.claim(*args)), _slots(c.claim(
            np.array([0]), np.array([SSRCS[0]]), np.array([101]),
            np.array([64]), True))]
        t.add_stream(0, *_keys(0x77))
        c.prime(np.array([0]), np.array([SSRCS[0]]), start=100)
        res.append(_slots(c.claim(*args)))
        return res, list(c._serve_log), c.stats()
    (mine, log, stats), (theirs, jlog, jstats) = _both(run)
    assert mine == theirs
    assert mine[1] is None and mine[2] is None and mine[4] is not None
    assert log == jlog and len(set(log)) == len(log)
    assert {(g, i) for g, _s, _v, i in log} == {(0, 100), (0, 101), (1, 100)}
    for k in ("hits", "misses", "evictions", "gen", "filled_slots"):
        assert stats[k] == jstats[k], k


def test_in_batch_duplicates_alias_only():
    def run(t, c):
        c.prime(np.array([0]), np.array([SSRCS[0]]), start=200)
        two = np.array([0, 0])
        ssrc = np.array([SSRCS[0]] * 2)
        one = (np.array([0]), np.array([SSRCS[0]]))
        return ([_slots(c.claim(two, ssrc, np.array([200, 200]),
                                np.array([64, 64]), True)),
                 len(c._serve_log),
                 _slots(c.claim(*one, np.array([200]), np.array([64]),
                                True)),
                 _slots(c.claim(two, ssrc, np.array([201, 201]),
                                np.array([64, 48]), True)),
                 _slots(c.claim(*one, np.array([201]), np.array([64]),
                                True))], c.stats())
    (mine, stats), (theirs, jstats) = _both(run)
    assert mine == theirs
    assert mine[0][0] == mine[0][1] and mine[1] == 1
    assert mine[2] is None and mine[3] is None and mine[4] is not None
    assert stats["hits"] == jstats["hits"] == 3


def test_never_serve_twice_under_chaos():
    """Loss, reorder, retransmit and a rekey through the port's tables:
    both directions' serve logs stay free of duplicates (14 ticks; the
    JAX test runs 28)."""
    rng = np.random.default_rng(7)
    tx, rx = _table(), _table()
    ctx = tx.enable_keystream_cache(window=64, debug=True)
    crx = rx.enable_keystream_cache(window=64, debug=True)
    all_s, all_v = np.arange(len(SSRCS)), np.asarray(SSRCS)
    ctx.prime(all_s, all_v, start=SEQ0)
    crx.prime(all_s, all_v, start=SEQ0)
    queue = []
    for tick in range(14):
        wire = tx.protect_rtp(_port(_batch(tick)))
        for i in range(wire.batch_size):
            u = rng.random()
            if u < 0.15:
                continue
            row = (wire.to_bytes(i), int(wire.stream[i]))
            queue.append(row)
            if u < 0.30:
                queue.append(row)
        rng.shuffle(queue)
        feed, queue = queue[:4], queue[4:]
        if feed:
            rx.unprotect_rtp(PacketBatch.from_payloads(
                [b for b, _ in feed], capacity=128,
                stream=[s for _, s in feed]))
        if tick == 7:
            tx.add_stream(1, *_keys(0xA0))
            rx.add_stream(1, *_keys(0xA0))
        ctx.fill()
        crx.fill()
    for cache in (ctx, crx):
        assert cache.hits > 0
        assert len(set(cache._serve_log)) == len(cache._serve_log)


def _faulted_wire(n_ticks=16, seed=99):
    rng = np.random.default_rng(seed)
    prot = _table()
    wire = {}
    for t in range(n_ticks):
        pb = prot.protect_rtp(_port(_batch(t)))
        rows = []
        for i in range(pb.batch_size):
            raw = bytearray(pb.to_bytes(i))
            u = rng.random()
            pos = int(rng.integers(0, len(raw)))
            if u < 0.15:
                continue
            if u < 0.25:
                raw[pos] ^= 0xFF
            rows.append((bytes(raw), int(pb.stream[i])))
        wire[t] = rows
    return wire


def test_cached_unprotect_bit_exact_across_roc_wrap():
    wire = _faulted_wire()
    runs = []
    for cached, jt in ((True, False), (False, True)):
        rx = _table(jax_table=jt)
        cache = None
        if cached:
            cache = rx.enable_keystream_cache(window=64)
            cache.prime(np.arange(len(SSRCS)), np.asarray(SSRCS),
                        start=SEQ0)
        accepted = {}
        for t, rows in wire.items():
            if not rows:
                continue
            cls = JaxBatch if jt else PacketBatch
            b = cls.from_payloads([r for r, _ in rows], capacity=128,
                                  stream=[s for _, s in rows])
            dec, ok = rx.unprotect_rtp(b)
            for i in np.nonzero(np.asarray(ok))[0]:
                accepted[(int(dec.stream[i]), t)] = dec.to_bytes(int(i))
            if cache is not None:
                cache.fill()
        runs.append((accepted, cache))
    (cached, cache), (stock, _) = runs
    assert cache.hits > 0, "the cached run never hit"
    assert cached == stock
    assert any(t >= 65536 - SEQ0 for _, t in stock)


def test_cached_protect_bit_exact_across_roc_wrap():
    stock_tx = _table(jax_table=True)
    cached_tx = _table()
    cache = cached_tx.enable_keystream_cache(window=64)
    cache.prime(np.arange(len(SSRCS)), np.asarray(SSRCS), start=SEQ0)
    kbuild.reset_counts()
    for t in range(14):
        b = _batch(t)
        a = stock_tx.protect_rtp(b)
        c = cached_tx.protect_rtp(_port(b))
        for i in range(a.batch_size):
            assert c.to_bytes(i) == a.to_bytes(i), (t, i)
        cache.fill()
    assert cache.hits > 0 and cache.misses == 0
    assert kbuild.plain_calls["srtp_gcm_seal_cached"] == 14
    assert kbuild.plain_calls["srtp_gcm_seal"] == 0
    assert kbuild.plain_calls["gcm_ks_fill"] > 0


def test_fill_plain_matches_jax_fill_dev():
    """`gcm_ks_fill_plain` against the JAX `_fill_dev` (run eagerly): 10
    slots of 48 bytes (3 keystream blocks) under 4 streams, a run of
    one stream across several slots beside single ones, written to
    slots in a shuffled order of a 13-row table; every byte of both
    tables equal, the slots not written left as they were."""
    rng = np.random.default_rng(15)
    rk = t_aes.expand_keys_batch(rng.integers(0, 256, (4, 16), np.uint8))
    n, ks_bytes, n_slots = 10, 48, 13
    stream = np.array([2, 2, 2, 0, 3, 3, 1, 2, 0, 0], np.int32)
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    slot = rng.permutation(n_slots)[:n].astype(np.int32)
    ks0 = rng.integers(0, 256, (n_slots, ks_bytes), np.uint8)
    ek0 = rng.integers(0, 256, (n_slots, 16), np.uint8)
    want_ks, want_ek = j_keystream._fill_dev(
        jnp.asarray(ks0), jnp.asarray(ek0), jnp.asarray(rk[stream]),
        jnp.asarray(iv12), jnp.asarray(slot), nblocks=ks_bytes // 16)
    ks, ek = torch.from_numpy(ks0.copy()), torch.from_numpy(ek0.copy())
    t_gcm.gcm_ks_fill_plain(ks, ek, torch.from_numpy(rk),
                            torch.from_numpy(stream),
                            torch.from_numpy(iv12), torch.from_numpy(slot))
    assert np.array_equal(ks.numpy(), np.asarray(want_ks))
    assert np.array_equal(ek.numpy(), np.asarray(want_ek))
    untouched = np.setdiff1d(np.arange(n_slots), slot)
    assert np.array_equal(ks.numpy()[untouched], ks0[untouched])
