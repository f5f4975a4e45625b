"""The port's io_uring ingest engine against the JAX package's, on the CPU.

Twins of `tests/test_io_uring.py` (all but its `donate_argnums` case,
a JAX selector with no counterpart).  Every behavioural case runs over
the engine modes this box can run: recvmmsg always, io_uring where
`uring_available()` holds (the ring cases skip elsewhere, as the JAX
`ring_only` mark does, decided as each case runs).  The same datagrams go to the port's engine in
each mode, to the port's recvmmsg engine and to the JAX engine in the
same mode: the rows, lengths, source addresses and accept sets must be
equal, in arrival order.  Then the arena invariants in both modes
(idempotent token release, generation tags across re-occupancy, the
ring growing while every arena is pinned), the syscall telemetry
(`syscall_enters`, `ring_reaps`, the zero-syscall steady state), the
opt-in ring egress, the re-arm at an arena's end, the environment
switches and the explicit-request fallback's warning, each beside the
JAX engine's answer, and the loop's engine metrics.

Tolerance: exact equality.
"""

import logging
import socket
import struct
import time

import numpy as np
import pytest

from libjitsi_tpu.io import udp as j_udp
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.udp import (UdpEngine, _ArenaToken,
                                       probe_engine_mode, uring_available)
from test_torch_threads import one_torch_thread  # noqa: F401

LOCALHOST = struct.unpack("!I", socket.inet_aton("127.0.0.1"))[0]

MODES = ["recvmmsg", "io_uring"]


def _need(mode="io_uring"):
    """Skip a ring case where this box gives no ring (decided when the
    case runs, so every worker collects the same cases)."""
    if mode == "io_uring" and not uring_available():
        pytest.skip("io_uring engine not available on this box")


def _send(tx, rx, payloads):
    tx.send_batch(PacketBatch.from_payloads(payloads), LOCALHOST, rx.port)


def _drain_views(rx, want, timeout_ms=50, max_windows=200):
    """(payload bytes, token) of zero-copy windows until `want` packets
    arrived; the bytes are copied out."""
    out, toks = [], []
    for _ in range(max_windows):
        batch, _sip, _sport = rx.recv_batch_view(timeout_ms=timeout_ms)
        lens = np.asarray(batch.length)
        for i in range(batch.batch_size):
            out.append(bytes(batch.data[i, :lens[i]]))
        if batch.batch_size:
            toks.append(batch.arena_token)
        if len(out) >= want:
            break
    return out, toks


def _drain_rows(rx, want, max_windows=200):
    """Every received row as (payload, length, src ip, src port), copied,
    in arrival order."""
    rows = []
    for _ in range(max_windows):
        batch, sip, sport = rx.recv_batch(timeout_ms=50)
        for i in range(batch.batch_size):
            rows.append((batch.to_bytes(i), int(batch.length[i]),
                         int(sip[i]), int(sport[i])))
        if len(rows) >= want:
            break
    return rows


# ------------------------------------------------------------- probing

def test_probe_default_is_recvmmsg_without_env_pin(monkeypatch):
    monkeypatch.delenv("LIBJITSI_TPU_ENGINE_MODE", raising=False)
    monkeypatch.delenv("LIBJITSI_TPU_NO_IOURING", raising=False)
    assert probe_engine_mode() == j_udp.probe_engine_mode() == "recvmmsg"
    assert uring_available() == j_udp.uring_available()


def test_force_disable_env_wins(monkeypatch, caplog):
    """LIBJITSI_TPU_NO_IOURING=1: the probe reports no ring, "auto" is
    recvmmsg, and an explicit io_uring request degrades with the warning
    `io_uring_unavailable_fallback`, in both packages."""
    monkeypatch.setenv("LIBJITSI_TPU_NO_IOURING", "1")
    assert not uring_available() and not j_udp.uring_available()
    assert probe_engine_mode() == "recvmmsg"
    for cls in (UdpEngine, j_udp.UdpEngine):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            eng = cls(port=0, engine_mode="io_uring")
        try:
            assert eng.engine_mode == "recvmmsg" and eng._u is None
            assert eng.ring_reaps == 0
            assert "io_uring_unavailable_fallback" in caplog.text, cls
        finally:
            eng.close()


def test_engine_mode_pin_recvmmsg_counts_as_disabled(monkeypatch):
    monkeypatch.setenv("LIBJITSI_TPU_ENGINE_MODE", "recvmmsg")
    monkeypatch.delenv("LIBJITSI_TPU_NO_IOURING", raising=False)
    assert not uring_available() and not j_udp.uring_available()
    assert probe_engine_mode() == j_udp.probe_engine_mode() == "recvmmsg"


def test_invalid_engine_mode_rejected():
    for cls in (UdpEngine, j_udp.UdpEngine):
        with pytest.raises(ValueError):
            cls(port=0, engine_mode="dpdk")


# --------------------------------------------------- mode-twin ingest

@pytest.mark.parametrize("mode", MODES)
def test_ordered_ingest_and_parity_accept_set(mode):
    """The same datagrams from one sender reach the port's engine in
    `mode`, the port's recvmmsg engine and the JAX engine in `mode`:
    every one exactly once, in arrival order, with the same bytes,
    lengths and source address in all three."""
    _need(mode)
    tx = UdpEngine(port=0, bind_ip="127.0.0.1")
    rxs = {"port": UdpEngine(port=0, max_batch=16, engine_mode=mode),
           "port recvmmsg": UdpEngine(port=0, max_batch=16,
                                      engine_mode="recvmmsg"),
           "jax": j_udp.UdpEngine(port=0, max_batch=16, engine_mode=mode)}
    try:
        assert rxs["port"].engine_mode == rxs["jax"].engine_mode == mode
        sent = [bytes([0x40 + i]) * (20 + i) for i in range(12)]
        got = {}
        for name, rx in rxs.items():
            _send(tx, rx, sent)
            got[name] = _drain_rows(rx, len(sent))
        assert [r[0] for r in got["port"]] == sent, \
            f"{mode} scrambled or lost the accept set"
        assert [r[1] for r in got["port"]] == [len(p) for p in sent]
        assert {(r[2], r[3]) for r in got["port"]} == {(LOCALHOST, tx.port)}
        assert got["port"] == got["port recvmmsg"] == got["jax"]
    finally:
        tx.close()
        for rx in rxs.values():
            rx.close()


@pytest.mark.parametrize("mode", MODES)
def test_double_release_is_idempotent(mode):
    _need(mode)
    tx = UdpEngine(port=0)
    rx = UdpEngine(port=0, max_batch=8, engine_mode=mode)
    try:
        _send(tx, rx, [b"\xAA" * 32, b"\xBB" * 32])
        got, toks = _drain_views(rx, 2)
        assert got == [b"\xAA" * 32, b"\xBB" * 32] and toks
        tok = toks[0]
        assert isinstance(tok, _ArenaToken)
        a = tok.arena
        pins_before = a.pins
        rx.release_arena(tok)
        rx.release_arena(tok)               # double release: no-op
        assert a.pins == pins_before - 1
        assert tok.released
        for t in toks[1:]:
            rx.release_arena(t)
        assert all(ar.pins == 0 for ar in rx._ring)
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("mode", MODES)
def test_generation_tag_invalidates_stale_tokens(mode):
    """A token of an arena's earlier occupancy never unpins the current
    one: the gen bump (at arm time for the ring, a window for recvmmsg)
    voids it; the JAX engine's (arena, gen) tuple is checked alike."""
    _need(mode)
    tx = UdpEngine(port=0)
    rx = UdpEngine(port=0, max_batch=4, arenas=2, engine_mode=mode)
    try:
        _send(tx, rx, [b"\x01" * 24] * 2)
        _, toks = _drain_views(rx, 2)
        tok0 = toks[0]
        a0, g0 = tok0.arena, tok0.gen
        rx.release_arena(tok0)
        for round_ in range(64):
            _send(tx, rx, [bytes([0x10 + round_]) * 24] * 2)
            _, tk = _drain_views(rx, 2)
            for t in tk:
                rx.release_arena(t)
            if a0.gen > g0:
                break
        assert a0.gen > g0, "arena never re-occupied"
        _send(tx, rx, [b"\x77" * 24] * 2)
        _, live = _drain_views(rx, 2)
        pins_now = a0.pins
        rx.release_arena((a0, g0))          # stale (arena, gen) tuple
        assert a0.pins == pins_now, \
            "stale-generation token stole a live pin"
        for t in live:
            rx.release_arena(t)
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("mode", MODES)
def test_grow_never_reuse_while_owned(mode):
    """With every arena pinned by a live view (and, on the ring, the
    armed one owned by the kernel), ingest grows the ring; pinned bytes
    are never overwritten."""
    _need(mode)
    tx = UdpEngine(port=0)
    rx = UdpEngine(port=0, max_batch=4, arenas=2, engine_mode=mode)
    try:
        views = []
        for tag in (0xA1, 0xB2, 0xC3, 0xD4, 0xE5):
            _send(tx, rx, [bytes([tag]) * 48] * 2)
            got, toks = _drain_views(rx, 2)
            assert got == [bytes([tag]) * 48] * 2
            views.append((tag, toks))
        assert rx.arena_grows >= 1, \
            f"{mode}: ring should have grown while all arenas pinned"
        for tag, toks in views:
            a = toks[0].arena
            rows = np.nonzero((a.buf[:, 0] == tag))[0]
            assert len(rows) >= 2, \
                f"{mode}: pinned arena bytes for {tag:#x} clobbered"
        for _tag, toks in views:
            for t in toks:
                rx.release_arena(t)
        assert all(a.pins == 0 for a in rx._ring)
    finally:
        tx.close()
        rx.close()


# ------------------------------------------------- syscall telemetry

@pytest.mark.parametrize("mode", MODES)
def test_syscall_telemetry_shape(mode):
    """`syscall_enters` is monotone in both modes; `ring_reaps` is zero
    under recvmmsg and counts every completion under the ring, as the
    JAX engine's do for the same datagrams."""
    _need(mode)
    tx = UdpEngine(port=0)
    rxs = (UdpEngine(port=0, max_batch=8, engine_mode=mode),
           j_udp.UdpEngine(port=0, max_batch=8, engine_mode=mode))
    try:
        for rx in rxs:
            e0 = rx.syscall_enters
            _send(tx, rx, [b"\x55" * 30] * 4)
            got, toks = _drain_views(rx, 4)
            assert got == [b"\x55" * 30] * 4
            assert rx.syscall_enters >= e0
            if mode == "recvmmsg":
                assert rx.ring_reaps == 0
                assert rx.syscall_enters > e0     # every window enters
            else:
                assert rx.ring_reaps >= 4, \
                    "completed ring SQEs not accounted as reaps"
            for t in toks:
                rx.release_arena(t)
        if mode == "io_uring":
            # the arm and the first window's wait, in both packages
            assert rxs[0].ring_reaps == rxs[1].ring_reaps
    finally:
        tx.close()
        for rx in rxs:
            rx.close()


def test_uring_steady_state_recv_is_zero_syscall():
    """Once the chain is armed, landed completions are reaped ring-side:
    0 ms windows never enter the kernel."""
    _need()
    tx = UdpEngine(port=0)
    rx = UdpEngine(port=0, max_batch=16, engine_mode="io_uring")
    try:
        _send(tx, rx, [b"\x66" * 30] * 4)
        got, toks = _drain_views(rx, 4, timeout_ms=100)
        assert len(got) == 4
        e0 = rx.syscall_enters
        sent = [bytes([0x90 + i]) * 30 for i in range(4)]
        _send(tx, rx, sent)
        got2 = []
        for _ in range(500):
            batch, _s, _p = rx.recv_batch_view(timeout_ms=0)
            lens = np.asarray(batch.length)
            for i in range(batch.batch_size):
                got2.append(bytes(batch.data[i, :lens[i]]))
            if batch.batch_size:
                toks.append(batch.arena_token)
            if len(got2) >= 4:
                break
            time.sleep(0.002)
        assert got2 == sent
        assert rx.syscall_enters == e0, "ring-side reaps entered the kernel"
        for t in toks:
            rx.release_arena(t)
    finally:
        tx.close()
        rx.close()


def test_uring_gather_egress_roundtrip(monkeypatch):
    """Ring egress (LIBJITSI_TPU_URING_EGRESS): the same bytes sendmmsg
    would send, whole batches and gathered rows, from both packages."""
    _need()
    monkeypatch.setenv("LIBJITSI_TPU_URING_EGRESS", "1")
    rx = UdpEngine(port=0, max_batch=16)
    try:
        sent = [bytes([0x70 + i]) * (25 + i) for i in range(6)]
        rows = [4, 0, 2]
        for cls in (UdpEngine, j_udp.UdpEngine):
            tx = cls(port=0, engine_mode="io_uring")
            try:
                assert tx.uring_egress and tx.engine_mode == "io_uring"
                batch = PacketBatch.from_payloads(sent)
                tx.send_batch(batch, LOCALHOST, rx.port)
                got, toks = _drain_views(rx, len(sent))
                assert got == sent, cls
                tx.send_rows(batch, rows, "127.0.0.1", rx.port)
                got2, toks2 = _drain_views(rx, len(rows))
                assert got2 == [sent[r] for r in rows], cls
                for t in toks + toks2:
                    rx.release_arena(t)
            finally:
                tx.close()
    finally:
        rx.close()


def test_uring_arena_exhaustion_rearms_across_boundary():
    """More packets than an arena holds: the EXHAUSTED re-arm loses
    nothing at the boundary and the new occupancy has its own arena and
    generation; the JAX engine delivers the same sequence."""
    _need()
    tx = UdpEngine(port=0)
    rxs = (UdpEngine(port=0, max_batch=8, arenas=2, engine_mode="io_uring"),
           j_udp.UdpEngine(port=0, max_batch=8, arenas=2,
                           engine_mode="io_uring"))
    try:
        for rx in rxs:
            n = rx._rows + 4
            sent = [struct.pack("!I", i) + b"z" * 20 for i in range(n)]
            for i in range(0, n, 8):
                _send(tx, rx, sent[i:i + 8])
            got, toks = _drain_views(rx, n)
            assert got == sent, "packets lost/reordered at arena boundary"
            gens = {t.arena: t.gen for t in toks}
            assert len(gens) >= 2, "re-arm never moved to a second arena"
            for t in toks:
                rx.release_arena(t)
    finally:
        tx.close()
        for rx in rxs:
            rx.close()


def test_token_legacy_tuple_unpacking():
    for cls in (_ArenaToken, j_udp._ArenaToken):
        tok = cls.__new__(cls)
        tok.arena, tok.gen, tok.released = "arena", 7, False
        arena, gen = tok
        assert (arena, gen) == ("arena", 7)


def test_engine_mode_env_pin_selects_ring_when_available(monkeypatch):
    """LIBJITSI_TPU_ENGINE_MODE=io_uring turns "auto" to the ring, only on
    a box that can run it."""
    monkeypatch.setenv("LIBJITSI_TPU_ENGINE_MODE", "io_uring")
    monkeypatch.delenv("LIBJITSI_TPU_NO_IOURING", raising=False)
    want = "io_uring" if uring_available() else "recvmmsg"
    assert probe_engine_mode() == j_udp.probe_engine_mode() == want
    for cls in (UdpEngine, j_udp.UdpEngine):
        eng = cls(port=0, engine_mode="auto")
        try:
            assert eng.engine_mode == want
        finally:
            eng.close()


def test_loop_exports_engine_metrics():
    """The port's MediaLoop over each engine mode: the mode gauge, the
    ring count and the ingest syscall and reap counters."""
    from libjitsi_tpu_torch.io.loop import MediaLoop
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    for mode in MODES[:1 + uring_available()]:
        eng = UdpEngine(port=0, engine_mode=mode)
        loop = MediaLoop(eng, StreamRegistry(4, device="cpu"),
                         recv_window_ms=0)
        try:
            tx = UdpEngine(port=0)
            _send(tx, eng, [b"\x80" * 28] * 3)
            for _ in range(20):
                loop.tick()
            tx.close()
            reg = loop.metrics
            assert reg.sample_total("loop_ingest_rings") == 1.0
            assert reg.sample_total("loop_ingest_syscalls") >= 1
            reaps = reg.sample_total("loop_ingest_ring_reaps")
            assert (reaps >= 3) if mode == "io_uring" else reaps == 0
            assert reg.sample_total("loop_engine_io_uring") == \
                (1.0 if mode == "io_uring" else 0.0)
            assert loop.engine_mode == eng.engine_mode == mode
        finally:
            eng.close()
