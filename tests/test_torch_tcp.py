"""The port's RFC 4571 TCP connector against the JAX package's, on the CPU.

Twins of the 9 cases of `tests/test_tcp.py`:
- framing: both deframers give the same packets from the same stream of
  adversarial chunks, both `frame` encodings are byte-equal, and both
  refuse a packet past the 16-bit length prefix;
- host behaviour over loopback: a batch each way, a closed peer dropped,
  an oversize frame counted and dropped, a stalled peer timed out and
  dropped, `max_batch` held mid-flood with nothing lost, each beside the
  JAX connector's answer, and a port client talking to a JAX server and
  back;
- `MediaLoop` over `TcpMediaEngine`: the port's loop on its CPU SRTP
  tables echoes the same wire as the JAX loop over the JAX engine with
  the same tables in its chain (a JAX table compiles for over 30 s
  here), byte for byte;
- an SDES-keyed stream pair's SRTP leg over TCP: the same seeded pair on
  each package (the JAX registry on the port's CPU tables) puts the same
  bytes on the wire, and the far end takes them.

Tolerance: exact equality.
"""

import socket as pysock

import numpy as np
import pytest

from libjitsi_tpu.core.packet import PacketBatch as JaxBatch
from libjitsi_tpu.io import tcp as j_tcp
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io import tcp as p_tcp
from libjitsi_tpu_torch.io.tcp import TcpConnector
from test_torch_threads import one_torch_thread  # noqa: F401

PKGS = ((p_tcp, PacketBatch), (j_tcp, JaxBatch))


def test_framing_roundtrip_incremental():
    pkts = [b"\x80" + bytes(range(20)), b"x" * 1, b"y" * 1400, b""]
    blobs = [b"".join(m.frame(p) for p in pkts) for m, _ in PKGS]
    assert blobs[0] == blobs[1]
    for m, _ in PKGS:
        fb = m._FrameBuffer()
        got = []
        # adversarial chunk sizes (1, 2, ... 9, 1, ...) across frame edges
        i, step = 0, 1
        while i < len(blobs[0]):
            got += fb.feed(blobs[0][i:i + step])
            i += step
            step = (step % 9) + 1
        assert got == pkts, m


def test_frame_rejects_oversize():
    for m, _ in PKGS:
        with pytest.raises(ValueError):
            m.frame(b"z" * 65536)
        assert m.frame(b"z" * 65535)[:2] == b"\xff\xff"


def test_loopback_batch_transport():
    """A batch each way over loopback, and across the packages: a port
    client to a JAX server and the JAX server's reply back."""
    payloads = [bytes([0x80, 96, 0, i, 0, 0, 0, i, 0, 0, 0, 7]) + b"p" * i
                for i in range(5)]
    for srv_m, srv_b in PKGS:
        for cli_m, cli_b in PKGS:
            srv = srv_m.TcpConnector(listen=True)
            cli = cli_m.TcpConnector()
            try:
                dst = cli.connect("127.0.0.1", srv.port)
                cli.send_batch(cli_b.from_payloads(payloads), dst)
                got, addrs = srv.recv_batch(timeout_ms=2000)
                assert got.to_payloads() == payloads
                assert len(set(addrs)) == 1
                peer = srv.peers()[0]
                srv.send_batch(srv_b.from_payloads(payloads[:2]), peer)
                back, _ = cli.recv_batch(timeout_ms=2000)
                assert back.to_payloads() == payloads[:2]
            finally:
                cli.close()
                srv.close()


def test_peer_close_is_dropped():
    for m, _ in PKGS:
        srv = m.TcpConnector(listen=True)
        cli = m.TcpConnector()
        cli.connect("127.0.0.1", srv.port)
        assert len(srv.peers()) == 1
        cli.close()
        b, addrs = srv.recv_batch(timeout_ms=50)
        assert b.batch_size == 0 and addrs == []
        assert len(srv.peers()) == 0
        srv.close()


def test_oversize_frame_counted_not_silent():
    big = b"\x80" + b"K" * 300          # legitimate RFC 4571, > row width
    small = b"\x80" + b"s" * 20
    for m, batch in PKGS:
        srv = m.TcpConnector(listen=True, mtu=100)
        cli = m.TcpConnector()
        dst = cli.connect("127.0.0.1", srv.port)
        cli.send_batch(batch.from_payloads([big, small], capacity=1500),
                       dst)
        got, _ = srv.recv_batch(timeout_ms=2000)
        assert got.to_payloads() == [small] and got.capacity == 100
        assert srv.dropped_oversize == 1
        cli.close()
        srv.close()


def test_stalled_peer_send_times_out_and_drops():
    srv = TcpConnector(listen=True)
    cli = TcpConnector(send_timeout_s=0.5)
    dst = cli.connect("127.0.0.1", srv.port)
    srv.peers()                          # accept, then never read
    batch = PacketBatch.from_payloads([b"\x80" + b"z" * 1400] * 64)
    # small buffers make the zero-window stall come fast
    cli._conns[dst].setsockopt(pysock.SOL_SOCKET, pysock.SO_SNDBUF, 4096)
    with pytest.raises(ConnectionError):
        for _ in range(600):             # ~54 MB >> buffers
            cli.send_batch(batch, dst)
    assert dst not in cli._conns         # peer dropped
    with pytest.raises(KeyError):
        cli.send_batch(batch, dst)
    cli.close()
    srv.close()


def test_recv_batch_respects_max_batch_with_overflow():
    pkts = [bytes([0x80, 96, 0, i]) + b"\x00" * 8 for i in range(30)]
    for m, batch in PKGS:
        srv = m.TcpConnector(listen=True, max_batch=8)
        cli = m.TcpConnector()
        dst = cli.connect("127.0.0.1", srv.port)
        cli.send_batch(batch.from_payloads(pkts), dst)
        got = []
        for _ in range(10):
            b, _addrs = srv.recv_batch(timeout_ms=500)
            assert b.batch_size <= 8     # the contract, even mid-flood
            got += b.to_payloads()
            if len(got) == 30:
                break
        assert got == pkts, m            # nothing lost, order kept
        cli.close()
        srv.close()


# -------------------------------------------------- MediaLoop over TCP

MK, MS = bytes(range(16)), bytes(range(30, 44))
SSRCS = (0xFEED, 0xBEEF)


def _tables():
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    out = []
    for _ in range(2):
        t = SrtpStreamTable(8, device="cpu")
        for sid in (2, 5):
            t.add_stream(sid, MK, MS)
        out.append(t)
    return out


def _client_wire():
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    tab = SrtpStreamTable(2, device="cpu")
    tab.add_stream(0, MK, MS)
    tab.add_stream(1, MK, MS)
    plain = rtp_header.build(
        [b"media-%d" % i for i in range(8)], list(range(300, 308)),
        [0] * 8, [SSRCS[i % 2] for i in range(8)], [96] * 8,
        stream=[i % 2 for i in range(8)])
    return plain.to_payloads(), tab.protect_rtp(plain).to_payloads()


def _echo_over_tcp(jax: bool, wire):
    """One package's loop echoing `wire` over its own TCP engine; the
    echoes the client reads, in order."""
    if jax:
        import libjitsi_tpu
        from libjitsi_tpu.io.loop import MediaLoop
        from libjitsi_tpu.service.media_stream import StreamRegistry
        from libjitsi_tpu.transform import (SrtpTransformEngine,
                                            TransformEngineChain)

        libjitsi_tpu.stop()
        libjitsi_tpu.init()
        reg = StreamRegistry(libjitsi_tpu.configuration_service(),
                             capacity=8)
        m, batch_cls = j_tcp, JaxBatch
    else:
        from libjitsi_tpu_torch.io.loop import MediaLoop
        from libjitsi_tpu_torch.service.media_stream import StreamRegistry
        from libjitsi_tpu_torch.transform.engine import TransformEngineChain
        from libjitsi_tpu_torch.transform.srtp.engine import \
            SrtpTransformEngine

        reg = StreamRegistry(8, device="cpu")
        m, batch_cls = p_tcp, PacketBatch
    tx, rx = _tables()
    chain = TransformEngineChain([SrtpTransformEngine(tx, rx)])

    def on_media(batch, ok):
        rows = np.nonzero(ok)[0]
        if not len(rows):
            return None
        return batch_cls(batch.data[rows], np.asarray(batch.length)[rows],
                         batch.stream[rows])

    srv = m.TcpConnector(listen=True, max_batch=64)
    loop = MediaLoop(m.TcpMediaEngine(srv), reg, on_media=on_media,
                     chain=chain)
    reg.map_ssrc(SSRCS[0], 2)
    reg.map_ssrc(SSRCS[1], 5)
    cli = m.TcpConnector()
    try:
        dst = cli.connect("127.0.0.1", srv.port)
        cli.send_batch(batch_cls.from_payloads(wire), dst)
        got = 0
        for _ in range(200):
            got += loop.tick()
            if got >= len(wire):
                break
        assert got == len(wire)
        echoes = []
        # echoes may straddle recv windows on a stream transport
        for _ in range(200):
            loop.tick()
            back, _ = cli.recv_batch(timeout_ms=50)
            echoes += back.to_payloads()
            if len(echoes) >= len(wire):
                break
        return echoes, loop.engine.send_failures
    finally:
        cli.close()
        loop.engine.close()
        if jax:
            libjitsi_tpu.stop()


def test_media_loop_runs_over_tcp_engine():
    """The port's MediaLoop over `TcpMediaEngine`: protected RTP of two
    streams in, the SRTP reverse chain, the echo re-protected back over
    the same connection; byte-equal to the JAX loop's echo and opened by
    the client's table."""
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    plain, wire = _client_wire()
    port, failures = _echo_over_tcp(False, wire)
    jax, _ = _echo_over_tcp(True, wire)
    assert len(port) == len(wire) and failures == 0
    assert port == jax
    dec_tab = SrtpStreamTable(2, device="cpu")
    dec_tab.add_stream(0, MK, MS)
    dec_tab.add_stream(1, MK, MS)
    sids = [int(int.from_bytes(p[8:12], "big") == SSRCS[1]) for p in port]
    dec, ok = dec_tab.unprotect_rtp(PacketBatch.from_payloads(
        port, stream=sids))
    assert ok.all()
    assert sorted(dec.to_payloads()) == sorted(plain)
    # a dead peer is counted, and the loop goes on
    eng = p_tcp.TcpMediaEngine(TcpConnector(listen=True))
    assert eng.send_rows(PacketBatch.from_payloads([b"\x80" * 20]), [0],
                         "127.0.0.1", 9) == 0
    assert eng.send_failures == 1
    eng.close()


def test_srtp_protected_media_over_tcp():
    """An SDES-keyed pair's leg: protect, RFC 4571 over TCP, unprotect;
    the port's wire byte-equal to the JAX pair's (the same seeded keys,
    SSRCs, seq and ts; the JAX registry on the port's CPU tables)."""
    from test_torch_pump import J, P, _pair, _registry

    wires = []
    for m, (tcp, batch_cls) in ((P, PKGS[0]), (J, PKGS[1])):
        a, b = _pair(m, _registry(m), 0)
        srv = tcp.TcpConnector(listen=True)
        cli = tcp.TcpConnector()
        try:
            dst = cli.connect("127.0.0.1", srv.port)
            wire = a.send([b"g722-frame-" + bytes(40)], pt=9)
            cli.send_batch(batch_cls.from_payloads(wire), dst)
            got, _ = srv.recv_batch(timeout_ms=2000)
            batch, ok = b.receive(got.to_payloads())
            assert list(ok) == [True]
            assert batch.to_bytes(0)[12:] == b"g722-frame-" + bytes(40)
            wires.append(wire)
        finally:
            cli.close()
            srv.close()
    assert wires[0] == wires[1]
