"""The port's DTLS-SRTP control (`libjitsi_tpu_torch/control/dtls.py`)
and its bridge joins against the JAX package, on the CPU.

Byte-equal first: the RFC 5764 demux over every first byte and the SDP
fingerprint.  Then OpenSSL handshakes across the packages (a JAX client
against a port server and the reverse, under AES-CM-80, AES-CM-32 and
AEAD-GCM, with and without the cookie exchange): both complete, select
one profile and export complementary keys, and a pinned fingerprint that
does not match is refused on either side.  With `os.urandom` and the
flight clock of both modules drawn from one seeded source, the
dependency-free `StubDtlsEndpoint`'s flights and keys equal the JAX
stub's, and the port's `DtlsAssociationTable` follows the JAX table over
one datagram script, inline and deferred (the scripts of JAX
`tests/test_dtls.py`'s claim, cookie-spoof and storm cases, and an
inline one with a refused fingerprint, flight retransmission and inbox
overflow).  Then the bridges: a four-party DTLS-keyed `ConferenceBridge`
on seeded stubs follows the JAX bridge tick by tick (its SRTP tables the
port's CPU tables, as `test_torch_conference._jax_bridge` gives them), a
port `SfuBridge` over UDP loopback with real DTLS (early media held and
replayed, pending rows out of the routes and the snapshot, a leave in
mid-handshake, a refused fingerprint), and a `MediaStream` keyed by the
port's DTLS control.  Tolerance: exact equality.
"""

import time
import types

import numpy as np
import pytest

from libjitsi_tpu.control import dtls as jd
from libjitsi_tpu.transform.srtp.policy import SrtpProfile as JaxProfile
from libjitsi_tpu_torch.control import dtls as pd
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io import loop as p_loop
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

LOOP = 0x7F000001
CM80, CM32, GCM = ("AES_CM_128_HMAC_SHA1_80", "AES_CM_128_HMAC_SHA1_32",
                   "AEAD_AES_128_GCM")


def _profile(mod, name):
    return (JaxProfile if mod is jd else SrtpProfile)[name]


def _handshake(client, server):
    """Pump datagrams between the endpoints until both complete."""
    wire = [(0, p) for p in client.handshake_packets()]
    for _ in range(50):
        if client.complete and server.complete:
            return
        nxt = []
        for who, pkt in wire:
            ep = server if who == 0 else client
            nxt += [(1 - who, p) for p in ep.feed(pkt)]
        wire = nxt or ([(0, p) for p in client.handshake_packets()]
                       + [(1, p) for p in server.handshake_packets()])
    assert client.complete and server.complete, "handshake did not finish"


def _complementary(a, b):
    pa, atk, ats, ark, ars = a.srtp_keys()
    pb, btk, bts, brk, brs = b.srtp_keys()
    assert pa.name == pb.name
    assert (atk, ats) == (brk, brs) and (ark, ars) == (btk, bts)
    return pa.name


def test_demux_and_fingerprint_equal_jax():
    for b in range(256):
        d = bytes([b]) + b"\x00" * 12
        assert pd.is_dtls(d) == jd.is_dtls(d) == (20 <= b <= 63)
        assert bool(p_loop.is_dtls(np.array([b], np.uint8))[0]) == \
            jd.is_dtls(d)
    assert not pd.is_dtls(b"") and not jd.is_dtls(b"")
    der = bytes(range(256)) * 3 + b"libjitsi-tpu"
    assert pd.fingerprint(der) == jd.fingerprint(der)
    assert pd.fingerprint(der).count(":") == 31
    cert, _key, fp = pd.generate_certificate()
    assert fp == jd.fingerprint(cert)


@pytest.mark.parametrize("cookie", [False, True])
@pytest.mark.parametrize("profile", [CM80, CM32, GCM])
@pytest.mark.parametrize("port_server", [True, False])
def test_handshake_across_packages(port_server, profile, cookie):
    s_mod, c_mod = (pd, jd) if port_server else (jd, pd)
    client = c_mod.DtlsSrtpEndpoint("client",
                                    profiles=[_profile(c_mod, profile)])
    server = s_mod.DtlsSrtpEndpoint(
        "server", profiles=[_profile(s_mod, profile)],
        remote_fingerprint=client.local_fingerprint, cookie_exchange=cookie)
    client.remote_fingerprint = server.local_fingerprint
    _handshake(client, server)
    assert _complementary(client, server) == profile
    assert client.selected_profile.name == server.selected_profile.name
    assert client.peer_cert_der == server.cert_der
    assert server.progressed and client.progressed


@pytest.mark.parametrize("port_pins", [True, False])
def test_wrong_fingerprint_is_refused_on_either_side(port_pins):
    pin, other = (pd, jd) if port_pins else (jd, pd)
    bogus = "AB:" * 31 + "CD"
    for role in ("server", "client"):
        pinned = pin.DtlsSrtpEndpoint(role, remote_fingerprint=bogus)
        peer = other.DtlsSrtpEndpoint(
            "client" if role == "server" else "server")
        pair = (peer, pinned) if role == "server" else (pinned, peer)
        with pytest.raises(RuntimeError, match="fingerprint mismatch"):
            _handshake(*pair)
        assert not pinned.complete


# ------------------------------------------------------- seeded stubs

class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def _seed(monkeypatch, seed: int) -> _Clock:
    """Both modules' `os.urandom` from one generator seeded with `seed`
    and their flight clock on one frozen clock (call again to start
    over)."""
    rng = np.random.default_rng(seed)
    fake_os = types.SimpleNamespace(urandom=lambda n: rng.bytes(n))
    clock = _Clock()
    for mod in (jd, pd):
        monkeypatch.setattr(mod, "os", fake_os)
        monkeypatch.setattr(mod, "time", clock)
    return clock


@pytest.mark.parametrize("cookie", [False, True])
def test_stub_flights_and_keys_equal_jax(monkeypatch, cookie):
    got = {}
    for name, mod in (("jax", jd), ("port", pd)):
        clock = _seed(monkeypatch, 31 + cookie)
        c = mod.StubDtlsEndpoint("client", profiles=[
            _profile(mod, GCM), _profile(mod, CM80)])
        s = mod.StubDtlsEndpoint("server", profiles=[_profile(mod, CM80)],
                                 remote_fingerprint=c.local_fingerprint,
                                 cookie_exchange=cookie)
        log = []
        wire = [(0, p) for p in c.handshake_packets()]
        clock.t += 0.3
        retx = s.tick() + c.tick()          # the client's hello flight
        log += retx
        while wire:
            nxt = []
            for who, pkt in wire:
                log.append(pkt)
                nxt += [(1 - who, p)
                        for p in (s if who == 0 else c).feed(pkt)]
            wire = nxt
        p, *keys = c.srtp_keys()
        q, *skeys = s.srtp_keys()
        got[name] = (log, p.name, keys, q.name, skeys, c.retransmits,
                     s.progressed, c.peer_cert_der, s.peer_cert_der)
    assert got["port"] == got["jax"]
    log, pname, keys, qname, skeys = got["port"][:5]
    assert pname == qname == CM80 and keys[:2] == skeys[2:]
    assert all(pd.is_dtls(d) for d in log)


class _FakeEng:
    def __init__(self):
        self.out = []

    def send_batch(self, batch, ip, port):
        for i in range(batch.batch_size):
            self.out.append((batch.to_bytes(i), (ip, port)))
        return batch.batch_size


class _FakeLoop:
    def __init__(self, n=16):
        self.addr_ip = np.zeros(n, np.uint32)
        self.addr_port = np.zeros(n, np.uint16)
        self.engine = _FakeEng()
        self.held, self.released, self.discarded = [], [], []

    def hold_stream(self, sid, max_packets=64):
        self.held.append(sid)

    def release_stream(self, sid):
        self.released.append(sid)
        return 0

    def discard_stream(self, sid):
        self.discarded.append(sid)


def _state(table, loop, installed):
    return (sorted(table.pending), sorted(table.addr_of.items()),
            sorted(table.sid_addr.items()), table.rejected,
            table.inbox_dropped, table.retransmits_total, table.feeds_total,
            table.handshakes_completed, table.backlog, list(loop.held),
            list(loop.released), list(loop.discarded), list(loop.engine.out),
            loop.addr_ip.tolist(), loop.addr_port.tolist(),
            [(s, ep.srtp_keys()[1:]) for s, ep in installed])


def _script_claim(mod, table, loop, installed, trace, clock):
    """JAX `test_dtls.py:249`: an ambiguous source facing two unclaimed
    rows is dropped; a forgotten 5-tuple's queued datagrams are purged
    and a rejoin on the recycled address completes on its own row."""
    S = mod.StubDtlsEndpoint
    table.join(1)
    table.join(2)
    for d in S("client").handshake_packets():
        table.on_dtls(d, (0x0A000001, 5000))
    table.process()
    trace.append(_state(table, loop, installed))
    table.forget(1)
    table.forget(2)
    addr = (0x0A000002, 6000)
    table.join(3, remote_addr=addr)
    for d in S("client").handshake_packets():
        table.on_dtls(d, addr)
    trace.append(_state(table, loop, installed))
    table.forget(3)
    client = S("client")
    table.join(4, remote_addr=addr)
    for d in client.handshake_packets():
        table.on_dtls(d, addr)
    for _ in range(8):
        table.process()
        out, loop.engine.out = loop.engine.out, []
        for d, a in out:
            for r in client.feed(d):
                table.on_dtls(r, a)
        trace.append(_state(table, loop, installed))
    assert [s for s, _ in installed] == [4] and client.complete


def _script_cookie(mod, table, loop, installed, trace, clock):
    """JAX `test_dtls.py:302`: a spoofed copy of a ClientHello binds a
    fresh row first but never round-trips the cookie; the real peer
    supersedes it and both handshakes complete through a bounded
    drain."""
    S = mod.StubDtlsEndpoint
    r1, r2, spoof = (0x0A000011, 5001), (0x0A000012, 5002), \
        (0x0A999999, 9999)
    table.join(1, cookie_exchange=True)
    c1 = S("client")
    for d in c1.handshake_packets():
        table.on_dtls(d, r1)
    table.process()
    for d, a in loop.engine.out:
        for r in c1.feed(d):
            table.on_dtls(r, a)
    loop.engine.out.clear()
    table.process()
    trace.append(_state(table, loop, installed))
    table.join(2, cookie_exchange=True)
    c2 = S("client")
    hello = c2.handshake_packets()
    for d in hello:
        table.on_dtls(d, spoof)
    table.process()
    trace.append(_state(table, loop, installed))
    for d in hello:
        table.on_dtls(d, r2)
    peers = {r1: c1, r2: c2}
    for _ in range(16):
        table.process(budget=2)
        out, loop.engine.out = loop.engine.out, []
        for d, a in out:
            if a in peers:
                for r in peers[a].feed(d):
                    table.on_dtls(r, a)
        trace.append(_state(table, loop, installed))
    assert {s for s, _ in installed} == {1, 2} and spoof not in table.addr_of


def _script_storm(mod, table, loop, installed, trace, clock):
    """JAX `test_dtls.py:366`: six signaling-bound associations drained in
    seeded interleavings under a budget of 3."""
    S = mod.StubDtlsEndpoint
    rng = np.random.default_rng(7)
    clients = {}
    for k in range(6):
        addr = (0x0A000100 + k, 7000 + k)
        table.join(k, remote_addr=addr)
        clients[addr] = S("client")
    wire = [(d, a) for a, c in clients.items() for d in c.handshake_packets()]
    for _ in range(40):
        for i in rng.permutation(len(wire)):
            table.on_dtls(*wire[int(i)])
        table.process(budget=3)
        wire = [(r, a) for d, a in loop.engine.out
                for r in clients[a].feed(d)]
        loop.engine.out.clear()
        trace.append(_state(table, loop, installed))
        if len(installed) == 6 and all(c.complete for c in clients.values()):
            break
    assert len(installed) == 6


def _script_inline(mod, table, loop, installed, trace, clock):
    """Inline mode: replies come back from `on_dtls`; a row pinned to a
    wrong fingerprint is refused and forgotten; lost flights resend in
    batches by address on the frozen clock's expiry (a stride pass
    first); the backlog counts; then a deferred inbox bounded at 2."""
    S = mod.StubDtlsEndpoint
    a1, a2, a3 = (0x0A000201, 8001), (0x0A000202, 8002), (0x0A000203, 8003)
    c1, c3 = S("client"), S("client")
    bad = S("client")
    table.join(1, remote_addr=a1, remote_fingerprint=c1.local_fingerprint)
    table.join(2, remote_addr=a2, remote_fingerprint="AB:CD")
    table.join(3, remote_addr=a3)
    replies = [r for d in c1.handshake_packets() for r in table.on_dtls(d, a1)]
    trace.append((replies, _state(table, loop, installed)))
    for r in replies:
        for f in c1.feed(r):
            trace.append(table.on_dtls(f, a1))
    for d in bad.handshake_packets():
        for r in table.on_dtls(d, a2):
            for f in bad.feed(r):
                trace.append(table.on_dtls(f, a2))
    # row 3's accept flight is "lost": the client never sees it
    trace.append([r for d in c3.handshake_packets()
                  for r in table.on_dtls(d, a3)])
    trace.append(_state(table, loop, installed))
    clock.t += 0.3
    trace.append((table.tick(stride=2, phase=0), table.tick(stride=2,
                                                           phase=1)))
    clock.t += 0.6
    trace.append((table.tick(), table.backlog))
    trace.append(_state(table, loop, installed))
    table.deferred, table.inbox_limit = True, 2
    for d in S("client").handshake_packets() * 5:
        table.on_dtls(d, a3)
    trace.append((table.backlog, table.process(budget=1), table.backlog))
    trace.append(_state(table, loop, installed))
    assert table.rejected == 1 and [s for s, _ in installed] == [1]
    assert table.retransmits_total >= 2 and table.inbox_dropped == 3


@pytest.mark.parametrize("script", [_script_claim, _script_cookie,
                                    _script_storm, _script_inline],
                         ids=["claim", "cookie", "storm", "inline"])
def test_association_table_follows_jax(monkeypatch, script):
    traces = {}
    for name, mod in (("jax", jd), ("port", pd)):
        clock = _seed(monkeypatch, 400)
        loop, installed, trace = _FakeLoop(), [], []
        table = mod.DtlsAssociationTable(
            loop, _profile(mod, CM80),
            lambda sid, ep: installed.append((sid, ep)),
            deferred=script is not _script_inline,
            endpoint_factory=mod.StubDtlsEndpoint)
        script(mod, table, loop, installed, trace, clock)
        traces[name] = trace
    assert len(traces["port"]) == len(traces["jax"])
    for k, (got, want) in enumerate(zip(traces["port"], traces["jax"])):
        assert got == want, k


# ------------------------------------------------------------ bridges

def test_dtls_keyed_conference_follows_jax_bridge_tick_by_tick(monkeypatch,
                                                               tmp_path):
    """Four DTLS-keyed parties (seeded stubs, the handshakes through each
    bridge's `loop.on_dtls`), then ten ticks of the same wire: per tick
    the same egress bytes, levels and dominant speaker, the same speaker
    events and recorder timeline, and each party's mix authenticated
    under its own exported keys."""
    import libjitsi_tpu
    from libjitsi_tpu.io.udp import UdpEngine as JaxUdp
    from libjitsi_tpu.recording.recorder import Recorder as JaxRecorder
    from libjitsi_tpu.rtp import header as j_header
    from libjitsi_tpu_torch.recording.recorder import Recorder
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge
    from test_torch_conference import PARTIES, _client_wire, _drain, \
        _jax_bridge

    libjitsi_tpu.init()
    bridges, clients, recs = {}, {}, {}
    for name, mod in (("jax", jd), ("port", pd)):
        _seed(monkeypatch, 909)
        recs[name] = (JaxRecorder if mod is jd else Recorder)(
            str(tmp_path / name))
        b = (_jax_bridge(False, recorder=recs[name]) if mod is jd else
             ConferenceBridge(port=0, capacity=8, recorder=recs[name],
                              device="cpu"))
        b._dtls.endpoint_factory = mod.StubDtlsEndpoint
        cl = []
        for i, (ssrc, _f) in enumerate(PARTIES):
            addr = (LOOP, 47000 + i)
            sid, ep = b.add_participant_dtls(ssrc, remote_addr=addr)
            assert sid == i and sid in b._dtls.pending
            c = mod.StubDtlsEndpoint("client",
                                     remote_fingerprint=ep.local_fingerprint)
            out = c.handshake_packets()
            while out:
                back = [r for d in out for r in b.loop.on_dtls(d, addr)]
                out = [r for d in back for r in c.feed(d)]
            assert c.complete and ep.complete and not b._dtls.pending.get(i)
            assert (int(b.loop.addr_ip[i]), int(b.loop.addr_port[i])) == addr
            cl.append(c)
        bridges[name], clients[name] = b, cl
    jb, pb = bridges["jax"], bridges["port"]
    for f in ("_tx_seq", "_tx_ts", "_tx_ssrc"):
        getattr(pb, f)[:] = getattr(jb, f)
    keys = [c.srtp_keys() for c in clients["port"]]
    assert [k[1:] for k in keys] == [c.srtp_keys()[1:]
                                     for c in clients["jax"]]
    up = SrtpStreamTable(len(PARTIES), device="cpu")
    for i, (_p, tk, ts, _rk, _rs) in enumerate(keys):
        up.add_stream(i, tk, ts)
    engines = [JaxUdp(port=0, max_batch=64) for _ in range(2)]
    heard = {"jax": [], "port": []}
    now = 300.0
    try:
        for tick in range(10):
            wire = _client_wire(up, tick)
            for eng, b in zip(engines, (jb, pb)):
                eng.send_batch(wire, "127.0.0.1", b.port)
            time.sleep(0.005)
            stats = [jb.tick(now=now), pb.tick(now=now)]
            assert stats[0]["rx"] == stats[1]["rx"] == wire.batch_size
            assert np.array_equal(np.asarray(stats[0]["levels"]),
                                  stats[1]["levels"])
            assert stats[0]["dominant"] == stats[1]["dominant"]
            assert stats[0]["tx"] == stats[1]["tx"] == len(PARTIES)
            for eng, name in zip(engines, heard):
                heard[name].append(sorted(_drain(eng, len(PARTIES))))
            assert heard["jax"][-1] == heard["port"][-1]
            now += 0.02
    finally:
        for eng in engines:
            eng.close()
        jb.close()
        pb.close()
    assert jb.speaker_events == pb.speaker_events != []
    events = {n: [(e["type"], e.get("ssrc")) for e in r._events]
              for n, r in recs.items()}
    assert events["jax"] == events["port"]
    assert ("SPEAKER_CHANGED", PARTIES[pb.speaker_events[-1][1]][0]) in \
        events["port"]
    down = SrtpStreamTable(8, device="cpu")
    for i, (_p, _tk, _ts, rk, rs) in enumerate(keys):
        down.add_stream(i, rk, rs)
    batch = PacketBatch.from_payloads([p for t in heard["port"] for p in t])
    batch.stream[:] = j_header.parse(batch).ssrc - 0x42000000
    _dec, ok = down.unprotect_rtp(batch)
    assert ok.all() and batch.batch_size == 10 * len(PARTIES)


class _Peer:
    """One remote endpoint on its own loopback socket."""

    def __init__(self, ssrc, bridge_port):
        from libjitsi_tpu_torch.io.udp import UdpEngine

        self.ssrc, self.bridge_port = ssrc, bridge_port
        self.engine = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=64)
        self.addr = (LOOP, self.engine.port)

    def send(self, datagrams):
        if datagrams:
            self.engine.send_batch(PacketBatch.from_payloads(list(datagrams)),
                                   "127.0.0.1", self.bridge_port)

    def recv(self):
        b, _, _ = self.engine.recv_batch(timeout_ms=2)
        return b.to_payloads()


def _media(table, row, ssrc, seqs, tag):
    from libjitsi_tpu_torch.rtp import header as rtp_header

    b = rtp_header.build([tag + b"-%d" % s for s in seqs], seqs,
                         [s * 960 for s in seqs], [ssrc] * len(seqs),
                         111, stream=[row] * len(seqs))
    wire = table.protect_rtp(b)
    return wire.to_payloads()


def test_sfu_dtls_joins_over_loopback():
    """Real DTLS to a port `SfuBridge` over loopback: a server-role join
    completes and forwards; a client-role join whose peer's Finished is
    held back has its early media held, then replayed when the keys land;
    pending and refused rows stay out of the routes and the snapshot; a
    leave in mid-handshake forgets the row."""
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    sfu = SfuBridge(port=0, capacity=6, recv_window_ms=0, device="cpu")
    peers = []
    try:
        def tick(n=3):
            for _ in range(n):
                sfu.tick(now=50.0)

        # an SDES receiver, latched by one packet
        rkey = (bytes(range(16)), bytes(range(14)))
        tkey = (bytes(range(16, 32)), bytes(range(14, 28)))
        recv = _Peer(0x700, sfu.port)
        peers.append(recv)
        r_sid = sfu.add_endpoint(recv.ssrc, rkey, tkey)
        up = SrtpStreamTable(1, device="cpu")
        up.add_stream(0, *rkey)
        recv.send(_media(up, 0, recv.ssrc, [1], b"r"))
        tick()
        # a server-role join (the bridge answers the peer's ClientHello)
        a = _Peer(0x701, sfu.port)
        peers.append(a)
        a_sid, a_ep = sfu.add_endpoint_dtls(a.ssrc, remote_addr=a.addr)
        a_cli = pd.DtlsSrtpEndpoint("client",
                                    remote_fingerprint=a_ep.local_fingerprint)
        a_ep.remote_fingerprint = a_cli.local_fingerprint
        assert a_sid in sfu._dtls.pending
        assert a_sid not in sfu.translator._routes
        assert a_sid not in sfu.translator._routes[r_sid]
        assert a_sid not in sfu.snapshot()["ssrc_of"]
        out = a_cli.handshake_packets()
        for _ in range(20):
            a.send(out)
            tick(2)
            out = [r for d in a.recv() for r in a_cli.feed(d)]
            if a_cli.complete and not out:
                break
        assert a_cli.complete and a_sid not in sfu._dtls.pending
        assert a_sid in sfu.translator._routes[r_sid]
        assert sfu.snapshot()["ssrc_of"][a_sid] == a.ssrc
        # a client-role join: the bridge's ClientHello goes out on its own
        # socket; the peer's Finished flight is held back while its media
        # races ahead
        b = _Peer(0x702, sfu.port)
        peers.append(b)
        b_sid, b_ep = sfu.add_endpoint_dtls(b.ssrc, role="client",
                                            remote_addr=b.addr)
        b_srv = pd.DtlsSrtpEndpoint("server",
                                    remote_fingerprint=b_ep.local_fingerprint)
        sfu.loop.engine.send_batch(
            PacketBatch.from_payloads(b_ep.handshake_packets()),
            "127.0.0.1", b.engine.port)
        finished = []
        for _ in range(20):
            got = b.recv()
            out = [r for d in got for r in b_srv.feed(d)]
            if b_srv.complete:
                finished = out
                break
            b.send(out)
            tick(2)
        assert b_srv.complete and finished and b_sid in sfu._dtls.pending
        _p, btk, bts, _brk, _brs = b_srv.srtp_keys()
        b_up = SrtpStreamTable(1, device="cpu")
        b_up.add_stream(0, btk, bts)
        early = _media(b_up, 0, b.ssrc, [10, 11], b"early")
        b.send(early)
        tick()
        assert list(sfu.loop._hold_q[b_sid]) == early
        forwarded = sfu.forwarded
        b.send(finished)
        tick()
        assert b_ep.complete and b_sid not in sfu._dtls.pending
        assert b_sid not in sfu.loop._hold_q
        assert sfu.forwarded == forwarded + 2 * 2     # to recv and to a
        # a leave in mid-handshake
        c = _Peer(0x703, sfu.port)
        peers.append(c)
        c_sid, _c_ep = sfu.add_endpoint_dtls(c.ssrc, remote_addr=c.addr)
        c_cli = pd.DtlsSrtpEndpoint("client")
        c.send(c_cli.handshake_packets())
        tick()
        first = [r for d in c.recv() for r in c_cli.feed(d)]
        assert first and c_sid in sfu._dtls.pending
        sfu.remove_endpoint(c_sid)
        assert c_sid not in sfu._dtls.pending
        assert c.addr not in sfu._dtls.addr_of
        assert c_sid not in sfu._ssrc_of and c_sid not in sfu.loop._hold_q
        feeds = sfu._dtls.feeds_total
        c.send(first)
        tick()
        assert sfu._dtls.feeds_total == feeds and not c.recv()
        # a refused fingerprint tears the association down for good
        d = _Peer(0x704, sfu.port)
        peers.append(d)
        d_sid, _d_ep = sfu.add_endpoint_dtls(
            d.ssrc, remote_fingerprint="AB:" * 31 + "CD", remote_addr=d.addr)
        d_cli = pd.DtlsSrtpEndpoint("client")
        out = d_cli.handshake_packets()
        for _ in range(10):
            d.send(out)
            tick(2)
            out = [r for p in d.recv() for r in d_cli.feed(p)]
            if sfu._dtls.rejected:
                break
        assert sfu._dtls.rejected == 1 and d_sid not in sfu._dtls.pending
        sfu._rebuild_routes()
        assert d_sid not in sfu.translator._routes
        assert all(d_sid not in r for r in sfu.translator._routes.values())
        assert d_sid not in sfu.snapshot()["ssrc_of"]
        # the receiver's copies of the early media open under its leg key
        # and carry the early payloads
        copies = recv.recv() + recv.recv()
        down = SrtpStreamTable(1, device="cpu")
        down.add_stream(0, *tkey)
        dec, ok = down.unprotect_rtp(
            PacketBatch.from_payloads(copies, stream=[0] * len(copies)))
        assert ok.all() and len(copies) == 2
        hdr = rtp_header.parse(dec)
        assert hdr.ssrc.tolist() == [b.ssrc] * 2
        assert [dec.to_bytes(k)[int(hdr.payload_off[k]):]
                for k in range(2)] == [b"early-10", b"early-11"]
    finally:
        sfu.close()
        for p in peers:
            p.engine.close()


def test_stream_keyed_by_dtls_control():
    """Twin of JAX `tests/test_media_stream.py::
    test_stream_keyed_by_dtls_control` on the port's streams and control."""
    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.service.media_service import MediaService

    c = pd.DtlsSrtpEndpoint("client")
    s = pd.DtlsSrtpEndpoint("server", remote_fingerprint=c.local_fingerprint)
    _handshake(c, s)
    svc = MediaService(ConfigurationService(), device="cpu")
    a = svc.create_media_stream(local_ssrc=0x6A)
    b = svc.create_media_stream(local_ssrc=0x6B)
    a.set_remote_ssrc(b.local_ssrc)
    b.set_remote_ssrc(a.local_ssrc)
    a.start(srtp_control=c)
    b.start(srtp_control=s)
    wire = a.send([b"dtls-keyed-stream"])
    got, ok = b.receive(wire)
    assert ok.all() and got.to_bytes(0).endswith(b"dtls-keyed-stream")
    x = svc.create_media_stream(local_ssrc=0x6C,
                                profile=SrtpProfile.AEAD_AES_128_GCM)
    with pytest.raises(ValueError):
        x.start(srtp_control=c)
