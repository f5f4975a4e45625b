"""The port's echo tick over UDP loopback, on the CPU.

A client protects RTP with the JAX SrtpStreamTable and sends it to the
port's MediaLoop bridge, whose port-side transform chain unprotects,
echoes and re-protects every packet.  The echoed wire bytes must equal
what the JAX table produces for the same packets under the bridge's
send keys, and decrypt back to the sent payloads.  A second test drives
the loop's DTLS / RTCP / unknown-SSRC split without a chain.
Tolerance: exact equality.
"""

import numpy as np

from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import SrtpStreamTable as JaxTable
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.transform.engine import TransformEngineChain
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
from test_torch_threads import one_torch_thread  # noqa: F401

MK, MS = bytes(range(16)), bytes(range(40, 54))
MK2, MS2 = bytes(range(100, 116)), bytes(range(60, 74))
SSRC, SID, CAP = 0xC11E27, 3, 8


def _tick_until(loop, want, ticks=200):
    got = 0
    for _ in range(ticks):
        got += loop.tick()
        if got >= want:
            break
    return got


def _recv(engine, want, tries=50):
    rows = []
    for _ in range(tries):
        b, _, _ = engine.recv_batch(timeout_ms=20)
        rows += b.to_payloads()
        if len(rows) >= want:
            break
    return rows


def test_echo_tick_wire_bytes_equal_jax_table():
    reg = StreamRegistry(capacity=CAP, device="cpu")
    tx_tab, rx_tab = reg.srtp_tables(SrtpProfile.AES_CM_128_HMAC_SHA1_80)
    rx_tab.add_stream(SID, MK, MS)
    tx_tab.add_stream(SID, MK2, MS2)
    reg.map_ssrc(SSRC, SID)
    echoed = []

    def on_media(batch, ok):
        rows = np.nonzero(ok)[0]
        echoed.append(len(rows))
        return PacketBatch(batch.data[rows], batch.length[rows],
                           batch.stream[rows])

    chain = TransformEngineChain([SrtpTransformEngine(tx_tab, rx_tab)])
    with UdpEngine(port=0, max_batch=64) as bridge_eng, \
            UdpEngine(port=0, max_batch=64) as client:
        bridge = MediaLoop(bridge_eng, reg, on_media=on_media, chain=chain)
        payloads = [b"frame-%02d-" % i + bytes(range(i * 9)) for i in range(8)]
        plain = j_header.build(payloads, 65533 + np.arange(8), 0, SSRC, 96,
                               stream=[0] * 8)
        c_tx = JaxTable(CAP)
        c_tx.add_stream(0, MK, MS)
        wire = c_tx.protect_rtp(plain.copy())
        client.send_batch(wire, "127.0.0.1", bridge_eng.port)
        assert _tick_until(bridge, 8) == 8
        assert sum(echoed) == 8
        assert bridge.addr_port[SID] == client.port      # address latched
        back = _recv(client, 8)
    assert len(back) == 8 and bridge.tx_packets == 8
    # the reference: the JAX table protecting the same packets under the
    # bridge's send keys, at the bridge's row
    ref = JaxTable(CAP)
    ref.add_stream(SID, MK2, MS2)
    want = ref.protect_rtp(PacketBatch(plain.data.copy(), plain.length.copy(),
                                       np.full(8, SID, np.int32)))
    assert sorted(back) == sorted(want.to_payloads())
    # and the client's receive table decrypts them to the sent payloads
    c_rx = SrtpStreamTable(1, device="cpu")
    c_rx.add_stream(0, MK2, MS2)
    dec, ok = c_rx.unprotect_rtp(PacketBatch.from_payloads(
        back, stream=[0] * 8))
    assert ok.all()
    assert sorted(dec.to_payloads()) == sorted(plain.to_payloads())


def test_loop_splits_dtls_rtcp_and_unknown_ssrc():
    reg = StreamRegistry(capacity=CAP, device="cpu")
    reg.map_ssrc(0x1111, 1)
    seen = {"dtls": [], "rtcp": [], "media": []}

    def on_dtls(datagram, addr):
        seen["dtls"].append(datagram)
        return [b"\x16reply"]

    with UdpEngine(port=0) as eng, UdpEngine(port=0) as peer:
        loop = MediaLoop(
            eng, reg, on_dtls=on_dtls,
            on_rtcp=lambda b, ok: seen["rtcp"].append(b.stream.tolist()),
            on_media=lambda b, ok: seen["media"].append(b.stream.tolist()))
        rtp_ok = j_header.build([b"x" * 10], [1], 0, 0x1111, 96)
        rtp_unknown = j_header.build([b"y" * 10], [1], 0, 0x2222, 96)
        rtcp = bytes([0x80, 200, 0, 6]) + (0x1111).to_bytes(4, "big") + \
            bytes(20)
        dtls = b"\x16\xfe\xfd" + bytes(20)
        batch = PacketBatch.from_payloads(
            [dtls, rtp_ok.to_bytes(0), rtcp, rtp_unknown.to_bytes(0)])
        peer.send_batch(batch, "127.0.0.1", eng.port)
        assert _tick_until(loop, 4) == 4
        reply = _recv(peer, 1)
        reg.unmap_ssrc(0x1111)
        peer.send_batch(PacketBatch.from_payloads([rtp_ok.to_bytes(0)]),
                        "127.0.0.1", eng.port)
        assert _tick_until(loop, 1) == 1
    assert seen["dtls"] == [dtls] and reply == [b"\x16reply"]
    assert seen["rtcp"] == [[1]] and seen["media"] == [[1]]
    assert loop.dtls_packets == 1 and loop.unknown_ssrc_dropped == 2
