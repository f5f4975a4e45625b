"""The port's SfuBridge video plane on the CPU over loopback UDP, held
against the JAX package.

`test_simulcast_track_over_udp_follows_jax_forwarder` carries the
assertions of `tests/test_sfu_bridge.py`'s simulcast cases: a 2-layer
VP8 simulcast track, an upswitch that waits for the PLI-forced keyframe,
a downswitch, one gapless projected seq space (run past a seq wrap on the
projection row and on the RTX row, so a receiver's replay or ROC fault
shows), and a NACK served as RTX that decapsulates to the cached original.
What the receiver decrypts is held byte for byte against the JAX
`SimulcastForwarder` fed the same plaintext batches and layer requests
the bridge gave its forwarder.  The SVC case does the same with a
`Vp9SvcForwarder`.  Then the bridge's bookkeeping: conference scoping of
video receivers, a DTLS row attached when its keys land, the teardown of
a departing sender's and receiver's rows, the layer SSRCs in the SSRC ->
sid map, and the recovery controller's flight events and metrics against
JAX.  A `slow` case runs the JAX SfuBridge and the port's tick by tick
with video tracks and compares every datagram.  Endpoints are the port's
CPU SRTP tables.  Tolerance: exact bytes.
"""

import numpy as np
import pytest

import libjitsi_tpu.codecs.vp8 as j_vp8
import libjitsi_tpu.codecs.vp9 as j_vp9
import libjitsi_tpu.core.packet as j_packet
import libjitsi_tpu.sfu.simulcast as j_simulcast
import libjitsi_tpu.sfu.svc as j_svc
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp import rtcp
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
from libjitsi_tpu_torch.sfu import rtx as rtx_mod
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from test_torch_sfu_bridge import _Endpoint, _keys
from test_torch_threads import one_torch_thread  # noqa: F401

RTX_XOR = 0x00525458


class _Recorded:
    """A forwarder whose inputs (the datagrams of every `forward` batch)
    and layer requests are logged, so a JAX forwarder can replay them."""

    def __init__(self, fwd):
        self.__dict__["_fwd"] = fwd
        self.__dict__["log"] = []

    def __getattr__(self, name):
        return getattr(self._fwd, name)

    def __setattr__(self, name, value):
        setattr(self._fwd, name, value)

    def forward(self, batch):
        self.log.append(("forward", batch.to_payloads()))
        return self._fwd.forward(batch)

    def request_layer(self, layer):
        self.log.append(("request_layer", layer))
        return self._fwd.request_layer(layer)

    def request_layers(self, sid=None, tid=None):
        self.log.append(("request_layers", (sid, tid)))
        return self._fwd.request_layers(sid=sid, tid=tid)


def _replay(jfwd, log) -> list:
    """The JAX forwarder's projection of a recorded trace."""
    out = []
    for kind, arg in log:
        if kind == "forward":
            out += jfwd.forward(j_packet.PacketBatch.from_payloads(arg))
        elif kind == "request_layer":
            jfwd.request_layer(arg)
        else:
            jfwd.request_layers(sid=arg[0], tid=arg[1])
    return out


class _Viewer:
    """A receiver's end of a projected stream: opens the projection and
    its RTX stream under the leg's tx key, keeping every plaintext
    datagram in arrival order."""

    def __init__(self, ep, out_ssrc):
        self.ep = ep
        self.rows = {out_ssrc: 0, (out_ssrc ^ RTX_XOR) & 0xFFFFFFFF: 1}
        self.table = SrtpStreamTable(2, device="cpu")
        for row in (0, 1):
            self.table.add_stream(row, *ep.tx_key)
        self.media, self.rtx = [], []

    def drain(self):
        for _ in range(3):
            back, _, _ = self.ep.engine.recv_batch(timeout_ms=2)
            if not back.batch_size:
                continue
            is_rtcp = (back.data[:, 1] >= 192) & (back.data[:, 1] <= 223)
            rows = np.nonzero(~is_rtcp)[0]
            b = PacketBatch(back.data[rows], back.length[rows],
                            np.zeros(len(rows), np.int32))
            hdr = rtp_header.parse(b)
            b.stream[:] = [self.rows.get(int(s), -1) for s in hdr.ssrc]
            keep = np.nonzero(b.stream >= 0)[0]
            if not len(keep):
                continue
            b = PacketBatch(b.data[keep], b.length[keep], b.stream[keep])
            dec, ok = self.table.unprotect_rtp(b)
            assert np.asarray(ok).all(), "a projected copy failed auth"
            for i in range(dec.batch_size):
                (self.media if dec.stream[i] == 0 else self.rtx).append(
                    dec.to_bytes(i))


class _Sender:
    """A video-only sender: every layer's SRTP row under its rx key, PLI
    read back from the bridge's feedback (which reaches a video-only
    sender at its layer rows' address)."""

    def __init__(self, ep, layer_ssrcs):
        self.ep = ep
        self.ssrcs = list(layer_ssrcs)
        self.table = SrtpStreamTable(len(layer_ssrcs), device="cpu")
        for k in range(len(layer_ssrcs)):
            self.table.add_stream(k, *ep.rx_key)
        self.seq = [65530 - 7 * k for k in range(len(layer_ssrcs))]
        self.plis = set()

    def send(self, datagrams_of_layer, port):
        pls, seqs, ts, ssrcs, marks, rows = [], [], [], [], [], []
        for k, (payloads, t, mark_last) in datagrams_of_layer.items():
            n = len(payloads)
            pls += payloads
            seqs += [(self.seq[k] + i) & 0xFFFF for i in range(n)]
            ts += [t] * n
            ssrcs += [self.ssrcs[k]] * n
            marks += [0] * (n - 1) + [int(mark_last)]
            rows += [k] * n
            self.seq[k] += n
        b = rtp_header.build(pls, seqs, ts, ssrcs, [96] * len(pls),
                             marker=marks, stream=rows)
        self.ep.engine.send_batch(self.table.protect_rtp(b), "127.0.0.1",
                                  port)

    def read_feedback(self):
        self.ep.feedback.clear()
        self.ep.drain()
        assert all(ok for ok, _ in self.ep.feedback)
        for _, blob in self.ep.feedback:
            for p in rtcp.parse_compound(blob):
                if isinstance(p, rtcp.Pli):
                    self.plis.add(p.media_ssrc)


def _remb(recv, bps, ssrc, port):
    blob = rtcp.build_compound([rtcp.build_remb(rtcp.Remb(
        recv.ssrc, int(bps), [ssrc]))])
    recv.engine.send_batch(recv.rtcp_wire([blob]), "127.0.0.1", port)


def _tick(sfu, now, n=6):
    for _ in range(n):
        sfu.tick(now=now)


def test_simulcast_track_over_udp_follows_jax_forwarder():
    sfu = SfuBridge(port=0, capacity=16, recv_window_ms=0, device="cpu")
    send = _Endpoint(0xE0, sfu.port)
    recv = _Endpoint(0xE4, sfu.port)
    sid_s = sfu.add_endpoint(send.ssrc, send.rx_key, send.tx_key)
    sid_r = sfu.add_endpoint(recv.ssrc, recv.rx_key, recv.tx_key)
    recv.send_media(1)                         # latch receiver address
    layer_ssrcs = [0xE00, 0xE01]
    track = sfu.add_video_track(sid_s, layer_ssrcs, layer_bps=[100e3, 1e6],
                                rtx_pt=97)
    assert sorted(track.fwd) == [sid_r] and sfu._sid_of_ssrc(0xE01) == sid_s
    fwd = track.fwd[sid_r] = _Recorded(track.fwd[sid_r])
    # the projection starts 6 short of a wrap, its RTX stream 1 short
    fwd._last_out_seq = 65529
    track.rtx_seq[sid_r] = 65535
    sender = _Sender(send, layer_ssrcs)
    viewer = _Viewer(recv, track.out_ssrc)
    pid = [10, 0x7F0]

    def frames(t, key_layers):
        out = {}
        for k in range(2):
            key = t % 8 == 0 or k in key_layers
            frame = bytes([0x00 if key else 0x01, 0xE0 + k, t]) * (
                60 * (k + 1))
            out[k] = (j_vp8.packetize(frame, picture_id=pid[k],
                                      max_payload=200), t * 3000, True)
            pid[k] = (pid[k] + 1) & 0x7FFF
        return out

    def run(rounds, t0, remb):
        for t in range(t0, t0 + rounds):
            _remb(recv, remb, track.out_ssrc, sfu.port)
            _tick(sfu, 95.0 + t * 0.1, 3)
            sfu.emit_feedback(now=95.0 + t * 0.1)
            sender.read_feedback()
            key_layers = {layer_ssrcs.index(s) for s in sender.plis
                          if s in layer_ssrcs}
            sender.plis.clear()
            sender.send(frames(t, key_layers), sfu.port)
            _tick(sfu, 95.0 + t * 0.1 + 0.05)
            viewer.drain()

    run(1, 0, remb=150_000)          # the sender's layer rows latch
    run(2, 1, remb=2_000_000)        # the raise needs a PLI'd keyframe
    assert fwd.current_layer == 1, "no upswitch"
    run(3, 3, remb=150_000)          # starved to the base layer
    assert fwd.current_layer == 0, "no downswitch"
    seqs = [int.from_bytes(p[2:4], "big") for p in viewer.media]
    assert seqs == [(seqs[0] + i) & 0xFFFF for i in range(len(seqs))]
    assert seqs[0] == 65530 and seqs[-1] < 100, "no wrap on the projection"
    layers = [p[-2] - 0xE0 for p in viewer.media]
    assert 1 in layers and layers[-1] == 0
    # held against the JAX forwarder on the bridge's own trace
    jf = j_simulcast.SimulcastForwarder(layer_ssrcs,
                                        out_ssrc=track.out_ssrc)
    jf._last_out_seq = 65529
    assert viewer.media == _replay(jf, fwd.log)
    # two NACKed projections come back as RTX across the RTX row's wrap,
    # each decapsulating to the cached pre-SRTP original
    want = seqs[-3:-1]
    recv.send_nack(track.out_ssrc, want)
    _tick(sfu, 96.0)
    viewer.drain()
    assert sfu.retransmitted == 2 and sfu.recovery.rtx_requests_served == 2
    assert [int.from_bytes(p[2:4], "big") for p in viewer.rtx] == [65535, 0]
    back, osn = rtx_mod.decapsulate_batch(
        PacketBatch.from_payloads(viewer.rtx), track.out_ssrc, 96)
    assert list(osn) == want
    assert back.to_payloads() == [viewer.media[seqs.index(s)]
                                  for s in want]
    sfu.close()
    for e in (send, recv):
        e.engine.close()


def test_svc_track_over_udp_follows_jax_forwarder():
    sfu = SfuBridge(port=0, capacity=16, recv_window_ms=0, device="cpu")
    send = _Endpoint(0xF0, sfu.port)
    recv = _Endpoint(0xF4, sfu.port)
    sid_s = sfu.add_endpoint(send.ssrc, send.rx_key, send.tx_key)
    sid_r = sfu.add_endpoint(recv.ssrc, recv.rx_key, recv.tx_key)
    recv.send_media(1)
    svc_ssrc = 0xF00
    track = sfu.add_svc_track(sid_s, svc_ssrc, layer_bps=[100e3, 1e6, 3e6])
    fwd = track.fwd[sid_r] = _Recorded(track.fwd[sid_r])
    sender = _Sender(send, [svc_ssrc])
    viewer = _Viewer(recv, svc_ssrc)
    state = {"pid": 300}

    def picture(t, key):
        pls = []
        for s in range(3):
            desc = j_vp9.build_descriptor(
                begin=True, end=True, picture_id=state["pid"],
                tid=0 if key else t % 2, sid=s, tl0picidx=t & 0xFF,
                inter_predicted=not (key and s == 0))
            pls.append(desc + bytes([0x80 | s, t]) * 20)
        state["pid"] += 1
        return {0: (pls, t * 3000, True)}

    def run(rounds, t0, remb):
        for t in range(t0, t0 + rounds):
            _remb(recv, remb, svc_ssrc, sfu.port)
            _tick(sfu, 60.0 + t * 0.1, 3)
            sfu.emit_feedback(now=60.0 + t * 0.1)
            sender.read_feedback()
            key = t % 10 == 0 or svc_ssrc in sender.plis
            sender.plis.clear()
            sender.send(picture(t, key), sfu.port)
            _tick(sfu, 60.0 + t * 0.1 + 0.05)
            viewer.drain()

    run(1, 1, remb=150_000)
    assert fwd.current_sid == 0
    run(2, 2, remb=1_500_000)        # the raise waits for a PLI'd keyframe
    assert fwd.current_sid == 1
    run(2, 4, remb=150_000)          # picture-boundary downswitch
    assert fwd.current_sid == 0
    sids = [p[-2] & 0x7F for p in viewer.media]
    assert 1 in sids and 2 not in sids and sids[-1] == 0
    seqs = [int.from_bytes(p[2:4], "big") for p in viewer.media]
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
    assert viewer.media == _replay(j_svc.Vp9SvcForwarder(), fwd.log)
    recv.send_nack(svc_ssrc, [seqs[-1]])
    _tick(sfu, 61.0)
    viewer.drain()
    back, osn = rtx_mod.decapsulate_batch(
        PacketBatch.from_payloads(viewer.rtx), svc_ssrc, 96)
    assert list(osn) == [seqs[-1]]
    assert back.to_payloads() == [viewer.media[-1]]
    sfu.close()
    for e in (send, recv):
        e.engine.close()


class _ExportedKeys:
    """What a finished DTLS endpoint hands the bridge."""

    def __init__(self, ssrc):
        (rk, rs), (tk, ts) = _keys(ssrc)
        self.keys = (None, tk, ts, rk, rs)

    def srtp_keys(self):
        return self.keys


def test_video_rows_scoping_dtls_attach_and_teardown():
    sfu = SfuBridge(port=0, capacity=64, device="cpu")
    free0 = sfu.registry.free_slots
    specs = [(0x10 + k, *_keys(0x10 + k), None) for k in range(3)]
    s0, s1, s2 = sfu.stage_endpoints(specs, conferences=[0, 0, 1])
    sfu.commit_endpoints([s0, s1, s2])
    track = sfu.add_video_track(s0, [0x900, 0x901, 0x902], [1e5, 5e5, 2e6])
    assert sorted(track.fwd) == [s1], "video crossed a conference"
    assert len(track.layer_sids) == 3 and all(
        sfu.rx_table.active[track.layer_sids])
    rows = [track.tx_sid[s1], track.rtx_sid[s1]]
    assert all(sfu.tx_table.active[rows])
    # the projection rows are keyed with the receiver's leg key
    probe = SrtpStreamTable(1, device="cpu")
    probe.add_stream(0, *_keys(0x11)[1])
    assert np.array_equal(sfu.tx_table._rk_rtp[rows[0]], probe._rk_rtp[0])
    # moving a row between conferences moves its forwarders
    sfu.set_conference(s2, 0)
    assert sorted(track.fwd) == [s1, s2]
    sfu.set_conference(s1, 1)
    assert sorted(track.fwd) == [s2]
    assert not sfu.tx_table.active[rows].any()
    sfu.set_conference(s1, 0)
    # a DTLS row has no leg keys, so no forwarder, until its keys land
    sid_d, _ep = sfu.add_endpoint_dtls(0x55)
    sfu.set_conference(sid_d, 0)
    assert sid_d not in track.fwd
    sfu._install_dtls(sid_d, _ExportedKeys(0x55))
    assert sid_d in track.fwd and sfu.tx_table.active[track.tx_sid[sid_d]]
    # an SVC track of another sender, and the SSRC map over layers
    svc = sfu.add_svc_track(s1, 0x777, [1e5, 1e6])
    assert sfu._sid_of_ssrc(0x777) == s1 and sfu._sid_of_ssrc(0x902) == s0
    assert sorted(svc.fwd) == sorted([s0, s2, sid_d])
    # a departing receiver drops its forwarders and rows; a departing
    # sender its track, layer rows and SSRC maps
    sfu.remove_endpoint(s2)
    assert s2 not in track.fwd and s2 not in svc.fwd
    sfu.remove_endpoint(s0)
    assert track not in sfu._video.values() and s0 not in svc.fwd
    assert sfu.registry._lookup(np.array([0x900]))[0] < 0
    assert sfu._sid_of_ssrc(0x901) is None
    sfu.remove_endpoints([s1, sid_d])
    assert not sfu._video and sfu.registry.free_slots == free0
    assert not sfu.rx_table.active.any() and not sfu.tx_table.active.any()
    # the snapshot keeps endpoints only: tracks attach again after it
    snap_sfu = SfuBridge(port=0, capacity=64, device="cpu")
    a = snap_sfu.add_endpoint(0x41, *_keys(0x41))
    b = snap_sfu.add_endpoint(0x42, *_keys(0x42))
    snap_sfu.add_video_track(a, [0x4A0], [1e5])
    assert sorted(snap_sfu.snapshot()["ssrc_of"]) == [a, b]
    snap_sfu.close()
    sfu.close()


def test_recovery_flight_events_and_metrics_follow_jax():
    from libjitsi_tpu.sfu.recovery import (RecoveryConfig as JCfg,
                                           RecoveryController as JRec)
    from libjitsi_tpu.utils.flight import FlightRecorder as JFlight
    from libjitsi_tpu.utils.metrics import MetricsRegistry as JReg
    from libjitsi_tpu_torch.sfu.recovery import (RecoveryConfig,
                                                 RecoveryController)
    from libjitsi_tpu_torch.utils.flight import FlightRecorder
    from libjitsi_tpu_torch.utils.metrics import MetricsRegistry

    outs = []
    for cfg, rec, flight, reg in ((JCfg, JRec, JFlight, JReg),
                                  (RecoveryConfig, RecoveryController,
                                   FlightRecorder, MetricsRegistry)):
        c = rec(cfg(rtx_budget_bps=8000, rtx_burst_bytes=1500))
        c.flight = flight(clock=lambda: 0.0)
        c.sid_of = {0xA: 3}.get
        r = reg()
        c.register_metrics(r)
        c.observe_rx([0xA] * 4 + [0xB] * 3, [1, 2, 6, 7, 10, 14, 15], 1.0)
        nacks = c.collect_upstream_nacks(1.5)
        allowed = [c.allow_rtx(1000, 2.0) for _ in range(3)]
        c.shed_fec(True)
        c.throttle_rtx(True)
        c.rtx_cache_miss += 2
        events = [list(c.flight._global)] + [
            list(c.flight._streams[s]) for s in sorted(c.flight._streams)]
        outs.append((nacks, allowed, events, r.render()))
    assert outs[1] == outs[0]
    assert any(e["kind"] == "nack_queued" and e.get("sid") == 3
               for ring in outs[1][2] for e in ring)
    assert "recovery_rtx_cache_miss 2" in outs[1][3]


# ------------------------------------------------------------- parity

def _same_video_input(bridges, eps) -> list:
    """Drive each bridge with the same input, tick by tick: two senders'
    video (a 2-layer simulcast track, crossing a seq wrap, and an SVC
    stream), a receiver's REMB that raises and lowers its layers, and its
    NACK for two projected seqs; returns each bridge's sent datagrams."""
    from test_torch_sfu_bridge import _Capture

    caps = [_Capture(b) for b in bridges]
    for b in bridges:
        for e in eps:
            b.add_endpoint(e.ssrc, e.rx_key, e.tx_key)
        b.add_video_track(0, [0x3A0, 0x3A1], [1e5, 1e6])
        b.add_svc_track(1, 0x3B0, [1e5, 1e6])
    # rows: the two layers of eps[0]'s track, then eps[1]'s SVC stream
    up = SrtpStreamTable(3, device="cpu")
    for row, e in enumerate((eps[0], eps[0], eps[1])):
        up.add_stream(row, *e.rx_key)
    nxt = [65533, 65533]                 # each layer's next seq
    for t in range(8):
        pls, seqs, ts, ssrcs, rows, marks = [], [], [], [], [], []
        for k, ssrc in enumerate((0x3A0, 0x3A1)):
            key = t % 4 == 0
            frame = bytes([0 if key else 1, k, t]) * (100 * (k + 1))
            p = j_vp8.packetize(frame, picture_id=t, max_payload=400)
            pls += p
            seqs += [(nxt[k] + i) & 0xFFFF for i in range(len(p))]
            nxt[k] += len(p)
            ts += [t * 3000] * len(p)
            ssrcs += [ssrc] * len(p)
            rows += [k] * len(p)
            marks += [0] * (len(p) - 1) + [1]
        for s in range(2):
            pls.append(j_vp9.build_descriptor(
                begin=True, end=True, picture_id=t, tid=0, sid=s,
                tl0picidx=t, inter_predicted=t % 4 != 0) + bytes([s]) * 40)
            seqs.append(100 + 2 * t + s)
            ts.append(t * 3000)
            ssrcs.append(0x3B0)
            rows.append(2)
            marks.append(s)
        wire = up.protect_rtp(rtp_header.build(
            pls, seqs, ts, ssrcs, [96] * len(pls), marker=marks,
            stream=rows))
        # eps[2] latches its address with one audio packet
        extra = [eps[2].media(1)] if t == 0 else []
        bw = 2_000_000 if 2 <= t < 6 else 150_000
        extra.append(eps[2].rtcp_wire([rtcp.build_compound([
            rtcp.build_remb(rtcp.Remb(eps[2].ssrc, bw,
                                      [eps[0].ssrc, 0x3B0]))])]))
        if t == 6:
            extra.append(eps[2].rtcp_wire([rtcp.build_compound([
                rtcp.build_nack(rtcp.Nack(eps[2].ssrc, eps[0].ssrc,
                                          [1, 2]))])]))
        for b in bridges:
            for w in [wire] + extra:
                eps[0].engine.send_batch(w, "127.0.0.1", b.port)
            _tick(b, 70.0 + 0.02 * t, 6)
            b.emit_feedback(now=70.0 + 0.02 * t + 0.01)
    return [[d for _, d in c.sent] for c in caps]


@pytest.mark.slow          # the JAX bridge's SRTP tables compile: minutes
def test_port_and_jax_bridges_forward_the_same_video():
    """The JAX SfuBridge and the port's, the same endpoints, a simulcast
    track and an SVC track, the same input each tick (video, REMBs that
    switch layers, a NACK): every datagram each sends, in order, equal."""
    import libjitsi_tpu
    from libjitsi_tpu.service.sfu_bridge import SfuBridge as JaxBridge

    libjitsi_tpu.stop()
    libjitsi_tpu.init()
    eps = [_Endpoint(0x300 + 5 * k, 0) for k in range(3)]
    bridges = [JaxBridge(libjitsi_tpu.configuration_service(), port=0,
                         capacity=16, recv_window_ms=0),
               SfuBridge(port=0, capacity=16, recv_window_ms=0,
                         device="cpu")]
    sent = _same_video_input(bridges, eps)
    assert bridges[1].forwarded > 0 and bridges[1].retransmitted == 2
    assert sent[1] == sent[0]
    for b in bridges:
        b.close()
    for e in eps:
        e.engine.close()
