#!/usr/bin/env python
"""Churn soak of the PyTorch port: continuous Poisson join/leave against
the stream lifecycle plane, with a capacity report.

The port's twin of `scripts/churn_soak.py`.  Drives an SfuBridge +
BridgeSupervisor + StreamLifecycleManager with a `ChurnModel` (Poisson
joins, exponential holds, diurnal rate swing) while persistent probe
endpoints exchange talk-spurt-gated media over loopback UDP under
simulated downlink loss, recovering via NACK.  After a ramp to steady
state the measured window asserts the lifecycle plane's invariants:

- zero first launches of a kernel instance inside tick windows (the
  port's `compile_cache` counters, bracketed by
  `lifecycle.tick_begin` / `tick_end`): admits and evicts ride warmed
  row classes;
- `table_protect` p99 against the live churn-mutated table stays within
  `--p99-factor` (2x) of the pre-churn static-batch p99;
- residual media loss across the probes stays under `--residual-bound`
  (1%) with NACK recovery on;
- rejected admissions carry typed reasons in both the metrics scrape and
  the flight ring;
- sustained churn meets `--target-events` joins+leaves per second.

`--gcm` runs the same soak on AEAD-GCM with the keystream cache on both
bridge tables (kernel O between ticks); `--reconnect` runs the
mass-reconnect storm (DTLS clients, a kill mid-storm and a recover from
the checkpoint).  `--broadcast` and `--cascade` exit non-zero: broadcast
conferences and cascade trunks are ROADMAP Queue 1 item 12.

Usage:
    python3 scripts/torch_churn_soak.py                        # the card
    python3 scripts/torch_churn_soak.py --smoke --device cpu   # quick
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from libjitsi_tpu_torch.control.dtls import (  # noqa: E402
    HAVE_CRYPTOGRAPHY, DtlsSrtpEndpoint, StubDtlsEndpoint,
    generate_certificate)
from libjitsi_tpu_torch.core.packet import PacketBatch  # noqa: E402
from libjitsi_tpu_torch.io.udp import UdpEngine  # noqa: E402
from libjitsi_tpu_torch.rtp import header as rtp_header  # noqa: E402
from libjitsi_tpu_torch.rtp import rtcp  # noqa: E402
from libjitsi_tpu_torch.service.lifecycle import (  # noqa: E402
    ADMIT_REASONS, LifecycleConfig, StreamLifecycleManager)
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge  # noqa: E402
from libjitsi_tpu_torch.service.supervisor import (  # noqa: E402
    BridgeSupervisor, SupervisorConfig)
from libjitsi_tpu_torch.transform.srtp.context import (  # noqa: E402
    SrtpStreamTable)
from libjitsi_tpu_torch.transform.srtp.policy import (  # noqa: E402
    SrtpProfile)
from libjitsi_tpu_torch.utils.faults import (  # noqa: E402
    ChurnModel, DiurnalProfile, TalkSpurtModel)


def _keys(b: int, salt_len: int = 14):
    """Deterministic (master key, master salt) from one byte seed."""
    return (bytes([b & 0xFF]) * 16, bytes([(b + 1) & 0xFF]) * salt_len)


class _Probe:
    """Persistent endpoint measuring end-to-end loss under churn: sends
    talk-spurt media, drops `drop_rate` of its downlink before decrypt
    (wire-level loss — seq/ssrc are read from the clear header), NACKs
    the gaps, and accounts every (sender, seq) it eventually decrypts."""

    FIRST_SEQ = 1000

    def __init__(self, ssrc: int, bridge_port: int, n_probes: int,
                 seed: int, profile=None, device=None):
        self.ssrc = ssrc
        tkw = {"device": device}
        if profile is not None:
            tkw["profile"] = profile
        salt_len = 14 if profile is None else profile.policy.salt_len
        self.rx_key = _keys(ssrc & 0xFF, salt_len)
        self.tx_key = _keys((ssrc + 2) & 0xFF, salt_len)
        self.protect = SrtpStreamTable(capacity=1, **tkw)
        self.protect.add_stream(0, *self.rx_key)
        self.open = SrtpStreamTable(capacity=max(4, n_probes), **tkw)
        self.row_of = {}
        self.engine = UdpEngine(port=0, max_batch=256)
        self.bridge_port = bridge_port
        self.seq = self.FIRST_SEQ
        self.sid = None                    # filled once committed
        self.got = set()                   # (sender ssrc, seq)
        self.pending = {}                  # sender ssrc -> set(seq)
        self.scanned_to = {}               # sender ssrc -> seq
        self._head = {}                    # sender ssrc -> seq @ last round
        self.wire_drops = 0
        self.rng = np.random.default_rng(seed)

    def expect_sender(self, ssrc: int) -> None:
        row = len(self.row_of)
        self.row_of[ssrc] = row
        self.open.add_stream(row, *self.tx_key)
        self.pending[ssrc] = set()
        self.scanned_to[ssrc] = self.FIRST_SEQ

    def send_media(self, n: int = 2) -> None:
        pls = [b"\x5a" * 120] * n
        b = rtp_header.build(pls, [self.seq + i for i in range(n)],
                             [0] * n, [self.ssrc] * n, [96] * n,
                             stream=[0] * n)
        self.seq += n
        self.engine.send_batch(self.protect.protect_rtp(b),
                               "127.0.0.1", self.bridge_port)

    def drain(self, drop_rate: float = 0.0) -> None:
        back, _, _ = self.engine.recv_batch(timeout_ms=0)
        if back.batch_size == 0:
            return
        hdr = rtp_header.parse(back)
        drop = self.rng.random(back.batch_size) < drop_rate
        keep = []
        for i in range(back.batch_size):
            ssrc = int(hdr.ssrc[i])
            if ssrc not in self.row_of:
                continue                   # FEC / foreign stream
            if drop[i] and (ssrc, int(hdr.seq[i])) not in self.got:
                self.wire_drops += 1       # lost on the simulated wire
                continue
            keep.append(i)
        if not keep:
            return
        sub = PacketBatch(
            back.data[keep], np.asarray(back.length)[keep],
            np.asarray([self.row_of[int(hdr.ssrc[i])] for i in keep]))
        dec, ok = self.open.unprotect_rtp(sub)
        dhdr = rtp_header.parse(dec)
        for j in np.nonzero(np.asarray(ok))[0]:
            j = int(j)
            self.got.add((int(dhdr.ssrc[j]), int(dhdr.seq[j])))

    def nack_round(self, senders, max_seqs: int = 30) -> None:
        """Scan each sender's seq space for gaps, NACK the freshest.

        The horizon is the sender's head as of the PREVIOUS round —
        those packets have had a full round trip to arrive, so anything
        absent is a real gap.  (A fixed in-flight allowance freezes the
        horizon just below a pausing talker's final packets, and the
        bridge cache ages them out before the first NACK ever goes
        out.)"""
        for other in senders:
            if other is self:
                continue
            hi = self._head.get(other.ssrc, self.scanned_to[other.ssrc])
            self._head[other.ssrc] = other.seq
            pend = self.pending[other.ssrc]
            for s in range(self.scanned_to[other.ssrc], hi):
                if (other.ssrc, s) not in self.got:
                    pend.add(s)
            self.scanned_to[other.ssrc] = max(
                self.scanned_to[other.ssrc], hi)
            pend -= {s for s in pend if (other.ssrc, s) in self.got}
            if not pend:
                continue
            want = sorted(pend)[-max_seqs:]
            blob = rtcp.build_compound([rtcp.build_nack(rtcp.Nack(
                sender_ssrc=self.ssrc, media_ssrc=other.ssrc,
                lost_seqs=want))])
            wire = self.protect.protect_rtcp(
                PacketBatch.from_payloads([blob], stream=[0]))
            self.engine.send_batch(wire, "127.0.0.1", self.bridge_port)

    def close(self) -> None:
        self.engine.close()


def _timed_protect(table, sid: int, seq0: int, n: int = 64,
                   payload_len: int = 160) -> float:
    """One protect launch against the LIVE table (includes any pending
    copy-on-write / re-upload the churn left behind); returns seconds."""
    pls = [b"\x00" * payload_len] * n
    b = rtp_header.build(pls, [(seq0 + i) & 0xFFFF for i in range(n)],
                         [0] * n, [0x7E57] * n, [96] * n,
                         stream=[sid] * n)
    t0 = time.perf_counter()
    out = table.protect_rtp(b)
    np.asarray(out.data).ravel()[0]        # force materialization
    return time.perf_counter() - t0


def run_soak(duration_s: float = 30.0, ramp_s: float = 6.0,
             settle_s: float = 1.0, dt: float = 0.02,
             join_rate_hz: float = 300.0, mean_hold_s: float = 0.6,
             capacity: int = 1024, probes: int = 3,
             drop_rate: float = 0.05,
             target_events_per_sec: float = 500.0,
             residual_bound: float = 0.01,
             p99_factor_bound: float = 2.0, seed: int = 0,
             gcm: bool = False, device=None,
             verbose: bool = True, report_path=None) -> dict:
    """Run the soak; returns the report dict (every `ok_*` must hold).

    `gcm` swaps the whole wire onto AEAD_AES_128_GCM and enables the
    keystream pregeneration cache on both bridge tables — the same
    acceptance invariants then cover the cached crypto fast path (in
    particular ZERO data-path recompiles: fills and fused-hit kernels
    must ride the warmed ladder: no kernel instance's first launch lands
    inside a tick).  `device` None is the card; the probes' tables sit
    on the same device."""
    profile = SrtpProfile.AEAD_AES_128_GCM if gcm else None
    salt_len = 14 if profile is None else profile.policy.salt_len
    bkw = {} if profile is None else {"profile": profile}
    bridge = SfuBridge(port=0, capacity=capacity, recv_window_ms=0,
                       device=device, **bkw)
    device = bridge.device
    ks_caches = []
    if gcm:
        for t in (bridge.rx_table, bridge.tx_table):
            ks_caches.append(t.enable_keystream_cache(window=256))
    reg = bridge.loop.metrics
    sup = BridgeSupervisor(
        bridge,
        SupervisorConfig(deadline_ms=1000.0,
                         quarantine_auth_threshold=1 << 30,
                         quarantine_replay_threshold=1 << 30),
        metrics=reg)
    lc = StreamLifecycleManager(bridge, supervisor=sup, metrics=reg)

    now = 100.0
    t0_wall = time.perf_counter()

    # ---- probes join through the lifecycle plane like anyone else
    plist = [_Probe(0x50 + 11 * k, bridge.port, probes, seed + 10 + k,
                    profile=profile, device=device)
             for k in range(probes)]
    for p in plist:
        accepted, why = lc.request_join(p.ssrc, p.rx_key, p.tx_key,
                                        name=f"probe-{p.ssrc:#x}")
        assert accepted, f"probe admission refused: {why}"
    while any(p.ssrc not in bridge._ssrc_of.values() for p in plist):
        sup.tick(now=now)
        now += dt
    sid_of = {s: v for v, s in
              ((sid, ssrc) for sid, ssrc in bridge._ssrc_of.items())}
    for p in plist:
        p.sid = sid_of[p.ssrc]
        for other in plist:
            if other is not p:
                p.expect_sender(other.ssrc)

    # ---- address-latch phase: fan-out toward a receiver is filtered
    # (and NOT cached for NACK) until that receiver's source address
    # latches on its first inbound packet, so the first few packets of
    # a brand-new pair are unrecoverable by design.  Every probe sends
    # until all addresses are live, then the per-sender accounting
    # floor is the seq AFTER latch — the soak measures churn loss, not
    # bring-up loss.
    for _ in range(6):
        for p in plist:
            p.send_media(1)
        sup.tick(now=now)
        now += dt
        for p in plist:
            p.drain(0.0)
    floor = {p.ssrc: p.seq for p in plist}
    for p in plist:
        for other in plist:
            if other is not p:
                p.scanned_to[other.ssrc] = floor[other.ssrc]

    # ---- static protect p99 baseline: same tick cadence, probe
    # traffic, wire drops and NACK rounds as the churn window — only
    # the population is frozen.  (A tight idle timing loop would
    # flatter the baseline: no interleaved tick work, perfectly warm
    # caches — and the 2x bound would then measure the cost of ticking,
    # not the cost of churn.)
    spurt = TalkSpurtModel(probes, seed=seed + 1)
    meas_sid = plist[0].sid
    meas_seq = 0
    for _ in range(5):                   # settle the protect path
        _timed_protect(bridge.tx_table, meas_sid, meas_seq)
        meas_seq += 64
    static_samples = []
    static_ticks = max(20, int(round(min(duration_s, 4.0) / dt)))
    for t in range(static_ticks):
        speaking = spurt.advance(dt)
        if t % 2 == 0:
            for i, p in enumerate(plist):
                if speaking[i]:
                    p.send_media(2)
        sup.tick(now=now)
        for p in plist:
            p.drain(drop_rate)
        if t % 2 == 1:
            for p in plist:
                p.nack_round(plist)
        if t % 2 == 0:
            static_samples.append(
                _timed_protect(bridge.tx_table, meas_sid, meas_seq))
            meas_seq += 64
        now += dt
    p99_static = float(np.percentile(static_samples, 99))

    # ---- the churn
    period = 8.0 * duration_s
    t_mid = now + ramp_s + duration_s / 2.0
    cm = ChurnModel(join_rate_hz, mean_hold_s, seed=seed,
                    diurnal=DiurnalProfile(period_s=period, depth=0.2,
                                           peak_t=t_mid + period / 2.0))
    drv = np.random.default_rng(seed + 2)
    next_ssrc = 0x10000
    alive: list = []                       # churned ssrcs not yet left
    churn_samples: list = []
    peak_pop = len(bridge._ssrc_of)

    ramp_ticks = int(round(ramp_s / dt))
    window_ticks = int(round(duration_s / dt))
    settle_ticks = int(round(settle_s / dt))
    w0 = {}                                # counters at window start
    for t in range(ramp_ticks + window_ticks + settle_ticks):
        in_window = ramp_ticks <= t < ramp_ticks + window_ticks
        in_settle = t >= ramp_ticks + window_ticks
        if t == ramp_ticks:
            w0 = dict(recompiles=lc.datapath_recompiles,
                      admits=lc.admits, evicts=lc.evicts,
                      joins=cm.joins_offered, leaves=cm.leaves_offered)
        speaking = spurt.advance(dt)
        if t % 2 == 0:
            for i, p in enumerate(plist):
                if speaking[i]:
                    p.send_media(2)
        if not in_settle:
            joins, leaves = cm.step(dt, now, len(alive))
            for _ in range(joins):
                ssrc = next_ssrc
                next_ssrc += 1
                ok_j, _why = lc.request_join(
                    ssrc, _keys(ssrc & 0xFF, salt_len),
                    _keys((ssrc + 2) & 0xFF, salt_len))
                if ok_j:
                    alive.append(ssrc)
            if leaves and alive:
                committed = set(bridge._ssrc_of.values())
                pool = [s for s in alive if s in committed]
                drv.shuffle(pool)
                for ssrc in pool[:leaves]:
                    lc.request_leave(ssrc=ssrc)
                    alive.remove(ssrc)
        sup.tick(now=now)
        for p in plist:
            p.drain(0.0 if in_settle else drop_rate)
        if t % 2 == 1:
            for p in plist:
                p.nack_round(plist)
        if in_window and t % 2 == 0:
            churn_samples.append(
                _timed_protect(bridge.tx_table, meas_sid, meas_seq))
            meas_seq += 64
        peak_pop = max(peak_pop, len(bridge._ssrc_of))
        now += dt

    # ---- force at least one typed rejection (a duplicate join)
    dup_ok, dup_reason = lc.request_join(plist[0].ssrc,
                                         plist[0].rx_key,
                                         plist[0].tx_key)
    assert not dup_ok and dup_reason == "duplicate", dup_reason

    # ---- accounting
    p99_churn = float(np.percentile(churn_samples, 99))
    expected = 0
    missing = 0
    missing_pairs = []
    for p in plist:
        for other in plist:
            if other is p:
                continue
            lo, hi = floor[other.ssrc], other.seq
            expected += hi - lo
            for s in range(lo, hi):
                if (other.ssrc, s) not in p.got:
                    missing += 1
                    missing_pairs.append(
                        (hex(p.ssrc), hex(other.ssrc), s, hi))
    residual = missing / expected if expected else 0.0

    window_admits = lc.admits - w0["admits"]
    window_evicts = lc.evicts - w0["evicts"]
    events_per_sec = (window_admits + window_evicts) / duration_s
    window_recompiles = lc.datapath_recompiles - w0["recompiles"]

    scrape = reg.render()
    flight_kinds = {e.get("kind")
                    for e in sup.flight.dump_all()["global"]}
    typed_in_scrape = "_admit_rejected{reason=" in scrape
    n_dev = 1

    report = {
        "model_time_s": round(ramp_s + duration_s + settle_s, 3),
        "window_s": duration_s,
        "wall_s": round(time.perf_counter() - t0_wall, 3),
        "device": str(device),
        "capacity_rows": capacity,
        "peak_population": int(peak_pop),
        "peak_population_per_device": round(peak_pop / n_dev, 1),
        "window_admits": window_admits,
        "window_evicts": window_evicts,
        "events_per_sec": round(events_per_sec, 1),
        "events_per_sec_per_device": round(events_per_sec / n_dev, 1),
        "joins_offered": cm.joins_offered,
        "leaves_offered": cm.leaves_offered,
        "admit_rejected": dict(lc.admit_rejected),
        "key_installs": lc.key_installs,
        "warm_bucket": lc._warm_bucket,
        "priming_recompiles": w0["recompiles"],
        "window_recompiles": window_recompiles,
        "protect_p99_static_ms": round(p99_static * 1e3, 3),
        "protect_p99_churn_ms": round(p99_churn * 1e3, 3),
        "probe_expected": expected,
        "probe_wire_drops": sum(p.wire_drops for p in plist),
        "probe_missing": missing,
        "probe_missing_pairs": missing_pairs[:8],
        "rtx_served": bridge.recovery.rtx_requests_served,
        "rtx_cache_miss": bridge.recovery.rtx_cache_miss,
        "retransmitted": bridge.retransmitted,
        "residual_loss_ratio": round(residual, 5),
        "profile": bridge.profile.name,
        "keystream_cache": (None if not ks_caches else {
            "hits": sum(c.hits for c in ks_caches),
            "misses": sum(c.misses for c in ks_caches),
            "evictions": sum(c.evictions for c in ks_caches),
            "filled_slots": sum(c.filled_slots for c in ks_caches),
            "fill_seconds": round(sum(c.fill_seconds
                                      for c in ks_caches), 4),
        }),
        # ---- invariants
        "ok_zero_datapath_recompiles": window_recompiles == 0,
        "ok_protect_p99_bounded":
            p99_churn <= p99_factor_bound * p99_static,
        "ok_residual_loss": residual <= residual_bound,
        "ok_churn_rate": events_per_sec >= target_events_per_sec,
        "ok_typed_reasons": (bool(lc.admit_rejected)
                             and typed_in_scrape
                             and "admit_reject" in flight_kinds),
        "ok_media_flowed": expected > 0 and len(plist[0].got) > 0,
    }
    for p in plist:
        p.close()
    bridge.close()
    if verbose:
        print("---- churn soak report ----")
        for k, v in report.items():
            print(f"{k:32s} {v}")
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return report


class _ReconnectClient:
    """One reconnecting participant: a loopback UDP socket plus a real
    OpenSSL DTLS client endpoint.  The soak admits it through
    `request_handshake`, honors typed refusals by sleeping out the
    retry-after hint with exponential backoff, and counts it restored
    only when BOTH sides hold keys and the bridge row is committed
    live (not merely staged)."""

    def __init__(self, ssrc: int, bridge_port: int, ep_cls,
                 cert_der, key_der, seed: int):
        self.ssrc = ssrc
        self.engine = UdpEngine(port=0, max_batch=64)
        self.bridge_port = bridge_port
        self._ep_cls = ep_cls
        self._cert = (cert_der, key_der)
        self.ep = None
        self.state = "idle"            # idle -> pending -> live
        self.attempts = 0
        self.retry_at = 0.0
        self.requested_at = None       # first admission attempt
        self.refusals = 0
        self.rng = np.random.default_rng(seed)

    @property
    def addr(self):
        return (0x7F000001, self.engine.port)   # 127.0.0.1 as uint32

    def start_handshake(self) -> None:
        """(Re)start the client side from scratch and send the first
        flight — on admit, and again after a crash-recover when the
        server's in-flight association state died with the process."""
        self.ep = self._ep_cls("client", cert_der=self._cert[0],
                               key_der=self._cert[1])
        self._tx(self.ep.handshake_packets())

    def _tx(self, datagrams) -> None:
        if datagrams:
            self.engine.send_batch(PacketBatch.from_payloads(datagrams),
                                   "127.0.0.1", self.bridge_port)

    def pump(self) -> None:
        """Drain inbound server flights, advance the handshake, drive
        the RFC 6347 flight retransmission timer."""
        if self.ep is None or self.state != "pending":
            return
        back, _, _ = self.engine.recv_batch(timeout_ms=0)
        out = []
        for i in range(back.batch_size):
            if self.ep.complete:
                break
            out.extend(self.ep.feed(back.to_bytes(i)))
        if not self.ep.complete:
            out.extend(self.ep.tick())
        self._tx(out)

    def close(self) -> None:
        self.engine.close()


def _dtls_echo(sender, receiver, tick_fn, seq0: int,
               rounds: int = 16, need: int = 3, device=None) -> int:
    """SRTP media through the bridge between two DTLS-keyed clients,
    each side using only its own handshake-exported keys; returns how
    many of the sender's packets the receiver decrypted."""
    prof_s, stk, stsalt, _, _ = sender.ep.srtp_keys()
    tx = SrtpStreamTable(capacity=1, profile=prof_s, device=device)
    tx.add_stream(0, stk, stsalt)
    prof_r, _, _, rrk, rrsalt = receiver.ep.srtp_keys()
    rx = SrtpStreamTable(capacity=1, profile=prof_r, device=device)
    rx.add_stream(0, rrk, rrsalt)
    got, seq = 0, seq0
    for _ in range(rounds):
        pkt = rtp_header.build([b"\x5b" * 120] * 2, [seq, seq + 1],
                               [0, 0], [sender.ssrc] * 2, [96] * 2,
                               stream=[0, 0])
        seq += 2
        sender.engine.send_batch(tx.protect_rtp(pkt), "127.0.0.1",
                                 sender.bridge_port)
        tick_fn()
        back, _, _ = receiver.engine.recv_batch(timeout_ms=0)
        if back.batch_size == 0:
            continue
        hdr = rtp_header.parse(back)
        keep = [i for i in range(back.batch_size)
                if int(hdr.ssrc[i]) == sender.ssrc]
        if not keep:
            continue
        sub = PacketBatch(back.data[keep],
                          np.asarray(back.length)[keep],
                          np.asarray([0] * len(keep)))
        _dec, ok = rx.unprotect_rtp(sub)
        got += int(np.asarray(ok).sum())
        if got >= need:
            break
    return got


def _flight_kinds(flight) -> set:
    dump = flight.dump_all()
    kinds = {e.get("kind") for e in dump["global"]}
    for evs in dump["streams"].values():
        kinds |= {e.get("kind") for e in evs}
    return kinds


def run_reconnect_soak(n_clients: int = 1000, dt: float = 0.02,
                       max_handshakes: int = 128,
                       handshake_batch: int = 256,
                       kill_frac: float = 0.5,
                       restore_p99_bound_s: float = 10.0,
                       storm_budget_s: float = 120.0,
                       capacity=None, seed: int = 0, device=None,
                       verbose: bool = True, report_path=None) -> dict:
    """Mass-reconnect chaos scenario: `n_clients` real DTLS clients
    storm one bridge's handshake plane, the bridge is killed mid-storm
    and recovered from its checkpoint, and every association must come
    back — completed rows with working keys, staged rows committed or
    rolled back, in-flight rows requeued at their bound 5-tuple.
    Acceptance gates (every `ok_*` must hold):

    - time-to-media-restored p99 (recover -> committed live with both
      sides keyed, model time) under `restore_p99_bound_s`;
    - ZERO data-path recompiles inside tick windows after priming, on
      both the original and the recovered bridge;
    - ZERO handshake work attributed to the tick thread: every OpenSSL
      feed runs on the between-ticks drain (PhaseProfiler off-tick
      ledger + the lifecycle feed bracket both say so);
    - every refusal TYPED (`handshake_backlog` observed, with a
      retry-after hint clients honor via exponential backoff) and the
      total refusal count bounded — no refusal storms, no silent drops;
    - keys land ONLY via the staged commit barrier (stage counts match
      handshake completions exactly — the inline install path never
      runs)."""
    try:                               # one UDP socket per client
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < n_clients + 256:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(hard, n_clients + 512), hard))
    except Exception:
        pass

    if capacity is None:
        capacity = max(256, 2 * n_clients)
    bridge = SfuBridge(port=0, capacity=capacity, recv_window_ms=0,
                       device=device)
    device = bridge.device
    reg = bridge.loop.metrics
    sup = BridgeSupervisor(
        bridge,
        SupervisorConfig(deadline_ms=1000.0,
                         quarantine_auth_threshold=1 << 30,
                         quarantine_replay_threshold=1 << 30),
        metrics=reg)
    lcfg = LifecycleConfig(max_handshakes=max_handshakes,
                           handshake_batch=handshake_batch)
    lc = StreamLifecycleManager(bridge, supervisor=sup, metrics=reg,
                                config=lcfg)

    now = 100.0
    t0_wall = time.perf_counter()
    # real OpenSSL endpoints when `cryptography` is installed; the
    # same-surface stub otherwise (gated dependency — the plane's
    # datagram flows, admission and recovery logic are identical)
    if HAVE_CRYPTOGRAPHY:
        ep_cls = DtlsSrtpEndpoint
        cert_der, key_der, _fp = generate_certificate("reconnect-soak")
    else:
        ep_cls = StubDtlsEndpoint
        cert_der = key_der = None
    bridge._dtls.endpoint_factory = ep_cls
    clients = [_ReconnectClient(0x20000 + k, bridge.port, ep_cls,
                                cert_der, key_der, seed + 100 + k)
               for k in range(n_clients)]
    refused: dict = {}

    def _try_admit(c, lc_cur):
        if c.requested_at is None:
            c.requested_at = now
        ok, reason, retry = lc_cur.request_handshake(
            c.ssrc, remote_addr=c.addr, name=f"rc-{c.ssrc:#x}")
        if ok:
            c.state = "pending"
            c.attempts = 0
            c.start_handshake()
        else:
            c.refusals += 1
            refused[reason] = refused.get(reason, 0) + 1
            c.attempts += 1
            base = retry if retry > 0 else 0.05
            # exponential backoff on the server's retry-after hint,
            # jittered so the retry wave doesn't resynchronize into
            # the next storm front
            c.retry_at = now + base * (2 ** min(c.attempts - 1, 6)) \
                * (1.0 + 0.25 * float(c.rng.random()))
        return ok

    def _promote(b, cs, lat, base) -> None:
        committed = {ssrc: sid for sid, ssrc in b._ssrc_of.items()}
        for c in cs:
            if (c.state != "pending" or c.ep is None
                    or not c.ep.complete):
                continue
            sid = committed.get(c.ssrc)
            if (sid is not None and sid in b._tx_keys
                    and sid not in b._staged):
                c.state = "live"
                lat.append(now - (c.requested_at if base is None
                                  else base))

    # ---- priming: two clients handshake and exchange media BEFORE the
    # measured window, so first-media compiles land as priming, and the
    # final post-recover echo rides warm caches
    for c in clients[:2]:
        ok, why, _r = lc.request_handshake(
            c.ssrc, remote_addr=c.addr, name=f"rc-{c.ssrc:#x}")
        assert ok, f"priming admission refused: {why}"
        c.state = "pending"
        c.requested_at = now
        c.start_handshake()
    for _ in range(600):
        sup.tick(now=now)
        for c in clients[:2]:
            c.pump()
        _promote(bridge, clients[:2], [], None)
        now += dt
        if all(c.state == "live" for c in clients[:2]):
            break
    assert all(c.state == "live" for c in clients[:2]), \
        "priming handshakes stalled"

    def _tick1():
        nonlocal now
        sup.tick(now=now)
        now += dt

    prime_got = _dtls_echo(clients[0], clients[1], _tick1, seq0=3000,
                           device=device)
    assert prime_got > 0, "priming media never flowed"
    w0 = dict(recompiles=lc.datapath_recompiles)

    # ---- the storm: everyone else reconnects at once
    storm_ticks = int(round(storm_budget_s / dt))
    kill_target = max(2, int(round(kill_frac * n_clients)))
    latencies_join: list = []
    peak_depth = 0
    for _ in range(storm_ticks):
        for c in clients:
            if c.state == "idle" and now >= c.retry_at:
                _try_admit(c, lc)
        sup.tick(now=now)
        for c in clients:
            c.pump()
        _promote(bridge, clients, latencies_join, None)
        peak_depth = max(peak_depth, lc.handshakes.depth)
        now += dt
        n_live = sum(1 for c in clients if c.state == "live")
        if n_live >= kill_target and lc.handshakes.depth > 0:
            break
    n_live_at_kill = sum(1 for c in clients if c.state == "live")
    assert lc.handshakes.depth > 0, \
        "storm drained before the kill point — raise n_clients"

    # ---- kill mid-storm, recover from the checkpoint
    ckpt = os.path.join(tempfile.gettempdir(),
                        f"reconnect_soak_{os.getpid()}.ckpt")
    sup.save_checkpoint(ckpt)
    pre = dict(feeds=bridge._dtls.feeds_total,
               retransmits=bridge._dtls.retransmits_total,
               inbox_dropped=bridge._dtls.inbox_dropped,
               completed=lc.handshakes.completed,
               key_installs=lc.key_installs,
               recompiles=lc.datapath_recompiles,
               tick_feeds=lc.tick_thread_handshake_feeds,
               off_tick_s=lc.handshakes.off_tick_seconds,
               pending=len(bridge._dtls.pending),
               inbox=len(bridge._dtls._inbox))
    scrape1 = reg.render()
    kinds = _flight_kinds(sup.flight)
    bridge.close()                                 # the crash

    sup2 = BridgeSupervisor.recover(ckpt, SfuBridge, port=0,
                                    device=device,
                                    supervisor_config=sup.cfg,
                                    recv_window_ms=0)
    bridge2 = sup2.bridge
    bridge2._dtls.endpoint_factory = ep_cls     # before reconcile requeues
    lc2 = StreamLifecycleManager(bridge2, supervisor=sup2,
                                 metrics=bridge2.loop.metrics,
                                 config=lcfg)
    recover_now = now
    latencies_restore: list = []
    requeued_ssrcs = {bridge2._ssrc_of[s] for s in bridge2._dtls.pending
                      if s in bridge2._ssrc_of}
    keyed_ssrcs = {v for s, v in bridge2._ssrc_of.items()
                   if s in bridge2._tx_keys}
    restored_instantly = 0
    for c in clients:
        c.bridge_port = bridge2.port
        if (c.state == "live" and c.ssrc in keyed_ssrcs
                and c.ep is not None and c.ep.complete):
            restored_instantly += 1       # keys rode the checkpoint
            latencies_restore.append(dt)
            continue
        if c.ssrc in requeued_ssrcs:
            # server row survived as a fresh pending association bound
            # to our 5-tuple: redo the client side against it
            c.state = "pending"
            c.start_handshake()
        elif c.ssrc in keyed_ssrcs:
            # server completed + keyed but WE never saw the final
            # flight: only signaling resolves this — leave + rejoin
            lc2.request_leave(ssrc=c.ssrc)
            c.state = "idle"
            c.ep = None
            c.attempts = 0
            c.retry_at = recover_now + 5 * dt
        else:
            # association didn't survive (requeue refused under
            # backlog, or never admitted): back to the admission queue
            c.state = "idle"
            c.ep = None
            c.attempts = 0
            c.retry_at = recover_now

    sup2.tick(now=now)            # commit the reconciled staged rows
    now += dt
    torn = [s for s in bridge2._ssrc_of
            if s not in bridge2._tx_keys
            and s not in bridge2._dtls.pending]

    # ---- drive the re-handshake wave until everyone is back
    for _ in range(storm_ticks):
        if all(c.state == "live" for c in clients):
            break
        for c in clients:
            if c.state == "idle" and now >= c.retry_at:
                _try_admit(c, lc2)
        sup2.tick(now=now)
        for c in clients:
            c.pump()
        _promote(bridge2, clients, latencies_restore, recover_now)
        peak_depth = max(peak_depth, lc2.handshakes.depth)
        now += dt

    def _tick2():
        nonlocal now
        sup2.tick(now=now)
        now += dt

    all_live = all(c.state == "live" for c in clients)
    echo_got = (_dtls_echo(clients[0], clients[1], _tick2, seq0=4000,
                           device=device)
                if clients[0].state == clients[1].state == "live"
                else 0)

    # ---- accounting
    p99_restore = (float(np.percentile(latencies_restore, 99))
                   if latencies_restore else float("inf"))
    p99_join = (float(np.percentile(latencies_join, 99))
                if latencies_join else 0.0)
    window_recompiles = ((pre["recompiles"] - w0["recompiles"])
                         + lc2.datapath_recompiles)
    feeds_total = pre["feeds"] + bridge2._dtls.feeds_total
    tick_feeds = pre["tick_feeds"] + lc2.tick_thread_handshake_feeds
    off_tick_s = pre["off_tick_s"] + lc2.handshakes.off_tick_seconds
    completed = pre["completed"] + lc2.handshakes.completed
    key_installs = pre["key_installs"] + lc2.key_installs
    total_refusals = sum(c.refusals for c in clients)
    kinds |= _flight_kinds(sup2.flight)
    attr2 = sup2.phase_attribution().get("off_tick", {})

    report = {
        "mode": "reconnect",
        "endpoint_impl": ("openssl" if HAVE_CRYPTOGRAPHY else "stub"),
        "clients": n_clients,
        "max_handshakes": max_handshakes,
        "handshake_batch": handshake_batch,
        "capacity_rows": capacity,
        "wall_s": round(time.perf_counter() - t0_wall, 3),
        "model_time_s": round(now - 100.0, 3),
        "live_at_kill": n_live_at_kill,
        "pending_at_kill": pre["pending"],
        "inbox_at_kill": pre["inbox"],
        "requeued": lc2.handshakes.requeued,
        "restored_instantly": restored_instantly,
        "peak_queue_depth": peak_depth,
        "handshakes_completed": completed,
        "key_installs_staged": key_installs,
        "dtls_feeds_total": feeds_total,
        "dtls_retransmits_total": (pre["retransmits"]
                                   + bridge2._dtls.retransmits_total),
        "inbox_dropped": (pre["inbox_dropped"]
                          + bridge2._dtls.inbox_dropped),
        "refusals": dict(refused),
        "refusals_total": total_refusals,
        "join_p99_s": round(p99_join, 4),
        "restore_p99_s": round(p99_restore, 4),
        "restore_samples": len(latencies_restore),
        "priming_recompiles": w0["recompiles"],
        "window_recompiles": window_recompiles,
        "off_tick_drain_s": round(off_tick_s, 4),
        "off_tick_ledger": attr2,
        "torn_rows": torn,
        "echo_decrypted": echo_got,
        # ---- invariants
        "ok_all_restored": all_live,
        "ok_media_restored_p99": (all_live and len(latencies_restore) > 0
                                  and p99_restore <= restore_p99_bound_s),
        "ok_zero_datapath_recompiles": window_recompiles == 0,
        "ok_no_tick_thread_handshake": (
            tick_feeds == 0 and feeds_total > 0 and off_tick_s > 0
            and attr2.get("handshake_tick_thread_feeds", 1) == 0),
        "ok_typed_refusals": (
            refused.get("handshake_backlog", 0) > 0
            and set(refused) <= set(ADMIT_REASONS)
            and '_admit_rejected{reason="handshake_backlog"' in scrape1
            and "handshake_reject" in kinds
            and total_refusals <= n_clients * 40),
        "ok_commit_barrier_only": (key_installs == completed
                                   and completed >= n_clients
                                   and "handshake_complete" in kinds),
        "ok_reconciled": (not torn
                          and (pre["pending"] == 0
                               or "handshake_requeue" in kinds)),
        "ok_media_flowed": prime_got > 0 and echo_got > 0,
    }
    for c in clients:
        c.close()
    bridge2.close()
    try:
        os.remove(ckpt)
    except OSError:
        pass
    if verbose:
        print("---- reconnect storm soak report ----")
        for k, v in report.items():
            print(f"{k:32s} {v}")
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=30.0,
                    help="measured churn window, model seconds")
    ap.add_argument("--ramp", type=float, default=6.0,
                    help="ramp to steady state before the window")
    ap.add_argument("--join-rate", type=float, default=300.0)
    ap.add_argument("--hold", type=float, default=0.6,
                    help="mean stream hold time, seconds")
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--probes", type=int, default=3)
    ap.add_argument("--drop", type=float, default=0.05,
                    help="simulated probe downlink loss rate")
    ap.add_argument("--target-events", type=float, default=500.0,
                    help="required sustained joins+leaves per second")
    ap.add_argument("--residual-bound", type=float, default=0.01)
    ap.add_argument("--p99-factor", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", type=str, default=None,
                    help="write the JSON report here")
    ap.add_argument("--smoke", action="store_true",
                    help="fast tier-1 configuration (~3 s model time)")
    ap.add_argument("--gcm", action="store_true",
                    help="AEAD-GCM wire with the keystream "
                         "pregeneration cache enabled on both bridge "
                         "tables (zero-recompile acceptance for the "
                         "cached crypto fast path)")
    ap.add_argument("--device", default=None,
                    help="torch device of the bridge and its clients "
                         "(default: the card)")
    ap.add_argument("--broadcast", action="store_true",
                    help="broadcast-conference mode (not ported: ROADMAP "
                         "Queue 1 item 12)")
    ap.add_argument("--reconnect", action="store_true",
                    help="reconnect-storm chaos mode: mass DTLS "
                         "re-handshakes with a mid-storm kill/recover")
    ap.add_argument("--cascade", action="store_true",
                    help="bridge-cascade chaos mode (not ported: ROADMAP "
                         "Queue 1 item 12)")
    ap.add_argument("--clients", type=int, default=1000,
                    help="reconnect mode: simultaneous DTLS clients")
    ap.add_argument("--max-handshakes", type=int, default=128,
                    help="reconnect mode: admission bound on in-flight "
                         "handshakes (past it: typed refusals)")
    ap.add_argument("--handshake-batch", type=int, default=256,
                    help="reconnect mode: per-drain OpenSSL budget")
    ap.add_argument("--restore-p99", type=float, default=10.0,
                    help="reconnect mode: time-to-media-restored p99 "
                         "bound, model seconds")
    args = ap.parse_args()
    if args.broadcast or args.cascade:
        mode = "--broadcast" if args.broadcast else "--cascade"
        print(f"{mode}: broadcast conferences and cascade trunks are not "
              "ported yet (ROADMAP Queue 1, item 12)", file=sys.stderr)
        return 2
    if args.reconnect:
        kw = dict(n_clients=args.clients,
                  max_handshakes=args.max_handshakes,
                  handshake_batch=args.handshake_batch,
                  restore_p99_bound_s=args.restore_p99,
                  seed=args.seed, device=args.device,
                  report_path=args.report)
        if args.smoke:
            kw.update(n_clients=24, max_handshakes=6,
                      handshake_batch=8, capacity=128,
                      storm_budget_s=60.0)
        report = run_reconnect_soak(**kw)
        failed = [k for k, v in report.items()
                  if k.startswith("ok_") and not v]
        if failed:
            print(f"INVARIANT FAILURES: {failed}", file=sys.stderr)
            return 1
        print("all reconnect-storm invariants held")
        return 0
    kw = dict(duration_s=args.duration, ramp_s=args.ramp,
              join_rate_hz=args.join_rate, mean_hold_s=args.hold,
              capacity=args.capacity, probes=args.probes,
              drop_rate=args.drop,
              target_events_per_sec=args.target_events,
              residual_bound=args.residual_bound,
              p99_factor_bound=args.p99_factor, seed=args.seed,
              gcm=args.gcm, device=args.device, report_path=args.report)
    if args.smoke:
        kw.update(duration_s=2.0, ramp_s=1.0, join_rate_hz=60.0,
                  mean_hold_s=0.5, capacity=128, probes=2,
                  target_events_per_sec=100.0)
    report = run_soak(**kw)
    failed = [k for k, v in report.items()
              if k.startswith("ok_") and not v]
    if failed:
        print(f"INVARIANT FAILURES: {failed}", file=sys.stderr)
        return 1
    print("all churn invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
