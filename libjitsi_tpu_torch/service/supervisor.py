"""Supervised runtime: watchdog, overload shedding, stream quarantine,
and crash-restart recovery from checkpoints.

Counterpart: `libjitsi_tpu/service/supervisor.py` `BridgeSupervisor`,
copied whole (host only) over the port's bridges, which supply process
supervision of their own, since the reference ran inside a JVM container.
One `BridgeSupervisor` wraps a bridge's tick and layers four mechanisms:

1. **Watchdog**: every tick is timed against a deadline (default: the
   ptime budget).  Consecutive overruns drive a health state machine
   (healthy -> overloaded -> stalled) exported through the
   MetricsRegistry, so an orchestrator can probe liveness without
   touching media.

2. **Graceful degradation**: sustained overload walks an escalation
   ladder.  Rung 1 shrinks the recv batching window to 0 (poll, do not
   wait); rung 2 sets `bridge.degraded` (the conference bridge skips
   speaker scoring and egress level stamping, the SFU its RTCP reports).
   On a bridge with a loss-recovery controller (`bridge.recovery`,
   `sfu/recovery.py`) two more rungs come before stream loss: shed FEC,
   then throttle the retransmission budget; only then are the
   lowest-priority streams shed, deterministically.  When one stage owns
   the tick's budget ledger the ladder acts on that stage first
   (`_pick_rung`); every escalation records the dominant stage and the
   dominant host/device phase (`utils/perf.classify_bound`).  Recovery
   walks the ladder back down LIFO once ticks meet the deadline again,
   restoring shed streams.

3. **Stream quarantine**: per-stream sliding windows over the SRTP
   auth-failure and replay-rejection counters.  A stream over the
   threshold is dropped at ingress (the loop's `inbound_drop`, before
   the source-address latch, so a spoofing sender cannot redirect return
   media) and re-admitted after an exponentially backed-off ban.

4. **Crash-restart recovery**: whole-bridge snapshots into one versioned
   checkpoint file (atomic rename; the JAX package's magic, version and
   blob keys, so either package's file loads in the other), and
   `recover()`, which reopens the socket with bounded retry and restores
   the bridge with SRTP ROC and replay state intact.

`recover(path, bridge_cls, port=0, device=None, ...)` differs from the
JAX form, `recover(config, path, bridge_cls, ...)`: the port's bridges
take no `config`, and their `restore(snap, port, device)` takes the
device, which is the card unless the caller passes `device="cpu"`.
`CascadeSupervisor` belongs to `mesh/cascade.py`, ROADMAP Queue 1 item
12: the port's class raises `NotImplementedError` until then.
"""

from __future__ import annotations

import os
import pickle
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from libjitsi_tpu_torch.core.device import DeviceLike
from libjitsi_tpu_torch.utils.flight import FlightRecorder
from libjitsi_tpu_torch.utils.health import (ExponentialBackoff,
                                             SlidingWindowCounter, Watchdog,
                                             retrying, state_code)
from libjitsi_tpu_torch.utils.perf import classify_bound
from libjitsi_tpu_torch.utils.tracing import PipelineTracer

CKPT_MAGIC = "ljt-ckpt"
CKPT_VERSION = 1


@dataclass
class SupervisorConfig:
    """Knobs, all per-tick counts unless suffixed otherwise.

    Quarantine thresholds are windowed totals: an SSRC is banned when
    its last `quarantine_window` ticks accumulate that many SRTP auth
    failures / replay rejections.  Replay's threshold is much higher —
    reordering and duplication produce benign replay hits, only a storm
    (attack or broken sender) should convict.
    """

    deadline_ms: float = 20.0
    overload_after: int = 3          # consecutive overruns -> escalate
    stall_after: int = 25            # consecutive overruns -> STALLED
    overload_exit: int = 5           # consecutive good ticks -> de-escalate
    shed_step: int = 4               # streams shed per level-3+ escalation
    # stage attribution: when one stage owns at least this share of the
    # tick's budget ledger, escalation jumps to the rung that targets
    # that stage (forward_chain -> shed FEC, ingress -> shrink the recv
    # window) instead of walking the wall-time ladder in order
    stage_share_threshold: float = 0.6
    quarantine_window: int = 50      # ticks of history per stream
    quarantine_auth_threshold: int = 20
    quarantine_replay_threshold: int = 200
    quarantine_backoff_ticks: int = 50    # first ban length
    quarantine_backoff_cap: int = 1600    # ban length ceiling
    checkpoint_every: int = 0        # ticks between checkpoints; 0 = off
    checkpoint_path: Optional[str] = None


class BridgeSupervisor:
    """Wraps ConferenceBridge / SfuBridge ticks with the four mechanisms
    above.  Call `sup.tick()` wherever you called `bridge.tick()`; the
    bridge result passes through unchanged.
    """

    def __init__(self, bridge, config: Optional[SupervisorConfig] = None,
                 metrics=None, priorities: Optional[Dict[int, int]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 flight: Optional[FlightRecorder] = None,
                 slo=None):
        self.bridge = bridge
        self.cfg = config or SupervisorConfig()
        self.loop = getattr(bridge, "loop", bridge)
        self.clock = clock
        self.priorities = priorities or {}
        # flight recorder: every destructive action below (quarantine,
        # shed, recover) dumps a post-mortem naming its trigger
        self.flight = flight if flight is not None else FlightRecorder()
        self.postmortems: deque = deque(maxlen=32)
        # optional SloEngine (utils/slo.py): ticked here so its windows
        # advance on the same cadence as the watchdog, and its worst
        # state rides on every ladder_escalate event
        self.slo = slo
        if slo is not None and getattr(slo, "flight", None) is None:
            slo.flight = self.flight
        self._attach_flight()
        # stage-budget ledger drained from the loop's PipelineTracer
        # each tick: overload events name the dominant stage instead of
        # just "the tick was slow"
        self.tracer: Optional[PipelineTracer] = getattr(
            self.loop, "tracer", None)
        self.last_ledger: Dict[str, float] = {}
        # host/device phase ledger (utils/perf.PhaseProfiler via the
        # tracer): escalations say host-bound vs device-bound, not just
        # which stage.  getattr-guarded — test stubs carry only
        # take_ledger
        self.last_phases: Dict[str, float] = {}
        cap = self.loop.registry.capacity
        self.watchdog = Watchdog(self.cfg.deadline_ms / 1000.0,
                                 overload_after=self.cfg.overload_after,
                                 stall_after=self.cfg.stall_after)
        self._auth_win = SlidingWindowCounter(cap, self.cfg.quarantine_window)
        self._replay_win = SlidingWindowCounter(cap,
                                                self.cfg.quarantine_window)
        # baseline the failure counters at ATTACH time: a supervisor
        # adopting a long-running (or just-restored) bridge must judge
        # fresh failures only, not replay history as a sudden burst
        table = getattr(bridge, "rx_table", None)
        if table is not None and hasattr(table, "auth_fail"):
            self._last_auth = np.asarray(table.auth_fail[:cap]).copy()
            self._last_replay = np.asarray(
                table.replay_reject[:cap]).copy()
        else:
            self._last_auth = np.zeros(cap, dtype=np.int64)
            self._last_replay = np.zeros(cap, dtype=np.int64)
        self._ban = ExponentialBackoff(self.cfg.quarantine_backoff_ticks,
                                       cap=self.cfg.quarantine_backoff_cap)
        self.level = 0               # current escalation-ladder rung
        self._rungs: List[str] = []  # actions taken, LIFO unwind order
        self._good = 0               # consecutive on-deadline ticks
        self._shed: List[int] = []   # shed sids, LIFO restore order
        self._shed_set: set = set()
        # sids evicted by the lifecycle plane (stream LEFT, the slot is
        # dead or recycled): distinct from overload sheds, so the LIFO
        # unwind never "restores" a departed stream
        self._evicted: set = set()
        # StreamLifecycleManager attaches itself here; when present its
        # commit barrier + off-tick install stage run between ticks
        self.lifecycle = None
        # optional AdaptiveBatcher (io/batching.py): ticked on this
        # cadence; the recv_window rung clamps its window writes so the
        # ladder and the tuner never fight over the same knob
        self.batcher = None
        # optional CapacityModel (utils/capacity.py): fed each tick,
        # consulted by admission_decision (capacity_forecast) and the
        # lifecycle plane's placement steering / retry-after hints
        self.capacity = None
        self.last_tick_s = 0.0
        self._quarantined: Dict[int, int] = {}  # sid -> release tick
        self._q_strikes: Dict[int, int] = {}    # sid -> conviction count
        self.quarantine_total = 0
        self._saved_window: Optional[float] = None
        self.ticks = 0
        self.checkpoints_written = 0
        if metrics is not None:
            self.register_metrics(metrics)

    def _attach_flight(self) -> None:
        """Hand the recorder to every pipeline piece that can feed it
        (loop header samples, recovery-ladder actions, bridge events).
        Only objects that declare a `flight` slot participate."""
        for obj in (self.loop, self.bridge,
                    getattr(self.bridge, "recovery", None)):
            if obj is not None and hasattr(obj, "flight"):
                obj.flight = self.flight

    # ------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None):
        lc = self.lifecycle
        if lc is not None:
            # bracket the data path with the compile-cache guard: any
            # compile event landing inside this window is a lifecycle
            # bug (shapes must be warmed off-tick)
            lc.tick_begin()
        t0 = self.clock()
        result = (self.bridge.tick(now=now) if now is not None
                  else self.bridge.tick())
        self.last_tick_s = self.clock() - t0
        over = self.watchdog.observe(self.last_tick_s)
        if lc is not None:
            lc.tick_end()
        if self.tracer is not None:
            self.last_ledger = self.tracer.take_ledger()
            take_phases = getattr(self.tracer, "take_phase_ledger",
                                  None)
            if take_phases is not None:
                phases = take_phases()
                if phases:       # sampled ticks only; keep last split
                    self.last_phases = phases
        self.ticks += 1
        if self.slo is not None:
            self.slo.on_tick()
        if self.batcher is not None:
            self.batcher.on_tick()
        if self.capacity is not None:
            self.capacity.on_tick(self)
        self._update_quarantine()
        if over:
            self._good = 0
            # one rung per `overload_after` consecutive overruns: graded
            # pressure, not a free-fall to full shedding
            if (self.watchdog.consecutive % self.cfg.overload_after) == 0:
                self._escalate()
        else:
            self._good += 1
            if self.level > 0 and self._good >= self.cfg.overload_exit:
                self._deescalate()
                self._good = 0
        if (self.cfg.checkpoint_every
                and self.ticks % self.cfg.checkpoint_every == 0):
            self.save_checkpoint()
        if lc is not None:
            # between-ticks window: flip staged streams live (commit
            # barrier), then stage the next admit/evict wave off-tick
            lc.run_between_ticks(now=now)
        return result

    # ------------------------------------------- overload escalation

    #: wall-time rung order (the PR-2 ladder); recovery-only rungs are
    #: skipped on bridges without a controller, and `shed_streams`
    #: repeats once every named rung is held
    LADDER = ("recv_window", "degrade", "shed_fec", "throttle_rtx")

    def _slo_state(self) -> str:
        return self.slo.state() if self.slo is not None else "none"

    def _pick_rung(self, stage: Optional[str], share: float,
                   rec) -> str:
        """Stage-attributed rung choice: when one stage owns the tick
        budget, act on THAT stage — shed FEC only when forward_chain
        dominates, shrink the recv window only when ingress does.  No
        dominant stage (or its rung already held) falls back to the
        wall-time ladder order."""
        taken = set(self._rungs)
        if share >= self.cfg.stage_share_threshold:
            if (stage == "forward_chain" and rec is not None
                    and "shed_fec" not in taken):
                return "shed_fec"
            if stage == "ingress" and "recv_window" not in taken:
                return "recv_window"
        for rung in self.LADDER:
            if rung in ("shed_fec", "throttle_rtx") and rec is None:
                continue
            if rung not in taken:
                return rung
        return "shed_streams"

    def _apply_rung(self, rung: str) -> None:
        rec = getattr(self.bridge, "recovery", None)
        if rung == "recv_window":
            # stop waiting for packets: the batching window is latency
            # the tick can't afford while behind
            self._saved_window = getattr(self.loop, "recv_window_ms",
                                         None)
            if self._saved_window is not None:
                self.loop.recv_window_ms = 0
            if self.batcher is not None:
                self.batcher.clamp_window(True)
        elif rung == "degrade":
            self.bridge.degraded = True
        elif rung == "shed_fec":
            # loss-recovery coupling: FEC overhead is the first
            # bandwidth/CPU to go — redundancy sheds before media
            rec.shed_fec(True)
        elif rung == "throttle_rtx":
            # then the retransmission budget shrinks...
            rec.throttle_rtx(True)
        else:
            # ...and only then are whole streams dropped
            self._shed_streams(self.cfg.shed_step)

    def _escalate(self) -> None:
        self.level += 1
        rec = getattr(self.bridge, "recovery", None)
        # budget attribution: the ladder acts on WHERE the tick budget
        # went, not just that it overran — the dominant stage, its
        # ledger share, the chosen rung, and the SLO state ride on
        # every escalation event for the post-mortem
        stage, stage_s = PipelineTracer.dominant(self.last_ledger)
        total = sum(self.last_ledger.values())
        share = (stage_s / total) if total > 0 else 0.0
        rung = self._pick_rung(stage, share, rec)
        phase, _phase_s, phase_share, bound = self._phase_attr()
        self.flight.record(
            "ladder_escalate", tick=self.ticks, level=self.level,
            worst_s=self.watchdog.worst_s,
            stage=stage or "unknown", stage_s=stage_s,
            stage_share=round(share, 4), rung=rung,
            phase=phase, phase_share=round(phase_share, 4),
            bound=bound, slo_state=self._slo_state())
        self._apply_rung(rung)
        self._rungs.append(rung)

    def _deescalate(self) -> None:
        """Pop the most recent rung and reverse it — LIFO, so whatever
        order stage attribution escalated in, recovery unwinds it."""
        rec = getattr(self.bridge, "recovery", None)
        rung = self._rungs.pop() if self._rungs else "shed_streams"
        self.flight.record("ladder_deescalate", tick=self.ticks,
                           level=self.level - 1, rung=rung)
        if rung == "shed_streams":
            if self._shed:
                restored = 0
                while self._shed and restored < self.cfg.shed_step:
                    sid = self._shed.pop()
                    self._shed_set.discard(sid)
                    if sid in self._evicted:
                        # the stream LEFT while shed: its slot is dead
                        # (or already recycled) — restoring it would
                        # resurrect a departed stream into someone
                        # else's row.  Skip without consuming budget.
                        continue
                    self.flight.record("shed_restore", sid=sid,
                                       tick=self.ticks)
                    restored += 1
                self._sync_drop_mask()
        elif rung == "throttle_rtx" and rec is not None:
            rec.throttle_rtx(False)
        elif rung == "shed_fec" and rec is not None:
            rec.shed_fec(False)
        elif rung == "degrade":
            self.bridge.degraded = False
        elif rung == "recv_window" and self._saved_window is not None:
            self.loop.recv_window_ms = self._saved_window
            self._saved_window = None
            if self.batcher is not None:
                self.batcher.clamp_window(False)
        self.level -= 1

    def _active_sids(self) -> List[int]:
        by_ssrc = getattr(self.bridge, "_ssrc_of", None)
        if by_ssrc:
            return sorted(by_ssrc.keys())
        ports = getattr(self.loop, "addr_port", None)
        if ports is None:
            return []
        return [int(s) for s in np.nonzero(np.asarray(ports) > 0)[0]]

    def _shed_streams(self, k: int) -> None:
        """Shed the k lowest-priority active streams, deterministically:
        priority ascending (default 0), then highest sid first — newest
        joins go before long-standing participants.  The dominant
        speaker is never shed."""
        speaker = getattr(self.bridge, "speaker", None)
        dominant = getattr(speaker, "dominant", -1) if speaker else -1
        staged = getattr(self.bridge, "_staged", ())
        cands = [s for s in self._active_sids()
                 if s not in self._shed_set and s not in self._quarantined
                 and s not in staged and s != dominant]
        cands.sort(key=lambda s: (self.priorities.get(s, 0), -s))
        stage, stage_s = PipelineTracer.dominant(self.last_ledger)
        for sid in cands[:k]:
            self._shed.append(sid)
            self._shed_set.add(sid)
            ev = self.flight.record(
                "shed", sid=sid, tick=self.ticks, level=self.level,
                priority=self.priorities.get(sid, 0),
                stage=stage or "unknown", stage_s=stage_s)
            self.postmortems.append({
                "trigger": "overload_shed", "sid": sid,
                "tick": self.ticks, "event": ev,
                "dump": self.flight.dump(sid)})
        if cands[:k]:
            self._sync_drop_mask()

    # ------------------------------------------------- lifecycle plane

    def note_evicted(self, sids) -> None:
        """Lifecycle evict bookkeeping: the stream LEFT — this is not an
        overload shed.  Clear every per-sid mechanism (shed membership,
        quarantine, strike history, failure windows) so the departed
        stream can never be restored, and its row's next occupant starts
        with a clean record.  Flight-records `evicted`, distinct from
        `shed`."""
        changed = False
        for sid in sids:
            sid = int(sid)
            self._evicted.add(sid)
            self._shed_set.discard(sid)
            if self._quarantined.pop(sid, None) is not None:
                changed = True
            self._q_strikes.pop(sid, None)
            if sid < len(self._last_auth):
                self._auth_win.reset_rows([sid])
                self._replay_win.reset_rows([sid])
            self.flight.record("evicted", sid=sid, tick=self.ticks)
        if changed or sids:
            self._sync_drop_mask()

    def note_admitted(self, sids) -> None:
        """Lifecycle admit bookkeeping: a row given to a NEW stream is
        no longer 'evicted' — overload shedding may target it again."""
        for sid in sids:
            self._evicted.discard(int(sid))

    def admission_decision(self, handshake_backlog=None,
                           handshake_bound=0):
        """Burn-aware admission control for the lifecycle plane:
        `(ok, reason)` where reason is a typed string.  Joins are
        refused while the error budget is burning fast, while the phase
        ledger says the tick is host-bound under overload (installing
        more streams feeds the bottleneck), or while streams are
        actively being shed (admitting during shedding thrashes).

        DTLS/ZRTP joins pass the handshake plane's current
        `handshake_backlog` (queued datagrams + pending associations)
        and its `handshake_bound`: past the bound the join is refused
        `handshake_backlog`, typed backpressure for reconnect storms
        (the caller attaches a retry-after hint).

        (The JAX gate also takes a target `shard` (`shard_burn`), a
        per-hop journey burn (`hop_burn`) and a cascade `trunk`; they
        come with placement and the cascade, item 12.)"""
        if self._slo_state() == "fast_burn":
            return False, "fast_burn"
        if (handshake_bound and handshake_backlog is not None
                and handshake_backlog >= handshake_bound):
            return False, "handshake_backlog"
        if self.watchdog.state == "stalled":
            return False, "stalled"
        if self._shed_set:
            return False, "shedding"
        if self.level > 0:
            _phase, _s, share, bound = self._phase_attr()
            if bound == "host" and share >= self.cfg.stage_share_threshold:
                return False, "host_bound"
        if self.capacity is not None and self.capacity.should_refuse():
            # forecast refusal (utils/capacity.py): every hard signal
            # above is still green, but a confident headroom fit says
            # this join won't fit before one of them fires — refuse
            # NOW, typed and with a retry-after hint, instead of
            # admitting into a forecast brown-out
            return False, "capacity_forecast"
        return True, "ok"

    # ------------------------------------------------------ quarantine

    def _update_quarantine(self) -> None:
        table = getattr(self.bridge, "rx_table", None)
        if table is None or not hasattr(table, "auth_fail"):
            return
        cap = len(self._last_auth)
        auth = np.asarray(table.auth_fail[:cap])
        replay = np.asarray(table.replay_reject[:cap])
        d_auth = auth - self._last_auth
        d_replay = replay - self._last_replay
        self._auth_win.push(d_auth)
        self._replay_win.push(d_replay)
        self._last_auth[:] = auth
        self._last_replay[:] = replay
        # per-stream failure deltas feed the flight ring: when a
        # conviction lands, the dump shows the storm that caused it
        for sid in np.nonzero(d_auth > 0)[0]:
            self.flight.record("srtp_auth_fail", sid=int(sid),
                               tick=self.ticks, n=int(d_auth[sid]))
        for sid in np.nonzero(d_replay > 0)[0]:
            self.flight.record("srtp_replay_reject", sid=int(sid),
                               tick=self.ticks, n=int(d_replay[sid]))

        changed = False
        for sid in [s for s, until in self._quarantined.items()
                    if self.ticks >= until]:
            del self._quarantined[sid]
            self._auth_win.reset_rows([sid])
            self._replay_win.reset_rows([sid])
            self.flight.record("quarantine_release", sid=sid,
                               tick=self.ticks)
            changed = True

        auth_sum = self._auth_win.sums()
        replay_sum = self._replay_win.sums()
        bad = np.nonzero(
            (auth_sum >= self.cfg.quarantine_auth_threshold)
            | (replay_sum >= self.cfg.quarantine_replay_threshold))[0]
        for sid in (int(s) for s in bad):
            if sid in self._quarantined or sid in self._shed_set:
                continue
            strikes = self._q_strikes.get(sid, 0)
            self._quarantined[sid] = self.ticks + int(
                self._ban.delay(strikes))
            self._q_strikes[sid] = strikes + 1
            self.quarantine_total += 1
            reason = ("auth_storm"
                      if auth_sum[sid] >= self.cfg.quarantine_auth_threshold
                      else "replay_storm")
            ev = self.flight.record(
                "quarantine", sid=sid, tick=self.ticks, reason=reason,
                auth_window=int(auth_sum[sid]),
                replay_window=int(replay_sum[sid]),
                until=self._quarantined[sid], strikes=strikes + 1)
            self.postmortems.append({
                "trigger": "quarantine", "sid": sid,
                "tick": self.ticks, "event": ev,
                "dump": self.flight.dump(sid)})
            self._auth_win.reset_rows([sid])
            self._replay_win.reset_rows([sid])
            changed = True
        if changed:
            self._sync_drop_mask()

    def _sync_drop_mask(self) -> None:
        self.loop.inbound_drop[:] = False
        banned = self._shed_set | set(self._quarantined)
        if banned:
            self.loop.inbound_drop[list(banned)] = True

    # ------------------------------------------------------ checkpoint

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Serialize the whole bridge into one versioned checkpoint
        file.  Write-to-temp + rename: a crash mid-write leaves the
        previous checkpoint intact, never a torn one."""
        path = path or self.cfg.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path configured")
        # pipeline drain barrier: a deep-pipelined loop may hold
        # dispatched-but-uncommitted ticks (replay state, egress bytes,
        # pinned arenas) — the snapshot must never capture a half tick
        drain = getattr(self.loop, "drain", None)
        if drain is not None:
            drain()
        blob = {"magic": CKPT_MAGIC, "version": CKPT_VERSION,
                "bridge": type(self.bridge).__name__,
                "ticks": self.ticks,
                "snap": self.bridge.snapshot()}
        if self.lifecycle is not None:
            # in-flight admits (queued joins + staged-but-uncommitted
            # installs) ride the checkpoint so recover() can complete
            # or roll them back instead of leaving half-installed rows
            blob["lifecycle"] = self.lifecycle.snapshot()
        # (the JAX blob's "cascade" key, the cascade control plane's
        # state, comes with CascadeSupervisor: item 12)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        self.checkpoints_written += 1
        self.flight.record("checkpoint_saved", tick=self.ticks,
                           path=path)
        return path

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if (not isinstance(blob, dict)
                or blob.get("magic") != CKPT_MAGIC):
            raise ValueError(f"{path}: not a libjitsi_tpu checkpoint")
        if blob.get("version") != CKPT_VERSION:
            raise ValueError(
                f"{path}: checkpoint version {blob.get('version')} "
                f"(supported: {CKPT_VERSION})")
        return blob

    @classmethod
    def recover(cls, path: str, bridge_cls, port: int = 0,
                device: DeviceLike = None,
                retries: int = 5, backoff_s: float = 0.05,
                sleep: Callable[[float], None] = time.sleep,
                supervisor_config: Optional[SupervisorConfig] = None,
                metrics=None, **bridge_kwargs) -> "BridgeSupervisor":
        """Crash-restart: load the checkpoint, re-bind the socket with
        bounded retry (a just-killed worker's port can linger), restore
        the bridge (SRTP ROC/replay included) on `device` (None: the
        card, which raises without one), resume supervising.  The JAX
        form takes the bridge `config` first; the port's bridges have
        none."""
        blob = cls.load_checkpoint(path)
        bridge = retrying(
            lambda: bridge_cls.restore(blob["snap"], port=port,
                                       device=device, **bridge_kwargs),
            retries=retries, backoff_s=backoff_s, sleep=sleep)
        sup = cls(bridge, config=supervisor_config, metrics=metrics)
        sup.ticks = blob["ticks"]
        # lifecycle in-flight state (if any) is held for the next
        # StreamLifecycleManager attached to this supervisor: its
        # constructor reconciles every half-installed stream (complete
        # or roll back — never a half state)
        sup.pending_lifecycle = blob.get("lifecycle")
        # crash-restart is a destructive action like any other: it
        # leaves a post-mortem naming the checkpoint it rose from
        ev = sup.flight.record("recovered", tick=sup.ticks, path=path,
                               bridge=blob["bridge"])
        sup.postmortems.append({
            "trigger": "checkpoint_recover", "tick": sup.ticks,
            "event": ev, "dump": sup.flight.dump_all()})
        return sup

    # --------------------------------------------------- observability

    def register_metrics(self, registry, prefix: str = "supervisor") -> None:
        wd, cfg = self.watchdog, self.cfg
        registry.register_scalar(
            f"{prefix}_ticks_overrun", lambda: wd.overruns,
            help_="ticks that exceeded the deadline", kind="counter")
        registry.register_scalar(
            f"{prefix}_watchdog_state", lambda: state_code(wd.state),
            help_="0 healthy, 1 overloaded, 2 stalled")
        registry.register_scalar(
            f"{prefix}_overload_level", lambda: self.level,
            help_="current escalation-ladder rung")
        registry.register_scalar(
            f"{prefix}_streams_shed", lambda: len(self._shed),
            help_="streams currently shed for overload")
        registry.register_scalar(
            f"{prefix}_streams_quarantined", lambda: len(self._quarantined),
            help_="streams currently quarantined")
        registry.register_scalar(
            f"{prefix}_quarantine_total", lambda: self.quarantine_total,
            help_="quarantine convictions since start", kind="counter")
        registry.register_scalar(
            f"{prefix}_checkpoints_written",
            lambda: self.checkpoints_written, kind="counter")
        registry.register_scalar(
            f"{prefix}_inbound_dropped",
            lambda: self.loop.inbound_dropped_total,
            help_="packets dropped by shed/quarantine masks",
            kind="counter")
        # per-stream arrays are registered as CALLABLES resolving
        # through self.bridge/self.loop at render time: a checkpoint
        # restore that rebinds rx_table (or the whole bridge) must not
        # leave the exporter reading the pre-restore arrays
        registry.register_array(
            "inbound_dropped", lambda: self.loop.inbound_dropped,
            help_="per-stream packets dropped at ingress", kind="counter")
        table = getattr(self.bridge, "rx_table", None)
        if table is not None and hasattr(table, "auth_fail"):
            registry.register_array(
                "srtp_auth_fail", lambda: self.bridge.rx_table.auth_fail,
                help_="SRTP authentication failures", kind="counter")
            registry.register_array(
                "srtp_replay_reject",
                lambda: self.bridge.rx_table.replay_reject,
                help_="SRTP replay-window rejections", kind="counter")
        if hasattr(self.bridge, "forwarded"):
            # denominator of the residual-loss SLO: packets the bridge
            # actually forwarded downstream
            registry.register_scalar(
                "bridge_forwarded", lambda: self.bridge.forwarded,
                help_="packets forwarded to receivers", kind="counter")
        if hasattr(self.bridge, "_video"):
            # simulcast/SVC forwarders are per-receiver objects; export
            # the fleet-wide sums (drift rule: every bumped counter is
            # scraped somewhere)
            def _fwds():
                return [f for t in set(self.bridge._video.values())
                        for f in t.fwd.values()]
            registry.register_scalar(
                "video_layer_switches",
                lambda: sum(f.switches for f in _fwds()),
                help_="simulcast/SVC layer switches across receivers",
                kind="counter")
            registry.register_scalar(
                "video_svc_dropped",
                lambda: sum(f.dropped for f in _fwds()
                            if hasattr(f, "dropped")),
                help_="SVC packets dropped by layer projection",
                kind="counter")
            registry.register_scalar(
                "video_svc_late_dropped",
                lambda: sum(f.late_dropped for f in _fwds()
                            if hasattr(f, "late_dropped")),
                help_="late SVC packets with no renumber hole left",
                kind="counter")
        rec = getattr(self.bridge, "recovery", None)
        if rec is not None:
            rec.register_metrics(registry)
        if self.slo is not None:
            self.slo.register_metrics(registry)
        bank = getattr(self.bridge, "bank", None)
        if bank is not None and hasattr(bank, "plc_frames"):
            registry.register_array(
                "plc_frames", lambda: self.bridge.bank.plc_frames,
                help_="frames concealed by packet-loss concealment",
                kind="counter")
            if hasattr(bank, "register_metrics"):
                bank.register_metrics(registry)

    def _phase_attr(self):
        """(phase, seconds, share, bound) of the last sampled phase
        split — "which phase owns the tick, and is that host-side or
        device-side?"."""
        phase, phase_s = PipelineTracer.dominant(self.last_phases)
        total = sum(self.last_phases.values())
        share = (phase_s / total) if total > 0 else 0.0
        return (phase or "unknown", phase_s, share,
                classify_bound(self.last_phases))

    def phase_attribution(self) -> dict:
        """Host/device attribution summary for /debug/slo: the phase
        split the escalation ladder is currently judging by, labeled
        with the ingest engine mode and its syscall telemetry — a phase
        share is only comparable against runs of the SAME engine."""
        phase, phase_s, share, bound = self._phase_attr()
        out = {"bound": bound, "phase": phase,
               "phase_share": round(share, 4),
               "phases": dict(self.last_phases)}
        loop = getattr(self.bridge, "loop", None)
        if loop is not None:
            out["engine_mode"] = getattr(loop, "engine_mode", "recvmmsg")
            out["ingest_syscalls"] = int(
                getattr(loop, "ingest_syscalls", 0))
            out["ingest_ring_reaps"] = int(
                getattr(loop, "ingest_ring_reaps", 0))
        caches = [c for name in ("rx_table", "tx_table")
                  for c in (getattr(getattr(self.bridge, name, None),
                                    "_ks_cache", None),)
                  if c is not None]
        if caches:
            # off-tick phases don't appear in the tick's phase split —
            # keystream pregeneration runs at the lifecycle barrier, so
            # its cost is attributed here as a separate ledger line
            served = sum(c.hits for c in caches)
            missed = sum(c.misses for c in caches)
            out["off_tick"] = {
                "keystream_fill_seconds": round(
                    sum(c.fill_seconds for c in caches), 6),
                "keystream_filled_slots": int(
                    sum(c.filled_slots for c in caches)),
                "keystream_hit_rate": round(
                    served / (served + missed), 4)
                if served + missed else None,
            }
        hq = getattr(self.lifecycle, "handshakes", None) \
            if self.lifecycle is not None else None
        if hq is not None:
            # same rule as the keystream ledger: handshake OpenSSL work
            # runs on the between-ticks window, so the PhaseProfiler's
            # tick split never contains it — its wall time is attributed
            # here, and `tick_thread_feeds` must stay 0 (the reconnect
            # soak gates on it)
            out.setdefault("off_tick", {}).update({
                "handshake_drain_seconds": round(hq.off_tick_seconds, 6),
                "handshake_queue_depth": int(hq.depth),
                "handshake_tick_thread_feeds": int(
                    getattr(self.lifecycle,
                            "tick_thread_handshake_feeds", 0)),
            })
        return out

    def health(self) -> dict:
        """Liveness summary for probes / logs."""
        return {"state": self.watchdog.state, "level": self.level,
                "rungs": list(self._rungs),
                "shed": sorted(self._shed_set),
                "evicted": len(self._evicted),
                "quarantined": sorted(self._quarantined),
                "ticks": self.ticks, "overruns": self.watchdog.overruns,
                "last_ledger": dict(self.last_ledger),
                "last_phases": dict(self.last_phases),
                "bound": self._phase_attr()[3],
                "slo_state": self._slo_state(),
                "postmortems": len(self.postmortems)}


class CascadeSupervisor(BridgeSupervisor):
    """The supervisor of one end of a bridge-to-bridge cascade
    (`mesh/cascade.py`): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CascadeSupervisor (mesh/cascade.py) is not ported yet "
            "(ROADMAP Queue 1, item 12)")
