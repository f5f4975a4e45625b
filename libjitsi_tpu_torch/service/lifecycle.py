"""Stream lifecycle plane: churn-proof admit and evict for a bridge.

Counterpart: `libjitsi_tpu/service/lifecycle.py` `HandshakeQueue` and
`StreamLifecycleManager`, copied (host only) over the port's bridges.
Under continuous join and leave, a naive install can land first-time
work or a table copy on the data path, departed streams leak recovery
state, and overload shedding can "restore" a stream that already left.
One `StreamLifecycleManager` owns that:

1. **Warm row classes, off-tick.**  The device sees the size classes of
   `core/packet.py` (`ROW_CLASSES`); the manager warms each row class
   off-tick the first time the population bucket (a power of two) could
   reach it (`_ensure_warm`: `SrtpStreamTable.warmup_rtp` /
   `warmup_rtcp`, `RtpTranslator.warmup_fanout`).  The port compiles
   nothing per shape; what a tick could still pay for the first time is
   a kernel instance's first launch in the process.
   `utils/compile_cache.compile_stats()` counts those, and every tick is
   bracketed (`tick_begin` / `tick_end`, wired by the BridgeSupervisor):
   a first launch inside the window increments `datapath_recompiles`,
   and `assert_datapath_clean()` makes "none lands on the data path" a
   checkable invariant.

2. **Pipelined off-tick key install.**  `request_join` only queues; the
   key derivation runs between ticks in batches
   (`SfuBridge.stage_endpoints`, one vectorized `add_streams` a table),
   media racing the install is held by the loop, and `commit_endpoints`
   flips the whole batch live between ticks.  In-flight admits ride the
   supervisor checkpoint and are completed or rolled back by
   `_reconcile` after `recover()`.

3. **Burn-aware admission control.**  Joins are refused with a typed
   reason (`ADMIT_REASONS`), exported as
   `lifecycle_admit_rejected{reason=...}` and flight-recorded, through
   `BridgeSupervisor.admission_decision()`.  Evictions are booked as
   `evicted` (not overload `shed`), so the supervisor's LIFO unwind
   never resurrects a departed stream.

4. **Off-tick handshake pipeline** (`HandshakeQueue`): DTLS joins admit
   through `request_handshake` (the same typed refusals, and a
   retry-after hint when the handshake plane is saturated); their
   OpenSSL work drains in bounded batches between ticks
   (`control/dtls.py`'s deferred table), and completed keys land through
   `stage_dtls_keys` and the same commit barrier.  The tick thread never
   runs an OpenSSL call (`tick_thread_handshake_feeds` stays 0).

Between ticks, `run_between_ticks` also tops up the GCM keystream caches
(`fill_keystream`: kernel O).

Not ported: conference-affinity placement, broadcast conferences and
cascaded (remote) conferences, which call `mesh/placement.py`,
`hierarchy.py` and `cascade.py` (ROADMAP Queue 1, item 12).
`enable_placement`, `declare_broadcast`, `promote_speaker`,
`demote_speaker`, `mark_remote_conference` and
`promote_remote_conference` raise `NotImplementedError`, and the port
keeps none of their state; everything else runs as the JAX plane does
without placement.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from libjitsi_tpu_torch.core.packet import ROW_CLASSES
from libjitsi_tpu_torch.utils.compile_cache import compile_stats
from libjitsi_tpu_torch.utils.flight import FlightRecorder
from libjitsi_tpu_torch.utils.logging import get_logger

_log = get_logger("lifecycle")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item 12)")

#: every reason `request_join`/`request_handshake` can refuse with
#: (typed: metrics, flight events and callers all share these strings)
ADMIT_REASONS = ("capacity", "backlog", "duplicate", "fast_burn",
                 "stalled", "shedding", "host_bound", "shard_burn",
                 "hop_burn", "handshake_backlog", "trunk_down",
                 "trunk_backlog", "capacity_forecast")


@dataclass
class LifecycleConfig:
    """Knobs for the admit/evict pipeline."""

    min_bucket: int = 16         # smallest population bucket warmed
    install_batch: int = 64      # joins staged per between-ticks window
    max_pending: int = 512       # queued + staged backlog cap
    warm_payload_len: int = 160  # representative payload for warmups
    # est. packets per stream per tick: sizes the row classes a
    # population bucket can drive (warmup_rtp uses the same figure)
    pkts_per_stream: int = 4
    # ------------------------------------------ handshake plane knobs
    # datagrams the HandshakeQueue drains per between-ticks window
    # (the OpenSSL budget — install_batch's twin for handshakes)
    handshake_batch: int = 64
    # backlog bound (queued datagrams + pending associations) past
    # which request_handshake refuses `handshake_backlog`
    max_handshakes: int = 256
    # flight retransmission jitter: each off-tick pass services only
    # 1/stride of the pending associations' RFC 6347 timers, spreading
    # a storm's flights so retransmissions never fire in lockstep
    handshake_retx_stride: int = 4
    # nominal between-ticks cadence used to turn a backlog depth into
    # the retry-after hint attached to handshake_backlog refusals
    handshake_retry_tick_s: float = 0.02


class HandshakeQueue:
    """Off-tick DTLS handshake pipeline for one bridge.

    Construction flips the bridge's `DtlsAssociationTable` to deferred
    ingest — `on_dtls` (tick thread) only enqueues datagrams — and
    re-points its install callback at the STAGED landing: completed
    keys go through `stage_dtls_keys` and flip live at the next commit
    barrier, never mid-tick.  `drain()` runs on the between-ticks
    window (wired into `run_between_ticks`): one bounded `process`
    batch of OpenSSL work plus a jittered flight-retransmission pass
    with gather egress (one PacketBatch per peer per pass).

    ZRTP associations share the same endpoint surface (`feed` /
    `complete` / `srtp_keys`), so a ZRTP-keyed bridge plugs into this
    queue unchanged; today's bridges key via DTLS-SRTP.
    """

    def __init__(self, lc: "StreamLifecycleManager"):
        self.lc = lc
        self.bridge = lc.bridge
        self.cfg = lc.cfg
        self.table = lc.bridge._dtls
        self.table.deferred = True
        # generous inbox: refusal happens at ADMISSION (typed, with a
        # retry hint), not by silently dropping datagrams of already
        # admitted associations.  ~2 flights of 6 datagrams per row.
        self.table.inbox_limit = max(self.table.inbox_limit,
                                     12 * self.cfg.max_handshakes)
        self._inline_install = self.table.install
        self.table.install = self._on_complete
        # sid -> admission metadata (ssrc/role/fingerprint/cookie/addr
        # + admit tick): what a checkpoint needs to REQUEUE the
        # association after recover (OpenSSL state cannot serialize)
        self.active: Dict[int, dict] = {}
        self._pass = 0
        self.off_tick_seconds = 0.0
        self.completed = 0
        self.requeued = 0

    @property
    def depth(self) -> int:
        """Admission-facing depth: queued datagrams + pending rows."""
        return self.table.backlog

    def retry_after(self) -> float:
        """Hint for a refused client: model-time until the drain could
        plausibly reach it, from the backlog depth and the per-window
        budget.  Clients honor it with their own exponential backoff
        on repeated refusals."""
        passes = 1 + self.depth // max(1, self.cfg.handshake_batch)
        return round(passes * self.cfg.handshake_retry_tick_s, 4)

    def drain(self) -> int:
        """The between-ticks pass: bounded OpenSSL work + jittered
        flight retransmissions.  Wall time accrues to
        `off_tick_seconds` (the supervisor's phase-attribution ledger
        line — handshake cost is attributed HERE, never to a tick
        phase)."""
        t0 = time.perf_counter()
        n = self.table.process(self.cfg.handshake_batch)
        self._pass += 1
        self.table.tick(stride=max(1, self.cfg.handshake_retx_stride),
                        phase=self._pass)
        if self.active:
            # drop metadata for rows that left the plane sideways
            # (evicted mid-handshake, fingerprint-rejected)
            live = self.bridge._ssrc_of
            self.active = {s: m for s, m in self.active.items()
                           if s in self.table.pending or s in live}
        self.off_tick_seconds += time.perf_counter() - t0
        return n

    def _on_complete(self, sid: int, ep) -> None:
        """Install callback for the deferred table: land the exported
        keys STAGED so the commit barrier flips the row live."""
        meta = self.active.pop(sid, None)
        if hasattr(self.bridge, "stage_dtls_keys"):
            # the committed population grows at the next barrier: warm
            # its bucket NOW (off-tick) so the flip compiles nothing
            self.lc._ensure_warm(len(self.bridge._ssrc_of))
            self.bridge.stage_dtls_keys(sid, ep)
            self.lc._staged.append(sid)
            self.lc.key_installs += 1
        else:
            # bridge without a staged pipeline: inline install (still
            # off-tick — we are on the between-ticks window)
            self._inline_install(sid, ep)
            self.bridge.loop.release_stream(sid)
        self.completed += 1
        self.lc.flight.record(
            "handshake_complete", tick=self.lc.ticks(), sid=sid,
            ssrc=(meta or {}).get("ssrc"),
            profile=ep.selected_profile.name)

    def snapshot(self) -> List[dict]:
        """Mid-handshake associations for the supervisor checkpoint:
        OpenSSL state cannot serialize, so each rides as its admission
        parameters (plus its bound 5-tuple) and REQUEUES as a fresh
        association after recover — the peer's flight timers drive the
        new handshake."""
        out = []
        for sid, ep in self.table.pending.items():
            meta = self.active.get(sid, {})
            out.append({
                "ssrc": meta.get("ssrc", self.bridge._ssrc_of.get(sid)),
                "role": meta.get("role", getattr(ep, "role", "server")),
                "fingerprint": meta.get("fingerprint"),
                "cookie": bool(meta.get("cookie", False)),
                "addr": self.table.sid_addr.get(sid),
            })
        return out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class StreamLifecycleManager:
    """Owns admit/evict for one bridge.  Construct after the
    BridgeSupervisor; the manager attaches itself
    (`supervisor.lifecycle = self`) so the supervisor's tick brackets
    the data path with the compile guard and runs the commit barrier +
    install stage between ticks.  Without a supervisor, call
    `run_between_ticks()` manually after each `bridge.tick()`."""

    def __init__(self, bridge, supervisor=None,
                 config: Optional[LifecycleConfig] = None,
                 metrics=None, flight: Optional[FlightRecorder] = None):
        self.bridge = bridge
        self.supervisor = supervisor
        self.cfg = config or LifecycleConfig()
        if flight is None:
            flight = (supervisor.flight if supervisor is not None
                      else getattr(bridge, "flight", None))
        self.flight = flight if flight is not None else FlightRecorder()
        # join queue: (ssrc, rx_key, tx_key, name, conference, role,
        # shard), host-side only until poll() stages a batch; the last
        # three are placement's (item 12) and stay None, as in the JAX
        # plane without placement, so checkpoints keep its format
        self._join_q: deque = deque()
        self._queued_ssrcs: set = set()
        # placement's rebalance moves (item 12): exported, always 0
        self.moves_applied = 0
        self._staged: List[int] = []     # staged sids awaiting commit
        self._evict_q: List[int] = []
        # counters (all registered in register_metrics)
        self.admits = 0
        self.evicts = 0
        self.key_installs = 0
        self.datapath_recompiles = 0
        self.admit_rejected: Dict[str, int] = {}
        # population bucket whose row classes are warm; classes warmed
        self._warm_bucket = 0
        self._warm_rows: set = set()
        self._tick_compiles0: Optional[int] = None
        # off-tick handshake pipeline: attaches only when the bridge
        # keys rows via a DTLS association table (SfuBridge /
        # ConferenceBridge); direct-keyed bridges and test fakes get
        # None and the plane behaves exactly as before
        self.handshakes: Optional[HandshakeQueue] = None
        if getattr(bridge, "_dtls", None) is not None:
            self.handshakes = HandshakeQueue(self)
        # OpenSSL feed() calls observed INSIDE tick windows (invariant:
        # 0 once deferred — the reconnect soak gates on it)
        self.tick_thread_handshake_feeds = 0
        self._tick_feeds0: Optional[int] = None
        if supervisor is not None:
            supervisor.lifecycle = self
            pend = getattr(supervisor, "pending_lifecycle", None)
            if pend:
                self._reconcile(pend)
                supervisor.pending_lifecycle = None
        if metrics is not None:
            self.register_metrics(metrics)

    # ------------------------------------------------------- placement

    def enable_placement(self, n_shards: int, placer=None) -> None:
        """Conference-affinity sharding (`mesh/placement.py`)."""
        raise _not_ported("conference-affinity placement")

    def declare_broadcast(self, conference, objective: float = 0.999
                          ) -> int:
        """Broadcast conferences (`mesh/hierarchy.py`)."""
        raise _not_ported("broadcast conferences")

    def promote_speaker(self, conference, sid: int) -> None:
        """A broadcast listener's promotion (`mesh/hierarchy.py`)."""
        raise _not_ported("broadcast conferences")

    def mark_remote_conference(self, conference, trunk) -> None:
        """A cascaded conference homed on a peer (`mesh/cascade.py`)."""
        raise _not_ported("cascaded conferences")

    def promote_remote_conference(self, conference) -> None:
        """A cascade failover's promotion (`mesh/cascade.py`)."""
        raise _not_ported("cascaded conferences")

    def retry_after_hint(self, reason: str, conference=None) -> float:
        """Seconds a refused caller should wait before retrying:
        handshake
        refusals ride the queue's drain estimate, trunk refusals the
        trunk's jittered-exponential backoff."""
        if reason == "handshake_backlog" and self.handshakes is not None:
            # called: the JAX method returns the bound method here
            return self.handshakes.retry_after()
        if reason == "capacity_forecast":
            cap = getattr(self.supervisor, "capacity", None) \
                if self.supervisor is not None else None
            if cap is not None:
                return float(cap.retry_after())
        return self.cfg.handshake_retry_tick_s

    def demote_speaker(self, conference, sid: int) -> None:
        """A broadcast speaker's demotion (`mesh/hierarchy.py`)."""
        raise _not_ported("broadcast conferences")

    # ------------------------------------------------------- admission

    def ticks(self) -> int:
        return self.supervisor.ticks if self.supervisor is not None else 0

    def _admission_reason(self, ssrc: int) -> Optional[str]:
        if (ssrc in self.bridge._ssrc_of.values()
                or ssrc in self._queued_ssrcs):
            return "duplicate"
        if len(self._join_q) + len(self._staged) >= self.cfg.max_pending:
            return "backlog"
        # queued joins have slots spoken for; evictions still queued do
        # NOT count as free (they only free up at the barrier)
        if self.bridge.registry.free_slots <= len(self._join_q):
            return "capacity"
        if self.supervisor is not None:
            ok, reason = self.supervisor.admission_decision()
            if not ok:
                return reason
        return None

    def request_join(self, ssrc: int, rx_key: Tuple[bytes, bytes],
                     tx_key: Tuple[bytes, bytes],
                     name: Optional[str] = None,
                     conference=None,
                     role: Optional[str] = None) -> Tuple[bool, str]:
        """Admission decision + queue.  Returns (accepted, reason):
        (True, "queued") or (False, <typed reason>).  Nothing touches
        the device here — keys install off-tick in poll().

        `conference` and `role` group endpoints only under placement
        and in broadcast conferences (item 12); without them, as in the
        JAX plane without placement, they scope nothing (the caller
        scopes a staged row with `SfuBridge.set_conference`)."""
        ssrc = int(ssrc) & 0xFFFFFFFF
        reason = self._admission_reason(ssrc)
        if reason is not None:
            self.admit_rejected[reason] = \
                self.admit_rejected.get(reason, 0) + 1
            self.flight.record("admit_reject", tick=self.ticks(),
                               ssrc=ssrc, reason=reason)
            _log.info("admit_reject", ssrc=ssrc, reason=reason)
            return False, reason
        self._join_q.append((ssrc, tuple(rx_key), tuple(tx_key), name,
                             None, None, None))
        self._queued_ssrcs.add(ssrc)
        self.flight.record("admit_queued", tick=self.ticks(), ssrc=ssrc)
        return True, "queued"

    def request_handshake(self, ssrc: int, role: str = "server",
                          remote_fingerprint: Optional[str] = None,
                          cookie_exchange: bool = False,
                          remote_addr=None,
                          name: Optional[str] = None
                          ) -> Tuple[bool, str, float]:
        """Admission decision + association start for a DTLS-keyed
        join: the handshake plane's twin of `request_join`.  Returns
        `(accepted, reason, retry_after_s)` — `(True, "queued", 0.0)`
        on admit, or a typed refusal; `handshake_backlog` refusals
        (the plane saturated past `max_handshakes`) carry a non-zero
        retry-after hint that clients honor with exponential backoff.

        On admit the row allocates and the association starts
        immediately (`add_endpoint_dtls`): datagrams route to it from
        the next packet on, but ALL OpenSSL work runs on the
        between-ticks drain and the keys land via the staged commit
        barrier — the tick thread never handshakes.  Pass
        `remote_addr` when signaling knows the peer's 5-tuple; under a
        storm (many concurrent unbound rows) unknown-address datagrams
        are dropped rather than guessed onto the wrong row."""
        hq = self.handshakes
        if hq is None:
            raise RuntimeError(
                "bridge has no DTLS association table; use request_join")
        ssrc = int(ssrc) & 0xFFFFFFFF
        reason: Optional[str] = None
        if (ssrc in self.bridge._ssrc_of.values()
                or ssrc in self._queued_ssrcs):
            reason = "duplicate"
        elif self.bridge.registry.free_slots <= len(self._join_q):
            reason = "capacity"
        elif self.supervisor is not None:
            ok, r = self.supervisor.admission_decision(
                handshake_backlog=hq.depth,
                handshake_bound=self.cfg.max_handshakes)
            if not ok:
                reason = r
        elif hq.depth >= self.cfg.max_handshakes:
            reason = "handshake_backlog"
        if reason is not None:
            retry = hq.retry_after() \
                if reason == "handshake_backlog" else 0.0
            self.admit_rejected[reason] = \
                self.admit_rejected.get(reason, 0) + 1
            self.flight.record("handshake_reject", tick=self.ticks(),
                               ssrc=ssrc, reason=reason,
                               retry_after_s=retry)
            _log.info("handshake_reject", ssrc=ssrc, reason=reason,
                      retry_after_s=retry)
            return False, reason, retry
        sid, _ep = self.bridge.add_endpoint_dtls(
            ssrc, role=role, remote_fingerprint=remote_fingerprint,
            cookie_exchange=cookie_exchange, remote_addr=remote_addr)
        if name is not None:
            self.bridge.loop.metrics.set_stream_name(sid, name)
        hq.active[sid] = {
            "ssrc": ssrc, "role": role,
            "fingerprint": remote_fingerprint,
            "cookie": bool(cookie_exchange), "tick": self.ticks(),
        }
        self.flight.record("handshake_queued", tick=self.ticks(),
                           sid=sid, ssrc=ssrc)
        return True, "queued", 0.0

    def request_leave(self, sid: Optional[int] = None,
                      ssrc: Optional[int] = None) -> bool:
        """Queue an evict (by sid or ssrc).  A join still queued
        host-side is simply cancelled; anything staged or live is torn
        down at the next between-ticks barrier."""
        if sid is None:
            if ssrc is None:
                raise ValueError("need sid or ssrc")
            ssrc = int(ssrc) & 0xFFFFFFFF
            if ssrc in self._queued_ssrcs:          # never installed
                self._queued_ssrcs.discard(ssrc)
                self._join_q = deque(j for j in self._join_q
                                     if j[0] != ssrc)
                self.flight.record("admit_cancelled",
                                   tick=self.ticks(), ssrc=ssrc)
                return True
            sid = next((s for s, v in self.bridge._ssrc_of.items()
                        if v == ssrc), None)
            if sid is None:
                return False
        self._evict_q.append(int(sid))
        return True

    # ------------------------------------------- between-ticks pipeline

    def run_between_ticks(self, now=None) -> None:
        """The off-tick half of the plane: handshake drain first (its
        completions stage rows that the SAME window's commit flips
        live), then the commit barrier (staged rows flip live, queued
        evicts tear down — both between ticks, never inside one), then
        the next install wave, then the keystream fill.  (The JAX plane
        also runs placement's rebalance moves here: item 12.)"""
        if self.handshakes is not None:
            self.handshakes.drain()
        self.commit()
        self.poll()
        self.fill_keystream()

    def _keystream_caches(self):
        for name in ("rx_table", "tx_table"):
            cache = getattr(getattr(self.bridge, name, None),
                            "_ks_cache", None)
            if cache is not None:
                yield cache

    def fill_keystream(self) -> None:
        """Off-tick keystream pregeneration: top up the GCM caches'
        sliding windows AFTER the commit barrier (so a rekey's
        invalidation has already landed and the refill keys are the
        live ones).  Kernel O runs here, between ticks, never in one."""
        for cache in self._keystream_caches():
            cache.fill()

    def commit(self) -> None:
        """Atomic (w.r.t. the tick) population flip: committed admits
        and processed evicts both land here, between ticks."""
        if self._staged or self._evict_q:
            # pipeline drain barrier: a deep-pipelined loop may still
            # hold in-flight reverse work referencing rows about to be
            # evicted/recycled — collapse it before the population flips
            loop = getattr(self.bridge, "loop", None)
            drain = getattr(loop, "drain", None)
            if drain is not None:
                drain()
        if self._staged:
            sids, self._staged = self._staged, []
            self.bridge.commit_endpoints(sids)
            self.admits += len(sids)
            if self.supervisor is not None:
                self.supervisor.note_admitted(sids)
            for sid in sids:
                self.flight.record("admit_commit", tick=self.ticks(),
                                   sid=sid)
        if self._evict_q:
            live = dict.fromkeys(self._evict_q)  # de-dup, keep order
            self._evict_q = []
            sids = [s for s in live if s in self.bridge._ssrc_of]
            if sids:
                self.bridge.remove_endpoints(sids)
                self.evicts += len(sids)
                if self.supervisor is not None:
                    self.supervisor.note_evicted(sids)

    def poll(self) -> None:
        """Stage the next install wave: batch-limited, slot-limited,
        with the target bucket's row classes warmed BEFORE any new
        stream can contribute traffic."""
        n = min(len(self._join_q), self.cfg.install_batch,
                self.bridge.registry.free_slots)
        if n <= 0:
            return
        specs = [self._join_q.popleft() for _ in range(n)]
        for spec in specs:
            self._queued_ssrcs.discard(spec[0])
        self._ensure_warm(len(self.bridge._ssrc_of) + len(specs))
        out_sids = self.bridge.stage_endpoints(
            [tuple(spec[:4]) for spec in specs])
        self.key_installs += len(specs)
        self._staged.extend(out_sids)
        for sid, spec in zip(out_sids, specs):
            self.flight.record("key_install", tick=self.ticks(),
                               sid=sid, ssrc=spec[0])

    @property
    def key_installs_pending(self) -> int:
        return len(self._join_q) + len(self._staged)

    # ----------------------------------------------- bucketed warmup

    def _ensure_warm(self, population: int) -> None:
        """Grow the warm bucket to the next power of two covering
        `population` and warm (off-tick, throwaway tables) every RTP row
        class that bucket's aggregate traffic can drive.  The work a
        class pays the first time (a kernel instance's first launch, the
        first buffers of that size) depends only on the class, so within
        a bucket admits and evicts pay nothing new; crossing a boundary
        pays it here, never inside a tick."""
        bucket = _next_pow2(max(self.cfg.min_bucket, population))
        if bucket <= self._warm_bucket:
            return
        max_rows = min(bucket * self.cfg.pkts_per_stream,
                       ROW_CLASSES[-1])
        # one class of headroom: fan-out rows are packets x receivers,
        # which can cross the class ABOVE the aggregate-traffic estimate
        # while the population is still inside this bucket — that first
        # crossing must not compile inside a tick
        above = [rc for rc in ROW_CLASSES if rc > max_rows]
        cover = above[0] if above else ROW_CLASSES[-1]
        want = [rc for rc in ROW_CLASSES
                if rc <= cover and rc not in self._warm_rows]
        if not want and ROW_CLASSES[0] not in self._warm_rows:
            want = [ROW_CLASSES[0]]
        tr = getattr(self.bridge, "translator", None)
        for rc in want:
            self.bridge.rx_table.warmup_rtp(
                rc, payload_len=self.cfg.warm_payload_len)
            self.bridge.tx_table.warmup_rtp(
                rc, payload_len=self.cfg.warm_payload_len)
            if tr is not None and hasattr(tr, "warmup_fanout"):
                # the fan-out expansion (packets x receivers) has its own
                # class-padded shape space — compile it here, off-tick
                tr.warmup_fanout(rc, payload_len=self.cfg.warm_payload_len)
            if hasattr(self.bridge.rx_table, "warmup_rtcp"):
                # control traffic (NACK/RR/SR) rides the same
                # zero-recompile discipline as media
                self.bridge.rx_table.warmup_rtcp(rc)
                self.bridge.tx_table.warmup_rtcp(rc)
            self._warm_rows.add(rc)
        self.flight.record("bucket_warm", tick=self.ticks(),
                           bucket=bucket, rows=sorted(self._warm_rows))
        _log.info("bucket_warm", bucket=bucket,
                  row_classes=sorted(self._warm_rows))
        self._warm_bucket = bucket

    # --------------------------------------------- data-path compile proof

    def tick_begin(self) -> None:
        self._tick_compiles0 = compile_stats().compile_events
        self._tick_feeds0 = (self.handshakes.table.feeds_total
                             if self.handshakes is not None else None)

    def tick_end(self) -> None:
        if self._tick_feeds0 is not None:
            # the other zero-on-the-tick-thread invariant: with the
            # deferred table no OpenSSL feed may run inside the tick
            d = self.handshakes.table.feeds_total - self._tick_feeds0
            self._tick_feeds0 = None
            if d > 0:
                self.tick_thread_handshake_feeds += d
                self.flight.record("tick_thread_handshake",
                                   tick=self.ticks(), n=d)
                _log.warn("tick_thread_handshake", n=d)
        if self._tick_compiles0 is None:
            return
        delta = compile_stats().compile_events - self._tick_compiles0
        self._tick_compiles0 = None
        if delta > 0:
            self.datapath_recompiles += delta
            self.flight.record("datapath_recompile",
                               tick=self.ticks(), n=delta)
            _log.warn("datapath_recompile", n=delta)

    def assert_datapath_clean(self) -> None:
        """The zero-recompile invariant, as an assertion: call after a
        soak window (once all shapes are warm) — raises if any compile
        event landed inside a tick."""
        if self.datapath_recompiles:
            raise AssertionError(
                f"{self.datapath_recompiles} compile event(s) landed on "
                f"the data path (inside tick windows)")

    # --------------------------------------------------- checkpointing

    def snapshot(self) -> dict:
        """In-flight admit state for the supervisor checkpoint: queued
        joins carry their keys (host-side only so far); staged sids'
        keys already ride the bridge snapshot.  (The JAX plane adds its
        placement and broadcast state: item 12.)"""
        snap = {
            "queued": [tuple(j) for j in self._join_q],
            "staged": [(sid, self.bridge._ssrc_of.get(sid))
                       for sid in self._staged],
        }
        if self.handshakes is not None:
            # mid-handshake associations: keyless, so they ride as
            # their admission parameters and requeue after recover
            # (staged handshake rows already carry keys and ride the
            # "staged" list + bridge snapshot like any other admit)
            snap["handshakes"] = self.handshakes.snapshot()
        return snap

    def _reconcile(self, pend: dict) -> None:
        """Post-`recover()` reconciliation: every in-flight admit either
        COMPLETES or ROLLS BACK — never a half state.

        * staged installs: the bridge snapshot captured their keys, SSRC
          mapping and table rows, and `restore()` routed them — the
          admit completes here (counted, flight-recorded).  A staged sid
          whose keys did NOT survive is rolled back: its remnants are
          removed and the slot freed.
        * queued joins: never touched the device; they re-enter the
          queue and install through the normal off-tick pipeline.

        A JAX checkpoint with placement or broadcast state is refused
        (item 12).
        """
        if pend.get("placement") is not None:
            raise _not_ported("conference-affinity placement")
        if pend.get("broadcast"):
            raise _not_ported("broadcast conferences")
        for sid, ssrc in pend.get("staged", []):
            sid = int(sid)
            if (sid in self.bridge._ssrc_of
                    and sid in self.bridge._tx_keys):
                self.admits += 1
                self.flight.record("admit_commit", tick=self.ticks(),
                                   sid=sid, recovered=True)
            else:
                if sid in self.bridge._ssrc_of:
                    self.bridge.remove_endpoints([sid])
                self.flight.record("admit_rollback", tick=self.ticks(),
                                   sid=sid, ssrc=ssrc)
                _log.info("admit_rollback", sid=sid)
        for spec in pend.get("queued", []):
            ssrc, rx, tx, name = spec[:4]
            self.request_join(ssrc, rx, tx, name=name)
        for rec in pend.get("handshakes", []):
            # mid-handshake at the kill: the OpenSSL state died with
            # the process, so the association REQUEUES as a fresh row
            # (same ssrc, same bound 5-tuple when known) and the
            # peer's flight timers / signaling re-join drive the new
            # handshake — completed or requeued, never torn
            ssrc = rec.get("ssrc")
            if ssrc is None or self.handshakes is None:
                continue
            addr = rec.get("addr")
            ok, reason, retry = self.request_handshake(
                ssrc, role=rec.get("role", "server"),
                remote_fingerprint=rec.get("fingerprint"),
                cookie_exchange=bool(rec.get("cookie", False)),
                remote_addr=tuple(addr) if addr is not None else None)
            if ok:
                self.handshakes.requeued += 1
            self.flight.record("handshake_requeue", tick=self.ticks(),
                               ssrc=ssrc, accepted=ok,
                               reason=reason, retry_after_s=retry)
            _log.info("handshake_requeue", ssrc=ssrc, accepted=ok,
                      reason=reason)

    # --------------------------------------------------- observability

    def register_metrics(self, registry, prefix: str = "lifecycle") -> None:
        registry.register_counters(self, (
            ("admits", "streams admitted (committed live)"),
            ("evicts", "streams evicted by the lifecycle plane"),
            ("key_installs", "streams whose keys installed off-tick"),
            ("datapath_recompiles",
             "compile events inside tick windows (invariant: 0)"),
            ("moves_applied",
             "placement rebalance moves executed at the barrier"),
        ), prefix=prefix)
        registry.register_scalar(
            f"{prefix}_key_installs_pending",
            lambda: self.key_installs_pending,
            help_="joins queued or staged, not yet committed")
        registry.register_scalar(
            f"{prefix}_warm_bucket", lambda: self._warm_bucket,
            help_="population bucket whose shapes are pre-compiled")
        registry.register_multi(
            f"{prefix}_admit_rejected", self._rejected_samples,
            help_="admissions refused, by typed reason", kind="counter")
        # broadcast conferences (item 12): exported as the JAX plane
        # does, always 0 here
        registry.register_scalar(
            "bcast_listeners", lambda: 0.0,
            help_="fanout-only listener rows live across all "
                  "broadcast conferences")
        registry.register_scalar(
            "speaker_promotions_total", lambda: 0.0,
            help_="listener-to-speaker role flips applied at the "
                  "commit barrier", kind="counter")
        # keystream pregeneration cache (transform/srtp/keystream.py):
        # summed across the rx/tx tables' caches; all zero until
        # enable_keystream_cache is called on a GCM bridge
        registry.register_scalar(
            "srtp_keystream_hits",
            lambda: float(sum(c.hits for c in self._keystream_caches())),
            help_="packets served from the pregenerated keystream "
                  "window (fast-path protect/unprotect)",
            kind="counter")
        registry.register_scalar(
            "srtp_keystream_misses",
            lambda: float(sum(c.misses
                              for c in self._keystream_caches())),
            help_="packets that fell back to the stock GCM path "
                  "(window miss, reorder, rekey, non-uniform batch)",
            kind="counter")
        registry.register_scalar(
            "srtp_keystream_evictions",
            lambda: float(sum(c.evictions
                              for c in self._keystream_caches())),
            help_="pregenerated keystream slots discarded unused "
                  "(window slide, rekey invalidation, SSRC change)",
            kind="counter")
        registry.register_scalar(
            "srtp_keystream_fill_seconds",
            lambda: float(sum(c.fill_seconds
                              for c in self._keystream_caches())),
            help_="cumulative off-tick wall time spent generating "
                  "keystream (the cache-fill phase)", kind="counter")
        # handshake plane (HandshakeQueue + deferred association
        # table): all read through self.handshakes so direct-keyed
        # bridges export zeros instead of raising
        registry.register_scalar(
            "handshake_queue_depth",
            lambda: float(self.handshakes.depth)
            if self.handshakes is not None else 0.0,
            help_="queued handshake datagrams + pending associations "
                  "awaiting the off-tick drain")
        registry.register_scalar(
            "dtls_handshakes_active",
            lambda: float(len(self.handshakes.table.pending))
            if self.handshakes is not None else 0.0,
            help_="DTLS associations mid-handshake (allocated, "
                  "keyless rows)")
        registry.register_scalar(
            "dtls_retransmits_total",
            lambda: float(self.handshakes.table.retransmits_total)
            if self.handshakes is not None else 0.0,
            help_="expired-flight datagrams resent by the batched "
                  "retransmission pass", kind="counter")
        registry.register_scalar(
            "dtls_feeds_total",
            lambda: float(self.handshakes.table.feeds_total)
            if self.handshakes is not None else 0.0,
            help_="handshake datagrams fed to endpoints (all on the "
                  "off-tick drain in deferred mode)", kind="counter")
        registry.register_scalar(
            "dtls_inbox_dropped",
            lambda: float(self.handshakes.table.inbox_dropped)
            if self.handshakes is not None else 0.0,
            help_="handshake datagrams dropped at the deferred "
                  "table's inbox bound (admission refuses first; this "
                  "staying near 0 proves the bound is generous)",
            kind="counter")
        registry.register_scalar(
            "dtls_handshakes_completed",
            lambda: float(self.handshakes.completed)
            if self.handshakes is not None else 0.0,
            help_="handshakes whose keys landed via the staged "
                  "commit barrier", kind="counter")
        registry.register_scalar(
            "handshake_off_tick_seconds",
            lambda: float(self.handshakes.off_tick_seconds)
            if self.handshakes is not None else 0.0,
            help_="cumulative between-ticks wall time in the "
                  "handshake drain (OpenSSL + flight resends)",
            kind="counter")
        registry.register_scalar(
            "handshake_tick_thread_feeds",
            lambda: float(self.tick_thread_handshake_feeds),
            help_="OpenSSL feed() calls observed inside tick windows "
                  "(invariant: 0)", kind="counter")

    def _rejected_samples(self):
        return [({"reason": r}, float(c))
                for r, c in sorted(self.admit_rejected.items())]
