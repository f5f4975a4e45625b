"""ConferenceBridge — the whole audio-bridge tick as one object.

Counterpart: `libjitsi_tpu/service/bridge.py` `ConferenceBridge`.  ONE
MediaLoop (batched UDP + reverse chain), ONE ReceiveBank (dense jitter
+ decode), ONE AudioMixer row range, and a batched encode -> packetize
-> protect -> send tail: a whole conference tick is a handful of kernel
launches regardless of participant count.

Tick flow (one ptime, default 20 ms), kernels in brackets:

    loop.tick()            drain socket -> demux -> unprotect [D]
       -> bank.push_decrypted (dense jitter insert)
    bank.tick()            pop due frames -> G.711 decode [G] (G.722 and
                           Opus rows: host codecs) -> off-rate groups to
                           the bridge clock [R]
    mixer.mix()            mix-minus + RFC 6465 levels [E]
    speaker / egress levels
    encode rows            off-rate kinds from the bridge clock [R], then
                           G.711 encode [F] (G.722, Opus: host codecs)
    loop.send_media()      packetize -> RFC 6464 level stamp
                           -> protect [C] -> sendmmsg

Pipelined (`pipelined=True` or `pipeline_depth` > 1, as in the JAX
bridge): the mixes' protect is dispatched only (`send_media_async`) and
their bytes leave at the top of the next tick, or at `snapshot()`, which
flushes them first; at depth >= 2 the loop's deep receive path runs too,
tick N's unprotect dispatched on the table's async seams and
materialized `pipeline_depth - 1` ticks later, so the bank hears tick
N's frames that much later.  `kernel_timestamps` asks the UDP engine for
SO_TIMESTAMPNS arrival stamps (`loop.last_rtp_arrival_ns`).

The first joiner's codec sets the bridge clock (rate and frame); legs at
another rate with the same ptime resample to it on deposit and from it on
egress, one launch of kernel R a same-rate group (a deposit group, an
egress kind).  Keying is SDES-style static master keys per participant
(rx = what the participant sends with, tx = what we send to them with),
or DTLS-SRTP (`add_participant_dtls`, as in the JAX bridge: the row joins
the mix at once, a `control.dtls.DtlsAssociationTable` on the loop's
`on_dtls` drives the handshake, early media is held and replayed when the
exported keys install, and a row without installed tx keys gets no
egress).  `recorder=` takes a `recording.Recorder`, told of each
dominant-speaker change.  `device` None means the card; the tests pass
device="cpu".  The bank and mixer stages run inside `record_function`
spans `decode` and `mixer`, and R's calls inside `resample`, beside the
loop's own.

`snapshot()` / `ConferenceBridge.restore(snap, device=...)` checkpoint and
resume a conference in the JAX bridge's format, from a snapshot of either
package: SRTP tables, jitter rings, rows, codecs by name (G.722 and Opus
resume with fresh codec state: `degraded_rows`), the recorded clock, TX
counters, speaker scores and latched addresses.

G.729 and iLBC legs join receive-only, as in the JAX bridge: the mix
toward them has no encoder and raises `RuntimeError` on the first send.

Not ported: the JAX bridge's `config` argument, the mesh mode and sharded
snapshots (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from libjitsi_tpu_torch.conference.mixer import AudioMixer
from libjitsi_tpu_torch.conference.speaker import DominantSpeakerIdentification
from libjitsi_tpu_torch.control.dtls import DtlsAssociationTable
from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.kernels.resample import resample_to_frame
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp.dense_jitter import DenseJitterBank
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.service.pump import (G711_LAWS, FrameCodec,
                                             ReceiveBank,
                                             codec_from_name, g711_codec)
from libjitsi_tpu_torch.transform.engine import TransformEngineChain
from libjitsi_tpu_torch.transform.header_ext import CsrcAudioLevelEngine
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile


class ConferenceBridge:
    """A secure N-party audio bridge on one UDP port."""

    def __init__(self, port: int = 0, capacity: int = 256,
                 profile: SrtpProfile =
                 SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 ptime_ms: int = 20, kernel_timestamps: bool = False,
                 recv_window_ms: int = 1,
                 audio_level_ext_id: int = 1,
                 on_speaker_change=None, recorder=None,
                 pipelined: bool = False, pipeline_depth: int = 1,
                 plc: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.profile = profile
        self.ptime_ms = ptime_ms
        # opt-in packet-loss concealment in the receive bank
        self._plc = plc
        self.registry = StreamRegistry(capacity, device=self.device)
        self.rx_table = SrtpStreamTable(capacity, profile, self.device)
        self.tx_table = SrtpStreamTable(capacity, profile, self.device)
        # egress audio-level stamping (RFC 6464 element = the loudest
        # contributor heard in that receiver's mix-minus) sits BEFORE
        # SRTP in the forward chain; the reverse chain extracts
        # participants' own levels
        self._egress_levels = np.full(capacity, 127, dtype=np.uint8)
        self._level_ext_id = audio_level_ext_id
        self.levels_engine = CsrcAudioLevelEngine(
            audio_level_ext_id, capacity,
            level_of=lambda sids: self._egress_levels[sids])
        self.chain = TransformEngineChain(
            [self.levels_engine,
             SrtpTransformEngine(self.tx_table, self.rx_table)])
        # dominant-speaker detection fed by the mixer's per-tick levels
        self.on_speaker_change = on_speaker_change
        self.recorder = recorder
        self.speaker = DominantSpeakerIdentification(
            capacity, on_change=self._speaker_changed)
        self.speaker_events: List[Tuple[int, int]] = []  # (tick, sid)
        # overload degradation (set by a BridgeSupervisor rung): the tick
        # skips speaker scoring and egress level stamping while media
        # keeps flowing
        self.degraded = False
        self.loop = MediaLoop(
            UdpEngine(port=port, max_batch=4 * capacity,
                      kernel_timestamps=kernel_timestamps),
            self.registry, on_media=self._on_media, chain=self.chain,
            on_dtls=lambda d, a: self._dtls.on_dtls(d, a),
            recv_window_ms=recv_window_ms, pipelined=pipelined,
            pipeline_depth=pipeline_depth)
        self._dtls = DtlsAssociationTable(self.loop, profile,
                                          self._install_dtls)
        self.port = self.loop.engine.port
        # one mixer frame clock per bridge (the first codec sets it)
        self._frame_samples: Optional[int] = None
        self._rate: Optional[int] = None
        self.mixer: Optional[AudioMixer] = None
        self.bank: Optional[ReceiveBank] = None
        self._codec: Dict[int, FrameCodec] = {}
        self._ssrc_of: Dict[int, int] = {}      # sid -> mapped rx ssrc
        self._tx_seq = np.zeros(capacity, dtype=np.int64)
        self._tx_ts = np.zeros(capacity, dtype=np.int64)
        self._tx_ssrc = np.zeros(capacity, dtype=np.int64)
        self._now = 0.0
        self.ticks = 0

    # ------------------------------------------------------- participants
    def add_participant(self, ssrc: int, rx_key: Tuple[bytes, bytes],
                        tx_key: Tuple[bytes, bytes],
                        codec: Optional[FrameCodec] = None) -> int:
        """Join: install keys + codec, map the SSRC, return the row id.

        `rx_key` protects what the participant sends us; `tx_key`
        protects what we send them (SDES-style separate directions).
        """
        sid = self._register_media(ssrc, codec)
        self.rx_table.add_stream(sid, *rx_key)
        self.tx_table.add_stream(sid, *tx_key)
        return sid

    def _register_media(self, ssrc: int,
                        codec: Optional[FrameCodec]) -> int:
        """The join's half that needs no keys: row, demux, bank, mixer
        and speaker rows."""
        codec = codec or g711_codec(ptime_ms=self.ptime_ms,
                                    device=self.device)
        if (codec.frame_samples * 1000
                != codec.sample_rate * self.ptime_ms):
            raise ValueError(
                f"codec ptime {codec.frame_samples * 1000.0 / codec.sample_rate:.1f} ms "
                f"!= bridge ptime {self.ptime_ms} ms")
        if ssrc in self._ssrc_of.values():
            # silently remapping would mute the existing participant
            raise ValueError(f"ssrc {ssrc:#x} already joined")
        sid = self.registry.alloc(self)
        self._attach_media_row(sid, ssrc, codec)
        return sid

    def _attach_media_row(self, sid: int, ssrc: int,
                          codec: FrameCodec) -> None:
        """Join bookkeeping for a claimed row (allocated or reserved): the
        bridge clock, mixer and bank on the first attach, the demux map,
        the bank, mixer and speaker rows, randomized TX counters (a
        restore overwrites those afterwards).  Shared by joins and
        `restore`, so resumed conferences cannot diverge from live ones."""
        if self._frame_samples is None:
            # the first participant's codec sets the bridge clock; later
            # joins at other rates resample to it
            self._bootstrap_clock(codec.frame_samples, codec.sample_rate)
        self.registry.map_ssrc(ssrc, sid)
        self.bank.add_stream(sid, codec)
        self.mixer.add_participant(sid)
        self.speaker.add_participant(sid)
        self._codec[sid] = codec
        self._ssrc_of[sid] = ssrc & 0xFFFFFFFF
        self._tx_seq[sid] = int.from_bytes(np.random.bytes(2), "big")
        self._tx_ts[sid] = int.from_bytes(np.random.bytes(4), "big")
        self._tx_ssrc[sid] = (0x42000000 + sid) & 0xFFFFFFFF

    def _bootstrap_clock(self, frame_samples: int, rate: int) -> None:
        """Fix the bridge clock and build the mixer + receive bank (the
        first join; a restore applies the recorded clock, so a mixed-rate
        conference resumes on the same one)."""
        self._frame_samples = frame_samples
        self._rate = rate
        self.mixer = AudioMixer(capacity=self.capacity,
                                frame_samples=frame_samples,
                                device=self.device)
        self.bank = ReceiveBank(self.capacity, mixer=self.mixer,
                                payload_cap=max(256, frame_samples),
                                mixer_rate=rate, plc=self._plc,
                                device=self.device)

    def add_participant_dtls(self, ssrc: int,
                             codec: Optional[FrameCodec] = None,
                             role: str = "server",
                             remote_fingerprint: Optional[str] = None,
                             cookie_exchange: bool = False,
                             remote_addr=None):
        """Join keyed by DTLS-SRTP: the media row registers now, the SRTP
        keys install when the handshake completes, and early media is
        queued and replayed (`MediaLoop.hold_stream`).  Returns (sid,
        endpoint); pass `remote_addr` (ip as u32, port) when signaling
        knows the peer's 5-tuple.  Reference: DtlsControlImpl under
        MediaStream.start (SURVEY §3.5)."""
        sid = self._register_media(ssrc, codec)
        ep = self._dtls.join(sid, role, remote_fingerprint,
                             cookie_exchange, remote_addr)
        return sid, ep

    def _install_dtls(self, sid: int, ep) -> None:
        _profile, tk, tsalt, rk, rsalt = ep.srtp_keys()
        self.rx_table.add_stream(sid, rk, rsalt)
        self.tx_table.add_stream(sid, tk, tsalt)

    def remove_participant(self, sid: int) -> None:
        """Leave: every per-row residue must go — a recycled sid must
        not demux the old SSRC, keep old keys, or inherit the old
        latched address."""
        ssrc = self._ssrc_of.pop(sid, None)
        if ssrc is not None:
            self.registry.unmap_ssrc(ssrc)
        self.rx_table.remove_stream(sid)
        self.tx_table.remove_stream(sid)
        self._dtls.forget(sid)
        self.loop.addr_ip[sid] = 0
        self.loop.addr_port[sid] = 0
        self.bank.remove_stream(sid)
        self.mixer.remove_participant(sid)
        self.speaker.remove_participant(sid)
        self._egress_levels[sid] = 127
        self._codec.pop(sid, None)
        self.registry.release(sid)

    # --------------------------------------------------------------- tick
    def _on_media(self, batch, ok: np.ndarray):
        self.bank.push_decrypted(batch, ok, now=self._now)
        return None

    def tick(self, now: Optional[float] = None) -> dict:
        """One ptime: returns counters and this tick's levels and
        dominant speaker."""
        self._now = time.time() if now is None else now
        rx = self.loop.tick()
        if self._dtls.pending:
            self._dtls.tick()         # DTLS flight retransmission
        if self.bank is None:         # no participants yet
            return {"rx": rx, "mixed": 0, "tx": 0, "trace": self.loop.ticks,
                    "levels": np.zeros(0, dtype=np.uint8), "dominant": -1}
        with record_function("decode"):
            sids, _frames = self.bank.tick(now=self._now)
        with record_function("mixer"):
            out, levels = self.mixer.mix()
            if not self.degraded:
                self.speaker.levels(levels)
                self._update_egress_levels(levels)
        tx = self._send_mixes(out)
        self.ticks += 1
        return {"rx": rx, "mixed": len(sids), "tx": tx,
                "trace": self.loop.ticks, "levels": levels,
                "dominant": self.speaker.dominant}

    def _speaker_changed(self, sid: int) -> None:
        self.speaker_events.append((self.ticks, sid))
        ssrc = self._ssrc_of.get(sid)
        if self.recorder is not None and ssrc is not None:
            self.recorder.on_speaker_change(ssrc)
        if self.on_speaker_change is not None:
            self.on_speaker_change(sid, ssrc)

    def _update_egress_levels(self, levels: np.ndarray) -> None:
        """Each receiver's egress level = loudest OTHER contributor
        (min dBov excluding self), i.e. the level of the mix it hears:
        overall min + second-min, one vector pass."""
        act = self.mixer.active
        lv = np.where(act, levels[:len(act)].astype(np.int64), 128)
        order = np.argsort(lv)
        m1, m1_row = int(lv[order[0]]), int(order[0])
        m2 = int(lv[order[1]]) if len(order) > 1 else 128
        outl = np.full(self.capacity, m1, dtype=np.int64)
        outl[m1_row] = m2
        self._egress_levels[:] = np.minimum(outl, 127).astype(np.uint8)

    def _send_mixes(self, out: np.ndarray) -> int:
        """Encode each addressed participant's mix-minus row and send it
        through the forward chain to their latched address.  The rows of
        one codec kind leave the bridge clock in one launch of kernel R
        (off-rate kinds only); a G.711 law's rows then encode as ONE
        launch of kernel F, and stateful legs one host encode a row.  A
        row without installed tx keys gets nothing: a pending DTLS row
        has a latched address (the handshake's 5-tuple) but sending would
        put zero-key "protected" frames on the wire mid-handshake (the
        JAX bridge's pending exclusion), and a row whose handshake was
        refused never gets keys."""
        active = [sid for sid in self._codec
                  if self.loop.addr_port[sid] != 0
                  and self.tx_table.active[sid]]
        if not active:
            return 0
        payloads: Dict[int, bytes] = {}
        by_kind: Dict[str, List[int]] = {}
        for sid in active:
            by_kind.setdefault(self._codec[sid].name.upper(),
                               []).append(sid)
        for kind, rows in by_kind.items():
            pcm = self._from_bridge_rate(rows, out[np.asarray(rows)])
            if kind in G711_LAWS:
                enc = g711.encode(to_device(pcm, self.device),
                                  G711_LAWS[kind]).cpu().numpy()
                for k, sid in enumerate(rows):
                    payloads[sid] = enc[k].tobytes()
            else:
                for k, sid in enumerate(rows):
                    payloads[sid] = self._codec[sid].encode(pcm[k])
        sids = np.asarray(active, dtype=np.int64)
        steps = np.asarray([self._codec[s].ts_step for s in active],
                           dtype=np.int64)
        batch = rtp_header.build(
            [payloads[s] for s in active], self._tx_seq[sids].tolist(),
            self._tx_ts[sids].tolist(), self._tx_ssrc[sids].tolist(),
            [self._codec[s].pt for s in active],
            stream=sids.tolist())
        self._tx_seq[sids] = (self._tx_seq[sids] + 1) & 0xFFFF
        self._tx_ts[sids] = (self._tx_ts[sids] + steps) & 0xFFFFFFFF
        if self.loop.pipelined:
            # dispatch only: the protect overlaps the next recv window,
            # the bytes leave at the top of the next tick
            return self.loop.send_media_async(batch)
        return self.loop.send_media(batch)

    def _from_bridge_rate(self, rows: List[int], pcm: np.ndarray
                          ) -> np.ndarray:
        """Mix rows to a codec kind's clock (one kind, one rate): the
        identity at the bridge clock, else one launch of kernel R."""
        codec = self._codec[rows[0]]
        if codec.sample_rate == self._rate:
            return pcm
        with record_function("resample"):
            return resample_to_frame(pcm, self._rate, codec.sample_rate,
                                     codec.frame_samples, device=self.device)

    # ----------------------------------------------------------- resume
    _STATELESS = tuple(G711_LAWS)

    def snapshot(self) -> dict:
        """Checkpoint the conference in the JAX bridge's format: SRTP
        tables (indices and replay windows), the dense jitter rings, rows,
        SSRCs and codecs by name, the bridge clock, TX counters, speaker
        scores and latched addresses.  G.711 legs resume bit-exactly;
        G.722 and Opus legs resume with fresh codec state
        (`degraded_rows`) while their SRTP state carries over exactly.  A
        pipelined tick's last mixes are sent first.  Rows mid-DTLS are
        left out (they rejoin through signaling), as in the SFU
        snapshot."""
        self.loop.flush_sends()
        keyed = {sid: ssrc for sid, ssrc in self._ssrc_of.items()
                 if sid not in self._dtls.pending}
        return {
            "capacity": self.capacity,
            "profile": self.profile.name,
            "sharded": False,
            "ptime_ms": self.ptime_ms,
            "level_ext_id": self._level_ext_id,
            "rate": self._rate,
            "frame_samples": self._frame_samples,
            "rx_table": self.rx_table.snapshot(),
            "tx_table": self.tx_table.snapshot(),
            "jb": self.bank.jb.snapshot() if self.bank else None,
            "ssrc_of": keyed,
            "codec_name": {s: self._codec[s].name for s in keyed},
            "degraded_rows": sorted(
                s for s in keyed
                if self._codec[s].name.upper() not in self._STATELESS),
            "tx_seq": self._tx_seq.copy(),
            "tx_ts": self._tx_ts.copy(),
            "tx_ssrc": self._tx_ssrc.copy(),
            "addr_ip": self.loop.addr_ip.copy(),
            "addr_port": self.loop.addr_port.copy(),
            "speaker": {
                "immediate": self.speaker.immediate.copy(),
                "medium": self.speaker.medium.copy(),
                "long": self.speaker.long.copy(),
                "dominant": self.speaker.dominant,
            },
        }

    @classmethod
    def restore(cls, snap: dict, port: int = 0, device: DeviceLike = None,
                **kwargs) -> "ConferenceBridge":
        """Resume a snapshotted conference (of either package) on a fresh
        socket.  Rows reoccupy their old sids, so the restored SRTP tables
        and jitter rings line up; the bridge clock is the recorded one."""
        if snap.get("sharded"):
            raise ValueError(
                "snapshot came from a mesh bridge: restoring one is not "
                "ported yet (ROADMAP Queue 1, item 12)")
        bridge = cls(port=port, capacity=snap["capacity"],
                     profile=SrtpProfile[snap["profile"]],
                     ptime_ms=snap["ptime_ms"],
                     audio_level_ext_id=snap["level_ext_id"], device=device,
                     **kwargs)
        sids = sorted(snap["ssrc_of"])
        bridge.registry.reserve_many(sids, bridge)
        if snap.get("rate"):
            # the clock came from the first joiner, who need not come
            # first in row order here
            bridge._bootstrap_clock(snap["frame_samples"], snap["rate"])
        names = snap.get("codec_name")
        if names is None:        # the JAX bridge's older format
            names = {s: "PCMU" if snap["codec_ulaw"][s] else "PCMA"
                     for s in sids}
        for sid in sids:
            bridge._attach_media_row(
                sid, snap["ssrc_of"][sid],
                codec_from_name(names[sid], snap["ptime_ms"],
                                device=bridge.device))
        # the crypto, playout and counter state resumes verbatim (the
        # rings AFTER add_stream, which resets rows)
        bridge.rx_table = SrtpStreamTable.restore(snap["rx_table"],
                                                  bridge.device)
        bridge.tx_table = SrtpStreamTable.restore(snap["tx_table"],
                                                  bridge.device)
        bridge.chain = TransformEngineChain(
            [bridge.levels_engine,
             SrtpTransformEngine(bridge.tx_table, bridge.rx_table)])
        bridge.loop.chain = bridge.chain
        if snap["jb"] is not None and bridge.bank is not None:
            bridge.bank.jb = DenseJitterBank.restore(snap["jb"])
        bridge._tx_seq = np.asarray(snap["tx_seq"]).copy()
        bridge._tx_ts = np.asarray(snap["tx_ts"]).copy()
        bridge._tx_ssrc = np.asarray(snap["tx_ssrc"]).copy()
        keep = np.zeros(snap["capacity"], dtype=bool)
        keep[sids] = True
        bridge.loop.addr_ip[:] = np.where(keep, snap["addr_ip"], 0)
        bridge.loop.addr_port[:] = np.where(keep, snap["addr_port"], 0)
        sp = snap["speaker"]
        bridge.speaker.immediate[:] = sp["immediate"]
        bridge.speaker.medium[:] = sp["medium"]
        bridge.speaker.long[:] = sp["long"]
        bridge.speaker.dominant = sp["dominant"]
        return bridge

    # ------------------------------------------------------------ driving
    def run(self, duration_s: float) -> None:
        """Drive real-time ticks for a bounded interval."""
        end = time.time() + duration_s
        period = self.ptime_ms / 1000.0
        nxt = time.time()
        while time.time() < end:
            self.tick()
            nxt += period
            delay = nxt - time.time()
            if delay > 0:
                time.sleep(delay)

    def close(self) -> None:
        self.loop.engine.close()
