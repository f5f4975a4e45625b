"""ConferenceBridge — the whole audio-bridge tick as one object.

Counterpart: `libjitsi_tpu/service/bridge.py` `ConferenceBridge`.  ONE
MediaLoop (batched UDP + reverse chain), ONE ReceiveBank (dense jitter
+ decode), ONE AudioMixer row range, and a batched encode -> packetize
-> protect -> send tail: a whole conference tick is a handful of kernel
launches regardless of participant count.

Tick flow (one ptime, default 20 ms), kernels in brackets:

    loop.tick()            drain socket -> demux -> unprotect [D]
       -> bank.push_decrypted (dense jitter insert)
    bank.tick()            pop due frames -> G.711 decode [G]
    mixer.mix()            mix-minus + RFC 6465 levels [E]
    speaker / egress levels
    encode rows            G.711 encode [F]
    loop.send_media()      packetize -> RFC 6464 level stamp
                           -> protect [C] -> sendmmsg

Keying is SDES-style static master keys per participant (rx = what the
participant sends with, tx = what we send to them with).  `device`
None means the card; the tests pass device="cpu".  The bank and mixer
stages run inside `record_function` spans `decode` and `mixer`, beside
the loop's own.

Not ported: the JAX bridge's `config` argument and DTLS joins
(`add_participant_dtls`, ROADMAP Queue 1, item 9), the pipelined tick
(item 4), the mesh mode (item 12), the recorder (item 9),
`snapshot` / `restore` (item 7); joins with a stateful codec (item 9)
or at another rate than the first joiner's, which needs the resampler
(K13b, ROADMAP Queue 2), raise `NotImplementedError`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from libjitsi_tpu_torch.conference.mixer import AudioMixer
from libjitsi_tpu_torch.conference.speaker import DominantSpeakerIdentification
from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.io.loop import MediaLoop
from libjitsi_tpu_torch.io.udp import UdpEngine
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.service.media_stream import StreamRegistry
from libjitsi_tpu_torch.service.pump import (G711_LAWS, STATEFUL, FrameCodec,
                                             ReceiveBank, g711_codec)
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
                 ptime_ms: int = 20, recv_window_ms: int = 1,
                 audio_level_ext_id: int = 1,
                 on_speaker_change=None, plc: bool = False,
                 device: DeviceLike = None):
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
        self.speaker = DominantSpeakerIdentification(
            capacity, on_change=self._speaker_changed)
        self.speaker_events: List[Tuple[int, int]] = []  # (tick, sid)
        self.loop = MediaLoop(
            UdpEngine(port=port, max_batch=4 * capacity),
            self.registry, on_media=self._on_media, chain=self.chain,
            recv_window_ms=recv_window_ms)
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
        codec = codec or g711_codec(ptime_ms=self.ptime_ms,
                                    device=self.device)
        if (codec.frame_samples * 1000
                != codec.sample_rate * self.ptime_ms):
            raise ValueError(
                f"codec ptime {codec.frame_samples * 1000.0 / codec.sample_rate:.1f} ms "
                f"!= bridge ptime {self.ptime_ms} ms")
        if codec.name.upper() not in G711_LAWS:
            raise NotImplementedError(STATEFUL)
        if self._rate is not None and codec.sample_rate != self._rate:
            raise NotImplementedError(
                f"codec rate {codec.sample_rate} != bridge rate "
                f"{self._rate}: off-rate legs need the resampler, not "
                "ported yet (K13b, ROADMAP Queue 2)")
        if ssrc in self._ssrc_of.values():
            # silently remapping would mute the existing participant
            raise ValueError(f"ssrc {ssrc:#x} already joined")
        sid = self.registry.alloc(self)
        if self._frame_samples is None:
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
        self.rx_table.add_stream(sid, *rx_key)
        self.tx_table.add_stream(sid, *tx_key)
        return sid

    def _bootstrap_clock(self, frame_samples: int, rate: int) -> None:
        """Fix the bridge clock and build the mixer + receive bank."""
        self._frame_samples = frame_samples
        self._rate = rate
        self.mixer = AudioMixer(capacity=self.capacity,
                                frame_samples=frame_samples,
                                device=self.device)
        self.bank = ReceiveBank(self.capacity, mixer=self.mixer,
                                payload_cap=max(256, frame_samples),
                                mixer_rate=rate, plc=self._plc,
                                device=self.device)

    def remove_participant(self, sid: int) -> None:
        """Leave: every per-row residue must go — a recycled sid must
        not demux the old SSRC, keep old keys, or inherit the old
        latched address."""
        ssrc = self._ssrc_of.pop(sid, None)
        if ssrc is not None:
            self.registry.unmap_ssrc(ssrc)
        self.rx_table.remove_stream(sid)
        self.tx_table.remove_stream(sid)
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
        if self.bank is None:         # no participants yet
            return {"rx": rx, "mixed": 0, "tx": 0, "trace": self.loop.ticks,
                    "levels": np.zeros(0, dtype=np.uint8), "dominant": -1}
        with record_function("decode"):
            sids, _frames = self.bank.tick(now=self._now)
        with record_function("mixer"):
            out, levels = self.mixer.mix()
            self.speaker.levels(levels)
            self._update_egress_levels(levels)
        tx = self._send_mixes(out)
        self.ticks += 1
        return {"rx": rx, "mixed": len(sids), "tx": tx,
                "trace": self.loop.ticks, "levels": levels,
                "dominant": self.speaker.dominant}

    def _speaker_changed(self, sid: int) -> None:
        self.speaker_events.append((self.ticks, sid))
        if self.on_speaker_change is not None:
            self.on_speaker_change(sid, self._ssrc_of.get(sid))

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
        one G.711 law encode as ONE launch of kernel F."""
        active = [sid for sid in self._codec if self.loop.addr_port[sid] != 0]
        if not active:
            return 0
        payloads: Dict[int, bytes] = {}
        by_kind: Dict[str, List[int]] = {}
        for sid in active:
            by_kind.setdefault(self._codec[sid].name.upper(),
                               []).append(sid)
        for kind, rows in by_kind.items():
            enc = g711.encode(to_device(out[np.asarray(rows)], self.device),
                              G711_LAWS[kind]).cpu().numpy()
            for k, sid in enumerate(rows):
                payloads[sid] = enc[k].tobytes()
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
        return self.loop.send_media(batch)

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
