"""The dense many-stream receive plane and the G.711 codec legs.

Counterpart: `libjitsi_tpu/service/pump.py` — `FrameCodec`,
`g711_codec` and `ReceiveBank`.  The bank drives a `DenseJitterBank`
from the MediaLoop's decrypted batches and decodes per tick: the G.711
rows of one law and frame width decode as ONE launch of kernel G
(`kernels/g711.py`) on the bank's device.  PLC (repeat-with-decay) is
kept.

Not ported, each raising `NotImplementedError` where a caller would
reach it: the stateful codecs (Opus, G.722, GSM, Speex) and their
per-row decode path (ROADMAP Queue 1, item 9); legs at another rate than
the mixer's, which need the resampler (K13b, ROADMAP Queue 2).  Also
not ported: `SendPump`, `ReceivePump`, `register_metrics` and the bank's
histograms (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp.dense_jitter import DenseJitterBank

_RESAMPLE = ("legs at another rate than the mixer's need the resampler, "
             "not ported yet (K13b, ROADMAP Queue 2)")
STATEFUL = ("stateful codecs (Opus, G.722, GSM, Speex) are not ported yet "
            "(ROADMAP Queue 1, item 9)")
G711_LAWS = {"PCMU": g711.ULAW, "PCMA": g711.ALAW}


@dataclasses.dataclass
class FrameCodec:
    """One audio frame codec leg (encode: int16 [F] -> bytes)."""

    name: str
    pt: int
    sample_rate: int          # media clock
    frame_samples: int        # samples per ptime at sample_rate
    ts_step: int              # RTP timestamp increment per packet
    encode: Callable[[np.ndarray], bytes]
    decode: Callable[[bytes], np.ndarray]


def g711_codec(ulaw: bool = True, ptime_ms: int = 20,
               device: DeviceLike = None) -> FrameCodec:
    """A G.711 leg at 8 kHz.  Its one-frame `encode` / `decode` run on
    `device` (None means the card, resolved at the first call); the bank
    and the bridge encode and decode whole batches instead."""
    law = g711.ULAW if ulaw else g711.ALAW
    n = 8000 * ptime_ms // 1000

    def enc(pcm):
        x = torch.as_tensor(np.asarray(pcm, dtype=np.int16))
        return g711.encode(x.to(resolve_device(device)), law).cpu() \
            .numpy().tobytes()

    def dec(b):
        x = torch.as_tensor(np.frombuffer(b, dtype=np.uint8).copy())
        return g711.decode(x.to(resolve_device(device)), law).cpu().numpy()

    return FrameCodec("PCMU" if ulaw else "PCMA", 0 if ulaw else 8,
                      8000, n, n, enc, dec)


class ReceiveBank:
    """The dense many-stream receive plane: one object serves S streams.

    The G.711 rows of one law and frame width decode as ONE kernel launch
    across all ready streams.
    """

    def __init__(self, capacity: int, mixer=None, payload_cap: int = 256,
                 depth: int = 16, mixer_rate: Optional[int] = None,
                 plc: bool = False, plc_max_run: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.mixer = mixer
        # sample rate of the mixer's frame clock (legs at another rate
        # would need the resampler, which is not ported)
        self.mixer_rate = mixer_rate
        self.jb = DenseJitterBank(capacity, depth=depth,
                                  payload_cap=payload_cap)
        self._law = np.full(capacity, -1, dtype=np.int8)    # -1: no stream
        self.frame_samples = np.zeros(capacity, dtype=np.int32)
        self.decoded_frames = np.zeros(capacity, dtype=np.int64)
        self.lost_frames = np.zeros(capacity, dtype=np.int64)
        # frames larger than payload_cap are DROPPED, not truncated
        self.oversize_dropped = np.zeros(capacity, dtype=np.int64)
        # packet-loss concealment (opt-in): an underrun mid-stream repeats
        # the row's last decoded frame with 6 dB decay per repeat, for at
        # most `plc_max_run` frames in a row
        self.plc = plc
        self.plc_max_run = plc_max_run
        self.plc_frames = np.zeros(capacity, dtype=np.int64)
        self._plc_run = np.zeros(capacity, dtype=np.int32)
        self._last_pcm: Dict[int, np.ndarray] = {}

    def add_stream(self, sid: int, codec: FrameCodec) -> None:
        if self.mixer is not None and \
                codec.frame_samples != self.mixer.frame_samples:
            if self.mixer_rate is None:
                # padding a mismatched frame would mix sped-up audio
                # silently — fail loudly at config
                raise ValueError(
                    f"codec frame ({codec.frame_samples}) != mixer "
                    f"frame ({self.mixer.frame_samples}); resample "
                    f"before deposit")
            if (codec.frame_samples * self.mixer_rate
                    != self.mixer.frame_samples * codec.sample_rate):
                raise ValueError(
                    f"codec ptime ({codec.frame_samples}/"
                    f"{codec.sample_rate}) != mixer ptime "
                    f"({self.mixer.frame_samples}/{self.mixer_rate})")
            raise NotImplementedError(_RESAMPLE)
        if codec.name.upper() not in G711_LAWS:
            raise NotImplementedError(STATEFUL)
        self._law[sid] = G711_LAWS[codec.name.upper()]
        self.frame_samples[sid] = codec.frame_samples
        ptime_ms = codec.frame_samples * 1000.0 / codec.sample_rate
        self.jb.reset_streams([sid])          # recycled sids start fresh
        self.jb.configure_streams(
            [sid], clock_rate=codec.ts_step * 1000.0 / ptime_ms,
            frame_ms=ptime_ms)
        self.decoded_frames[sid] = 0
        self.lost_frames[sid] = 0
        self.plc_frames[sid] = 0
        self._plc_run[sid] = 0
        self._last_pcm.pop(sid, None)

    def remove_stream(self, sid: int) -> None:
        self.remove_streams([sid])

    def remove_streams(self, sids) -> None:
        """Recycle the jitter-bank rows, PLC run state and per-stream
        stats in one pass, so a departed stream's concealment tail can
        never bleed into the row's next occupant."""
        sids = [int(s) for s in sids]
        if not sids:
            return
        for sid in sids:
            self._last_pcm.pop(sid, None)
        arr = np.asarray(sids, dtype=np.int64)
        self._law[arr] = -1
        self._plc_run[arr] = 0
        self.decoded_frames[arr] = 0
        self.lost_frames[arr] = 0
        self.plc_frames[arr] = 0
        self.jb.reset_streams(sids)

    # ------------------------------------------------------------- intake
    def push_decrypted(self, batch, ok, now: Optional[float] = None
                       ) -> int:
        """Feed a MediaLoop `on_media` batch (decrypted rows + ok mask);
        one header parse + one dense insert for the whole batch."""
        now = time.time() if now is None else now
        sids = np.asarray(batch.stream, dtype=np.int64)
        hdr = rtp_header.parse(batch)
        lens_all = np.asarray(batch.length) - hdr.payload_off
        cap = self.jb.payload_cap
        base = (np.asarray(ok) & np.asarray(hdr.valid)
                & (lens_all > 0)               # lying ext len -> negative
                & (sids >= 0) & (sids < self.capacity)
                & (self._law[np.clip(sids, 0,
                                     self.capacity - 1)] >= 0))
        over = base & (lens_all > cap)
        if over.any():
            np.add.at(self.oversize_dropped, sids[over], 1)
        rows = np.nonzero(base & ~over)[0]
        if len(rows) == 0:
            return 0
        off = hdr.payload_off[rows]
        lens = lens_all[rows]
        # vectorized ragged gather: no per-row Python loop on the intake
        col = np.arange(cap, dtype=np.int64)[None, :]
        src = np.clip(off[:, None] + col, 0, batch.capacity - 1)
        pay = np.take_along_axis(batch.data[rows], src, axis=1)
        pay[col >= lens[:, None]] = 0
        self.jb.insert_batch(sids[rows], hdr.seq[rows], hdr.ts[rows],
                             pay, lens, now)
        return len(rows)

    # --------------------------------------------------------------- tick
    def _decode_g711(self, codes: np.ndarray, law: int) -> np.ndarray:
        return g711.decode(to_device(codes, self.device), law).cpu().numpy()

    def tick(self, now: Optional[float] = None):
        """One decode tick for all streams.  Returns (sids, pcm [K, F*])
        for streams that produced a frame this tick; rows are also
        deposited into the mixer when one is attached.  Streams with an
        underrun count a lost frame (the mixer's zeroed row is the
        silence fill)."""
        now = time.time() if now is None else now
        ready, pays, _plens = self.jb.pop_all(now)
        lost = (self._law >= 0) & ~ready
        self.lost_frames[lost] += 1
        out_sids: List[int] = []
        out_pcm: List[np.ndarray] = []
        mix_deposits: List[Tuple[np.ndarray, np.ndarray]] = []

        for law in (g711.ULAW, g711.ALAW):
            krows = np.nonzero(ready & (self._law == law))[0]
            # group by frame size: mixed ptimes must not share a width
            for n in np.unique(self.frame_samples[krows]):
                rows = krows[self.frame_samples[krows] == n]
                pcm = self._decode_g711(pays[rows, :int(n)], law)
                self.decoded_frames[rows] += 1
                out_sids.extend(rows.tolist())
                out_pcm.extend(pcm)
                mix_deposits.append((rows, pcm))
        plc_sids: List[int] = []
        plc_pcm: List[np.ndarray] = []
        if self.plc:
            # per-row work only on LOST rows of an opted-in bank
            self._plc_run[ready] = 0
            for rows, pcm in mix_deposits:
                for i, sid in enumerate(rows.tolist()):
                    self._last_pcm[sid] = pcm[i]
            for sid in np.nonzero(lost)[0].tolist():
                last = self._last_pcm.get(sid)
                if last is None or self._plc_run[sid] >= self.plc_max_run:
                    continue          # nothing to extrapolate / run over
                self._plc_run[sid] += 1
                decay = 0.5 ** int(self._plc_run[sid])
                pcm = (last.astype(np.float32) * decay).astype(np.int16)
                self.plc_frames[sid] += 1
                plc_sids.append(sid)
                plc_pcm.append(pcm)
        out_sids.extend(plc_sids)
        out_pcm.extend(plc_pcm)
        if self.mixer is not None:
            # frame sizes were checked against the mixer at add_stream
            for rows, pcm in mix_deposits:
                self.mixer.push_batch(rows, pcm)
            if plc_sids:
                self.mixer.push_batch(np.asarray(plc_sids), np.stack(plc_pcm))
        return out_sids, out_pcm
