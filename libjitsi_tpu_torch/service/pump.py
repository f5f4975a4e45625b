"""The dense many-stream receive plane and the codec legs.

Counterpart: `libjitsi_tpu/service/pump.py` — `FrameCodec`, `g711_codec`,
`g722_codec`, `opus_codec`, `codec_from_name` and `ReceiveBank`.  The bank
drives a `DenseJitterBank` from the MediaLoop's decrypted batches and
decodes per tick: the G.711 rows of one law and frame width decode as ONE
launch of kernel G (`kernels/g711.py`) on the bank's device; the stateful
rows (G.722, Opus) decode one by one through their host codecs, counting
`decode_errors`.  Rows at another rate than the mixer's resample to the
mixer clock on deposit, one launch of kernel R (`kernels/resample.py`) a
same-rate group, inside a `record_function("resample")` span.  PLC
(repeat-with-decay) covers both kinds of row.

Not ported, each raising `NotImplementedError` where a caller would reach
it: the GSM, Speex, G.729 and iLBC legs (ROADMAP Queue 1, item 9);
`SendPump`, `ReceivePump`, `register_metrics` and the bank's histograms
(ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.kernels import g711
from libjitsi_tpu_torch.kernels.resample import resample_to_frame
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.rtp.dense_jitter import DenseJitterBank

G711_LAWS = {"PCMU": g711.ULAW, "PCMA": g711.ALAW}
#: the codec legs the port has (by upper-case wire name)
PORTED_CODECS = ("PCMU", "PCMA", "G722", "OPUS")
#: the bank's row kinds: a G.711 law, or a stateful host codec
STATEFUL = 2


def not_ported_codec(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {name} codec leg is not ported yet (ROADMAP Queue 1, item 9)")


def check_ported(codec: "FrameCodec") -> None:
    """Refuse a leg whose codec the port does not have (GSM, Speex, G.729,
    iLBC), by its wire name."""
    if codec.name.upper() not in PORTED_CODECS:
        raise not_ported_codec(codec.name)


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


def g722_codec(ptime_ms: int = 20) -> FrameCodec:
    """A G.722 leg at 16 kHz: one stateful encoder and decoder for the
    leg's lifetime (the predictor and scale factors carry across frames).
    RFC 3551 §4.5.2: its RTP clock is 8,000, so `ts_step` is n / 2."""
    from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder

    n = 16000 * ptime_ms // 1000
    enc, dec = G722Encoder(1), G722Decoder(1)

    def do_enc(pcm):
        return enc.encode(
            np.asarray(pcm, np.int16).reshape(1, -1))[0].tobytes()

    def do_dec(b):
        code = np.frombuffer(b, dtype=np.uint8).reshape(1, -1)
        return dec.decode(code)[0]

    return FrameCodec("G722", 9, 16000, n, n // 2, do_enc, do_dec)


def opus_codec(ptime_ms: int = 20, bitrate: int = 32000) -> FrameCodec:
    """An Opus leg at 48 kHz on the system libopus."""
    from libjitsi_tpu_torch.codecs.opus import OpusDecoder, OpusEncoder

    n = 48000 * ptime_ms // 1000
    enc = OpusEncoder(sample_rate=48000, channels=1)
    enc.set_bitrate(bitrate)
    dec = OpusDecoder(sample_rate=48000, channels=1)
    return FrameCodec(
        "opus", 111, 48000, n, n,
        lambda pcm: enc.encode(np.asarray(pcm, np.int16)),
        lambda b: dec.decode(b, frame_size=n))


def codec_from_name(name: str, ptime_ms: int,
                    device: DeviceLike = None) -> FrameCodec:
    """Rebuild a codec leg from its wire name (snapshot restore).

    G.711 resumes bit-exactly.  G.722 and Opus come back with fresh codec
    state, the JAX bridge's degraded resume: the decoder warms up over the
    first frames and the encoder restarts clean, while SRTP counters and
    replay windows carry over exactly."""
    u = name.upper()
    if u in G711_LAWS:
        return g711_codec(u == "PCMU", ptime_ms, device=device)
    if u == "G722":
        return g722_codec(ptime_ms)
    if u == "OPUS":
        return opus_codec(ptime_ms)
    if u in ("GSM", "G729", "ILBC") or u.startswith("SPEEX"):
        raise not_ported_codec(name)
    raise ValueError(f"cannot rebuild codec {name!r} on restore")


class ReceiveBank:
    """The dense many-stream receive plane: one object serves S streams.

    The G.711 rows of one law and frame width decode as ONE kernel launch
    across all ready streams; stateful rows (G.722, Opus) decode through
    their per-stream host codecs, a bounded loop over ready rows.  With
    `mixer_rate` set, streams of another rate but the same ptime are
    accepted and resampled to the mixer clock on deposit.
    """

    def __init__(self, capacity: int, mixer=None, payload_cap: int = 256,
                 depth: int = 16, mixer_rate: Optional[int] = None,
                 plc: bool = False, plc_max_run: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.mixer = mixer
        # sample rate of the mixer's frame clock; None = strict mode (exact
        # frame match or add_stream raises)
        self.mixer_rate = mixer_rate
        self.jb = DenseJitterBank(capacity, depth=depth,
                                  payload_cap=payload_cap)
        # a G.711 law, STATEFUL, or -1: no stream
        self._kind = np.full(capacity, -1, dtype=np.int8)
        self._decode: Dict[int, Callable[[bytes], np.ndarray]] = {}
        self._srate = np.zeros(capacity, dtype=np.int64)
        self.frame_samples = np.zeros(capacity, dtype=np.int32)
        self.decoded_frames = np.zeros(capacity, dtype=np.int64)
        self.lost_frames = np.zeros(capacity, dtype=np.int64)
        self.decode_errors = np.zeros(capacity, dtype=np.int64)
        # frames larger than payload_cap are DROPPED, not truncated (a
        # truncated frame would corrupt a stateful decoder)
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
            # resampling fixes the rate, not the frame's duration
            if (codec.frame_samples * self.mixer_rate
                    != self.mixer.frame_samples * codec.sample_rate):
                raise ValueError(
                    f"codec ptime ({codec.frame_samples}/"
                    f"{codec.sample_rate}) != mixer ptime "
                    f"({self.mixer.frame_samples}/{self.mixer_rate})")
        check_ported(codec)
        name = codec.name.upper()
        if name in G711_LAWS:
            self._kind[sid] = G711_LAWS[name]
        else:
            self._kind[sid] = STATEFUL
            self._decode[sid] = codec.decode
        self.frame_samples[sid] = codec.frame_samples
        self._srate[sid] = codec.sample_rate
        ptime_ms = codec.frame_samples * 1000.0 / codec.sample_rate
        self.jb.reset_streams([sid])          # recycled sids start fresh
        self.jb.configure_streams(
            [sid], clock_rate=codec.ts_step * 1000.0 / ptime_ms,
            frame_ms=ptime_ms)
        self.decoded_frames[sid] = 0
        self.lost_frames[sid] = 0
        self.decode_errors[sid] = 0
        self.plc_frames[sid] = 0
        self._plc_run[sid] = 0
        self._last_pcm.pop(sid, None)

    def remove_stream(self, sid: int) -> None:
        self.remove_streams([sid])

    def remove_streams(self, sids) -> None:
        """Recycle the jitter-bank rows, decoders, PLC run state and
        per-stream stats in one pass, so a departed stream's concealment
        tail can never bleed into the row's next occupant."""
        sids = [int(s) for s in sids]
        if not sids:
            return
        for sid in sids:
            self._decode.pop(sid, None)
            self._last_pcm.pop(sid, None)
        arr = np.asarray(sids, dtype=np.int64)
        self._kind[arr] = -1
        self._plc_run[arr] = 0
        self.decoded_frames[arr] = 0
        self.lost_frames[arr] = 0
        self.decode_errors[arr] = 0
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
                & (self._kind[np.clip(sids, 0,
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

    def _decode_stateful(self, sids: np.ndarray, pays: np.ndarray,
                         plens: np.ndarray) -> Tuple[List[int],
                                                     List[np.ndarray]]:
        """One host decode a ready stateful row, padded or trimmed to its
        frame; an undecodable (authenticated) payload counts a
        `decode_errors` and deposits nothing."""
        out_sids: List[int] = []
        out_pcm: List[np.ndarray] = []
        for sid in sids.tolist():
            try:
                pcm = np.asarray(
                    self._decode[sid](pays[sid, :plens[sid]].tobytes()),
                    dtype=np.int16)
            except (ValueError, RuntimeError):
                self.decode_errors[sid] += 1
                continue
            f = int(self.frame_samples[sid])
            if len(pcm) < f:
                pcm = np.pad(pcm, (0, f - len(pcm)))
            elif len(pcm) > f:
                pcm = pcm[:f]
            self.decoded_frames[sid] += 1
            out_sids.append(sid)
            out_pcm.append(pcm)
        return out_sids, out_pcm

    def tick(self, now: Optional[float] = None):
        """One decode tick for all streams.  Returns (sids, pcm [K, F*])
        for streams that produced a frame this tick, at their own rates;
        rows are also deposited into the mixer, at its rate, when one is
        attached.  Streams with an underrun count a lost frame (the
        mixer's zeroed row is the silence fill)."""
        now = time.time() if now is None else now
        ready, pays, plens = self.jb.pop_all(now)
        lost = (self._kind >= 0) & ~ready
        self.lost_frames[lost] += 1
        out_sids: List[int] = []
        out_pcm: List[np.ndarray] = []
        mix_deposits: List[Tuple[np.ndarray, np.ndarray]] = []

        for law in (g711.ULAW, g711.ALAW):
            krows = np.nonzero(ready & (self._kind == law))[0]
            # group by frame size: mixed ptimes must not share a width
            for n in np.unique(self.frame_samples[krows]):
                rows = krows[self.frame_samples[krows] == n]
                pcm = self._decode_g711(pays[rows, :int(n)], law)
                self.decoded_frames[rows] += 1
                out_sids.extend(rows.tolist())
                out_pcm.extend(pcm)
                mix_deposits.append((rows, pcm))
        s_sids, s_pcm = self._decode_stateful(
            np.nonzero(ready & (self._kind == STATEFUL))[0], pays, plens)
        if self.plc:
            # per-row work only on LOST rows of an opted-in bank
            self._plc_run[ready] = 0
            for rows, pcm in mix_deposits:
                for i, sid in enumerate(rows.tolist()):
                    self._last_pcm[sid] = pcm[i]
            for i, sid in enumerate(s_sids):
                self._last_pcm[sid] = s_pcm[i]
            for sid in np.nonzero(lost)[0].tolist():
                last = self._last_pcm.get(sid)
                if last is None or self._plc_run[sid] >= self.plc_max_run:
                    continue          # nothing to extrapolate / run over
                self._plc_run[sid] += 1
                decay = 0.5 ** int(self._plc_run[sid])
                pcm = (last.astype(np.float32) * decay).astype(np.int16)
                self.plc_frames[sid] += 1
                s_sids.append(sid)
                s_pcm.append(pcm)
        out_sids.extend(s_sids)
        out_pcm.extend(s_pcm)
        if self.mixer is not None:
            # frame sizes were checked against the mixer at add_stream;
            # off-rate groups resample to the mixer clock first
            for rows, pcm in mix_deposits:
                self.mixer.push_batch(rows, self._to_mixer_rate(rows, pcm))
            if s_sids:
                rows = np.asarray(s_sids)
                # stateful rows may mix rates: one resample per distinct
                # frame width (the same width is the same rate, the ptime
                # being the bridge's)
                widths = np.asarray([len(p) for p in s_pcm])
                for w in np.unique(widths):
                    sel = np.nonzero(widths == w)[0]
                    pcm = np.stack([s_pcm[i] for i in sel])
                    self.mixer.push_batch(
                        rows[sel], self._to_mixer_rate(rows[sel], pcm))
        return out_sids, out_pcm

    def _to_mixer_rate(self, rows: np.ndarray, pcm: np.ndarray
                       ) -> np.ndarray:
        """Resample a same-rate row group to the mixer frame clock: one
        launch of kernel R on the bank's device."""
        if (self.mixer_rate is None
                or pcm.shape[1] == self.mixer.frame_samples):
            return pcm
        with record_function("resample"):
            return resample_to_frame(pcm, int(self._srate[rows[0]]),
                                     self.mixer_rate,
                                     self.mixer.frame_samples,
                                     device=self.device)
