"""Media pumps, the codec legs and the dense many-stream receive plane.

Counterpart: `libjitsi_tpu/service/pump.py` — `FrameCodec`, the G.711,
G.722, Opus, GSM and Speex legs, the G.729 and iLBC receive-only legs,
`codec_from_name`, `SendPump`, `ReceivePump` and `ReceiveBank`.

The pumps are the Processor-graph role, one host object a stream:
`SendPump` reads a frame from an `AudioSource` (`device/`), encodes it and
hands it to `MediaStream.send` (one launch of kernel C, and of F for a
G.711 leg on the card); `ReceivePump` runs `MediaStream.receive` (one
launch of D), holds the payloads in a `rtp/jitter_buffer.JitterBuffer`,
and each `tick()` decodes one ptime (one launch of G for a G.711 leg),
conceals an underrun through the codec's `decode(b"")` where it can,
clamps an over-long decode to one ptime, and writes the frame to a sink
and/or a mixer row (`AudioMixerMediaDevice`: kernel E at its `tick()`).

The bank drives a `DenseJitterBank` from the MediaLoop's decrypted
batches and decodes per tick: the G.711 rows of one law and frame width
decode as ONE launch of kernel G (`kernels/g711.py`) on the bank's
device; the stateful rows (G.722, Opus, GSM, Speex, G.729, iLBC) decode
one by one
through their host codecs, counting `decode_errors`.  Rows at another
rate than the mixer's resample to the mixer clock on deposit, one launch
of kernel R (`kernels/resample.py`) a same-rate group, inside a
`record_function("resample")` span.  PLC (repeat-with-decay) covers both
kinds of row.  Each decode tick fills the bank's `jitter_hist` and
`decode_delay_hist` over its active rows, and `register_metrics` exposes
them with the per-stream counters.

The G.729 and iLBC legs decode on the system libavcodec
(`codecs/audio_avcodec.py`); it has no encoder for them, so their
`encode` raises `RuntimeError` (the gateway posture: reply legs use G.711
or Opus), and a host whose libavcodec lacks the decoder refuses the leg
with the JAX binding's `RuntimeError`.
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
from libjitsi_tpu_torch.utils.metrics import Histogram

G711_LAWS = {"PCMU": g711.ULAW, "PCMA": g711.ALAW}
#: the bank's row kinds: a G.711 law, or a stateful host codec
STATEFUL = 2


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


def gsm_codec() -> FrameCodec:
    """GSM 06.10 full rate: fixed 20 ms / 160 samples / 33 bytes at 8 kHz,
    one stateful encoder and decoder for the leg's lifetime."""
    from libjitsi_tpu_torch.codecs.gsm import GsmCodec

    c = GsmCodec()
    return FrameCodec(
        "GSM", 3, 8000, 160, 160,
        lambda pcm: c.encode(np.asarray(pcm, np.int16)),
        lambda b: c.decode(b))


def speex_codec(mode: str = "nb") -> FrameCodec:
    """Speex NB (8 kHz) / WB (16 kHz) / UWB (32 kHz), 20 ms frames."""
    from libjitsi_tpu_torch.codecs.speex import (MODE_NB, MODE_UWB, MODE_WB,
                                                 SpeexDecoder, SpeexEncoder)

    m = {"nb": MODE_NB, "wb": MODE_WB, "uwb": MODE_UWB}[mode]
    enc, dec = SpeexEncoder(mode=m), SpeexDecoder(mode=m)
    n = enc.frame_size      # libspeex's own 20 ms frame size
    return FrameCodec(
        "speex" if mode == "nb" else f"speex/{enc.sample_rate}", 97,
        enc.sample_rate, n, n,
        lambda pcm: enc.encode(np.asarray(pcm, np.int16)),
        lambda b: dec.decode(b))


def _no_encoder(name: str):
    """Encode stub of a receive-only leg (libavcodec has no encoder)."""
    def enc(pcm):
        raise RuntimeError(
            f"no {name} encoder on this host: receive-only leg "
            "(ReceivePump/ReceiveBank); send with G.711/Opus instead")
    return enc


def g729_rx_codec(ptime_ms: int = 20) -> FrameCodec:
    """G.729 receive-only leg, decoding on the system libavcodec.  RFC
    3551: pt 18, 8 kHz, N x 10-byte frames a packet (+ an optional 2-byte
    SID)."""
    from libjitsi_tpu_torch.codecs.audio_avcodec import g729_decoder

    dec = g729_decoder()
    n = 8000 * ptime_ms // 1000
    return FrameCodec("G729", 18, 8000, n, n, _no_encoder("G.729"),
                      lambda b: dec.decode_payload(b))


def ilbc_rx_codec() -> FrameCodec:
    """iLBC (RFC 3952, mode=20) receive-only leg; see g729_rx_codec."""
    from libjitsi_tpu_torch.codecs.audio_avcodec import ilbc_decoder

    dec = ilbc_decoder()
    return FrameCodec("iLBC", 97, 8000, 160, 160, _no_encoder("iLBC"),
                      lambda b: dec.decode_payload(b))


def codec_from_name(name: str, ptime_ms: int,
                    device: DeviceLike = None) -> FrameCodec:
    """Rebuild a codec leg from its wire name (snapshot restore).

    G.711 resumes bit-exactly.  G.722, Opus, GSM and Speex come back with
    fresh codec state, the JAX bridge's degraded resume: the decoder warms
    up over the first frames and the encoder restarts clean, while SRTP
    counters and replay windows carry over exactly."""
    u = name.upper()
    if u in G711_LAWS:
        return g711_codec(u == "PCMU", ptime_ms, device=device)
    if u == "G722":
        return g722_codec(ptime_ms)
    if u == "GSM":
        return gsm_codec()
    if u == "OPUS":
        return opus_codec(ptime_ms)
    if u.startswith("SPEEX"):
        rate = name.split("/", 1)[1] if "/" in name else "8000"
        return speex_codec({"8000": "nb", "16000": "wb",
                            "32000": "uwb"}[rate])
    # receive-only legs must restore too: a snapshot that cannot be
    # loaded again is worse than a refusal at snapshot time
    if u == "G729":
        return g729_rx_codec(ptime_ms)
    if u == "ILBC":
        return ilbc_rx_codec()
    raise ValueError(f"cannot rebuild codec {name!r} on restore")


class SendPump:
    """Capture -> encode -> packetize/protect.

    One `tick()` = one ptime: read a frame from the source, encode it,
    hand it to `MediaStream.send`, and return the wire datagrams (the
    caller forwards them to its engine)."""

    def __init__(self, stream, source, codec: FrameCodec):
        self.stream = stream
        self.source = source
        self.codec = codec
        if getattr(source, "sample_rate", codec.sample_rate) \
                != codec.sample_rate:
            raise ValueError(
                f"source rate {source.sample_rate} != codec rate "
                f"{codec.sample_rate}; resample at the device layer "
                "(kernels/resample.py)")

    def tick(self) -> List[bytes]:
        pcm = self.source.read(self.codec.frame_samples)
        payload = self.codec.encode(pcm)
        return self.stream.send([payload], pt=self.codec.pt,
                                ts_step=self.codec.ts_step)


class ReceivePump:
    """Unprotect -> jitter buffer -> decode -> sink/mixer.

    `push(datagrams)` feeds arrivals (any cadence); `tick()` pulls one
    ptime's packet from the jitter buffer, decodes it, writes the PCM to
    the sink and/or deposits it into a mixer row.  An underrun mid-stream
    asks the codec for a concealment frame (`decode(b"")`, with `plc`);
    where it has none, the underrun plays silence."""

    def __init__(self, stream, codec: FrameCodec,
                 sink=None, mixer=None, mixer_sid: Optional[int] = None,
                 plc: bool = True):
        from libjitsi_tpu_torch.rtp.jitter_buffer import JitterBuffer

        self.stream = stream
        self.codec = codec
        self.sink = sink
        self.mixer = mixer
        self.mixer_sid = mixer_sid
        self.plc = plc
        self.plc_frames = 0
        # the jitter clock is the RTP media clock: ts_step units a ptime
        ptime_ms = codec.frame_samples * 1000.0 / codec.sample_rate
        self.jb = JitterBuffer(
            clock_rate=int(round(codec.ts_step * 1000 / ptime_ms)),
            frame_ms=ptime_ms)
        self.decoded_frames = 0
        self.lost_frames = 0
        self.decode_errors = 0

    def register_metrics(self, registry, prefix: str = "rx_pump") -> None:
        """Export the pump's decode and loss counters and its jitter
        buffer's."""
        registry.register_counters(self, (
            ("decoded_frames", "frames decoded from the jitter buffer"),
            ("lost_frames", "jitter-buffer underruns (pre-PLC)"),
            ("decode_errors", "authenticated but undecodable payloads"),
            ("plc_frames", "underruns concealed by the codec PLC"),
        ), prefix=prefix)
        registry.register_scalar(
            f"{prefix}_jb_lost", lambda: self.jb.lost,
            help_="seqs the jitter buffer declared lost", kind="counter")
        registry.register_scalar(
            f"{prefix}_jb_late_dropped", lambda: self.jb.late_dropped,
            help_="arrivals already released past (too late to play)",
            kind="counter")

    def push(self, datagrams: List[bytes],
             now: Optional[float] = None) -> int:
        """Receive chain + jitter-buffer insert; returns accepted count."""
        if not datagrams:
            return 0
        now = time.time() if now is None else now
        batch, ok = self.stream.receive(datagrams, arrival=now)
        hdr = rtp_header.parse(batch)
        n = 0
        for i in np.nonzero(ok)[0]:
            payload = batch.to_bytes(int(i))[int(hdr.payload_off[i]):]
            self.jb.insert(int(hdr.seq[i]), int(hdr.ts[i]), payload, now)
            n += 1
        return n

    def tick(self, now: Optional[float] = None) -> np.ndarray:
        """Pull + decode one ptime; returns the PCM frame (int16 [F])."""
        now = time.time() if now is None else now
        payload = self.jb.pop(now)
        if payload is None:
            self.lost_frames += 1
            pcm = None
            if self.plc and self.decoded_frames > 0:
                # conceal only mid-stream: before the first decode there
                # is nothing to extrapolate, and silence is right
                try:
                    pcm = np.asarray(self.codec.decode(b""),
                                     dtype=np.int16)
                except (ValueError, RuntimeError, TypeError):
                    pcm = None
            if pcm is None or len(pcm) == 0:
                pcm = np.zeros(self.codec.frame_samples, dtype=np.int16)
            else:
                self.plc_frames += 1
        else:
            try:
                pcm = np.asarray(self.codec.decode(payload),
                                 dtype=np.int16)
                self.decoded_frames += 1
            except (ValueError, RuntimeError):
                # a malformed (but authenticated) payload must not kill
                # the loop driving thousands of pumps: play silence
                self.decode_errors += 1
                pcm = np.zeros(self.codec.frame_samples, dtype=np.int16)
        if len(pcm) < self.codec.frame_samples:   # short decode: pad
            pcm = np.pad(pcm, (0, self.codec.frame_samples - len(pcm)))
        elif len(pcm) > self.codec.frame_samples:
            # a remote-controlled payload length must not crash the
            # loop (the mixer takes one frame shape): clamp to one ptime
            pcm = pcm[: self.codec.frame_samples]
        if self.sink is not None:
            self.sink.write(pcm)
        if self.mixer is not None and self.mixer_sid is not None:
            self.mixer.push(self.mixer_sid, pcm)
        return pcm


class ReceiveBank:
    """The dense many-stream receive plane: one object serves S streams.

    The G.711 rows of one law and frame width decode as ONE kernel launch
    across all ready streams; stateful rows (G.722, Opus, GSM, Speex)
    decode through their per-stream host codecs, a bounded loop over
    ready rows.  With `mixer_rate` set, streams of another rate but the
    same ptime are accepted and resampled to the mixer clock on deposit.
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
        # distributions over the active rows, filled each decode tick
        self.jitter_hist = Histogram(
            (0.001, 0.0025, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25))
        self.decode_delay_hist = Histogram(
            (0.02, 0.04, 0.06, 0.08, 0.12, 0.2, 0.32, 0.5))

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

    def register_metrics(self, registry, prefix: str = "bank") -> None:
        """Expose the bank's per-stream counters (as callables, so a bank
        rebuilt by a restore stays live) and its two histograms."""
        registry.register_array(f"{prefix}_decoded_frames",
                                lambda: self.decoded_frames,
                                by="stream", help_="frames decoded",
                                kind="counter")
        registry.register_array(f"{prefix}_lost_frames",
                                lambda: self.lost_frames,
                                by="stream",
                                help_="underrun ticks (silence fill)",
                                kind="counter")
        registry.register_array(f"{prefix}_decode_errors",
                                lambda: self.decode_errors,
                                by="stream",
                                help_="stateful decoder failures",
                                kind="counter")
        registry.register_array(f"{prefix}_oversize_dropped",
                                lambda: self.oversize_dropped,
                                by="stream",
                                help_="payloads over payload_cap",
                                kind="counter")
        registry.register_array(f"{prefix}_plc_frames",
                                lambda: self.plc_frames,
                                by="stream", help_="concealed frames",
                                kind="counter")
        registry.register_histogram(
            f"{prefix}_jitter_seconds", self.jitter_hist,
            help_="interarrival jitter (RFC 3550), per active stream "
                  "per tick")
        registry.register_histogram(
            f"{prefix}_decode_delay_seconds", self.decode_delay_hist,
            help_="jitter-buffer hold time before decode, per active "
                  "stream per tick")

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
        installed = self._kind >= 0
        lost = installed & ~ready
        self.lost_frames[lost] += 1
        act = installed & (self.jb.next_seq >= 0)
        if act.any():
            # one searchsorted a histogram over every active row
            self.jitter_hist.observe_array(self.jb.jitter_s[act])
            self.decode_delay_hist.observe_array(
                self.jb.depth_used()[act] * self.jb.frame_s[act])
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
