"""G.722 wideband audio codec (ITU-T G.722 sub-band ADPCM), batched.

Counterpart: `libjitsi_tpu/codecs/g722.py` (`G722Encoder`, `G722Decoder`),
copied: the port keeps its own copy and imports nothing of the JAX package.
Host NumPy, as there; its bytes equal the JAX package's
(`tests/test_torch_codecs.py`).

Algorithm (from the ITU-T G.722 specification; constants are the
standard's published tables):

- a 24-tap QMF analysis bank splits 16 kHz PCM into two 8 kHz sub-bands;
- the lower band (0-4 kHz) is coded with embedded 6/5/4-bit ADPCM
  (modes 1/2/3 drop LSBs: the decoder picks how many bits to trust);
- the higher band (4-8 kHz) is coded with 2-bit ADPCM;
- each byte is ``(ihigh << 6) | ilow``, one byte per two input samples.

ADPCM is a per-sample recurrence, so the time axis is sequential; the
parallel axis is the stream axis, and the state arrays are ``[B, ...]``:
the sample loop does vector operations over all B streams at once.  The
conference bridge holds one coder a leg (B = 1), as the JAX bridge does,
which costs a Python loop of n samples a frame on the host.
"""

from __future__ import annotations

import numpy as np

# --- ITU-T G.722 quantizer / adaptation tables (spec constants) -----------

_Q6 = np.array([
    0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587,
    650, 714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765,
    1980, 2195, 2557, 2919], dtype=np.int32)          # decision levels (30)
_ILN = np.array([
    0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18,
    17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0], dtype=np.int32)
_ILP = np.array([
    0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46,
    45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0],
    dtype=np.int32)
_WL = np.array([-60, -30, 58, 172, 334, 538, 1198, 3042], dtype=np.int32)
_RL42 = np.array([0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0],
                 dtype=np.int32)
_ILB = np.array([
    2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543,
    2599, 2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228,
    3298, 3371, 3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008],
    dtype=np.int32)
_QM2 = np.array([-7408, -1616, 7408, 1616], dtype=np.int32)
_QM4 = np.array([
    0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
    20456, 12896, 8968, 6288, 4240, 2584, 1200, 0], dtype=np.int32)
_QM5 = np.array([
    -280, -280, -23352, -17560, -14120, -11664, -9752, -8184,
    -6864, -5712, -4696, -3784, -2960, -2208, -1520, -880,
    23352, 17560, 14120, 11664, 9752, 8184, 6864, 5712,
    4696, 3784, 2960, 2208, 1520, 880, 280, -280], dtype=np.int32)
_QM6 = np.array([
    -136, -136, -136, -136, -24808, -21904, -19008, -16704,
    -14984, -13512, -12280, -11192, -10232, -9360, -8576, -7856,
    -7192, -6576, -6000, -5456, -4944, -4464, -4008, -3576,
    -3168, -2776, -2400, -2032, -1688, -1360, -1040, -728,
    24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
    10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456,
    4944, 4464, 4008, 3576, 3168, 2776, 2400, 2032,
    1688, 1360, 1040, 728, 432, 136, -432, -136], dtype=np.int32)
_WH = np.array([0, -214, 798], dtype=np.int32)
_RH2 = np.array([2, 1, 2, 1], dtype=np.int32)
_IHN = np.array([0, 1, 0], dtype=np.int32)
_IHP = np.array([0, 3, 2], dtype=np.int32)
_QMF = np.array([3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53,
                 -11], dtype=np.int64)               # 24-tap half filter


def _sat16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767)


class _BandState:
    """Per-band predictor state for a batch of B channels (int32 [B,...])."""

    def __init__(self, batch: int, det0: int):
        self.s = np.zeros(batch, dtype=np.int32)     # predictor output
        self.sp = np.zeros(batch, dtype=np.int32)    # pole section
        self.sz = np.zeros(batch, dtype=np.int32)    # zero section
        self.r = np.zeros((batch, 3), dtype=np.int32)   # reconstructed
        self.a = np.zeros((batch, 3), dtype=np.int32)   # pole coeffs
        self.ap = np.zeros((batch, 3), dtype=np.int32)
        self.p = np.zeros((batch, 3), dtype=np.int32)   # partial recons
        self.d = np.zeros((batch, 7), dtype=np.int32)   # quantized diffs
        self.b = np.zeros((batch, 7), dtype=np.int32)   # zero coeffs
        self.bp = np.zeros((batch, 7), dtype=np.int32)
        self.nb = np.zeros(batch, dtype=np.int32)    # log scale factor
        self.det = np.full(batch, det0, dtype=np.int32)  # quantizer step


def _block4(st: _BandState, d: np.ndarray) -> None:
    """Predictor adaptation + reconstruction (spec blocks 3/4), batched."""
    st.d[:, 0] = d
    st.r[:, 0] = _sat16(st.s + d)
    st.p[:, 0] = _sat16(st.sz + d)

    # UPPOL2: second pole coefficient
    sg = st.p >> 15                                  # sign bits [B, 3]
    wd1 = _sat16(st.a[:, 1].astype(np.int64) << 2).astype(np.int32)
    wd2 = np.where(sg[:, 0] == sg[:, 1], -wd1, wd1)
    wd2 = np.minimum(wd2, 32767)
    wd3 = (wd2 >> 7) + np.where(sg[:, 0] == sg[:, 2], 128, -128)
    wd3 = wd3 + ((st.a[:, 2].astype(np.int64) * 32512) >> 15).astype(
        np.int32)
    st.ap[:, 2] = np.clip(wd3, -12288, 12288)

    # UPPOL1: first pole coefficient
    wd1 = np.where(sg[:, 0] == sg[:, 1], 192, -192)
    wd2 = ((st.a[:, 1].astype(np.int64) * 32640) >> 15).astype(np.int32)
    ap1 = _sat16(wd1 + wd2)
    wd3 = _sat16(15360 - st.ap[:, 2])
    st.ap[:, 1] = np.clip(ap1, -wd3, wd3)

    # UPZERO: the six zero coefficients
    wd1 = np.where(d == 0, 0, 128)[:, None]          # [B, 1]
    sgd = (st.d >> 15)                               # [B, 7]
    wd2 = np.where(sgd[:, 1:] == sgd[:, :1], wd1, -wd1)
    wd3 = ((st.b[:, 1:].astype(np.int64) * 32640) >> 15).astype(np.int32)
    st.bp[:, 1:] = _sat16(wd2 + wd3)

    # DELAY + coefficient commit
    st.d[:, 1:] = st.d[:, :-1]
    st.b[:, 1:] = st.bp[:, 1:]
    st.r[:, 1:] = st.r[:, :-1]
    st.p[:, 1:] = st.p[:, :-1]
    st.a[:, 1:] = st.ap[:, 1:]

    # FILTEP: pole section output
    wd1 = _sat16(st.r[:, 1].astype(np.int64) * 2)
    wd1 = (st.a[:, 1].astype(np.int64) * wd1) >> 15
    wd2 = _sat16(st.r[:, 2].astype(np.int64) * 2)
    wd2 = (st.a[:, 2].astype(np.int64) * wd2) >> 15
    st.sp = _sat16(wd1 + wd2).astype(np.int32)

    # FILTEZ: zero section output
    dd = _sat16(st.d[:, 1:].astype(np.int64) * 2)
    sz = ((st.b[:, 1:].astype(np.int64) * dd) >> 15).sum(axis=1)
    st.sz = _sat16(sz).astype(np.int32)

    st.s = _sat16(st.sp + st.sz).astype(np.int32)


def _scale(nb: np.ndarray, shift_base: int) -> np.ndarray:
    """Log-to-linear scale factor (spec block SCALEL/SCALEH)."""
    wd1 = _ILB[(nb >> 6) & 31].astype(np.int64)
    wd2 = shift_base - (nb >> 11)
    wd3 = np.where(wd2 < 0, wd1 << np.minimum(-wd2, 16),
                   wd1 >> np.minimum(wd2, 30))
    return (wd3 << 2).astype(np.int32)


class G722Encoder:
    """Batched G.722 encoder: int16 [B, 2n] @16 kHz -> uint8 [B, n]."""

    def __init__(self, batch: int = 1):
        self.batch = batch
        self.low = _BandState(batch, 32)
        self.high = _BandState(batch, 8)
        self._x = np.zeros((batch, 24), dtype=np.int64)  # QMF history

    def encode(self, pcm: np.ndarray) -> np.ndarray:
        pcm = np.atleast_2d(np.asarray(pcm, dtype=np.int64))
        if pcm.shape[0] != self.batch or pcm.shape[1] % 2:
            raise ValueError(f"want [B={self.batch}, even] PCM, "
                             f"got {pcm.shape}")
        n = pcm.shape[1] // 2
        out = np.zeros((self.batch, n), dtype=np.uint8)
        for j in range(n):
            # QMF analysis over the last 24 samples
            self._x[:, :22] = self._x[:, 2:]
            self._x[:, 22] = pcm[:, 2 * j]
            self._x[:, 23] = pcm[:, 2 * j + 1]
            sumodd = (self._x[:, 0::2] * _QMF).sum(axis=1)
            sumeven = (self._x[:, 1::2] * _QMF[::-1]).sum(axis=1)
            xlow = ((sumeven + sumodd) >> 14).astype(np.int32)
            xhigh = ((sumeven - sumodd) >> 14).astype(np.int32)

            # ---- lower band: 6-bit embedded ADPCM
            el = _sat16(xlow - self.low.s).astype(np.int32)
            wd = np.where(el >= 0, el, -(el + 1))
            decision = (_Q6[None, 1:30].astype(np.int64)
                        * self.low.det[:, None]) >> 12
            mil = 1 + (wd[:, None] >= decision).sum(axis=1)
            ilow = np.where(el < 0, _ILN[mil], _ILP[mil]).astype(np.int32)
            # local decode (4-bit core) feeds the predictor
            ril = ilow >> 2
            dlow = ((self.low.det.astype(np.int64) * _QM4[ril]) >> 15) \
                .astype(np.int32)
            il4 = _RL42[ril]
            nb = ((self.low.nb.astype(np.int64) * 127) >> 7).astype(
                np.int32) + _WL[il4]
            self.low.nb = np.clip(nb, 0, 18432)
            self.low.det = _scale(self.low.nb, 8)
            _block4(self.low, dlow)

            # ---- higher band: 2-bit ADPCM
            eh = _sat16(xhigh - self.high.s).astype(np.int32)
            wd = np.where(eh >= 0, eh, -(eh + 1))
            wd1 = (564 * self.high.det.astype(np.int64)) >> 12
            mih = np.where(wd >= wd1, 2, 1)
            ihigh = np.where(eh < 0, _IHN[mih], _IHP[mih]).astype(np.int32)
            dhigh = ((self.high.det.astype(np.int64) * _QM2[ihigh]) >> 15) \
                .astype(np.int32)
            ih2 = _RH2[ihigh]
            nb = ((self.high.nb.astype(np.int64) * 127) >> 7).astype(
                np.int32) + _WH[ih2]
            self.high.nb = np.clip(nb, 0, 22528)
            self.high.det = _scale(self.high.nb, 10)
            _block4(self.high, dhigh)

            out[:, j] = ((ihigh << 6) | ilow).astype(np.uint8)
        return out


class G722Decoder:
    """Batched G.722 decoder: uint8 [B, n] -> int16 [B, 2n] @16 kHz.

    bits_per_sample: 8 (mode 1, 64 kbit/s), 7 (mode 2, 56k) or 6
    (mode 3, 48k) — the embedded property: lower-band LSBs are dropped.
    """

    def __init__(self, batch: int = 1, bits_per_sample: int = 8):
        if bits_per_sample not in (6, 7, 8):
            raise ValueError("bits_per_sample must be 6, 7 or 8")
        self.batch = batch
        self.bits = bits_per_sample
        self.low = _BandState(batch, 32)
        self.high = _BandState(batch, 8)
        self._x = np.zeros((batch, 24), dtype=np.int64)  # QMF history

    def decode(self, code: np.ndarray) -> np.ndarray:
        code = np.atleast_2d(np.asarray(code, dtype=np.int32))
        if code.shape[0] != self.batch:
            raise ValueError(f"want [B={self.batch}, n] codes, "
                             f"got {code.shape}")
        n = code.shape[1]
        out = np.zeros((self.batch, 2 * n), dtype=np.int16)
        for j in range(n):
            byte = code[:, j]
            ilow = byte & 0x3F
            ihigh = (byte >> 6) & 0x03

            # ---- lower band reconstruction at the mode's precision
            det = self.low.det.astype(np.int64)
            if self.bits == 8:
                wd2 = _QM6[ilow]
            elif self.bits == 7:
                wd2 = _QM5[ilow >> 1]
            else:
                wd2 = _QM4[ilow >> 2]
            dlowt = ((det * wd2) >> 15).astype(np.int32)
            rlow = np.clip(self.low.s + dlowt, -16384, 16383)
            # adaptation always runs on the 4-bit core (embedded coding)
            ril = ilow >> 2
            dlow = ((det * _QM4[ril]) >> 15).astype(np.int32)
            il4 = _RL42[ril]
            nb = ((self.low.nb.astype(np.int64) * 127) >> 7).astype(
                np.int32) + _WL[il4]
            self.low.nb = np.clip(nb, 0, 18432)
            self.low.det = _scale(self.low.nb, 8)
            _block4(self.low, dlow)

            # ---- higher band
            dhigh = ((self.high.det.astype(np.int64) * _QM2[ihigh]) >> 15) \
                .astype(np.int32)
            rhigh = np.clip(self.high.s + dhigh, -16384, 16383)
            ih2 = _RH2[ihigh]
            nb = ((self.high.nb.astype(np.int64) * 127) >> 7).astype(
                np.int32) + _WH[ih2]
            self.high.nb = np.clip(nb, 0, 22528)
            self.high.det = _scale(self.high.nb, 10)
            _block4(self.high, dhigh)

            # ---- QMF synthesis: two output samples
            self._x[:, :22] = self._x[:, 2:]
            self._x[:, 22] = rlow + rhigh
            self._x[:, 23] = rlow - rhigh
            xout2 = (self._x[:, 0::2] * _QMF).sum(axis=1)
            xout1 = (self._x[:, 1::2] * _QMF[::-1]).sum(axis=1)
            out[:, 2 * j] = _sat16(xout1 >> 11)
            out[:, 2 * j + 1] = _sat16(xout2 >> 11)
        return out


def encode(pcm: np.ndarray) -> bytes:
    """One-shot single-channel helper: int16 PCM @16 kHz -> G.722 bytes."""
    return G722Encoder(1).encode(np.asarray(pcm).reshape(1, -1))[0].tobytes()


def decode(data: bytes, bits_per_sample: int = 8) -> np.ndarray:
    """One-shot single-channel helper: G.722 bytes -> int16 PCM @16 kHz."""
    code = np.frombuffer(data, dtype=np.uint8).reshape(1, -1)
    return G722Decoder(1, bits_per_sample).decode(code)[0]
