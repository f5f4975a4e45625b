"""G.711 µ-law / A-law for the PyTorch port.

Counterpart: `libjitsi_tpu/kernels/g711.py`.

- Plain PyTorch versions: `ulaw_encode_plain`, `alaw_encode_plain`,
  `ulaw_decode_plain` and `alaw_decode_plain`.  Decode is a lookup in a
  256-entry table generated from the G.711 spec (the JAX package's
  generators, copied); encode is the magnitude/segment arithmetic.
- `ulaw_encode` / `alaw_encode`: the wrappers of kernel F and
  `ulaw_decode` / `alaw_decode` of kernel G (`csrc/g711.cu`).  On a CUDA
  tensor they launch the kernel; on a CPU tensor they run the plain
  version.

Encode takes the segment exponent as the integer bit length of the
biased magnitude, which is the spec.  The JAX package takes it as
`floor(log2(float32(mag)))`; XLA evaluates `log2(8192)` just below 13,
so JAX encodes µ-law ±8060 as 47/175 (decoding to ∓4092) where the spec
and this port give 31/159 (∓8316).  Every other int16 input, and all of
A-law, agree.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libjitsi_tpu_torch.kernels import build as _k

ULAW, ALAW = 0, 1


def _ulaw_decode_table() -> np.ndarray:
    out = np.zeros(256, dtype=np.int16)
    for u in range(256):
        v = ~u & 0xFF
        sign = v & 0x80
        exp = (v >> 4) & 0x07
        mant = v & 0x0F
        x = ((mant << 3) + 0x84) << exp
        x -= 0x84
        out[u] = -x if sign else x
    return out


def _alaw_decode_table() -> np.ndarray:
    out = np.zeros(256, dtype=np.int16)
    for a in range(256):
        v = a ^ 0x55
        sign = v & 0x80
        exp = (v >> 4) & 0x07
        mant = v & 0x0F
        if exp == 0:
            x = (mant << 4) + 8
        else:
            x = ((mant << 4) + 0x108) << (exp - 1)
        # A-law sign bit (after the 0x55 toggle) set == positive
        out[a] = x if sign else -x
    return out


_TABLES = {ULAW: _ulaw_decode_table(), ALAW: _alaw_decode_table()}


@functools.lru_cache(maxsize=None)
def decode_table(law: int, device: torch.device) -> torch.Tensor:
    """The law's 256-entry decode table, int16, on `device`."""
    return torch.as_tensor(_TABLES[law], device=device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device)
# ---------------------------------------------------------------------------

def _bit_length(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Bit length of x, for x in [2**(lo-1), 2**hi): a sum of
    comparisons, exact on any device."""
    n = torch.full_like(x, lo)
    for k in range(lo, hi):
        n += (x >= (1 << k)).to(x.dtype)
    return n


def _encode_plain(pcm: torch.Tensor, law: int) -> torch.Tensor:
    _k.plain_calls["g711_encode"] += 1
    x = pcm.to(torch.int32)
    if law == ULAW:
        sign = (x < 0).to(torch.int32) << 7
        mag = x.abs().clamp(max=32635) + 0x84                 # >= 132
        exp = (_bit_length(mag, 8, 15) - 8).clamp(0, 7)
        mant = (mag >> (exp + 3)) & 0x0F
        return (~(sign | (exp << 4) | mant) & 0xFF).to(torch.uint8)
    sign = (x >= 0).to(torch.int32) << 7
    mag = x.abs().clamp(max=32767) >> 3                       # 13 bits
    exp = (_bit_length(mag.clamp(min=1), 1, 13) - 5).clamp(0, 7)
    mant = torch.where(exp == 0, mag >> 1, mag >> exp) & 0x0F
    return ((sign | (exp << 4) | mant) ^ 0x55).to(torch.uint8)


def _decode_plain(codes: torch.Tensor, law: int) -> torch.Tensor:
    _k.plain_calls["g711_decode"] += 1
    return decode_table(law, codes.device)[codes.long()]


def ulaw_encode_plain(pcm: torch.Tensor) -> torch.Tensor:
    """int16 [...] -> uint8 [...] (G.711 µ-law, bias 0x84)."""
    return _encode_plain(pcm, ULAW)


def alaw_encode_plain(pcm: torch.Tensor) -> torch.Tensor:
    """int16 [...] -> uint8 [...] (G.711 A-law, 0x55 toggle)."""
    return _encode_plain(pcm, ALAW)


def ulaw_decode_plain(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [...] -> int16 [...]."""
    return _decode_plain(codes, ULAW)


def alaw_decode_plain(codes: torch.Tensor) -> torch.Tensor:
    return _decode_plain(codes, ALAW)


# ---------------------------------------------------------------------------
# Kernel F and G wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, fn: str, x: torch.Tensor, dtype: torch.dtype,
            out_dtype: torch.dtype, law: int) -> torch.Tensor:
    dev = x.device
    _k.expect(x, "input", dtype, dev)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if x.numel():
        rc = getattr(_k.library(), fn)(x.data_ptr(), out.data_ptr(),
                                       x.numel(), law, _k.stream_handle(dev))
        _k.check(rc, name)
        _k.launches[name] += 1
    return out


def encode(pcm: torch.Tensor, law: int) -> torch.Tensor:
    """int16 [...] -> uint8 [...]: kernel F on a CUDA tensor, the plain
    version on a CPU one."""
    if _k.route(pcm) == "cpu":
        return _encode_plain(pcm, law)
    return _launch("g711_encode", "ljt_g711_encode", pcm, torch.int16,
                   torch.uint8, law)


def decode(codes: torch.Tensor, law: int) -> torch.Tensor:
    """uint8 [...] -> int16 [...]: kernel G on a CUDA tensor, the plain
    version on a CPU one."""
    if _k.route(codes) == "cpu":
        return _decode_plain(codes, law)
    return _launch("g711_decode", "ljt_g711_decode", codes, torch.uint8,
                   torch.int16, law)


def ulaw_encode(pcm: torch.Tensor) -> torch.Tensor:
    return encode(pcm, ULAW)


def alaw_encode(pcm: torch.Tensor) -> torch.Tensor:
    return encode(pcm, ALAW)


def ulaw_decode(codes: torch.Tensor) -> torch.Tensor:
    return decode(codes, ULAW)


def alaw_decode(codes: torch.Tensor) -> torch.Tensor:
    return decode(codes, ALAW)
