"""The port's CUDA kernel sources, run on the CPU under an emulation of
the CUDA execution model, against their plain PyTorch versions.

There is no `nvcc` or GPU here, so the kernels in `libjitsi_tpu_torch/
csrc/` are compiled with g++ against `tests/cuda_emu/cuda_emu.h` (one
std::thread per CUDA thread, std::barrier for `__syncthreads`) and their
C entry points are called through ctypes on NumPy buffers.  This holds
the kernels' arithmetic, indexing and synchronisation — not the GPU's
compiler or timing, which only the card shows (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Edge rows: offsets past the row, lengths
past the row, stream ids outside the table, counters carrying across
32-bit limbs, unaligned row widths, and for the tiled kernels C and D
partial tiles, windows that start off a word, and tampered rows beside
genuine ones in one tile.  Tolerance: exact equality.
"""

import ctypes
import hashlib
import hmac
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from libjitsi_tpu_torch.conference import mixer
from libjitsi_tpu_torch.kernels import aes, g711, sha1
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.transform.srtp import kernel as srtp_kernel

HERE = os.path.dirname(os.path.abspath(__file__))
T = torch.from_numpy


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources")
    work = tmp_path_factory.mktemp("cuda_emu")
    (work / "cuda_runtime.h").write_text("#pragma once\n")
    srcs = []
    for name in sorted(os.listdir(kbuild.CSRC_DIR)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(kbuild.CSRC_DIR, name)) as f:
            s = f.read()
        s = s.replace("extern __shared__ uint4 smem[];",
                      "uint4* smem = static_cast<uint4*>(emu_dyn_smem);")
        s = re.sub(r"(\w+(?:<\d+>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                   s, flags=re.S)
        out = work / (name + ".cpp")
        out.write_text(s)
        srcs.append(str(out))
    so = work / "libemu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", f"-I{work}", f"-I{kbuild.CSRC_DIR}",
                    "-include", os.path.join(HERE, "cuda_emu", "cuda_emu.h"),
                    "-o", str(so), *srcs], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, args in kbuild._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.mark.parametrize("key_len", [16, 32])
def test_emulated_kernel_a_matches_numpy_aes(emu, key_len):
    rng = np.random.default_rng(key_len)
    n = 300
    rk = aes.expand_keys_batch(rng.integers(0, 256, (n, key_len), np.uint8))
    blocks = rng.integers(0, 256, (n, 16), np.uint8)
    out = np.zeros((n, 16), np.uint8)
    assert emu.ljt_aes_encrypt(_p(rk), _p(blocks), _p(out), n,
                               rk.shape[1] - 1, None) == 0
    assert np.array_equal(out, aes.aes_encrypt_np(rk, blocks))
    assert emu.ljt_aes_encrypt(_p(rk), _p(blocks), _p(out), n, 12,
                               None) != 0          # AES-192 is refused


@pytest.mark.parametrize("width", [200, 37])
def test_emulated_kernel_b_matches_plain_and_stdlib(emu, width):
    rng = np.random.default_rng(width)
    n = 40
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    mid = sha1.hmac_precompute_batch(keys).view(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    lens = rng.integers(-3, width + 5, n).astype(np.int32)
    lens[:3] = [0, min(55, width), width]
    out = np.zeros((n, 20), np.uint8)
    assert emu.ljt_hmac_sha1(_p(mid), _p(data), _p(lens), _p(out), n, width,
                             None) == 0
    assert np.array_equal(out, sha1.hmac_sha1(T(mid), T(data),
                                              T(lens)).numpy())
    for i in range(n):
        k = min(max(int(lens[i]), 0), width)
        assert bytes(out[i]) == hmac.new(bytes(keys[i]), bytes(data[i, :k]),
                                         hashlib.sha1).digest()


def _cd(key_len, tag_len, width, n=45, case="mixed"):
    tail = "" if (n, case) == (45, "mixed") else f"-{n}-{case}"
    return pytest.param(key_len, tag_len, width, n, case,
                        id=f"{key_len}-{tag_len}-{width}{tail}")


# Kernels C and D aim for two tiles a streaming multiprocessor, at most
# 32 rows a tile; the emulator reports one, so a tile has ceil(n / 2)
# rows: n = 200 is six full tiles and one of 8, n = 70 two full and one
# of 6, n = 5 one of 3 and one of 2.
@pytest.mark.parametrize("key_len,tag_len,width,n,case", [
    _cd(16, 10, 224), _cd(32, 4, 96), _cd(16, 10, 50),
    _cd(16, 10, 224, 70), _cd(16, 10, 224, 200), _cd(32, 4, 96, 5),
    _cd(16, 10, 96, 40, "lengths"),      # one tile's lengths span 0..W+3
    _cd(16, 10, 160, 40, "off13"),       # windows not on a 16-byte block
    _cd(16, 10, 160, 40, "off20"),       # nor on a word
    _cd(16, 4, 160, 40, "offpast"),      # offsets at and past the row
    _cd(32, 10, 1536, 33),               # widest class, AES-256
])
def test_emulated_kernels_c_d_match_plain(emu, key_len, tag_len, width, n,
                                          case):
    rng = np.random.default_rng(width + tag_len + n)
    s = 7
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(-1, s + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = rng.integers(0, width + 3, n).astype(np.int32)
    length[:4] = [0, 3, width - tag_len, width][:n]
    off = rng.integers(0, width + 20, n).astype(np.int32)
    off[4:20] = 12
    if case == "lengths":
        length[:32] = np.linspace(0, width + 3, 32).astype(np.int32)
    elif case in ("off13", "off20"):
        off[:] = int(case[3:])
    elif case == "offpast":
        off[::2] = width + np.arange(0, n, 2) % 5 - 1
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[:6, 8:] = 0xFF
    roc = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    nr = tab_rk.shape[1] - 1
    out = np.zeros_like(data)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_protect_cm(
        _p(tab_rk), _p(tab_mid), _p(stream), s, _p(data), _p(length),
        _p(off), _p(iv), _p(roc), _p(out), _p(out_len), n, width, nr,
        tag_len, None) == 0
    want, want_len = srtp_kernel.srtp_protect_plain(
        *(T(x) for x in (tab_rk, tab_mid, stream, data, length, off, iv,
                         roc)), tag_len)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())

    wire = out.copy()
    wire_len = np.minimum(out_len, width).astype(np.int32)
    fits = length + tag_len <= width
    bad = np.nonzero(fits)[0][::7]                 # beside genuine rows
    wire[bad, 0] ^= 1                              # tampered headers
    dec = np.zeros_like(data)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.uint8)
    assert emu.ljt_srtp_unprotect_cm(
        _p(tab_rk), _p(tab_mid), _p(stream), s, _p(wire), _p(wire_len),
        _p(off), _p(iv), _p(roc), _p(dec), _p(mlen), _p(ok), n, width, nr,
        tag_len, None) == 0
    want, want_mlen, want_ok = srtp_kernel.srtp_unprotect_plain(
        *(T(x) for x in (tab_rk, tab_mid, stream, wire, wire_len, off, iv,
                         roc)), tag_len)
    assert np.array_equal(dec, want.numpy())
    assert np.array_equal(mlen, want_mlen.numpy())
    assert np.array_equal(ok.astype(bool), want_ok.numpy())
    genuine = fits.copy()
    genuine[bad] = False
    assert ok.astype(bool)[genuine].all()
    assert not ok.astype(bool)[bad].any()


def test_emulated_latency_probe_chains(emu):
    """The probe's chains compute what they claim: n SHA-1 compressions
    of each lane's state, n AES encryptions of each lane's block."""
    rng = np.random.default_rng(9)
    n = 3
    state = rng.integers(0, 2 ** 32, (32, 21), dtype=np.uint64).astype(
        np.uint32)
    want = state[:, :5].copy()
    for _ in range(n):
        want = sha1._compress_blocks_np(want, state[:, 5:])
    cycles = np.zeros(32, np.int64)
    assert emu.ljt_probe_sha1_chain(_p(state), _p(cycles), n, None) == 0
    assert np.array_equal(state[:, :5], want) and (cycles > 0).all()
    rk = aes.expand_key(bytes(range(16)))
    blocks = rng.integers(0, 256, (32, 16), np.uint8)
    want = blocks.copy()
    for _ in range(n):
        want = aes.aes_encrypt_np(np.broadcast_to(rk, (32,) + rk.shape),
                                  want)
    assert emu.ljt_probe_aes_chain(_p(rk), _p(blocks), _p(cycles), 10, n,
                                   None) == 0
    assert np.array_equal(blocks, want) and (cycles > 0).all()


@pytest.mark.parametrize("shape", [(2, 8, 960), (2, 5, 160), (1, 33, 70)])
def test_emulated_kernel_e_matches_plain(emu, shape):
    rng = np.random.default_rng(sum(shape))
    c, n, f = shape
    pcm = rng.integers(-32768, 32768, shape).astype(np.int16)
    active = (rng.random((c, n)) < 0.7).astype(np.uint8)
    pcm[:, 0] = 0                                   # silent
    pcm[:, 1] = 0
    pcm[:, 1, :3] = [1, -1, 1]                      # near-silent
    pcm[:, 2] = 32767                               # saturating
    pcm[:, 3] = 32767
    active[:, :4] = 1
    active[:, 4] = 0                                # inactive
    out = np.zeros_like(pcm)
    lv = np.zeros((c, n), np.uint8)
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), c, n, f,
                             None) == 0
    want_out, want_lv = mixer.mix_minus_many_plain(T(pcm), T(active))
    assert np.array_equal(out, want_out.numpy())
    assert np.array_equal(lv, want_lv.numpy())
    assert (lv[:, 4] == 127).all() and (lv[:, 0] == 127).all()
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), -1, n, f,
                             None) != 0


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
def test_emulated_kernels_f_g_match_plain(emu, law):
    rng = np.random.default_rng(law)
    pcm = np.concatenate([
        np.array([-32768, -32767, -32635, -8060, -1, 0, 1, 8060, 32635,
                  32767], np.int16),
        rng.integers(-32768, 32768, 1990).astype(np.int16)])
    codes = np.zeros(pcm.shape, np.uint8)
    assert emu.ljt_g711_encode(_p(pcm), _p(codes), len(pcm), law, None) == 0
    assert np.array_equal(codes, g711.encode(T(pcm), law).numpy())
    every = np.tile(np.arange(256, dtype=np.uint8), 3)
    back = np.zeros(every.shape, np.int16)
    assert emu.ljt_g711_decode(_p(every), _p(back), len(every), law,
                               None) == 0
    assert np.array_equal(back, g711.decode(T(every), law).numpy())
    assert emu.ljt_g711_encode(_p(pcm), _p(codes), len(pcm), 2, None) != 0
