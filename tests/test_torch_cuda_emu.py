"""The port's CUDA kernel sources, run on the CPU under an emulation of
the CUDA execution model, against their plain PyTorch versions.

There is no `nvcc` or GPU here, so the kernels in `libjitsi_tpu_torch/
csrc/` are compiled with g++ against `tests/cuda_emu/cuda_emu.h` (one
std::thread per CUDA thread, std::barrier for `__syncthreads`, a
cluster's blocks run together with distributed shared memory, split
cluster barriers and mbarrier-counted pushes) and their C entry points
are called through ctypes on NumPy buffers.  This holds the kernels'
arithmetic, indexing and synchronisation — not the GPU's compiler or
timing, which only the card shows (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Edge rows: offsets past the row, lengths past the
row, stream ids outside the table, counters carrying across 32-bit
limbs, unaligned row widths, for the tiled kernels C and D partial
tiles, windows that start off a word, and tampered rows beside genuine
ones in one tile, and for kernel E every kind of launch its plan makes
(clusters of 1, 2, 5, 8 and 16 blocks, blocks of unequal width, the
2-byte path, rows in stages) with silent, near-silent, saturating and
inactive rows.  Tolerance: exact equality.
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

from libjitsi_tpu.conference import mixer as jmixer
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
    # the CUDA headers, and csrc/dsmem.cuh's PTX, which cuda_emu.h stands
    # in for (a quoted include finds the sources' directory first)
    for stub in ("cuda_runtime.h", "cooperative_groups.h",
                 "cuda_pipeline_primitives.h", "dsmem.cuh"):
        (work / stub).write_text("#pragma once\n")
    srcs = []
    for name in sorted(os.listdir(kbuild.CSRC_DIR)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(kbuild.CSRC_DIR, name)) as f:
            s = f.read()
        s = s.replace("extern __shared__ uint4 smem[];",
                      "uint4* smem = static_cast<uint4*>(emu_dyn_smem);")
        s = re.sub(r"(\w+(?:<\d+>)?)<<<(.*?)>>>\((\))?",
                   lambda m: f"emu_launch({m[1]}, {m[2]}"
                   + (")" if m[3] else ", "), s, flags=re.S)
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
    assert emu.ljt_probe_empty(None) == 0
    assert emu.ljt_probe_cluster(2, None) == 0
    assert emu.ljt_probe_cluster(17, None) != 0


REFUSED = mixer.MIX_REFUSED


def _edge_rows(rng, c, n, f):
    """Random frames and a 70% active mask, then in every conference:
    row 0 silent, row 1 near-silent (±1 in three samples), rows 2-3
    saturating (all active) and row 4 inactive, as far as its rows go."""
    pcm = rng.integers(-32768, 32768, (c, n, f)).astype(np.int16)
    active = (rng.random((c, n)) < 0.7).astype(np.uint8)
    for row, value in enumerate((0, 0, 32767, 32767)[:n]):
        pcm[:, row] = value
        active[:, row] = 1
    if n > 1:
        pcm[:, 1, :3] = [1, -1, 1][:f]              # near-silent
    if n > 4:
        active[:, 4] = 0                            # inactive
    return pcm, active


# (C, N, F, SMs the emulator reports, pcm offset in samples, expected plan
# as (cluster, columns a block stages, rows staged at a time, vec)).
# Kernel E gives a conference ceil(2 SMs / C) blocks, at most 8 (16 while
# C * 8 < SMs) and at most one a column vector of 8 samples, more while
# one row of a block's columns does not fit, and stages at most 96 KB a
# block, rows in stages beyond; a staged row is an odd number of vectors
# long.
@pytest.mark.parametrize("shape", [
    (2, 8, 960, 1, 0, (1, 968, 8, 1)),
    (2, 5, 160, 1, 0, (1, 168, 5, 1)),
    (1, 33, 70, 1, 0, (2, 40, 33, 0)),        # F = 70: scalar path
    (1, 40, 64, 4, 0, (8, 8, 40, 1)),         # a cluster of 8
    (2, 12, 160, 2, 0, (2, 88, 12, 1)),       # blocks of equal width
    (2, 33, 96, 5, 0, (5, 24, 33, 1)),        # blocks of 2 and 3 vectors
    (2, 8, 960, 1, 1, (1, 968, 8, 0)),        # a view at an odd offset
    (5, 1, 1, 1, 0, (1, 8, 1, 0)),            # N = 1, F = 1
    (1, 64, 1600, 1, 0, (2, 808, 56, 1)),     # rows in two stages
    (1, 64, 1601, 1, 1, (2, 808, 56, 0)),     # the same, scalar path
    (1, 20, 128, 16, 0, (16, 8, 20, 1)),      # a cluster of 16
    (1, 1600, 96, 1, 0, (2, 56, 773, 1)),     # 1,600 rows in three stages
    (1, 1600, 97, 1, 1, (2, 56, 773, 0)),     # the same, scalar path
    (2, 3, 2400, 1, 0, (1, 2408, 3, 1)),      # more vectors than threads
    (2, 3, 12000, 1, 0, (2, 6008, 3, 1)),     # too wide for one block
])
def test_emulated_kernel_e_matches_plain(emu, monkeypatch, shape):
    c, n, f, sms, offset, want_plan = shape
    monkeypatch.setenv("EMU_SM_COUNT", str(sms))
    rng = np.random.default_rng(sum(shape[:3]))
    frames, active = _edge_rows(rng, c, n, f)
    buf = np.zeros(c * n * f + 8, np.int16)
    pcm = buf[offset:offset + c * n * f].reshape(c, n, f)
    pcm[:] = frames
    out = np.zeros_like(frames)
    lv = np.zeros((c, n), np.uint8)
    plan = np.zeros(5, np.int32)
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), c, n, f, _p(plan)) == 0
    assert tuple(plan[:4]) == want_plan
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), c, n, f,
                             None) == 0
    want_out, want_lv = mixer.mix_minus_many_plain(T(frames), T(active))
    assert np.array_equal(out, want_out.numpy())
    assert np.array_equal(lv, want_lv.numpy())
    assert (lv[:, 0] == 127).all() and (n < 5 or (lv[:, 4] == 127).all())
    assert n < 4 or (lv[:, 2:4] == 0).all()
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), -1, n, f,
                             None) not in (0, REFUSED)
    # refused (its own code, nothing launched): a conference over 65,535
    # rows (its int32 column sums), a frame wider than 8 blocks stage
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 1, 65536, 8,
                                  _p(plan)) == REFUSED
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 2, 1, 78528,
                                  _p(plan)) == 0 and plan[0] == 8
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 2, 1, 78529,
                                  _p(plan)) == REFUSED


def test_emulated_kernel_e_matches_jax_reference(emu, monkeypatch):
    """One multi-block cluster case held against the JAX package's XLA
    mixer itself, not only against the port's plain version."""
    monkeypatch.setenv("EMU_SM_COUNT", "4")
    c, n, f = 1, 40, 64
    frames, active = _edge_rows(np.random.default_rng(7), c, n, f)
    out = np.zeros_like(frames)
    lv = np.zeros((c, n), np.uint8)
    assert emu.ljt_mix_minus(_p(frames), _p(active), _p(out), _p(lv), c, n,
                             f, None) == 0
    j_out, j_lv = jmixer.mix_minus_many(frames, active.astype(bool))
    assert np.array_equal(out, np.asarray(j_out))
    assert np.array_equal(lv, np.asarray(j_lv))


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
def test_emulated_kernels_f_g_match_plain(emu, law):
    rng = np.random.default_rng(law)
    pcm = np.concatenate([
        np.array([-32768, -32767, -32635, -8060, -1, 0, 1, 8060, 32635,
                  32767], np.int16),
        rng.integers(-32768, 32768, 1990).astype(np.int16)])
    want = g711.encode(T(pcm), law).numpy()
    codes = np.zeros(pcm.shape, np.uint8)
    assert emu.ljt_g711_encode(_p(pcm), _p(codes), len(pcm), law, None) == 0
    assert np.array_equal(codes, want)
    # a ragged length (tail of 3 after the 8-sample steps), then pcm and
    # codes at odd offsets (the one-sample path)
    buf = np.zeros(len(pcm) + 8, np.int16)
    cbuf = np.zeros(len(pcm) + 8, np.uint8)
    for off, n in ((0, 1995), (1, len(pcm)), (3, 1003)):
        cbuf[:] = 0
        buf[off:off + n] = pcm[:n]
        assert emu.ljt_g711_encode(_p(buf[off:]), _p(cbuf[off:]), n, law,
                                   None) == 0
        assert np.array_equal(cbuf[off:off + n], want[:n])
        assert not cbuf[off + n:].any() and not cbuf[:off].any()
    every = np.tile(np.arange(256, dtype=np.uint8), 3)
    back = np.zeros(every.shape, np.int16)
    assert emu.ljt_g711_decode(_p(every), _p(back), len(every), law,
                               None) == 0
    assert np.array_equal(back, g711.decode(T(every), law).numpy())
    assert emu.ljt_g711_encode(_p(pcm), _p(codes), len(pcm), 2, None) != 0


def _fanout_inputs(rng, key_len, p, width, counts):
    """P packets (offsets before, inside and past the row, lengths at and
    past the width), a leg table of 6 with random salts, and `counts`
    receivers for each packet (ragged; stream ids outside the table)."""
    s = 6
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    tab_salt = rng.integers(0, 256, (s, 16), np.uint8)
    tab_salt[:, 14:] = 0
    data = rng.integers(0, 256, (p, width), np.uint8)
    length = rng.integers(12, width + 3, p).astype(np.int32)
    length[:2] = [width - 10, width][:p]
    off = np.full(p, 12, np.int32)
    off[1::3] = 20
    off[2::5] = width + 3                     # forged past the row
    ssrc = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    index[:3] = [0xFFFF, 0x10000, (1 << 48) - 1][:p]
    src = np.repeat(np.arange(p), counts).astype(np.int32)
    recv = rng.integers(-1, s + 1, len(src)).astype(np.int32)
    return tab_rk, tab_mid, tab_salt, data, length, off, ssrc, index, \
        src, recv


# P = 1 and N = 1; ragged receiver counts (a packet with none); widths at
# the word and block edges, an unaligned width and the widest class
@pytest.mark.parametrize("key_len,p,width,counts", [
    (16, 1, 64, [1]), (16, 5, 208, [3, 0, 10, 1, 4]),
    (32, 4, 37, [2, 2, 5, 1]), (16, 3, 1536, [4, 1, 2]),
])
def test_emulated_kernel_h_matches_plain(emu, key_len, p, width, counts):
    rng = np.random.default_rng(p * width + key_len)
    args = _fanout_inputs(rng, key_len, p, width, counts)
    tab_rk, tab_mid, tab_salt, data, length, off, ssrc, index, src, \
        recv = args
    n = len(src)
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_fanout_cm(
        _p(tab_rk), _p(tab_mid), _p(tab_salt), len(tab_rk), _p(data),
        _p(length), _p(off), _p(ssrc), _p(index), p, _p(src), _p(recv),
        _p(out), _p(out_len), n, width, tab_rk.shape[1] - 1, 10, None) == 0
    want, want_len = srtp_kernel.srtp_fanout_protect_plain(
        *(T(x) for x in args), 10)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())
    # a copy is the packet protected under its leg's keys: kernel C's
    # plain version on the expanded rows, with the IV built by hand
    leg = np.clip(recv, 0, len(tab_rk) - 1)
    iv = tab_salt[leg].copy()
    for k in range(4):
        iv[:, 4 + k] ^= (ssrc.view(np.uint32)[src] >> (8 * (3 - k))) & 0xFF
    for k in range(6):
        iv[:, 8 + k] ^= ((index[src] >> (8 * (5 - k))) & 0xFF).astype(
            np.uint8)
    roc = ((index[src] >> 16) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    c_out, _ = srtp_kernel.srtp_protect_plain(
        T(tab_rk), T(tab_mid), T(leg.astype(np.int32)), T(data[src]),
        T(length[src]), T(off[src]), T(iv), T(roc), 10)
    assert np.array_equal(out, c_out.numpy())


@pytest.mark.parametrize("key_len,tag_len,width,n", [
    (16, 10, 96, 1), (16, 4, 200, 9), (32, 10, 61, 6), (16, 10, 1536, 5),
])
def test_emulated_kernels_i_j_match_plain(emu, key_len, tag_len, width, n):
    rng = np.random.default_rng(width + n)
    s = 5
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(-1, s + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = rng.integers(0, width + 3, n).astype(np.int32)
    length[:3] = [width - 4 - tag_len, 8, 3][:n]
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[:2, 12:] = 0xFF
    word = (rng.integers(0, 2 ** 31, n, dtype=np.uint64)
            | (np.arange(n, dtype=np.uint64) % 2 == 0).astype(np.uint64)
            << np.uint64(31)).astype(np.uint32).view(np.int32)   # E = 1, 0
    nr = tab_rk.shape[1] - 1
    out = np.zeros_like(data)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtcp_protect_cm(
        _p(tab_rk), _p(tab_mid), _p(stream), s, _p(data), _p(length),
        _p(iv), _p(word), _p(out), _p(out_len), n, width, nr, tag_len,
        None) == 0
    want, want_len = srtp_kernel.srtcp_protect_plain(
        *(T(x) for x in (tab_rk, tab_mid, stream, data, length, iv, word)),
        tag_len)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())

    wire = out.copy()
    wlen = np.minimum(out_len, width).astype(np.int32)
    fits = length + 4 + tag_len <= width
    if n > 1:
        wlen[-1] = rng.integers(0, 4 + tag_len)    # mlen below 0
        fits[-1] = False
    forged = np.nonzero(fits)[0][1::3]
    wire[forged, wlen[forged] - 1] ^= 0x10          # forged tags
    dec = np.zeros_like(data)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.uint8)
    e_bit = np.zeros(n, np.int32)
    idx = np.zeros(n, np.int32)
    assert emu.ljt_srtcp_unprotect_cm(
        _p(tab_rk), _p(tab_mid), _p(stream), s, _p(wire), _p(wlen), _p(iv),
        _p(dec), _p(mlen), _p(ok), _p(e_bit), _p(idx), n, width, nr,
        tag_len, None) == 0
    got = srtp_kernel.srtcp_unprotect_plain(
        *(T(x) for x in (tab_rk, tab_mid, stream, wire, wlen, iv)), tag_len)
    for a, b in zip((dec, mlen, ok.astype(bool), e_bit, idx), got):
        assert np.array_equal(a, b.numpy())
    genuine = fits.copy()
    genuine[forged] = False
    assert ok.astype(bool)[genuine].all() and not ok[forged].any()
    # E = 0 rows pass through undecrypted; E = 1 rows decrypt to the input
    e0 = genuine & (word.view(np.uint32) >> 31 == 0)
    e1 = genuine & ~e0
    for i in np.nonzero(e0)[0]:
        assert np.array_equal(dec[i], wire[i])
    for i in np.nonzero(e1)[0]:
        assert np.array_equal(dec[i, :length[i]], data[i, :length[i]])
    assert e1.any() and (n < 4 or e0.any())
