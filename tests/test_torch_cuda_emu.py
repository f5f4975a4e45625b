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
`chip_smoke.py`).  For the gather-free AES core (kernel A): every
S-box input at every byte position, FIPS-197's known answers and pairs
of blocks under two keys.  Edge rows: offsets past the row, lengths past
the row, stream ids outside the table, counters carrying across 32-bit
limbs, unaligned row widths, for the tiled kernels C, D, H, I and J
partial tiles, windows that start off a word, SRTCP words and tags cut
at the width, and tampered rows beside genuine ones in one tile; for
kernel B tiles of 1-32 rows, fewer rows where a row is wide and rows
staged in chunks where it outgrows a block; for kernel G every code at
ragged lengths and misaligned views; and for kernel E every kind of
launch its plan makes (clusters of 1, 2, 5, 8 and 16 blocks, blocks of
unequal width, the 2-byte path, rows in stages, and the staged kernel's
64-bit totals past 65,535 rows and columns in stages) with silent,
near-silent, saturating and inactive rows.  Tolerance: exact equality.
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


FIPS197 = {16: ("000102030405060708090a0b0c0d0e0f",
                "69c4e0d86a7b0430d8cdb78070b4c55a"),
           32: ("000102030405060708090a0b0c0d0e0f"
                "101112131415161718191a1b1c1d1e1f",
                "8ea2b7ca516745bfeafc49904b496089")}


def _encrypt(emu, rk, blocks):
    out = np.zeros(blocks.shape, np.uint8)
    assert emu.ljt_aes_encrypt(_p(rk), _p(blocks), _p(out), len(blocks),
                               rk.shape[1] - 1, None) == 0
    return out


@pytest.mark.parametrize("key_len", [16, 32])
def test_emulated_kernel_a_sbox_exhaustive_and_fips197(emu, key_len):
    """Every S-box input at every byte position: block v is 16 bytes of
    v (v = 0..255) under the all-zero key, whose round key 0 is zero, so
    round 1 substitutes v at all 16 positions of both blocks of a pair.
    Then FIPS-197 appendix C's known answer, alone (a lone last block) and
    paired with a block under another key, in either slot."""
    rk = np.ascontiguousarray(np.broadcast_to(
        aes.expand_key(bytes(key_len)), (256, 15 if key_len == 32 else 11,
                                         16)))
    blocks = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 16, axis=1)
    assert np.array_equal(_encrypt(emu, rk, blocks),
                          aes.aes_encrypt_np(rk, blocks))
    key, ct = (bytes.fromhex(h) for h in FIPS197[key_len])
    fips = aes.expand_key(key)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    other = aes.expand_key(bytes(range(100, 100 + key_len)))
    for rks in ([fips], [fips, other], [other, fips], [other, fips, fips]):
        got = _encrypt(emu, np.stack(rks), np.tile(pt, (len(rks), 1)))
        for i, k in enumerate(rks):
            if k is fips:
                assert bytes(got[i]) == ct
            else:
                assert np.array_equal(got[i], aes.aes_encrypt_np(
                    k, pt[None])[0])


@pytest.mark.parametrize("key_len", [16, 32])
def test_emulated_kernel_a_mixed_key_pairs(emu, key_len):
    """Random per-block keys, the two blocks of every pair under
    different keys (the core merges their sliced round keys), an odd
    count so the last block is alone."""
    rng = np.random.default_rng(100 + key_len)
    n = 301
    keys = rng.integers(0, 256, (n, key_len), np.uint8)
    assert all((keys[0:n - 1:2] != keys[1::2]).any(axis=1))
    rk = aes.expand_keys_batch(keys)
    blocks = rng.integers(0, 256, (n, 16), np.uint8)
    blocks[1::2] = blocks[0:n - 1:2]            # same block, other key
    out = _encrypt(emu, rk, blocks)
    assert np.array_equal(out, aes.aes_encrypt_np(rk, blocks))
    assert not (out[0:n - 1:2] == out[1::2]).all(axis=1).any()


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


# Kernel B's tiles: the fewest rows that give each SM four tiles, at most
# 32 (one SM here, so ceil(n / 4) rows): n = 1, 33 (four tiles of 9 and
# a last of 6) and 200 rows of 1,504 bytes (tiles of 32 and a last of
# 8); at 8,192 bytes a tile holds 28 rows; at 240,000 a row outgrows a
# block's 227 KB and is staged in chunks (whole 64-byte blocks); width 0
# hashes empty messages.
@pytest.mark.parametrize("width,n", [(200, 1), (200, 33), (1504, 200),
                                     (8192, 40), (240000, 4), (0, 3)])
def test_emulated_kernel_b_tiles_match_stdlib(emu, width, n):
    rng = np.random.default_rng(width + n)
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    mid = sha1.hmac_precompute_batch(keys).view(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    lens = rng.integers(-3, width + 5, n).astype(np.int32)
    lens[:4] = [0, min(55, width), min(56, width), width][:n]
    _check_kernel_b(emu, keys, mid, data, lens)


def _check_kernel_b(emu, keys, mid, data, lens):
    n, width = data.shape
    out = np.zeros((n, 20), np.uint8)
    assert emu.ljt_hmac_sha1(_p(mid), _p(data), _p(lens), _p(out), n, width,
                             None) == 0
    assert [bytes(o) for o in out] == [
        hmac.new(bytes(keys[i]),
                 bytes(data[i, :min(max(int(lens[i]), 0), width)]),
                 hashlib.sha1).digest() for i in range(n)]
    if width <= 1504:
        assert np.array_equal(out, sha1.hmac_sha1(T(mid), T(data),
                                                  T(lens)).numpy())


def kernel_b_chunk(rows: int) -> int:
    """The bytes of a row kernel B stages at a time where a row outgrows
    a block's 227 KB: whole 64-byte blocks that fit `rows` rows at an odd
    word stride (`plan_b` in csrc/hmac_sha1.cu)."""
    return (232448 // 4 // rows - 1) * 4 // 64 * 64


# Messages that end at and across the chunks of 240,000-byte rows: the
# whole width, a chunk exactly, a chunk plus 1, and a chunk minus 1-9 (the
# 0x80 byte in the chunk's last 64-byte block, the bit length in a block
# of the next chunk).  Four rows are 1-row tiles (232,384-byte chunks, two
# a row); 13 rows are tiles of 4 (58,048-byte chunks, five a row, a
# message ending at every chunk edge in one tile).  An end is the width
# or (k, d): k chunks plus d bytes.
W_CHUNKED = 240000


@pytest.mark.parametrize("n,tile,ends", [
    (4, 1, [W_CHUNKED, (1, 0), (1, 1), (1, -1)]),
    (4, 1, [(1, -2), (1, -3), (1, -4), (1, -5)]),
    (4, 1, [(1, -6), (1, -7), (1, -8), (1, -9)]),
    (13, 4, [W_CHUNKED, (1, 0), (1, 1), (1, -1), (1, -8), (2, -1), (2, 0),
             (2, 1), (3, -4), (3, 1), (4, -1), (4, 0), W_CHUNKED - 1]),
])
def test_emulated_kernel_b_rows_across_chunks(emu, n, tile, ends):
    c = kernel_b_chunk(tile)
    lens = np.array([e if isinstance(e, int) else e[0] * c + e[1]
                     for e in ends], np.int32)
    rng = np.random.default_rng(n + int(lens.sum()))
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    mid = sha1.hmac_precompute_batch(keys).view(np.int32)
    data = rng.integers(0, 256, (n, W_CHUNKED), np.uint8)
    _check_kernel_b(emu, keys, mid, data, lens)


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
    of each lane's state, n AES encryptions of each lane's pair of
    blocks, AES-128 and AES-256, and n chained MACs of a 966-byte
    message on 1 lane and on 32."""
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
    for key_len in (16, 32):
        rk = aes.expand_key(bytes(range(key_len)))
        blocks = rng.integers(0, 256, (64, 16), np.uint8)
        want = blocks.copy()
        for _ in range(n):
            want = aes.aes_encrypt_np(np.broadcast_to(rk, (64,) + rk.shape),
                                      want)
        assert emu.ljt_probe_aes_chain(_p(rk), _p(blocks), _p(cycles),
                                       len(rk) - 1, n, None) == 0
        assert np.array_equal(blocks, want) and (cycles > 0).all()
    # one row's MAC as a hashing lane runs it, `reps` times chained
    # through the 4-byte word, on 1 lane and on a full warp
    keys = rng.integers(0, 256, (32, 20), np.uint8)
    mid = sha1.hmac_precompute_batch(keys).view(np.int32)
    rows = rng.integers(0, 256, (32, 1024), np.uint8)
    for lanes in (1, 32):
        digest = np.zeros(32, np.uint32)
        assert emu.ljt_probe_hmac_row(_p(mid), _p(rows), 962, 1024,
                                      _p(digest), _p(cycles), n, lanes,
                                      None) == 0
        for lane in range(lanes):
            word = 0
            for _ in range(n):
                word = int.from_bytes(hmac.new(
                    bytes(keys[lane]), bytes(rows[lane, :962])
                    + word.to_bytes(4, "big"), hashlib.sha1).digest()[:4],
                    "big")
            assert digest[lane] == word
    assert emu.ljt_probe_empty(None) == 0
    assert emu.ljt_probe_cluster(2, None) == 0
    assert emu.ljt_probe_cluster(17, None) != 0


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
# as (cluster, columns a block stages, rows staged at a time, vec, column
# stages of the widest block, staged kernel, row groups)).  Kernel E
# gives a conference ceil(2 SMs / C) blocks, at most 8 (16 while C * 8 <
# SMs) and at most one a column vector of 8 samples, more while one row
# of a block's columns does not fit, and stages at most 96 KB a block,
# rows in stages beyond; a staged row is an odd number of vectors long.  Past
# 65,535 rows, or where one row of a block's columns does not fit at the
# widest cluster, the staged kernel runs: 64-bit column totals, at most
# 227 KB a block, the block's columns in stages that hold 64 rows (or
# all, if fewer), and the rows of a conference whose columns leave blocks
# of the cluster free in groups over those blocks.
@pytest.mark.parametrize("shape", [
    (2, 8, 960, 1, 0, (1, 968, 8, 1, 1, 0, 1)),
    (2, 5, 160, 1, 0, (1, 168, 5, 1, 1, 0, 1)),
    (1, 33, 70, 1, 0, (2, 40, 33, 0, 1, 0, 1)),        # F = 70: scalar path
    (1, 40, 64, 4, 0, (8, 8, 40, 1, 1, 0, 1)),         # a cluster of 8
    (2, 12, 160, 2, 0, (2, 88, 12, 1, 1, 0, 1)),       # blocks of equal width
    (2, 33, 96, 5, 0, (5, 24, 33, 1, 1, 0, 1)),        # blocks of 2, 3 vectors
    (2, 8, 960, 1, 1, (1, 968, 8, 0, 1, 0, 1)),  # a view at an odd offset
    (5, 1, 1, 1, 0, (1, 8, 1, 0, 1, 0, 1)),            # N = 1, F = 1
    (1, 64, 1600, 1, 0, (2, 808, 56, 1, 1, 0, 1)),     # rows in two stages
    (1, 64, 1601, 1, 1, (2, 808, 56, 0, 1, 0, 1)),     # the same, scalar path
    (1, 20, 128, 16, 0, (16, 8, 20, 1, 1, 0, 1)),      # a cluster of 16
    (1, 1600, 96, 1, 0, (2, 56, 773, 1, 1, 0, 1)),     # 1,600 rows, 3 stages
    (1, 1600, 97, 1, 1, (2, 56, 773, 0, 1, 0, 1)),     # the same, scalar path
    (2, 3, 2400, 1, 0, (1, 2408, 3, 1, 1, 0, 1)),  # more vectors than threads
    (2, 3, 12000, 1, 0, (2, 6008, 3, 1, 1, 0, 1)),     # too wide for one block
    # past the old limits: 65,540 rows in 2 row groups of 6 stages (64-bit
    # totals) ...
    (1, 65540, 8, 1, 0, (2, 8, 6395, 1, 1, 1, 2)),
    # ... a frame wider than 16 blocks stage, its columns in 2 stages ...
    (1, 3, 160008, 16, 0, (16, 5016, 3, 1, 2, 1, 1)),
    # ... and wider than 8 blocks stage with 70 rows: 7 column stages of
    # one row stage each, the 16-byte and the 2-byte path
    (1, 70, 80000, 1, 0, (8, 1432, 70, 1, 7, 1, 1)),
    (1, 70, 80001, 1, 1, (8, 1432, 70, 0, 7, 1, 1)),
    # 65,540 rows as the H100 takes them: 16 row groups of 4,096 or 4,097
    # rows, one stage each; and groups of 38,370 and 38,371 rows (the 2-byte
    # path), whose last stages hold 0 and 1 rows
    (1, 65540, 8, 16, 0, (16, 8, 4097, 1, 1, 1, 16)),
    (1, 76741, 8, 1, 1, (2, 8, 6395, 0, 1, 1, 2)),
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
    plan = np.zeros(8, np.int32)
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), c, n, f, _p(plan)) == 0
    assert (*plan[:4], *plan[5:]) == want_plan
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), c, n, f,
                             None) == 0
    want_out, want_lv = mixer.mix_minus_many_plain(T(frames), T(active))
    assert np.array_equal(out, want_out.numpy())
    assert np.array_equal(lv, want_lv.numpy())
    assert (lv[:, 0] == 127).all() and (n < 5 or (lv[:, 4] == 127).all())
    assert n < 4 or (lv[:, 2:4] == 0).all()
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), -1, n, f,
                             None) != 0
    # where the old limits fell, the plan now takes the staged kernel: a
    # conference of 65,536 rows, and a frame one sample wider than a
    # cluster of 8 can stage one row of
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 1, 65535, 8,
                                  _p(plan)) == 0 and plan[6] == 0
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 1, 65536, 8,
                                  _p(plan)) == 0 and tuple(plan[5:7]) == (1, 1)
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 2, 1, 78528,
                                  _p(plan)) == 0 and plan[0] == 8 \
        and plan[6] == 0
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 2, 1, 78529,
                                  _p(plan)) == 0 and plan[0] == 8 \
        and tuple(plan[5:7]) == (2, 1)


@pytest.mark.parametrize("sms,n,f,groups", [(1, 76741, 8, 2),
                                             (16, 65540, 8, 16),
                                             (16, 70001, 1, 16)])
def test_emulated_kernel_e_row_groups_count_every_row_once(emu, monkeypatch,
                                                          sms, n, f, groups):
    """Quiet frames (samples in [-3, 3]), so that no mix clips: each
    output is the exact column total less the row's own sample, which
    shows a row counted twice or missed by the row groups' totals."""
    monkeypatch.setenv("EMU_SM_COUNT", str(sms))
    rng = np.random.default_rng(n + f)
    pcm = rng.integers(-3, 4, (1, n, f)).astype(np.int16)
    active = (rng.random((1, n)) < 0.7).astype(np.uint8)
    plan = np.zeros(8, np.int32)
    out = np.zeros_like(pcm)
    assert emu.ljt_mix_minus_plan(_p(pcm), _p(out), 1, n, f, _p(plan)) == 0
    assert plan[6] == 1 and plan[7] == groups
    lv = np.zeros((1, n), np.uint8)
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), 1, n, f,
                             None) == 0
    want_out, want_lv = mixer.mix_minus_many_plain(T(pcm), T(active))
    assert (np.abs(want_out.numpy()) < 32767).all()
    assert np.array_equal(out, want_out.numpy())
    assert np.array_equal(lv, want_lv.numpy())


def test_emulated_kernel_e_exact_clip_past_int32(emu, monkeypatch):
    """[1, 131,076, 1], every sample 32,767 but row 0's: each column
    total is 4,294,868,925, past 2**31 - 1.  The staged kernel's 64-bit
    totals give every row the exact clip, 32,767, as the plain version
    and numpy's int64 sum do (the JAX reference, which sums in int32,
    wraps there and gives -32,768)."""
    monkeypatch.setenv("EMU_SM_COUNT", "1")
    n = 131076
    pcm = np.full((1, n, 1), 32767, np.int16)
    pcm[0, 0] = 0
    active = np.ones((1, n), np.uint8)
    out = np.zeros_like(pcm)
    lv = np.zeros((1, n), np.uint8)
    assert emu.ljt_mix_minus(_p(pcm), _p(active), _p(out), _p(lv), 1, n, 1,
                             None) == 0
    x = pcm.astype(np.int64)
    exact = np.clip(x.sum(axis=1, keepdims=True) - x, -32768, 32767)
    assert (exact == 32767).all()
    want_out, want_lv = mixer.mix_minus_many_plain(T(pcm), T(active))
    assert np.array_equal(out, exact) and np.array_equal(out, want_out)
    assert np.array_equal(lv, want_lv.numpy())
    assert lv[0, 0] == 127 and (lv[0, 1:] == 0).all()


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


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
def test_emulated_kernel_g_tails_and_misaligned_views(emu, law):
    """Kernel G on every code at lengths around its 8-code step (1, 7, 8,
    9, 15, 16, 17, 768) and with codes off an 8-byte or out off a 16-byte
    boundary (its one-code path), against the plain version; nothing
    written outside out[:n]."""
    every = np.tile(np.arange(256, dtype=np.uint8), 3)
    for n in (1, 7, 8, 9, 15, 16, 17, 768):
        want = g711.decode(T(every[:n].copy()), law).numpy()
        for c_off, o_off in ((0, 0), (0, 1), (1, 0), (3, 5)):
            cbuf = np.zeros(n + 32, np.uint8)
            obuf = np.full(n + 32, -7, np.int16)
            cbuf[c_off:c_off + n] = every[:n]
            assert emu.ljt_g711_decode(_p(cbuf[c_off:]), _p(obuf[o_off:]),
                                       n, law, None) == 0
            assert np.array_equal(obuf[o_off:o_off + n], want), (n, c_off,
                                                                  o_off)
            assert (obuf[:o_off] == -7).all() and (obuf[o_off + n:] == -7
                                                   ).all()


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
# the word and block edges, an unaligned width and the widest class.
# Kernel H aims for four tiles an SM (one SM here, so ceil(N / 4) rows a
# tile, at most 32): 140 copies are four tiles of 32 and one of 12, each
# boundary inside a packet's copies; at 8,192 bytes (AES-256) a tile
# holds 26 rows, so 112 copies are four tiles of 26 and one of 8.
@pytest.mark.parametrize("key_len,p,width,counts", [
    (16, 1, 64, [1]), (16, 5, 208, [3, 0, 10, 1, 4]),
    (32, 4, 37, [2, 2, 5, 1]), (16, 3, 1536, [4, 1, 2]),
    (16, 14, 208, [10] * 14), (32, 4, 8192, [28] * 4),
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


# H's NULL and F8 instances against their plain versions: P = 1, ragged
# receiver counts (a packet with none), an unaligned width, and tiles of
# 32 and 12 copies (140 copies at one SM) with boundaries inside a
# packet's copies; every leg's k_e XOR m schedule differs from its k_e,
# packets' IVs carry counters near 2^32 in bytes 12-15, and windows start
# before, inside and past the row (`_fanout_inputs`).
@pytest.mark.parametrize("cipher,key_len,p,width,counts", [
    ("null", 16, 1, 64, [1]), ("null", 32, 5, 37, [3, 0, 10, 1, 4]),
    ("null", 16, 14, 208, [10] * 14),
    ("f8", 16, 1, 64, [1]), ("f8", 32, 5, 37, [3, 0, 10, 1, 4]),
    ("f8", 16, 14, 208, [10] * 14),
])
def test_emulated_kernel_h_null_and_f8_match_plain(emu, cipher, key_len, p,
                                                   width, counts):
    rng = np.random.default_rng(p * width + key_len + len(cipher))
    args = _fanout_inputs(rng, key_len, p, width, counts)
    tab_rk, tab_mid, tab_salt, data, length, off, ssrc, index, src, \
        recv = args
    tab_f8 = aes.expand_keys_batch(rng.integers(0, 256, (len(tab_rk),
                                                         key_len), np.uint8))
    assert (tab_f8 != tab_rk).any(axis=2).all()
    iv = rng.integers(0, 256, (p, 16), np.uint8)
    iv[:2, 12:] = 0xFF
    n, nr = len(src), tab_rk.shape[1] - 1
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    tail = (p, _p(src), _p(recv), _p(out), _p(out_len), n, width, nr, 10,
            None)
    if cipher == "f8":
        rc = emu.ljt_srtp_fanout_f8(
            _p(tab_rk), _p(tab_f8), _p(tab_mid), len(tab_rk), _p(data),
            _p(length), _p(off), _p(iv), _p(index), *tail)
    else:
        rc = emu.ljt_srtp_fanout_null(
            _p(tab_rk), _p(tab_mid), None, len(tab_rk), _p(data),
            _p(length), _p(off), None, _p(index), *tail)
    assert rc == 0
    want, want_len = srtp_kernel.srtp_fanout_protect_plain(
        *(T(x) for x in args), 10, cipher,
        T(tab_f8) if cipher == "f8" else None,
        T(iv) if cipher == "f8" else None)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())
    # a copy is its packet protected under its leg's keys: C's or K's
    # plain version on the expanded rows
    leg = np.clip(recv, 0, len(tab_rk) - 1)
    k = np.clip(src, 0, p - 1)
    roc = ((index[k] >> 16) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    c_out, _ = srtp_kernel.srtp_protect_plain(
        T(tab_rk), T(tab_mid), T(leg.astype(np.int32)), T(data[k]),
        T(length[k]), T(off[k]), T(iv[k]), T(roc), 10, cipher,
        T(tab_f8) if cipher == "f8" else None)
    assert np.array_equal(out, c_out.numpy())
    if cipher == "null":
        # the payload stays in clear: only the tag differs from the input
        ln = np.clip(length[k], 0, width)
        cols = np.arange(width)[None, :] < ln[:, None]
        assert np.array_equal(np.where(cols, out, 0),
                              np.where(cols, data[k], 0))


# Kernel J's tiles are sized as H's: 140 rows are four tiles of 32 and one
# of 12 here, and at 4,096 bytes (AES-256) a tile holds 26 rows, so 112
# rows are four of 26 and one of 8 (E = 0 and E = 1 rows alternate, so
# every tile holds both).  Kernel I runs the same tiles.
@pytest.mark.parametrize("key_len,tag_len,width,n", [
    (16, 10, 96, 1), (16, 4, 200, 9), (32, 10, 61, 6), (16, 10, 1536, 5),
    (16, 10, 224, 140), (32, 4, 4096, 112),
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


# Kernel I's tiles are sized as H's (four tiles an SM; one SM here): 70
# rows are three tiles of 18 and a partial one of 16, 33 rows four of 9
# and one of 6 (an unaligned width, AES-256), and 9 rows of 32,768 bytes
# three tiles of 3.  Each tile holds rows whose E || index word and tag
# fit, whose tag is cut at the width, whose word is cut at it, and whose
# length is past it, E = 0 beside E = 1, and stream ids outside the table.
@pytest.mark.parametrize("key_len,tag_len,width,n", [
    (16, 10, 96, 70), (32, 4, 61, 33), (16, 10, 32768, 9),
])
def test_emulated_kernel_i_tile_edges(emu, key_len, tag_len, width, n):
    rng = np.random.default_rng(width + n + tag_len)
    s = 5
    enc_keys = rng.integers(0, 256, (s, key_len), np.uint8)
    auth_keys = rng.integers(0, 256, (s, 20), np.uint8)
    tab_rk = aes.expand_keys_batch(enc_keys)
    tab_mid = sha1.hmac_precompute_batch(auth_keys).view(np.int32)
    stream = rng.integers(0, s, n).astype(np.int32)
    stream[1::4] = np.resize([-3, s, s + 7, -1], len(stream[1::4]))
    data = rng.integers(0, 256, (n, width), np.uint8)
    fit = width - 4 - tag_len
    edges = [fit, fit + 1, width - 4, width - 2, width, width + 3, 0, 7, 8,
             9, fit - 16, fit - 17]
    length = np.resize(np.array(edges, np.int32), n)
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[::3, 12:] = 0xFF                        # counters carry across limbs
    e_bit = (np.arange(n) % 3 != 1).astype(np.uint64)
    word = (rng.integers(0, 2 ** 31, n, dtype=np.uint64)
            | e_bit << np.uint64(31)).astype(np.uint32).view(np.int32)
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
    # each row against the host NumPy AES-CM and the stdlib HMAC: [8, len)
    # encrypted, the word at len and the tag after it, cut at the width
    for i in range(n):
        sid = min(max(int(stream[i]), 0), s - 1)
        ln = min(max(int(length[i]), 0), width)
        row = data[i].copy()
        if ln > 8:
            row[8:ln] ^= aes.ctr_keystream_np(tab_rk[sid], iv[i], ln - 8)
        wb = int(word.view(np.uint32)[i]).to_bytes(4, "big")
        tag = hmac.new(bytes(auth_keys[sid]), bytes(row[:ln]) + wb,
                       hashlib.sha1).digest()[:tag_len]
        tail = np.frombuffer(wb + tag, np.uint8)[:max(width - ln, 0)]
        row[ln:ln + len(tail)] = tail
        assert np.array_equal(out[i], row), i
        assert out_len[i] == length[i] + 4 + tag_len


def _emu_call(emu, name, cipher, tab_rk, tab_f8, *rest):
    """Call the C entry point of a cipher's instance: the F8 ones take the
    k_e XOR m table right after the round keys."""
    keys = [_p(tab_rk)] + ([_p(tab_f8)] if cipher == "f8" else [])
    return getattr(emu, f"ljt_{name}_{cipher}")(*keys, *rest)


# The F8 instances (K, L; I's and J's) and the NULL instances (C's, D's,
# I's, J's) against their plain versions.  At 1 SM, K, L and C, D tile
# ceil(n / 2) rows and I, J ceil(n / 4): 7 rows are tiles of 4 and 3 (a
# thread of the 3-row tile has no second row), 9 SRTCP rows tiles of 3.
# Each tile holds a row of length 0, rows shorter than header + tag, an
# empty keystream window (length = payload offset), a window of exactly
# one keystream block and, in the "off13" case, windows starting off a
# word; every row's k_e XOR m schedule differs from k_e in every round
# key, and a tampered row sits beside genuine ones.
@pytest.mark.parametrize("plane,cipher,key_len,width,n,case", [
    ("srtp", "f8", 16, 224, 7, "mixed"),
    ("srtp", "f8", 32, 160, 9, "off13"),
    ("srtp", "null", 16, 96, 5, "mixed"),
    ("srtcp", "f8", 16, 224, 9, "mixed"),
    ("srtcp", "null", 32, 96, 6, "mixed"),
])
def test_emulated_f8_and_null_instances_match_plain(emu, plane, cipher,
                                                    key_len, width, n, case):
    rng = np.random.default_rng(width + n + key_len)
    s, tag_len = 5, 10
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    tab_f8 = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    assert (tab_f8 != tab_rk).any(axis=2).all()
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(-1, s + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    hdr = 13 if case == "off13" else (12 if plane == "srtp" else 8)
    edges = [0, hdr + tag_len - 1, hdr, hdr + 16, width - tag_len - 4,
             hdr + 1, 60]
    length = np.resize(np.array(edges, np.int32), n)
    off = np.full(n, hdr, np.int32)
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[:2, 12:] = 0xFF                  # j is XORed into bytes 12-15
    f8 = T(tab_f8) if cipher == "f8" else None
    nr = tab_rk.shape[1] - 1
    t_args = [T(tab_rk), T(tab_mid), T(stream), T(data), T(length)]
    out = np.zeros_like(data)
    out_len = np.zeros(n, np.int32)
    if plane == "srtp":
        roc = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
        assert _emu_call(emu, "srtp_protect", cipher, tab_rk, tab_f8,
                         _p(tab_mid), _p(stream), s, _p(data), _p(length),
                         _p(off), _p(iv), _p(roc), _p(out), _p(out_len), n,
                         width, nr, tag_len, None) == 0
        want = srtp_kernel.srtp_protect_plain(
            *t_args, T(off), T(iv), T(roc), tag_len, cipher, f8)
    else:
        e = 0 if cipher == "null" else 1
        word = (rng.integers(0, 2 ** 31, n, dtype=np.uint64)
                | np.uint64(e << 31)).astype(np.uint32).view(np.int32)
        assert _emu_call(emu, "srtcp_protect", cipher, tab_rk, tab_f8,
                         _p(tab_mid), _p(stream), s, _p(data), _p(length),
                         _p(iv), _p(word), _p(out), _p(out_len), n, width,
                         nr, tag_len, None) == 0
        want = srtp_kernel.srtcp_protect_plain(
            *t_args, T(iv), T(word), tag_len, cipher, f8)
    assert np.array_equal(out, want[0].numpy())
    assert np.array_equal(out_len, want[1].numpy())
    if cipher == "f8":
        # the window [hdr, length) is encrypted, nothing before it
        whole = length >= hdr
        assert np.array_equal(out[whole, :hdr], data[whole, :hdr])
        assert not np.array_equal(out[4, hdr:hdr + 8], data[4, hdr:hdr + 8])

    wire = out.copy()
    wlen = np.minimum(out_len, width).astype(np.int32)
    wire[3, 2] ^= 1                                # a tampered row
    dec = np.zeros_like(data)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.uint8)
    u_args = [T(tab_rk), T(tab_mid), T(stream), T(wire), T(wlen)]
    if plane == "srtp":
        assert _emu_call(emu, "srtp_unprotect", cipher, tab_rk, tab_f8,
                         _p(tab_mid), _p(stream), s, _p(wire), _p(wlen),
                         _p(off), _p(iv), _p(roc), _p(dec), _p(mlen),
                         _p(ok), n, width, nr, tag_len, None) == 0
        got = (dec, mlen, ok.astype(bool))
        want = srtp_kernel.srtp_unprotect_plain(
            *u_args, T(off), T(iv), T(roc), tag_len, cipher, f8)
    else:
        e_bit = np.zeros(n, np.int32)
        idx = np.zeros(n, np.int32)
        assert _emu_call(emu, "srtcp_unprotect", cipher, tab_rk, tab_f8,
                         _p(tab_mid), _p(stream), s, _p(wire), _p(wlen),
                         _p(iv), _p(dec), _p(mlen), _p(ok), _p(e_bit),
                         _p(idx), n, width, nr, tag_len, None) == 0
        got = (dec, mlen, ok.astype(bool), e_bit, idx)
        want = srtp_kernel.srtcp_unprotect_plain(
            *u_args, T(iv), tag_len, cipher, f8)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    fits = length + tag_len + (0 if plane == "srtp" else 4) <= width
    genuine = fits.copy()
    genuine[3] = False
    assert got[2][genuine].all() and not got[2][3]
    for i in np.nonzero(genuine)[0]:
        assert np.array_equal(dec[i, :length[i]], data[i, :length[i]])
