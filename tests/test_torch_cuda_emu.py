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
near-silent, saturating and inactive rows; for kernel R the conference's
ratios, rows read in overlapping chunks, rows shorter than its filter and
rows at the rails.  Tolerance: exact equality.
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
from libjitsi_tpu_torch.kernels import aes, g711, resample, sha1
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.kernels import gcm as tgcm
from libjitsi_tpu_torch.transform.srtp import kernel as srtp_kernel
from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

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
    blocks, AES-128 and AES-256, n chained MACs of a 966-byte message on
    1 lane and on 32, and n GHASH Horner steps."""
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
    # n Horner steps of one GHASH block, read from shared memory a step
    from libjitsi_tpu_torch.kernels import ghash

    h, x = (rng.integers(0, 256, 16, np.uint8) for _ in range(2))
    gm = _aligned(ghash.ghash_matrix_packed(h[None])[0].view(np.int32))
    blk = _aligned(x.view(">u4").astype(np.uint32).view(np.int32))
    y = _aligned(np.zeros(4, np.int32))
    reps = 11
    assert emu.ljt_probe_ghash_chain(_p(gm), _p(blk), _p(y), _p(cycles),
                                     reps, None) == 0
    assert (y.view(np.uint32).astype(">u4").tobytes()
            == ghash.ghash_ref(bytes(h), bytes(x) * reps))
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


def _emu_resample(emu, x, l, m, span=resample.SPAN, taps=16):
    """Kernel R's C entry on [B, T] int16 at L/M, staging `span` samples a
    work item; out is pre-filled so an unwritten sample shows."""
    b, t = x.shape
    bank = resample.design(l, m, taps)
    out = np.full((b, t * l // m), -7, np.int16)
    rc = emu.ljt_resample(_p(x), _p(bank), _p(out), b, t, out.shape[1], l, m,
                          taps, resample.chunk_outputs(l, m, taps, span),
                          span, None)
    assert rc == 0
    return out


def _r_rows(rng, b, t):
    """Full-scale noise, with a clipped row (alternating at the rails), a
    row at +32767 and one at -32768 where there are enough rows."""
    x = rng.integers(-32768, 32768, (b, t)).astype(np.int16)
    rails = [np.where(np.arange(t) % 2, 32767, -32768), np.full(t, 32767),
             np.full(t, -32768)]
    for i, row in enumerate(rails[:max(b - 1, 0)]):
        x[1 + i] = row
    return x


@pytest.mark.parametrize("rows", [1, 3, 70])
@pytest.mark.parametrize("rates", [(8000, 16000), (16000, 8000),
                                   (8000, 48000), (48000, 8000),
                                   (44100, 48000)])
def test_emulated_kernel_r_matches_plain(emu, rates, rows):
    """Kernel R against its plain version at the conference's ratios and
    the widest bank's (44.1k -> 48k, L = 160): 20 ms rows of noise and at
    the rails, whose clamped edges read the row's first and last samples."""
    rng = np.random.default_rng(rows + rates[0] // 100)
    x = _r_rows(rng, rows, rates[0] // 50)
    l, m = resample.ratio(*rates)
    want = resample.resample_plain(T(x), l, m).numpy()
    assert np.array_equal(_emu_resample(emu, x, l, m), want)


@pytest.mark.parametrize("rates,t,span", [
    ((48000, 8000), 10000, resample.SPAN),   # rows past one staged span
    ((8000, 16000), 500, 40),                # 12-output chunks
    ((44100, 48000), 882, 64),               # 44 chunks a row, L = 160
    ((8000, 48000), 7, resample.SPAN),       # rows shorter than the taps
    ((16000, 8000), 1, resample.SPAN),       # one sample: every tap clamps
])
def test_emulated_kernel_r_stages_rows_in_chunks(emu, rates, t, span):
    """Rows read in chunks whose spans overlap, rows shorter than the
    filter, and the refusal of a chunk whose span would not fit."""
    rng = np.random.default_rng(t)
    x = _r_rows(rng, 4, t)
    l, m = resample.ratio(*rates)
    want = resample.resample_plain(T(x), l, m).numpy()
    assert np.array_equal(_emu_resample(emu, x, l, m, span), want)
    out = np.zeros(want.shape, np.int16)
    big = -(-(span - 16) * l // m) + 1     # its span: one past `span`
    assert emu.ljt_resample(_p(x), _p(resample.design(l, m)), _p(out), 4, t,
                            out.shape[1], l, m, 16, big, span, None) == 1
    assert not out.any()


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


# K's and L's own tile (at 1 SM one tile of all n rows, at most 128; 128
# threads up to 64 rows, else 256): chain thread i walks rows i and i +
# half, the hash runs on warps 2-3 (and 6-7) behind the chains (K) or
# beside them (L).  An odd row count (the last chain thread has one row),
# a pair whose rows differ by 50+ keystream blocks (the short row's hash
# waits on its own count only), AES-256, windows starting off a word, a
# full 128-row tile and a 2-row one; every case unprotects a tampered row
# beside genuine ones.
@pytest.mark.parametrize("case,key_len,n,width,hdr", [
    ("odd", 16, 9, 224, 12),
    ("long_short", 16, 4, 1024, 12),
    ("aes256", 32, 7, 160, 12),
    ("off13", 16, 6, 160, 13),
    ("full_tile", 16, 130, 96, 12),
])
def test_emulated_kernels_k_l_tiles(emu, case, key_len, n, width, hdr):
    rng = np.random.default_rng(n + width + hdr)
    s, tag_len = 5, 10
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, key_len), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(-1, s + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = rng.integers(hdr, width - tag_len + 1, n).astype(np.int32)
    if case == "long_short":
        length[:] = [width - tag_len, 40, hdr + 20, width - tag_len - 5]
        assert (length[0] - length[2]) // 16 >= 50
    off = np.full(n, hdr, np.int32)
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[::3, 12:] = 0xFF
    roc = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    nr = tab_rk.shape[1] - 1
    keys = (_p(tab_rk), _p(tab_f8), _p(tab_mid), _p(stream), s)
    t_args = [T(tab_rk), T(tab_mid), T(stream)]
    rest = [T(off), T(iv), T(roc)]
    out = np.zeros_like(data)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_protect_f8(
        *keys, _p(data), _p(length), _p(off), _p(iv), _p(roc), _p(out),
        _p(out_len), n, width, nr, tag_len, None) == 0
    want = srtp_kernel.srtp_protect_plain(
        *t_args, T(data), T(length), *rest, tag_len, "f8", T(tab_f8))
    assert np.array_equal(out, want[0].numpy())
    assert np.array_equal(out_len, want[1].numpy())

    wire = out.copy()
    wlen = np.minimum(out_len, width).astype(np.int32)
    wire[n // 2, hdr + 1] ^= 0x40                  # a tampered row
    dec = np.zeros_like(data)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.uint8)
    assert emu.ljt_srtp_unprotect_f8(
        *keys, _p(wire), _p(wlen), _p(off), _p(iv), _p(roc), _p(dec),
        _p(mlen), _p(ok), n, width, nr, tag_len, None) == 0
    want = srtp_kernel.srtp_unprotect_plain(
        *t_args, T(wire), T(wlen), *rest, tag_len, "f8", T(tab_f8))
    for a, b in zip((dec, mlen, ok.astype(bool)), want):
        assert np.array_equal(a, b.numpy())
    genuine = np.ones(n, bool)
    genuine[n // 2] = False
    assert ok[genuine].all() and not ok[n // 2]
    for i in np.nonzero(genuine)[0]:
        assert np.array_equal(dec[i, :length[i]], data[i, :length[i]])


# ------------------------------------------------------- AEAD-GCM: M, N, O

def _aligned(a: np.ndarray) -> np.ndarray:
    """A 16-byte aligned copy (the GCM kernels load matrix rows, cache
    blocks and tag masks as 16-byte vectors)."""
    buf = np.zeros(a.nbytes + 16, np.uint8)
    off = (-buf.ctypes.data) % 16
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _gcm_tables(rng, key_len, s=5):
    rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len), np.uint8))
    gm = _aligned(ghash_tables(rk).view(np.int32))
    return rk, gm


# AADs of 8, 12, 13, 28 and 60 bytes (SRTCP's 12; CSRC lists and header
# extensions), ct_len 0 and one byte short of a block, lengths past the
# row (cut at the width), lengths shorter than the AAD, stream ids outside
# the table; `ragged` rows alternate short and long ciphertexts (chains
# of 2-3 and of 50-60 blocks in one tile at width 1024).  M and N size
# tiles for two a SM (one SM here: ceil(n / 2) rows a tile, at most 32),
# so 37 rows are tiles of 19 and 18 (8 warps: rows past the eighth are
# handed out as warps come free), 130 rows four of 32 and one of 2, and
# 11 rows tiles of 6 and 5.  A tile of at most 256 CTR entries (37 rows
# at 208 bytes, 6 at 61, 1 at 96) leaves warps 4-7 no entry, so they hash
# while warps 0-3 run CTR; one with more (9 at 1,536, 130 at 224, 11
# ragged at 1,024) runs CTR on every warp first.
def _gcm_tile_rows(n):
    return min(-(-n // 2), 32)


def _gcm_rows(rng, n, width, s, ragged=False):
    data = rng.integers(0, 256, (n, width), np.uint8)
    aad = rng.choice([8, 12, 13, 28, 60], n).astype(np.int32)
    ct = rng.integers(0, max(width - 76, 1), n)
    if ragged:
        ct = np.where(np.arange(n) % 2, rng.integers(0, 16, n),
                      rng.integers(width - 220, width - 76, n))
    length = np.minimum(aad + ct, width - 16).astype(np.int32)
    edge = [(12, 0), (13, 15), (28, 16), (60, 1), (8, width), (12, -5)]
    for i, (a, c) in enumerate(edge[:n]):
        aad[i] = a
        length[i] = a + c
    stream = rng.integers(0, s, n).astype(np.int32)
    stream[:3] = [-1, s + 2, s - 1][:n]
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    return data, length, aad, stream, iv12


@pytest.mark.parametrize("width,n,ragged", [
    (96, 1, False), (208, 37, False), (61, 6, False), (1536, 9, False),
    (224, 130, False), (1024, 11, True),
])
def test_emulated_kernels_m_n_match_plain(emu, width, n, ragged):
    rng = np.random.default_rng(7 * width + n + 16)
    rk, gm = _gcm_tables(rng, 16)
    data, length, aad, stream, iv12 = _gcm_rows(rng, n, width, len(rk),
                                                ragged)
    nr = rk.shape[1] - 1
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_gcm_seal(
        _p(rk), _p(gm), _p(stream), len(rk), _p(data), _p(length), _p(aad),
        _p(iv12), _p(out), _p(out_len), n, width, nr, None) == 0
    args = (T(rk), T(gm), T(stream), T(data), T(length), T(aad), T(iv12))
    want, want_len = srtp_kernel.srtp_gcm_protect_plain(*args)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())
    # open the sealed rows, the tag of the middle row of the first tile
    # tampered beside genuine ones
    sealed, slen = out.copy(), np.minimum(out_len, width).astype(np.int32)
    bad = _gcm_tile_rows(n) // 2
    sealed[bad, min(int(slen[bad]), width) - 1] ^= 0x40
    dec = np.zeros((n, width), np.uint8)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.bool_)
    assert emu.ljt_srtp_gcm_open(
        _p(rk), _p(gm), _p(stream), len(rk), _p(sealed), _p(slen), _p(aad),
        _p(iv12), _p(dec), _p(mlen), _p(ok), n, width, nr, None) == 0
    w_dec, w_mlen, w_ok = srtp_kernel.srtp_gcm_unprotect_plain(
        T(rk), T(gm), T(stream), T(sealed), T(slen), T(aad), T(iv12))
    assert np.array_equal(dec, w_dec.numpy())
    assert np.array_equal(mlen, w_mlen.numpy())
    assert np.array_equal(ok, w_ok.numpy())
    assert not ok[bad]
    # every row sealed inside the row opens, and gives its bytes back
    fits = (length + 16 <= width) & (length >= 0)
    fits[bad] = False
    assert ok[fits].all()
    for i in np.nonzero(fits)[0]:
        assert np.array_equal(dec[i, :length[i]], data[i, :length[i]])


@pytest.mark.parametrize("open_", [0, 1])
def test_emulated_gcm_phase_probe(emu, open_):
    """The phase probe (`ljt_srtp_gcm_phases`) runs M's or N's tile as
    they run, with each tile's clock64 stamps in order and its plan."""
    rng = np.random.default_rng(41 + open_)
    n, width = 37, 208
    rk, gm = _gcm_tables(rng, 16)
    data, length, aad, stream, iv12 = _gcm_rows(rng, n, width, len(rk))
    args = (T(rk), T(gm), T(stream), T(data), T(length), T(aad), T(iv12))
    if open_:
        sealed, slen = srtp_kernel.srtp_gcm_protect_plain(*args)
        data = sealed.numpy().copy()
        length = np.minimum(slen.numpy(), width).astype(np.int32)
        want = srtp_kernel.srtp_gcm_unprotect_plain(
            *args[:3], T(data), T(length), T(aad), T(iv12))
    else:
        want = srtp_kernel.srtp_gcm_protect_plain(*args)
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    ok = np.zeros(n, np.bool_)
    stamps = np.zeros((n, 40), np.int64)
    plan = np.zeros(3, np.int32)
    assert emu.ljt_srtp_gcm_phases(
        _p(rk), _p(gm), _p(stream), len(rk), _p(data), _p(length), _p(aad),
        _p(iv12), _p(out), _p(out_len), _p(ok), _p(stamps), _p(plan), n,
        width, open_, 0, None) == 0
    assert np.array_equal(out, want[0].numpy())
    assert np.array_equal(out_len, want[1].numpy())
    if open_:
        assert np.array_equal(ok, want[2].numpy())
    rows, tiles = int(plan[0]), int(plan[2])
    assert tiles == -(-n // rows) and not stamps[tiles:].any()
    st = stamps[:tiles]
    # start, set-up, join, stored in order; no keystream barrier (the hash
    # overlaps the keystream); every warp's hash inside the tile's start ..
    # join (a warp's stamps after the set-up barrier and thread 0's come in
    # no fixed order)
    assert (st[:, 0] > 0).all() and not st[:, 2].any()
    assert list(st[:, 5]) == [min(rows, n - rows * i) for i in range(tiles)]
    warps = st[:, 8:].reshape(tiles, 8, 4)
    hashed = warps[:, :, 2] != 0
    assert hashed.any(axis=1).all()
    assert (warps[:, :, 2] <= warps[:, :, 3])[hashed].all()
    assert (np.diff(st[:, [0, 1, 3, 4]], axis=1) >= 0).all()
    assert (warps[:, :, 2] >= st[:, 0:1])[hashed].all()
    assert (warps[:, :, 3] <= st[:, 3:4])[hashed].all()


@pytest.mark.parametrize("n,ks_bytes,width,ragged", [
    (1, 64, 96, False), (37, 64, 208, False), (130, 256, 224, False),
    (11, 256, 1024, True)])
def test_emulated_cached_instances_match_plain(emu, n, ks_bytes, width,
                                               ragged):
    """M's and N's cached instances: slots clamped into the tables (ids
    past both ends), ciphertexts past the slot's bytes (XOR nothing
    there), and the same AAD and edge rows as M and N."""
    rng = np.random.default_rng(n + ks_bytes)
    rk, gm = _gcm_tables(rng, 16)
    data, length, aad, stream, _ = _gcm_rows(rng, n, width, len(rk), ragged)
    n_slots = 40
    ks = _aligned(rng.integers(0, 256, (n_slots, ks_bytes), np.uint8))
    ek = _aligned(rng.integers(0, 256, (n_slots, 16), np.uint8))
    slot = rng.integers(0, n_slots, n).astype(np.int32)
    slot[:2] = [-3, n_slots + 5][:n]
    cargs = (_p(ks), _p(ek), _p(slot), n_slots, ks_bytes, _p(gm),
             _p(stream), len(rk))
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_gcm_seal_cached(
        *cargs, _p(data), _p(length), _p(aad), _p(out), _p(out_len), n,
        width, None) == 0
    targs = (T(ks), T(ek), T(slot), T(gm), T(stream))
    want, want_len = srtp_kernel.srtp_gcm_protect_cached_plain(
        *targs, T(data), T(length), T(aad))
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())
    sealed, slen = out.copy(), np.minimum(out_len, width).astype(np.int32)
    sealed[n // 2, 0] ^= 1                        # a tampered AAD byte
    mid = _gcm_tile_rows(n) // 2                  # and a tampered tag
    if mid != n // 2:
        sealed[mid, slen[mid] - 1] ^= 0x08
    dec = np.zeros((n, width), np.uint8)
    mlen = np.zeros(n, np.int32)
    ok = np.zeros(n, np.bool_)
    assert emu.ljt_srtp_gcm_open_cached(
        *cargs, _p(sealed), _p(slen), _p(aad), _p(dec), _p(mlen), _p(ok), n,
        width, None) == 0
    w_dec, w_mlen, w_ok = srtp_kernel.srtp_gcm_unprotect_cached_plain(
        *targs, T(sealed), T(slen), T(aad))
    assert np.array_equal(dec, w_dec.numpy())
    assert np.array_equal(mlen, w_mlen.numpy())
    assert np.array_equal(ok, w_ok.numpy())
    assert not ok[n // 2] and not ok[mid]


def test_emulated_gcm_counter_add_is_inc32(emu):
    """J0's low word is 1 and a row has at most 2,048 blocks, so the CTR
    stage's 128-bit counter add gives GCM's inc32 sequence: with IVs of
    all-one bytes (where a carry out of the low word would change the
    upper 96 bits) and the widest rows, M's output is AES-GCM's as
    `cryptography` computes it."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 256, (2, 16), np.uint8)
    rk = aes.expand_keys_batch(keys)
    gm = _aligned(ghash_tables(rk).view(np.int32))
    width, n = 32768, 2
    data = rng.integers(0, 256, (n, width), np.uint8)
    aad = np.array([12, 13], np.int32)
    length = np.array([width - 16, width - 30], np.int32)
    iv12 = np.full((n, 12), 0xFF, np.uint8)
    iv12[1, :4] = 0x00
    stream = np.arange(n, dtype=np.int32)
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_gcm_seal(
        _p(rk), _p(gm), _p(stream), n, _p(data), _p(length), _p(aad),
        _p(iv12), _p(out), _p(out_len), n, width, 10, None) == 0
    for i in range(n):
        a, ln = int(aad[i]), int(length[i])
        ct = AESGCM(bytes(keys[i])).encrypt(
            bytes(iv12[i]), bytes(data[i, a:ln]), bytes(data[i, :a]))
        assert bytes(out[i, :ln + 16]) == bytes(data[i, :a]) + ct


@pytest.mark.parametrize("legs,width", [(3, 64), (10, 208)])
def test_emulated_kernel_h_gcm_matches_plain(emu, legs, width):
    """H's GCM instance: ragged receiver counts (a packet with none),
    offsets before, inside and past the row, lengths at and past the
    width, leg ids outside the table, indices near the 32- and 48-bit
    edges; and each copy is its packet sealed by M under its leg's keys
    with the RFC 7714 IV."""
    rng = np.random.default_rng(legs * width)
    p = 5
    counts = [legs, 0, legs - 1, 1, legs]
    _, _, tab_salt, data, length, off, ssrc, index, src, recv = \
        _fanout_inputs(rng, 16, p, width, counts)
    rk, gm = _gcm_tables(rng, 16, len(tab_salt))
    tab_salt[:, 12:] = 0
    n = len(src)
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_fanout_gcm(
        _p(rk), _p(gm), _p(tab_salt), len(rk), _p(data), _p(length),
        _p(off), _p(ssrc), _p(index), p, _p(src), _p(recv), _p(out),
        _p(out_len), n, width, 10, None) == 0
    want, want_len = srtp_kernel.srtp_fanout_gcm_plain(
        T(rk), T(gm), T(tab_salt), T(data), T(length), T(off), T(ssrc),
        T(index), T(src), T(recv))
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())
    leg = np.clip(recv, 0, len(rk) - 1)
    iv12 = tgcm.srtp_gcm_iv(tab_salt[leg], ssrc.view(np.uint32)[src],
                            index[src])
    m_out, _ = srtp_kernel.srtp_gcm_protect_plain(
        T(rk), T(gm), T(leg.astype(np.int32)), T(data[src]), T(length[src]),
        T(off[src]), T(iv12))
    assert np.array_equal(out, m_out.numpy())


@pytest.mark.parametrize("n,ks_bytes", [(1, 16), (70, 256), (33, 48)])
def test_emulated_kernel_o_matches_plain(emu, n, ks_bytes):
    """Kernel O fills the slots it is given (a partial last tile, stream
    ids outside the table, slots outside the tables skipped) and leaves
    every other slot as it was."""
    rng = np.random.default_rng(n + ks_bytes + 16)
    rk = aes.expand_keys_batch(rng.integers(0, 256, (4, 16), np.uint8))
    n_slots = n + 9
    stream = rng.integers(-1, 6, n).astype(np.int32)
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    slot = rng.permutation(n_slots)[:n].astype(np.int32)
    slot[:1] = [n_slots + 3]
    ks0 = rng.integers(0, 256, (n_slots, ks_bytes), np.uint8)
    ek0 = rng.integers(0, 256, (n_slots, 16), np.uint8)
    ks, ek = _aligned(ks0), _aligned(ek0)
    assert emu.ljt_gcm_ks_fill(
        _p(rk), len(rk), _p(stream), _p(iv12), _p(slot), _p(ks), _p(ek), n,
        n_slots, ks_bytes, rk.shape[1] - 1, None) == 0
    w_ks, w_ek = T(ks0.copy()), T(ek0.copy())
    tgcm.gcm_ks_fill_plain(w_ks, w_ek, T(rk), T(stream), T(iv12), T(slot))
    assert np.array_equal(ks, w_ks.numpy())
    assert np.array_equal(ek, w_ek.numpy())


# Kernel O's runs and edges.  A tile is 64 slots and a launch keeps at
# most 8 CTAs an SM (one SM here), each taking tiles in turn; each run of
# one stream's consecutive slots is sliced once and its entries paired in
# order.  Every case puts an id past the table and a negative one in its
# streams (clamped, so they may join a neighbour's run) and slots outside
# the tables among its slots (skipped); ks_bytes 16, 48, 256 and 1,024.
O_CASES = {
    "runs_across_tiles": (300, 256),      # runs of 100, 37, 64 and 99
    "all_distinct": (130, 48),
    "alternating": (96, 16),
    "windows_partial_last": (64 * 3 + 17, 256),
    "one_slot": (1, 1024),
    "odd_count": (77, 1024),              # runs of 1-11 slots
    "many_tiles": (600, 48),              # 10 tiles on 8 CTAs
}
O_TABLE = 140


def _o_case(case):
    """Table, streams, IVs, slots and the slot tables of an O case."""
    n, ks_bytes = O_CASES[case]
    rng = np.random.default_rng(len(case) * 1000 + n)
    rk = aes.expand_keys_batch(rng.integers(0, 256, (O_TABLE, 16), np.uint8))
    if case == "runs_across_tiles":
        stream = np.repeat([5, 9, 5, 77], [100, 37, 64, 99])
    elif case == "all_distinct":
        stream = rng.permutation(O_TABLE)[:n]
    elif case == "alternating":
        stream = np.tile([3, 4], n // 2)
    elif case in ("windows_partial_last", "many_tiles"):
        stream = np.repeat(rng.permutation(O_TABLE)[:10], 64)[:n]
    elif case == "odd_count":
        stream = np.repeat(rng.integers(0, O_TABLE, n), rng.integers(
            1, 12, n))[:n]
    else:
        stream = np.array([7])
    stream = stream.astype(np.int32)
    if n > 4:
        stream[n // 3] = O_TABLE + 5
        stream[n // 2] = -3
    n_slots = n + 9
    slot = rng.permutation(n_slots)[:n].astype(np.int32)
    slot[0] = n_slots + 3
    if n > 4:
        slot[n // 4] = -1
    ks0 = rng.integers(0, 256, (n_slots, ks_bytes), np.uint8)
    ek0 = rng.integers(0, 256, (n_slots, 16), np.uint8)
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    return rk, stream, iv12, slot, ks0, ek0


@pytest.mark.parametrize("case", list(O_CASES))
def test_emulated_kernel_o_runs_and_edges(emu, case):
    rk, stream, iv12, slot, ks0, ek0 = _o_case(case)
    n, (n_slots, ks_bytes) = len(stream), ks0.shape
    ks, ek = _aligned(ks0), _aligned(ek0)
    assert emu.ljt_gcm_ks_fill(
        _p(rk), len(rk), _p(stream), _p(iv12), _p(slot), _p(ks), _p(ek), n,
        n_slots, ks_bytes, 10, None) == 0
    w_ks, w_ek = T(ks0.copy()), T(ek0.copy())
    tgcm.gcm_ks_fill_plain(w_ks, w_ek, T(rk), T(stream), T(iv12), T(slot))
    assert np.array_equal(ks, w_ks.numpy())
    assert np.array_equal(ek, w_ek.numpy())


def test_emulated_fill_phase_probe(emu):
    """O's phase probe (`ljt_gcm_ks_fill_phases`) fills the tables as the
    shipped kernel does, plans as it does (64 slots a tile, 8 CTAs taking
    10 tiles in turn here), and stamps each tile in order: start, the run
    vote, thread 0's round keys, set-up done, the AES done."""
    rk, stream, iv12, slot, ks0, ek0 = _o_case("many_tiles")
    n, (n_slots, ks_bytes) = len(stream), ks0.shape
    ks, ek = _aligned(ks0), _aligned(ek0)
    pks, pek = _aligned(ks0), _aligned(ek0)
    assert emu.ljt_gcm_ks_fill(
        _p(rk), len(rk), _p(stream), _p(iv12), _p(slot), _p(ks), _p(ek), n,
        n_slots, ks_bytes, 10, None) == 0
    stamps = np.zeros((n, 24), np.int64)
    plan = np.zeros(4, np.int32)
    assert emu.ljt_gcm_ks_fill_phases(
        _p(rk), len(rk), _p(stream), _p(iv12), _p(slot), _p(pks), _p(pek),
        _p(stamps), _p(plan), n, n_slots, ks_bytes, None) == 0
    assert np.array_equal(pks, ks) and np.array_equal(pek, ek)
    tiles = -(-n // 64)
    assert list(plan[[0, 2, 3]]) == [64, 8, tiles]
    st = stamps[:tiles]
    assert not stamps[tiles:].any() and (st[:, 0] > 0).all()
    assert (np.diff(st[:, [0, 16, 17, 1, 2]], axis=1) >= 0).all()
    assert list(st[:, 5]) == [min(64, n - 64 * i) for i in range(tiles)]
    assert list(st[:, 7]) == [i % 8 for i in range(tiles)]
    # runs: windows of 64 slots, one split by each out-of-range id
    assert (st[:, 6] >= 1).all() and st[:, 6].sum() >= tiles


# H-F8's own tile: up to 128 copies (one tile here), the chains two
# copies a thread on warps 0-1 and the hash behind them on warps 2-3 and
# 6-7.  Copies whose MAC message ends exactly at a 64-byte SHA-1 block
# (lengths 64 and 128: header, payload and ROC) and inside one, a
# header-only copy (length 20, no keystream block), full-width and 1,504-
# byte rows, odd copy counts, a single copy, two tiles (140 copies), 10
# legs a packet, AES-128 and AES-256; IVs with counters near 2^32.
@pytest.mark.parametrize("key_len,lens,counts,width", [
    (16, [60, 124, 100, 20, 208, 150], [10] * 6, 208),
    (32, [1504, 20, 1000], [10, 10, 7], 1504),
    (16, [128], [1], 192),
    (32, None, [10] * 14, 208),
])
def test_emulated_kernel_h_f8_copies(emu, key_len, lens, counts, width):
    rng = np.random.default_rng(key_len + width + len(counts))
    p = len(counts)
    s = 6
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, key_len), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    data = rng.integers(0, 256, (p, width), np.uint8)
    length = (np.asarray(lens) if lens is not None
              else rng.integers(80, 181, p)).astype(np.int32)
    off = np.full(p, 20, np.int32)
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    iv = rng.integers(0, 256, (p, 16), np.uint8)
    iv[::2, 12:] = 0xFF
    src = np.repeat(np.arange(p), counts).astype(np.int32)
    recv = rng.integers(0, s, len(src)).astype(np.int32)
    n, nr = len(src), tab_rk.shape[1] - 1
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    assert emu.ljt_srtp_fanout_f8(
        _p(tab_rk), _p(tab_f8), _p(tab_mid), s, _p(data), _p(length),
        _p(off), _p(iv), _p(index), p, _p(src), _p(recv), _p(out),
        _p(out_len), n, width, nr, 10, None) == 0
    want, want_len = srtp_kernel.srtp_fanout_protect_plain(
        T(tab_rk), T(tab_mid), None, T(data), T(length), T(off), None,
        T(index), T(src), T(recv), 10, "f8", T(tab_f8), T(iv))
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(out_len, want_len.numpy())


def test_emulated_f8_phase_probe(emu):
    """H-F8's phase probe (`ljt_srtp_fanout_f8_phases`, AES-128) writes
    the copies the shipped kernel writes, plans as it does, and stamps
    each tile in order: start, set-up, IV', each chain warp's end, the
    hash joined, the rows stored; warps 0-1 walk chains, warps 2-3 hash."""
    rng = np.random.default_rng(23)
    p, legs, width, s = 14, 10, 208, 6
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, 16), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    data = rng.integers(0, 256, (p, width), np.uint8)
    length = rng.integers(80, 181, p).astype(np.int32)
    off = np.full(p, 20, np.int32)
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    iv = rng.integers(0, 256, (p, 16), np.uint8)
    src = np.repeat(np.arange(p), legs).astype(np.int32)
    recv = rng.integers(0, s, len(src)).astype(np.int32)
    n = len(src)
    args = (_p(tab_rk), _p(tab_f8), _p(tab_mid), s, _p(data), _p(length),
            _p(off), _p(iv), _p(index), p, _p(src), _p(recv))
    out, pout = (np.zeros((n, width), np.uint8) for _ in range(2))
    out_len, pout_len = np.zeros(n, np.int32), np.zeros(n, np.int32)
    assert emu.ljt_srtp_fanout_f8(*args, _p(out), _p(out_len), n, width, 10,
                                  10, None) == 0
    stamps = np.zeros((n, 40), np.int64)
    plan = np.zeros(3, np.int32)
    assert emu.ljt_srtp_fanout_f8_phases(
        *args, _p(pout), _p(pout_len), _p(stamps), _p(plan), n, width, 10,
        None) == 0
    assert np.array_equal(pout, out) and np.array_equal(pout_len, out_len)
    rows, tiles = int(plan[0]), int(plan[2])
    assert (rows, tiles) == (128, 2)
    st = stamps[:tiles]
    assert not stamps[tiles:].any()
    assert list(st[:, 8]) == [128, n - 128]
    warps = st[:, 16:].reshape(tiles, 8, 3)
    chain_end = warps[:, :, 1].max(axis=1)
    assert (np.diff(st[:, [0, 1, 2]], axis=1) >= 0).all()
    assert (st[:, 2] <= chain_end).all() and (chain_end <= st[:, 4]).all()
    assert (st[:, 4] <= st[:, 5]).all()
    assert (warps[:, 0, 1] > 0).all() and (warps[:, 2, 2] > 0).all()
    assert not warps[:, [4, 5], :].any()


@pytest.mark.parametrize("entry", ["seal", "open", "fanout", "fill"])
def test_emulated_gcm_entries_refuse_aes256(emu, entry):
    """The GCM kernels are AES-128 only (no SRTP profile runs AES-256
    GCM): each entry refuses 14 rounds and writes nothing."""
    rng = np.random.default_rng(5)
    rk = aes.expand_keys_batch(rng.integers(0, 256, (3, 32), np.uint8))
    gm = _aligned(ghash_tables(rk).view(np.int32))
    n, width = 4, 96
    data, length, aad, stream, iv12 = _gcm_rows(rng, n, width, len(rk))
    out = np.zeros((n, width), np.uint8)
    out_len = np.zeros(n, np.int32)
    ok = np.zeros(n, np.bool_)
    if entry == "seal":
        rc = emu.ljt_srtp_gcm_seal(
            _p(rk), _p(gm), _p(stream), len(rk), _p(data), _p(length),
            _p(aad), _p(iv12), _p(out), _p(out_len), n, width, 14, None)
    elif entry == "open":
        rc = emu.ljt_srtp_gcm_open(
            _p(rk), _p(gm), _p(stream), len(rk), _p(data), _p(length),
            _p(aad), _p(iv12), _p(out), _p(out_len), _p(ok), n, width, 14,
            None)
    elif entry == "fanout":
        salt = np.zeros((len(rk), 16), np.uint8)
        src = np.arange(n, dtype=np.int32)
        rc = emu.ljt_srtp_fanout_gcm(
            _p(rk), _p(gm), _p(salt), len(rk), _p(data), _p(length),
            _p(np.full(n, 12, np.int32)), _p(np.zeros(n, np.int32)),
            _p(np.zeros(n, np.int64)), n, _p(src), _p(stream % len(rk)),
            _p(out), _p(out_len), n, width, 14, None)
    else:
        out = _aligned(np.zeros((n, 16), np.uint8))
        ek = _aligned(np.zeros((n, 16), np.uint8))
        rc = emu.ljt_gcm_ks_fill(
            _p(rk), len(rk), _p(stream), _p(iv12),
            _p(np.arange(n, dtype=np.int32)), _p(out), _p(ek), n, n, 16,
            14, None)
        assert not ek.any()
    assert rc == 1                                 # cudaErrorInvalidValue
    assert not out.any() and not out_len.any() and not ok.any()


def test_emulated_srtp_f8_phase_probe(emu):
    """K's and L's phase probe (`ljt_srtp_f8_phases`, AES-128) writes what
    the shipped kernels write, plans as they do, and stamps each tile in
    order: start, thread 0's set-up, set-up done, each chain warp's end
    before the hash's join, the rows stored; its warps' slots are kept."""
    rng = np.random.default_rng(41)
    s, n, width, tag_len = 5, 13, 224, 10
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, 16), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(0, s, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = rng.integers(12, width - tag_len + 1, n).astype(np.int32)
    off = np.full(n, 12, np.int32)
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    roc = rng.integers(0, 2 ** 31, n).astype(np.int32)
    head = (_p(tab_rk), _p(tab_f8), _p(tab_mid), _p(stream), s)
    out, pout = np.zeros_like(data), np.zeros_like(data)
    out_len, pout_len = np.zeros(n, np.int32), np.zeros(n, np.int32)
    ok, pok = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    for unprotect in (0, 1):
        rows = (_p(data), _p(length), _p(off), _p(iv), _p(roc))
        if unprotect:
            data, length = out.copy(), np.minimum(out_len, width)
            rows = (_p(data), _p(length), _p(off), _p(iv), _p(roc))
            assert emu.ljt_srtp_unprotect_f8(
                *head, *rows, _p(out), _p(out_len), _p(ok), n, width, 10,
                tag_len, None) == 0
            assert ok.all()
        else:
            assert emu.ljt_srtp_protect_f8(
                *head, *rows, _p(out), _p(out_len), n, width, 10, tag_len,
                None) == 0
        stamps = np.zeros((n, 40), np.int64)
        plan = np.zeros(4, np.int32)
        assert emu.ljt_srtp_f8_phases(
            *head, *rows, _p(pout), _p(pout_len), _p(pok), _p(stamps),
            _p(plan), n, width, tag_len, unprotect, 0, None) == 0
        assert np.array_equal(pout, out) and np.array_equal(pout_len,
                                                            out_len)
        assert not unprotect or np.array_equal(pok, ok)
        tiles = int(plan[2])
        assert tiles == -(-n // int(plan[0])) and plan[3] in (128, 256)
        st = stamps[:tiles]
        assert not stamps[tiles:].any()
        assert st[:, 8].sum() == n
        warps = st[:, 16:].reshape(tiles, 8, 3)
        chain_end = warps[:, :, 1].max(axis=1)
        assert (st[:, 0] <= st[:, 9]).all() and (st[:, 9] <= st[:, 1]).all()
        assert (st[:, 1] <= chain_end).all() and (chain_end <= st[:, 4]).all()
        assert (warps[:, :, 2].max(axis=1) <= st[:, 4]).all()
        assert (st[:, 4] <= st[:, 5]).all()
        assert ((warps[:, :, 1] > 0) <= (warps[:, :, 0] > 0)).all()
