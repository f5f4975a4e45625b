"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit; without a card
the `cuda_device` fixture skips it.  This file imports neither JAX nor
the JAX package, so it also runs on the card's machine, where JAX is not
installed and `tests/conftest.py` (which imports JAX) must be skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality of every byte, length and mask.
"""

import hashlib
import hmac

import numpy as np
import pytest
import torch

from libjitsi_tpu_torch.conference import mixer
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels import aes, g711, sha1
from libjitsi_tpu_torch.kernels import build as kbuild
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp import kernel as srtp_kernel
from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("key_len", [16, 32])
def test_aes_kernel_matches_plain_and_fips197(cuda_device, key_len):
    rng = np.random.default_rng(key_len)
    n = 4099
    rk = aes.expand_keys_batch(rng.integers(0, 256, (n, key_len), np.uint8))
    blocks = rng.integers(0, 256, (n, 16), np.uint8)
    rk_d = torch.from_numpy(rk).to(cuda_device)
    bl_d = torch.from_numpy(blocks).to(cuda_device)
    before = kbuild.launches["aes_encrypt"]
    got = aes.aes_encrypt(rk_d, bl_d)
    torch.cuda.synchronize()
    assert kbuild.launches["aes_encrypt"] == before + 1
    assert _same(got, aes.aes_encrypt_plain(rk_d, bl_d))
    assert np.array_equal(got.cpu().numpy(), aes.aes_encrypt_np(rk, blocks))
    key, ct = {16: ("000102030405060708090a0b0c0d0e0f",
                    "69c4e0d86a7b0430d8cdb78070b4c55a"),
               32: ("000102030405060708090a0b0c0d0e0f"
                    "101112131415161718191a1b1c1d1e1f",
                    "8ea2b7ca516745bfeafc49904b496089")}[key_len]
    kat = aes.aes_encrypt(
        torch.from_numpy(aes.expand_key(bytes.fromhex(key))[None].copy())
        .to(cuda_device),
        torch.tensor([list(bytes.fromhex(
            "00112233445566778899aabbccddeeff"))], dtype=torch.uint8,
            device=cuda_device))
    assert bytes(kat.cpu().numpy()[0]) == bytes.fromhex(ct)


@pytest.mark.parametrize("key_len", [16, 32])
def test_aes_kernel_sbox_exhaustive_and_mixed_key_pairs(cuda_device,
                                                        key_len):
    """Kernel A at the shape chip_smoke.py times (65,536 blocks): blocks
    of 16 equal bytes v (every S-box input at every byte position in round
    1) under the all-zero key, then an odd count of blocks whose pairs are
    under two keys, against the plain version and the host AES."""
    rng = np.random.default_rng(200 + key_len)
    n = 65536
    zero = aes.expand_key(bytes(key_len))
    rk = np.ascontiguousarray(np.broadcast_to(zero, (n,) + zero.shape))
    blocks = np.repeat((np.arange(n) % 256).astype(np.uint8)[:, None], 16,
                       axis=1)
    for rk_h, bl_h in ((rk, blocks), (
            aes.expand_keys_batch(rng.integers(0, 256, (n - 1, key_len),
                                               np.uint8)),
            rng.integers(0, 256, (n - 1, 16), np.uint8))):
        rk_d = torch.from_numpy(rk_h).to(cuda_device)
        bl_d = torch.from_numpy(bl_h).to(cuda_device)
        got = aes.aes_encrypt(rk_d, bl_d)
        torch.cuda.synchronize()
        assert _same(got, aes.aes_encrypt_plain(rk_d, bl_d))
        assert np.array_equal(got.cpu().numpy(),
                              aes.aes_encrypt_np(rk_h, bl_h))


def test_hmac_kernel_matches_plain_and_stdlib(cuda_device):
    rng = np.random.default_rng(5)
    n, width = 257, 1504
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    mid = torch.from_numpy(sha1.hmac_precompute_batch(keys).view(np.int32))
    data = rng.integers(0, 256, (n, width), np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:4] = [0, 55, 56, width]
    args = [t.to(cuda_device) for t in
            (mid, torch.from_numpy(data), torch.from_numpy(lens))]
    got = sha1.hmac_sha1(*args)
    assert _same(got, sha1.hmac_sha1_plain(*args))
    got = got.cpu().numpy()
    for i in range(n):
        assert bytes(got[i]) == hmac.new(
            bytes(keys[i]), bytes(data[i, :lens[i]]), hashlib.sha1).digest()


# Kernel B's tiles on an H100 (132 SMs, four tiles an SM): 1, 33 and 200
# rows one row a tile, 4,096 rows 8 a tile (28 at 8,192 bytes); at
# 240,000 bytes a row is staged in chunks.
@pytest.mark.parametrize("width,n", [(200, 1), (200, 33), (1504, 200),
                                     (1504, 4096), (8192, 4096),
                                     (240000, 4)])
def test_hmac_kernel_tiles_match_stdlib(cuda_device, width, n):
    rng = np.random.default_rng(width + n)
    lens = rng.integers(-3, width + 5, n).astype(np.int32)
    lens[:4] = [0, 55, 56, width][:n]
    _check_hmac_kernel(cuda_device, rng, width, lens)


def _check_hmac_kernel(cuda_device, rng, width, lens):
    n = len(lens)
    keys = rng.integers(0, 256, (n, 20), np.uint8)
    data = rng.integers(0, 256, (n, width), np.uint8)
    mid, dat, ln = (torch.from_numpy(x).to(cuda_device) for x in
                    (sha1.hmac_precompute_batch(keys).view(np.int32), data,
                     lens))
    want = [hmac.new(bytes(keys[i]),
                     bytes(data[i, :min(max(int(lens[i]), 0), width)]),
                     hashlib.sha1).digest() for i in range(n)]
    before = kbuild.launches["hmac_sha1"]
    got = sha1.hmac_sha1(mid, dat, ln)
    torch.cuda.synchronize()
    assert kbuild.launches["hmac_sha1"] == before + 1
    assert [bytes(g) for g in got.cpu().numpy()] == want
    if width <= 1504:
        assert _same(got, sha1.hmac_sha1_plain(mid, dat, ln))


# Messages that end at and across the chunks of 240,000-byte rows (see
# tests/test_torch_cuda_emu.py): 14 rows are 1-row tiles on the card
# (232,384-byte chunks); 1,100 rows are tiles of 3 on 132 SMs (77,440-byte
# chunks, four a row), their first 14 ending at the chunk edges.  An end
# is the width or (k, d): k chunks plus d bytes.
@pytest.mark.parametrize("n,ends", [
    (14, [(1, 0), (1, 1)] + [(1, -d) for d in range(1, 10)]
     + [240000, 239999, 0]),
    (1100, [(1, 0), (1, 1), (1, -1), (1, -8), (2, -1), (2, 0), (2, 1),
            (3, -4), (3, -9), (3, 0), (3, 1), 240000, 239999, 0]),
])
def test_hmac_kernel_rows_across_chunks(cuda_device, n, ends):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tile = min(32, -(-n // (4 * sms)))      # plan_b in csrc/hmac_sha1.cu
    chunk = (232448 // 4 // tile - 1) * 4 // 64 * 64
    rng = np.random.default_rng(n)
    lens = rng.integers(0, 240001, n).astype(np.int32)
    lens[:len(ends)] = [e if isinstance(e, int) else e[0] * chunk + e[1]
                        for e in ends]
    assert lens.max() <= 240000
    _check_hmac_kernel(cuda_device, rng, 240000, lens)


def _cd(key_len, tag_len, width, n=301, case="random"):
    tail = "" if (n, case) == (301, "random") else f"-{n}-{case}"
    return pytest.param(key_len, tag_len, width, n, case,
                        id=f"{key_len}-{tag_len}-{width}{tail}")


# Kernels C and D give each SM about two tiles of at most 32 rows: on an
# H100 (132 SMs) 1, 31 and 33 rows run one row a tile, 301 rows 2 a tile,
# 4,096 rows 16 a tile, and 16,897 rows 32 a tile with a last tile of
# one row.
@pytest.mark.parametrize("key_len,tag_len,width,n,case", [
    _cd(16, 10, 224), _cd(32, 4, 544), _cd(16, 10, 1536), _cd(16, 10, 50),
    _cd(16, 10, 224, 1), _cd(16, 10, 224, 31), _cd(32, 10, 1536, 33),
    _cd(16, 10, 192, 16897),
    _cd(16, 10, 544, 4096, "production"),   # one table part of the mix
    _cd(16, 10, 224, 96, "one_stream"),     # every row of a tile one stream
])
def test_srtp_kernels_match_plain(cuda_device, key_len, tag_len, width, n,
                                  case):
    """Kernels C and D byte for byte, edge rows included: offsets past
    the row, lengths past the row, stream ids outside the table,
    counters that carry past 32 bits, partial tiles."""
    rng = np.random.default_rng(width + key_len + n)
    s = 9
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len), np.uint8))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    stream = rng.integers(-1, s + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    length = rng.integers(0, width + 3, n).astype(np.int32)
    off = rng.integers(0, width + 20, n).astype(np.int32)
    off[n // 2:] = 12
    if case == "production":
        # the 412-byte packets of a production-mix batch: 12-byte header
        stream = rng.integers(0, s, n).astype(np.int32)
        length[:] = 12 + 400
        off[:] = 12
    elif case == "one_stream":
        stream[:] = 3
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[:8, 8:] = 0xFF
    roc = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    host = [torch.from_numpy(x) for x in
            (tab_rk, tab_mid, stream, data, length, off, iv, roc)]
    dev = [t.to(cuda_device) for t in host]
    before = dict(kbuild.launches)
    pd, pl = srtp_kernel.srtp_protect(*dev, tag_len)
    wd, wl = srtp_kernel.srtp_protect_plain(*dev, tag_len)
    assert _same(pd, wd) and _same(pl, wl)
    ulen = pl.clamp(max=width)
    ud, um, uok = srtp_kernel.srtp_unprotect(*dev[:3], pd, ulen, *dev[5:],
                                             tag_len)
    wd, wm, wok = srtp_kernel.srtp_unprotect_plain(*dev[:3], pd, ulen,
                                                   *dev[5:], tag_len)
    assert _same(ud, wd) and _same(um, wm) and _same(uok, wok)
    fits = torch.from_numpy(length + tag_len <= width).to(cuda_device)
    assert bool(uok[fits].all())
    if case == "production":                  # the round trip gives the packets
        assert _same(ud[:, :412], dev[3][:, :412])
    assert kbuild.launches["srtp_protect_cm"] == before["srtp_protect_cm"] + 1
    assert (kbuild.launches["srtp_unprotect_cm"]
            == before["srtp_unprotect_cm"] + 1)


def test_kernel_wrappers_refuse_bad_arguments(cuda_device):
    blocks = torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device)
    rk = torch.zeros((4, 11, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        aes.aes_encrypt(rk, blocks.int())
    with pytest.raises(ValueError):
        aes.aes_encrypt(rk, blocks.t().contiguous().t())
    with pytest.raises(ValueError):
        aes.aes_encrypt(rk.cpu(), blocks)
    flat = torch.zeros(4 * 16 + 1, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        aes.aes_encrypt(rk, flat[1:].view(4, 16))


@pytest.mark.parametrize("profile", [SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                                     SrtpProfile.AES_256_CM_HMAC_SHA1_32])
def test_table_on_card_equals_table_on_cpu(cuda_device, profile):
    """The same stream table on the card and on the CPU: identical wire
    bytes, verdicts and per-stream state, through kernels C and D."""
    rng = np.random.default_rng(11)
    s = 32
    p = profile.policy
    mks = rng.integers(0, 256, (s, p.enc_key_len), np.uint8)
    mss = rng.integers(0, 256, (s, p.salt_len), np.uint8)
    tabs = {}
    for dev in ("cpu", cuda_device):
        tx = SrtpStreamTable(s, profile, device=dev)
        rx = SrtpStreamTable(s, profile, device=dev)
        tx.add_streams(np.arange(s), mks, mss)
        rx.add_streams(np.arange(s), mks, mss)
        tabs[str(dev)] = (tx, rx)
    n = 96
    streams = rng.integers(0, s, n)
    # one size class per stream: bucketing keeps a class's rows in order
    lens = np.array([100, 400, 950])[streams % 3]
    payloads = [rng.integers(0, 256, k, np.uint8).tobytes() for k in lens]
    # each stream's packets take consecutive seqs that cross the 16-bit
    # wrap, so no row is a replay of another
    occ = np.array([np.sum(streams[:i] == streams[i]) for i in range(n)])
    batch = rtp_header.build(payloads, ((occ + 65534) % 65536).tolist(),
                             [0] * n, (0x5000 + streams).tolist(), [96] * n,
                             stream=streams.tolist())
    outs = {}
    for name, (tx, rx) in tabs.items():
        kbuild.reset_counts()
        wire = tx.protect_rtp(batch.copy())
        wire.data[5, 20] ^= 1
        dec, ok = rx.unprotect_rtp(wire)
        outs[name] = (wire, dec, ok, tx.tx_ext.copy(), rx.rx_max.copy(),
                      rx.rx_mask.copy())
        if name != "cpu":
            assert kbuild.launches["srtp_protect_cm"] > 0
            assert kbuild.launches["srtp_unprotect_cm"] > 0
            assert sum(kbuild.plain_calls.values()) == 0
    a, b = outs["cpu"], outs[str(cuda_device)]
    assert np.array_equal(a[0].data, b[0].data)
    assert np.array_equal(a[0].length, b[0].length)
    assert np.array_equal(a[1].data, b[1].data)
    for x, y in zip(a[2:], b[2:]):
        assert np.array_equal(x, y)
    ok = b[2]
    assert not ok[5] and ok.sum() == n - 1
    assert isinstance(b[1], PacketBatch)


# (C, N, F) or (C, N, F, pcm offset in samples): the mixers' shapes, a
# ragged one, F = 1, views at an odd offset (the 2-byte path), rows in
# stages (a cluster of 16, then clusters of 8) and a frame too wide for
# one block's shared memory (more blocks than the SM count asks for)
@pytest.mark.parametrize("shape", [(1, 256, 960), (1, 256, 160),
                                   (64, 64, 960), (3, 7, 33), (1, 257, 161),
                                   (1, 1, 1), (1, 256, 160, 1),
                                   (64, 64, 960, 1), (1, 2000, 960),
                                   (20, 1000, 960), (300, 3, 12000)])
def test_mix_kernel_matches_plain(cuda_device, shape):
    """Kernel E against its plain version on the card and on the CPU,
    with inactive, silent, near-silent and saturating rows."""
    c, n, f, *rest = shape
    offset = rest[0] if rest else 0
    plan = np.zeros(8, np.int32)
    assert kbuild.library().ljt_mix_minus_plan(256, 256, c, n, f,
                                               plan.ctypes.data) == 0
    if n >= 1000:                          # staged: more than one stage
        assert plan[2] < n and plan[0] == (16 if c == 1 else 8)
    if f == 12000:                         # C >= 2 SMs would give 1 block
        assert plan[0] == 2
    rng = np.random.default_rng(sum(shape))
    pcm = rng.integers(-32768, 32768, (c, n, f)).astype(np.int16)
    active = rng.random((c, n)) < 0.75
    pcm[:, 0] = 0
    pcm[:, 1:2] = 0
    pcm[:, 1:2, :2] = [1, -1][:f]
    pcm[:, 2:4] = 32767
    active[:, :4] = True
    active[:, 4:5] = False
    flat = torch.zeros(c * n * f + 8, dtype=torch.int16, device=cuda_device)
    p_d = flat[offset:offset + c * n * f].view(c, n, f)
    p_d.copy_(torch.from_numpy(pcm))
    a_d = torch.from_numpy(active).to(cuda_device)
    before = kbuild.launches["mix_minus"]
    out, lv = mixer.mix_minus_many(p_d, a_d)
    torch.cuda.synchronize()
    assert kbuild.launches["mix_minus"] == before + 1
    want_out, want_lv = mixer.mix_minus_many_plain(p_d, a_d)
    assert _same(out, want_out) and _same(lv, want_lv)
    cpu_out, cpu_lv = mixer.mix_minus_many(torch.from_numpy(pcm),
                                           torch.from_numpy(active))
    assert _same(out, cpu_out) and _same(lv, cpu_lv)


def test_mix_kernel_refuses_what_it_cannot_take(cuda_device):
    """Nothing is left that kernel E cannot take.  The shapes it once
    refused with a ValueError run the staged kernel, one launch each, and
    equal the plain version on the card and on the CPU: 65,540 rows
    (64-bit column totals), [1, 131,076, 1] with every column total past
    2**31 - 1 (the exact clip, 32,767 in every row but row 0), and frames
    wider than a cluster of 8 and of 16 blocks can stage one row of.
    65,540 rows run in 16 row groups; with quiet samples no mix clips, so
    a row counted twice or missed by the groups' totals would show."""
    rng = np.random.default_rng(65540)
    loud = np.full((1, 131076, 1), 32767, np.int16)
    loud[0, 0] = 0
    cases = [rng.integers(-32768, 32768, (1, 65540, 8)).astype(np.int16),
             rng.integers(-3, 4, (1, 65540, 8)).astype(np.int16),
             loud,
             rng.integers(-32768, 32768, (300, 1, 80000)).astype(np.int16),
             rng.integers(-32768, 32768, (1, 3, 160008)).astype(np.int16)]
    for pcm in cases:
        c, n, f = pcm.shape
        plan = np.zeros(8, np.int32)
        assert kbuild.library().ljt_mix_minus_plan(256, 256, c, n, f,
                                                   plan.ctypes.data) == 0
        assert plan[6] == 1 and (n > 65535 or plan[5] > 1)
        assert plan[7] == (16 if n > 65535 else 1)
        p_d = torch.from_numpy(pcm).to(cuda_device)
        before = kbuild.launches["mix_minus"], dict(kbuild.plain_calls)
        out, lv = mixer.mix_minus_many(p_d)
        torch.cuda.synchronize()
        assert kbuild.launches["mix_minus"] == before[0] + 1
        assert dict(kbuild.plain_calls) == before[1]
        want_out, want_lv = mixer.mix_minus_many_plain(p_d)
        assert _same(out, want_out) and _same(lv, want_lv)
        cpu_out, cpu_lv = mixer.mix_minus_many(torch.from_numpy(pcm))
        assert _same(out, cpu_out) and _same(lv, cpu_lv)
        if pcm is loud:
            assert (out.cpu() == 32767).all()


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
def test_g711_kernels_match_plain_exhaustively(cuda_device, law):
    pcm = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    before = dict(kbuild.launches)
    enc = g711.encode(pcm.to(cuda_device), law)
    dec = g711.decode(codes.to(cuda_device), law)
    torch.cuda.synchronize()
    assert kbuild.launches["g711_encode"] == before["g711_encode"] + 1
    assert kbuild.launches["g711_decode"] == before["g711_decode"] + 1
    assert _same(enc, g711.encode(pcm, law))
    assert _same(dec, g711.decode(codes, law))


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
def test_g711_decode_kernel_tails_and_misaligned_views(cuda_device, law):
    """Kernel G on every code at lengths around its 8-code step and with
    codes off an 8-byte or out off a 16-byte boundary (its one-code
    path), against the plain version, writing nothing outside out[:n]."""
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).repeat(40)
    for n in (1, 7, 8, 9, 15, 16, 17, 10240):
        want = g711.decode(every[:n], law)
        for c_off, o_off in ((0, 0), (0, 1), (1, 0), (3, 5)):
            cbuf = torch.zeros(n + 32, dtype=torch.uint8, device=cuda_device)
            obuf = torch.full((n + 32,), -7, dtype=torch.int16,
                              device=cuda_device)
            cbuf[c_off:c_off + n] = every[:n].to(cuda_device)
            before = kbuild.launches["g711_decode"]
            rc = kbuild.library().ljt_g711_decode(
                cbuf[c_off:].data_ptr(), obuf[o_off:].data_ptr(), n, law,
                kbuild.stream_handle(cuda_device))
            assert rc == 0
            got = g711.decode(cbuf[c_off:c_off + n], law)
            torch.cuda.synchronize()
            assert kbuild.launches["g711_decode"] == before + 1
            assert _same(got, want)
            host = obuf.cpu()
            assert torch.equal(host[o_off:o_off + n], want)
            assert (host[:o_off] == -7).all() and (host[o_off + n:] == -7
                                                   ).all()


@pytest.mark.parametrize("law", [g711.ULAW, g711.ALAW])
@pytest.mark.parametrize("offset,n", [(0, 65533), (1, 65536), (3, 40961)])
def test_g711_encode_kernel_ragged_and_odd_offset(cuda_device, law, offset,
                                                  n):
    """Kernel F at a length that is not a multiple of 8 and on views at
    odd offsets (its one-sample path), against the plain version."""
    pcm = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)[:n]
    flat = torch.zeros(n + 8, dtype=torch.int16, device=cuda_device)
    view = flat[offset:offset + n]
    view.copy_(pcm)
    before = kbuild.launches["g711_encode"]
    got = g711.encode(view, law)
    torch.cuda.synchronize()
    assert kbuild.launches["g711_encode"] == before + 1
    assert _same(got, g711.encode(pcm, law))
    assert _same(got, g711.ulaw_encode_plain(view) if law == g711.ULAW
                 else g711.alaw_encode_plain(view))


# (key bytes, packets, width, receivers of each packet): P = 1 and N = 1,
# ragged receiver counts with a packet routed nowhere, an unaligned
# width, the widest class, the SFU tick's 1,100 packets x 10 legs, the
# 275 x 10 of one burst's launch, and one copy at the wrappers' widest
# row (a tile's rows shrink to fit the shared memory)
@pytest.mark.parametrize("key_len,p,width,counts", [
    (16, 1, 64, [1]), (16, 5, 208, [3, 0, 10, 1, 4]),
    (32, 4, 37, [2, 2, 5, 1]), (16, 3, 1536, [4, 1, 2]),
    (16, 1100, 208, [10] * 1100), (16, 275, 192, [10] * 275),
    (16, 1, 32768, [1]),
])
def test_fanout_kernel_matches_plain(cuda_device, key_len, p, width, counts):
    rng = np.random.default_rng(p * width + key_len)
    s = 1100
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
    off[2::5] = width + 3
    ssrc = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    index[:3] = [0xFFFF, 0x10000, (1 << 48) - 1][:p]
    src = np.repeat(np.arange(p), counts).astype(np.int32)
    recv = rng.integers(-1, s + 1, len(src)).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device) for x in
            (tab_rk, tab_mid, tab_salt, data, length, off, ssrc, index, src,
             recv)]
    before = kbuild.launches["srtp_fanout_cm"]
    got = srtp_kernel.srtp_fanout_protect(*args, 10)
    torch.cuda.synchronize()
    assert kbuild.launches["srtp_fanout_cm"] == before + 1
    want = srtp_kernel.srtp_fanout_protect_plain(*args, 10)
    assert all(_same(a, b) for a, b in zip(got, want))


# H's NULL and F8 instances at the CM cases' shapes (F8: every leg's k_e
# XOR m schedule and packet IVs with counters near 2^32 in bytes 12-15)
@pytest.mark.parametrize("cipher", ["null", "f8"])
@pytest.mark.parametrize("key_len,p,width,counts", [
    (16, 1, 64, [1]), (16, 5, 208, [3, 0, 10, 1, 4]),
    (32, 4, 37, [2, 2, 5, 1]), (16, 1100, 208, [10] * 1100),
    (16, 275, 192, [10] * 275), (16, 1, 32768, [1]),
])
def test_fanout_null_and_f8_kernels_match_plain(cuda_device, cipher,
                                                key_len, p, width, counts):
    rng = np.random.default_rng(p * width + key_len + len(cipher))
    s = 1100
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, key_len), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    data = rng.integers(0, 256, (p, width), np.uint8)
    length = rng.integers(12, width + 3, p).astype(np.int32)
    length[:2] = [width - 10, width][:p]
    off = np.full(p, 12, np.int32)
    off[1::3] = 20
    off[2::5] = width + 3
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    iv = rng.integers(0, 256, (p, 16), np.uint8)
    iv[:2, 12:] = 0xFF
    src = np.repeat(np.arange(p), counts).astype(np.int32)
    recv = rng.integers(-1, s + 1, len(src)).astype(np.int32)
    d = [torch.from_numpy(x).to(cuda_device) for x in
         (tab_rk, tab_mid, data, length, off, index, src, recv, tab_f8, iv)]
    f8 = cipher == "f8"
    args = d[:2] + [None] + d[2:5] + [None] + d[5:8]
    extra = (cipher, d[8] if f8 else None, d[9] if f8 else None)
    name = f"srtp_fanout_{cipher}"
    before = kbuild.launches[name]
    got = srtp_kernel.srtp_fanout_protect(*args, 10, *extra)
    torch.cuda.synchronize()
    assert kbuild.launches[name] == before + 1
    want = srtp_kernel.srtp_fanout_protect_plain(*args, 10, *extra)
    assert all(_same(a, b) for a, b in zip(got, want))


# (key bytes, tag bytes, width, rows): one row, a ragged few, an unaligned
# width, the widest class, every SFU sender's 1,100 rows, the 275 of one
# RR burst's launch of J, and one row at the wrappers' widest
@pytest.mark.parametrize("key_len,tag_len,width,n", [
    (16, 10, 96, 1), (16, 4, 200, 9), (32, 10, 61, 6), (16, 10, 1536, 5),
    (16, 10, 224, 1100), (16, 10, 224, 275), (16, 10, 32768, 1),
])
def test_srtcp_kernels_match_plain(cuda_device, key_len, tag_len, width, n):
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
    d = [torch.from_numpy(x).to(cuda_device) for x in
         (tab_rk, tab_mid, stream, data, length, iv, word)]
    before = dict(kbuild.launches)
    out, out_len = srtp_kernel.srtcp_protect(*d, tag_len)
    want = srtp_kernel.srtcp_protect_plain(*d, tag_len)
    assert _same(out, want[0]) and _same(out_len, want[1])
    wire = out.cpu().numpy().copy()
    wlen = np.minimum(out_len.cpu().numpy(), width).astype(np.int32)
    fits = length + 4 + tag_len <= width
    if n > 1:
        wlen[-1] = rng.integers(0, 4 + tag_len)    # mlen below 0
        fits[-1] = False
    forged = np.nonzero(fits)[0][1::3]
    wire[forged, wlen[forged] - 1] ^= 0x10          # forged tags
    u = d[:3] + [torch.from_numpy(x).to(cuda_device)
                 for x in (wire, wlen, iv)]
    got = srtp_kernel.srtcp_unprotect(*u, tag_len)
    torch.cuda.synchronize()
    assert kbuild.launches["srtcp_protect_cm"] == \
        before["srtcp_protect_cm"] + 1
    assert kbuild.launches["srtcp_unprotect_cm"] == \
        before["srtcp_unprotect_cm"] + 1
    want = srtp_kernel.srtcp_unprotect_plain(*u, tag_len)
    assert all(_same(a, b) for a, b in zip(got, want))
    ok = got[2].cpu().numpy()
    genuine = fits.copy()
    genuine[forged] = False
    assert ok[genuine].all() and not ok[forged].any()


def test_sfu_bridge_on_card_equals_cpu(cuda_device):
    """A small SFU conference driven on the card and on the CPU sends the
    same datagrams; on the card it runs D, H, I and J, no plain version."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.rtp import rtcp
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    rng = np.random.default_rng(77)
    n = 6
    ssrc = 0x4000 + np.arange(n)
    rx_k = rng.integers(0, 256, (n, 16), np.uint8)
    rx_s = rng.integers(0, 256, (n, 14), np.uint8)
    tx_k = rng.integers(0, 256, (n, 16), np.uint8)
    tx_s = rng.integers(0, 256, (n, 14), np.uint8)
    up = SrtpStreamTable(n, device=cuda_device)
    up.add_streams(np.arange(n), rx_k, rx_s)
    wires = []
    for t in range(3):
        b = rtp_header.build([bytes(rng.integers(0, 256, 80, np.uint8))
                              for _ in range(n)], [100 + t] * n, [0] * n,
                             ssrc.tolist(), [111] * n, stream=list(range(n)))
        wires.append(up.protect_rtp(b))
    nack = up.protect_rtcp(PacketBatch.from_payloads([rtcp.build_compound([
        rtcp.build_nack(rtcp.Nack(int(ssrc[1]), int(ssrc[0]), [100]))])],
        stream=[1]))
    sent = {}
    for dev in (cuda_device, torch.device("cpu")):
        sfu = SfuBridge(capacity=8, recv_window_ms=0, device=dev)
        sfu.stage_endpoints([(int(ssrc[k]), (rx_k[k].tobytes(),
                                             rx_s[k].tobytes()),
                              (tx_k[k].tobytes(), tx_s[k].tobytes()), None)
                             for k in range(n)], conferences=[0, 0, 0, 1, 1,
                                                              1])
        sfu.commit_endpoints(range(n))
        out = sent[dev.type] = []
        eng = sfu.loop.engine
        orig = eng.send_batch
        eng.send_batch = lambda b, ip, port: (
            out.extend(b.to_bytes(i) for i in range(b.batch_size)),
            orig(b, ip, port))[1]
        kbuild.reset_counts()
        with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=64) as client:
            for t, w in enumerate(wires):
                client.send_batch(w, "127.0.0.1", sfu.port)
                if t == 2:
                    client.send_batch(nack, "127.0.0.1", sfu.port)
                for _ in range(4):
                    sfu.tick(now=5.0 + 0.02 * t)
            sfu.emit_feedback(now=5.1)
        if dev.type == "cuda":
            for k in ("srtp_unprotect_cm", "srtp_fanout_cm",
                      "srtcp_protect_cm", "srtcp_unprotect_cm"):
                assert kbuild.launches[k] > 0, k
            assert sum(kbuild.plain_calls.values()) == 0
        assert sfu.forwarded == 3 * n * 2 and sfu.retransmitted == 1
        sfu.close()
    assert sent["cuda"] == sent["cpu"]


# Kernel I's tile edges at the SFU path's shapes: every sender's 1,100
# RTCP rows, the setup's 1,100 32-byte RRs in 1,504-byte rows, an
# unaligned width with AES-256, and 32,768-byte rows; each tile holds rows
# whose word and tag fit, are cut at the width or lie past it, E = 0
# beside E = 1, and stream ids outside the table.
@pytest.mark.parametrize("key_len,tag_len,width,n", [
    (16, 10, 224, 1100), (16, 10, 1504, 1100), (32, 4, 61, 33),
    (16, 10, 32768, 9),
])
def test_srtcp_protect_kernel_tile_edges(cuda_device, key_len, tag_len,
                                         width, n):
    rng = np.random.default_rng(width + n + tag_len)
    s = 5
    auth_keys = rng.integers(0, 256, (s, 20), np.uint8)
    tab_rk = aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                np.uint8))
    tab_mid = sha1.hmac_precompute_batch(auth_keys).view(np.int32)
    stream = rng.integers(0, s, n).astype(np.int32)
    stream[1::4] = np.resize([-3, s, s + 7, -1], len(stream[1::4]))
    data = rng.integers(0, 256, (n, width), np.uint8)
    fit = width - 4 - tag_len
    edges = [fit, fit + 1, width - 4, width - 2, width, width + 3, 0, 7, 8,
             9, fit - 16, fit - 17]
    length = np.resize(np.array(edges, np.int32), n)
    if width == 1504:
        length[12:] = 32                          # the setup's RRs
    iv = rng.integers(0, 256, (n, 16), np.uint8)
    iv[::3, 12:] = 0xFF
    e_bit = (np.arange(n) % 3 != 1).astype(np.uint64)
    word = (rng.integers(0, 2 ** 31, n, dtype=np.uint64)
            | e_bit << np.uint64(31)).astype(np.uint32).view(np.int32)
    d = [torch.from_numpy(x).to(cuda_device) for x in
         (tab_rk, tab_mid, stream, data, length, iv, word)]
    before = kbuild.launches["srtcp_protect_cm"]
    out, out_len = srtp_kernel.srtcp_protect(*d, tag_len)
    torch.cuda.synchronize()
    assert kbuild.launches["srtcp_protect_cm"] == before + 1
    want = srtp_kernel.srtcp_protect_plain(*d, tag_len)
    assert _same(out, want[0]) and _same(out_len, want[1])
    out = out.cpu().numpy()
    for i in range(min(n, 40)):
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


def _edge_lengths(n, hdr, tag_len, width, rng, trailer=0):
    """Production-mix lengths with the edge rows first: length 0, shorter
    than header + tag, an empty keystream window, exactly one keystream
    block, and the longest row that fits the width."""
    lens = hdr + np.array([100, 400, 950])[rng.integers(0, 3, n)]
    lens[:5] = [0, hdr + tag_len - 1, hdr, hdr + 16,
                width - tag_len - trailer]
    return np.minimum(lens, width - tag_len - trailer).astype(np.int32)


@pytest.mark.parametrize("plane,cipher,key_len,n,width,off,sizes", [
    ("srtp", "f8", 16, 4096, 1536, 12, "mix"),  # a mix batch's rows, one launch
    ("srtp", "f8", 32, 4095, 1536, 13, "mix"),  # odd rows, windows off a word
    ("srtp", "f8", 16, 1024, 1536, 12, "mix"),  # the batch's long launch
    ("srtp", "f8", 32, 1024, 1536, 12, "mix"),  # the same under AES-256
    ("srtp", "null", 16, 4096, 1536, 12, "mix"),
    ("srtcp", "f8", 16, 1100, 1536, 8, "mix"),
    ("srtcp", "null", 16, 1100, 1536, 8, "mix"),
    # I-NULL's and J-NULL's launches on the paths: srtp_profiles' 1,100
    # compound packets, an RR burst's 275 (J on the sfu path) and the SFU
    # set-up's 1,100 32-byte RRs (I on it), under both key lengths
    ("srtcp", "null", 16, 1100, 1504, 8, "rtcp"),
    ("srtcp", "null", 32, 1100, 1504, 8, "rtcp"),
    ("srtcp", "null", 16, 275, 1504, 8, "rtcp"),
    ("srtcp", "null", 32, 275, 1504, 8, "rtcp"),
    ("srtcp", "null", 16, 1100, 1504, 8, "rr"),
    ("srtcp", "null", 32, 1100, 1504, 8, "rr"),
])
def test_f8_and_null_kernels_match_plain(cuda_device, plane, cipher, key_len,
                                         n, width, off, sizes):
    """K, L and the F8 and NULL instances of C, D, I and J against their
    plain versions on the card, a tampered row beside genuine ones; the
    packets a production mix's, or compound RTCP's 60-200 bytes, or
    32-byte RRs, the edge rows first."""
    rng = np.random.default_rng(n + key_len + off)
    s, tag_len = 10240, 10
    d = cuda_device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(d)

    tab_rk = t(aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                  np.uint8)))
    tab_f8 = t(aes.expand_keys_batch(rng.integers(0, 256, (s, key_len),
                                                  np.uint8)))
    f8 = tab_f8 if cipher == "f8" else None
    tab_mid = t(sha1.hmac_precompute_batch(rng.integers(
        0, 256, (s, 20), np.uint8)).view(np.int32))
    stream = t(rng.integers(0, s, n).astype(np.int32))
    lens = _edge_lengths(n, off, tag_len, width, rng,
                         0 if plane == "srtp" else 4)
    if sizes != "mix":
        lens[5:] = (rng.integers(60, 201, n - 5) if sizes == "rtcp"
                    else 32)
    data = t(rng.integers(0, 256, (n, width), np.uint8))
    iv = t(rng.integers(0, 256, (n, 16), np.uint8))
    name = f"{plane}_protect_{cipher}"
    before = kbuild.launches[name]
    if plane == "srtp":
        roc = t(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))
        args = [tab_rk, tab_mid, stream, data, t(lens),
                t(np.full(n, off, np.int32)), iv, roc]
        got = srtp_kernel.srtp_protect(*args, tag_len, cipher, f8)
        want = srtp_kernel.srtp_protect_plain(*args, tag_len, cipher, f8)
    else:
        e = 0 if cipher == "null" else 1 << 31
        word = t((rng.integers(0, 2 ** 31, n) | e).astype(np.uint32)
                 .view(np.int32))
        args = [tab_rk, tab_mid, stream, data, t(lens), iv, word]
        got = srtp_kernel.srtcp_protect(*args, tag_len, cipher, f8)
        want = srtp_kernel.srtcp_protect_plain(*args, tag_len, cipher, f8)
    torch.cuda.synchronize()
    assert kbuild.launches[name] == before + 1
    assert all(_same(a, b) for a, b in zip(got, want))
    wire = got[0].clone()
    wire[7, 3] ^= 1
    wlen = got[1].clamp(max=width)
    if plane == "srtp":
        uargs = args[:3] + [wire, wlen] + args[5:]
        got = srtp_kernel.srtp_unprotect(*uargs, tag_len, cipher, f8)
        want = srtp_kernel.srtp_unprotect_plain(*uargs, tag_len, cipher, f8)
    else:
        uargs = args[:3] + [wire, wlen, iv]
        got = srtp_kernel.srtcp_unprotect(*uargs, tag_len, cipher, f8)
        want = srtp_kernel.srtcp_unprotect_plain(*uargs, tag_len, cipher,
                                                 f8)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))
    ok = got[2].cpu().numpy()
    genuine = lens + tag_len >= off + tag_len
    genuine[[0, 1, 7]] = False
    assert ok[genuine].all() and not ok[7]
    dec = got[0].cpu().numpy()
    raw = data.cpu().numpy()
    for i in np.nonzero(genuine)[0][:64]:
        assert np.array_equal(dec[i, :lens[i]], raw[i, :lens[i]])


@pytest.mark.parametrize("profile,kdr", [
    (SrtpProfile.F8_128_HMAC_SHA1_80, 0),
    (SrtpProfile.NULL_HMAC_SHA1_80, 0),
    (SrtpProfile.AES_CM_128_HMAC_SHA1_80, 4),
])
def test_profile_tables_on_card_equal_cpu_sync_and_async(cuda_device,
                                                         profile, kdr):
    """F8, NULL and kdr tables on the card and on the CPU: the same wire
    bytes, verdicts and state through the sync calls and through a depth-2
    pipeline of the async ones (dispatch n + 1, then n's result), SRTCP
    too; a key install while a protect is pending leaves it on the old
    keys."""
    rng = np.random.default_rng(17)
    s, n = 64, 128
    mks = rng.integers(0, 256, (s, 16), np.uint8)
    mss = rng.integers(0, 256, (s, 14), np.uint8)

    def batch(k):
        streams = np.arange(n) % s
        lens = np.array([100, 400, 950])[rng.integers(0, 3, n)]
        pls = [rng.integers(0, 256, x, np.uint8).tobytes() for x in lens]
        seq = (65530 + 4 * k + np.arange(n) // s) % 65536
        return rtp_header.build(pls, seq.tolist(), [0] * n,
                                (0x7000 + streams).tolist(), [96] * n,
                                stream=streams.tolist())

    batches = [batch(k) for k in range(3)]
    outs = {}
    for dev in ("cpu", cuda_device):
        tx, rx, tx2, rx2 = (SrtpStreamTable(s, profile, device=dev)
                            for _ in range(4))
        for tab in (tx, rx, tx2, rx2):
            tab.add_streams(np.arange(s), mks, mss, kdr=kdr)
        sync = [rx.unprotect_rtp(tx.protect_rtp(b.copy())) for b in batches]
        pend_tx = [tx2.protect_rtp_async(b.copy()) for b in batches]
        tx2.add_stream(0, bytes(16), bytes(14))  # after the dispatches
        wires = [p.result() for p in pend_tx]
        pend, asyn = [rx2.unprotect_rtp_async(wires[0])], []
        for w in wires[1:]:
            pend.append(rx2.unprotect_rtp_async(w))
            asyn.append(pend[-2].result())
        asyn.append(pend[-1].result())
        rr = bytes([0x80, 201, 0, 1]) + (0x7000).to_bytes(4, "big")
        rtcp = tx.protect_rtcp(PacketBatch.from_payloads([rr] * s,
                                                         stream=list(range(s))))
        rtcp_dec = rx.unprotect_rtcp(rtcp)
        outs[str(dev)] = (sync, wires, asyn, rtcp, rtcp_dec,
                          rx.snapshot(), rx2.snapshot())
    a, b = outs["cpu"], outs[str(cuda_device)]
    for (da, oka), (db, okb), (ea, okea) in zip(a[0], b[0], b[2]):
        assert np.array_equal(oka, okb) and oka.all()
        assert np.array_equal(da.data, db.data)
        assert np.array_equal(okb, okea) and np.array_equal(db.data, ea.data)
    for wa, wb in zip(a[1], b[1]):
        assert np.array_equal(wa.data, wb.data)
    assert np.array_equal(a[3].data, b[3].data)
    assert a[4][1].all() and np.array_equal(a[4][0].data, b[4][0].data)
    for snap_a, snap_b in ((a[5], b[5]), (a[6], b[6])):
        for k, v in snap_a.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, snap_b[k]), k
    for k in ("rx_max", "rx_mask", "auth_fail", "replay_reject",
              "epoch_rtp"):              # sync and async rx: one state
        assert np.array_equal(b[5][k], b[6][k]), k


# ------------------------------------------------------- AEAD-GCM: M, N, O

def _gcm_case(rng, n, width, s=7, full=False):
    """Tables of s streams and n rows: AADs of 8, 12, 13, 28 and 60 bytes,
    ct_len 0 and one short of a block, lengths past the row and shorter
    than the AAD, stream ids outside the table; with `full`, every other
    row fills the row with its tag (length width - 16)."""
    from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

    rk = aes.expand_keys_batch(rng.integers(0, 256, (s, 16), np.uint8))
    gm = ghash_tables(rk).view(np.int32)
    data = rng.integers(0, 256, (n, width), np.uint8)
    aad = rng.choice([8, 12, 13, 28, 60], n).astype(np.int32)
    length = np.minimum(aad + rng.integers(0, width, n),
                        width - 16).astype(np.int32)
    if full:
        length[:] = width - 16
    for i, (a, c) in enumerate([(12, 0), (13, 15), (60, 1), (8, width),
                                (12, -5)][:n]):
        aad[i], length[i] = a, a + c
    stream = rng.integers(0, s, n).astype(np.int32)
    stream[:2] = [-1, s + 3][:n]
    iv12 = rng.integers(0, 256, (n, 12), np.uint8)
    return rk, gm, stream, data, length, aad, iv12


@pytest.mark.parametrize("n,width,full", [
    (1, 64, False), (4096, 1024, False), (300, 61, False), (33, 8192, False),
    ("tiles_plus_one", 64, False), (1024, 1536, True)])
def test_gcm_kernels_match_plain(cuda_device, n, width, full):
    """M and N against their plain versions (a tampered row beside genuine
    ones), and the cached instances on the same rows.  Beside ragged
    counts: one row; every tile of the plan full (32 rows, two a
    multiprocessor) and one row more; 1,024 rows that fill their width
    (the mix batch's widest launch)."""
    if n == "tiles_plus_one":
        sms = torch.cuda.get_device_properties(cuda_device)
        n = 32 * 2 * sms.multi_processor_count + 1
    rng = np.random.default_rng(n + width + 16)
    case = _gcm_case(rng, n, width, full=full)
    d = [torch.from_numpy(x).to(cuda_device) for x in case]
    before = dict(kbuild.launches)
    out, out_len = srtp_kernel.srtp_gcm_protect(*d)
    want, want_len = srtp_kernel.srtp_gcm_protect_plain(*d)
    assert _same(out, want) and _same(out_len, want_len)
    sealed = out.clone()
    sealed[n // 2, 0] ^= 1
    slen = out_len.clamp(max=width)
    res = srtp_kernel.srtp_gcm_unprotect(*d[:3], sealed, slen, d[5], d[6])
    w_res = srtp_kernel.srtp_gcm_unprotect_plain(*d[:3], sealed, slen, d[5],
                                                 d[6])
    assert all(_same(a, b) for a, b in zip(res, w_res))
    assert not bool(res[2][n // 2])
    n_slots, ks_bytes = 97, 256
    ks = torch.randint(0, 256, (n_slots, ks_bytes), dtype=torch.uint8,
                       device=cuda_device)
    ek = torch.randint(0, 256, (n_slots, 16), dtype=torch.uint8,
                       device=cuda_device)
    slot = torch.randint(-2, n_slots + 2, (n,), dtype=torch.int32,
                         device=cuda_device)
    c_args = (ks, ek, slot, d[1], d[2])
    got = srtp_kernel.srtp_gcm_protect_cached(*c_args, d[3], d[4], d[5])
    exp = srtp_kernel.srtp_gcm_protect_cached_plain(*c_args, d[3], d[4],
                                                    d[5])
    assert all(_same(a, b) for a, b in zip(got, exp))
    got = srtp_kernel.srtp_gcm_unprotect_cached(*c_args, sealed, slen, d[5])
    exp = srtp_kernel.srtp_gcm_unprotect_cached_plain(*c_args, sealed, slen,
                                                      d[5])
    assert all(_same(a, b) for a, b in zip(got, exp))
    torch.cuda.synchronize()
    for name in ("srtp_gcm_seal", "srtp_gcm_open", "srtp_gcm_seal_cached",
                 "srtp_gcm_open_cached"):
        assert kbuild.launches[name] == before[name] + 1


def test_gcm_wrappers_refuse_aes256(cuda_device):
    """The GCM kernels are AES-128 only: a table of 15-round keys is
    refused before any launch."""
    rng = np.random.default_rng(9)
    case = list(_gcm_case(rng, 4, 96))
    case[0] = aes.expand_keys_batch(rng.integers(0, 256, (7, 32), np.uint8))
    d = [torch.from_numpy(x).to(cuda_device) for x in case]
    before = dict(kbuild.launches)
    with pytest.raises(ValueError):
        srtp_kernel.srtp_gcm_protect(*d)
    with pytest.raises(ValueError):
        srtp_kernel.srtp_gcm_unprotect(*d)
    assert dict(kbuild.launches) == before


def test_gcm_kernel_rfc7714_known_answer(cuda_device):
    """RFC 7714 §16.1.1 through M, back through N, and a tampered tag
    refused."""
    from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    salt = bytes.fromhex("517569642070726f2071756f")
    pkt = bytes.fromhex("8040f17b8041f8d35501a0b247616c6c"
                        "696120657374206f6d6e697320646976"
                        "69736120696e207061727465732074726573")
    want = bytes.fromhex("8040f17b8041f8d35501a0b2f24de3a3"
                         "fb34de6cacba861c9d7e4bcabe633bd5"
                         "0d294e6f42a5f47a51c7d19b36de3adf"
                         "8833899d7f27beb16a9152cf765ee439"
                         "0cce")
    from libjitsi_tpu_torch.kernels import gcm

    iv = gcm.srtp_gcm_iv(np.frombuffer(salt, np.uint8)[None],
                         [int.from_bytes(pkt[8:12], "big")],
                         [int.from_bytes(pkt[2:4], "big")])
    rk = aes.expand_key(key)[None].copy()
    data = np.zeros((2, 128), np.uint8)
    data[:, :len(pkt)] = np.frombuffer(pkt, np.uint8)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)

    tabs = (dev(rk), dev(ghash_tables(rk).view(np.int32)),
            dev(np.zeros(2, np.int32)))
    n = np.full(2, len(pkt), np.int32)
    out, out_len = srtp_kernel.srtp_gcm_protect(
        *tabs, dev(data), dev(n), dev(np.full(2, 12, np.int32)),
        dev(np.repeat(iv, 2, axis=0)))
    assert bytes(out.cpu().numpy()[0, :int(out_len[0])]) == want
    wire = out.clone()
    wire[1, len(want) - 1] ^= 0x80
    dec, mlen, ok = srtp_kernel.srtp_gcm_unprotect(
        *tabs, wire, out_len, dev(np.full(2, 12, np.int32)),
        dev(np.repeat(iv, 2, axis=0)))
    assert ok.cpu().tolist() == [True, False]
    assert bytes(dec.cpu().numpy()[0, :int(mlen[0])]) == pkt


@pytest.mark.parametrize("p,legs,width", [(275, 10, 224), (128, 512, 192)])
def test_fanout_gcm_kernel_matches_plain(cuda_device, p, legs, width):
    from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

    rng = np.random.default_rng(p + legs)
    rk = aes.expand_keys_batch(rng.integers(0, 256, (legs, 16), np.uint8))
    salt = rng.integers(0, 256, (legs, 16), np.uint8)
    salt[:, 12:] = 0
    data = rng.integers(0, 256, (p, width), np.uint8)
    length = rng.integers(60, width - 16, p).astype(np.int32)
    off = np.full(p, 12, np.int32)
    off[::7] = 20
    ssrc = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    index = rng.integers(0, 2 ** 48, p, dtype=np.int64)
    src = np.repeat(np.arange(p), legs).astype(np.int32)
    recv = np.tile(np.arange(legs), p).astype(np.int32)
    d = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in
         (rk, ghash_tables(rk).view(np.int32), salt, data, length, off, ssrc,
          index, src, recv)]
    got = srtp_kernel.srtp_fanout_gcm(*d)
    exp = srtp_kernel.srtp_fanout_gcm_plain(*d)
    assert all(_same(a, b) for a, b in zip(got, exp))


@pytest.mark.parametrize("n,ks_bytes", [(65536, 256), (70, 48)])
def test_gcm_fill_kernel_matches_plain(cuda_device, n, ks_bytes):
    from libjitsi_tpu_torch.kernels import gcm

    rng = np.random.default_rng(n)
    rk = torch.from_numpy(aes.expand_keys_batch(
        rng.integers(0, 256, (1024, 16), np.uint8))).to(cuda_device)
    n_slots = n + 1
    stream = torch.from_numpy(rng.integers(0, 1024, n).astype(
        np.int32)).to(cuda_device)
    iv12 = torch.from_numpy(rng.integers(0, 256, (n, 12), np.uint8)).to(
        cuda_device)
    slot = torch.from_numpy(rng.permutation(n_slots)[:n].astype(
        np.int32)).to(cuda_device)
    ks = torch.zeros((n_slots, ks_bytes), dtype=torch.uint8,
                     device=cuda_device)
    ek = torch.zeros((n_slots, 16), dtype=torch.uint8, device=cuda_device)
    ks2, ek2 = ks.clone(), ek.clone()
    gcm.gcm_ks_fill(ks, ek, rk, stream, iv12, slot)
    gcm.gcm_ks_fill_plain(ks2, ek2, rk, stream, iv12, slot)
    assert _same(ks, ks2) and _same(ek, ek2)


# Kernel O's runs and edges on the card (the emulator's cases,
# `test_torch_cuda_emu.py`, at the card's plan): runs crossing tiles of
# 64 slots, all-distinct and alternating streams, windows of 64 with a
# partial last one, one slot, an odd count, the fill's 65,536 slots in
# windows; ids past the table clamped and slots outside it skipped.
@pytest.mark.parametrize("case,n,ks_bytes", [
    ("runs", 300, 256), ("distinct", 1000, 48), ("alternating", 96, 16),
    ("windows", 64 * 3 + 17, 256), ("one", 1, 1024), ("odd", 77, 1024),
    ("windows", 65536, 256),
])
def test_gcm_fill_kernel_runs_and_edges(cuda_device, case, n, ks_bytes):
    from libjitsi_tpu_torch.kernels import gcm

    rng = np.random.default_rng(n + ks_bytes)
    s = 1024
    rk = aes.expand_keys_batch(rng.integers(0, 256, (s, 16), np.uint8))
    stream = {"runs": lambda: np.repeat([5, 9, 5, 77], [100, 37, 64, 99]),
              "distinct": lambda: rng.permutation(s)[:n],
              "alternating": lambda: np.tile([3, 4], n // 2),
              "windows": lambda: np.repeat(rng.permutation(s),
                                           64)[:n],
              "one": lambda: np.array([7]),
              "odd": lambda: np.repeat(rng.integers(0, s, n),
                                       rng.integers(1, 12, n))[:n]}[case]()
    stream = stream.astype(np.int32)
    n_slots = n + 9
    slot = rng.permutation(n_slots)[:n].astype(np.int32)
    slot[0] = n_slots + 3
    if n > 4:
        stream[n // 3], stream[n // 2] = s + 5, -3
        slot[n // 4] = -1
    d = [torch.from_numpy(x).to(cuda_device) for x in
         (rk, stream, rng.integers(0, 256, (n, 12), np.uint8), slot)]
    ks = torch.from_numpy(rng.integers(0, 256, (n_slots, ks_bytes),
                                       np.uint8)).to(cuda_device)
    ek = torch.from_numpy(rng.integers(0, 256, (n_slots, 16),
                                       np.uint8)).to(cuda_device)
    ks2, ek2 = ks.clone(), ek.clone()
    gcm.gcm_ks_fill(ks, ek, *d)
    gcm.gcm_ks_fill_plain(ks2, ek2, *d)
    assert _same(ks, ks2) and _same(ek, ek2)


def test_fill_and_f8_phase_probes_match_shipped(cuda_device):
    """The phase probes of O and H-F8 (`ljt_gcm_ks_fill_phases`,
    `ljt_srtp_fanout_f8_phases`) write what the shipped kernels write."""
    from libjitsi_tpu_torch.kernels import gcm

    rng = np.random.default_rng(3)
    lib = kbuild.library()
    stream_h = kbuild.stream_handle(cuda_device)
    n, ks_bytes = 4096, 256
    rk = torch.from_numpy(aes.expand_keys_batch(
        rng.integers(0, 256, (256, 16), np.uint8))).to(cuda_device)
    st = torch.from_numpy(np.repeat(rng.permutation(256)[:n // 64], 64)
                          .astype(np.int32)).to(cuda_device)
    iv12 = torch.from_numpy(rng.integers(0, 256, (n, 12), np.uint8)).to(
        cuda_device)
    slot = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(
        cuda_device)
    ks = torch.zeros((n, ks_bytes), dtype=torch.uint8, device=cuda_device)
    ek = torch.zeros((n, 16), dtype=torch.uint8, device=cuda_device)
    pks, pek = ks.clone(), ek.clone()
    gcm.gcm_ks_fill(ks, ek, rk, st, iv12, slot)
    stamps = torch.zeros((n, 24), dtype=torch.int64, device=cuda_device)
    plan = np.zeros(4, np.int32)
    assert lib.ljt_gcm_ks_fill_phases(
        rk.data_ptr(), 256, st.data_ptr(), iv12.data_ptr(), slot.data_ptr(),
        pks.data_ptr(), pek.data_ptr(), stamps.data_ptr(), plan.ctypes.data,
        n, n, ks_bytes, stream_h) == 0
    torch.cuda.synchronize()
    assert _same(pks, ks) and _same(pek, ek) and plan[3] == n // 64
    p, legs, width, s = 275, 10, 192, 1100
    tab_rk, tab_f8 = (torch.from_numpy(aes.expand_keys_batch(
        rng.integers(0, 256, (s, 16), np.uint8))).to(cuda_device)
        for _ in range(2))
    tab_mid = torch.from_numpy(sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)).to(
            cuda_device)
    h = [torch.from_numpy(x).to(cuda_device) for x in (
        rng.integers(0, 256, (p, width), np.uint8),
        rng.integers(80, 181, p).astype(np.int32), np.full(p, 20, np.int32),
        rng.integers(0, 256, (p, 16), np.uint8),
        rng.integers(0, 2 ** 48, p, dtype=np.int64),
        np.repeat(np.arange(p), legs).astype(np.int32),
        rng.integers(0, s, p * legs).astype(np.int32))]
    data, length, off, iv, index, src, recv = h
    got = srtp_kernel.srtp_fanout_protect(
        tab_rk, tab_mid, None, data, length, off, None, index, src, recv, 10,
        "f8", tab_f8, iv)
    n = p * legs
    out = torch.empty((n, width), dtype=torch.uint8, device=cuda_device)
    out_len = torch.empty((n,), dtype=torch.int32, device=cuda_device)
    f8_stamps = torch.zeros((n, 40), dtype=torch.int64, device=cuda_device)
    f8_plan = np.zeros(3, np.int32)
    assert lib.ljt_srtp_fanout_f8_phases(
        tab_rk.data_ptr(), tab_f8.data_ptr(), tab_mid.data_ptr(), s,
        data.data_ptr(), length.data_ptr(), off.data_ptr(), iv.data_ptr(),
        index.data_ptr(), p, src.data_ptr(), recv.data_ptr(),
        out.data_ptr(), out_len.data_ptr(), f8_stamps.data_ptr(),
        f8_plan.ctypes.data, n, width, 10, stream_h) == 0
    torch.cuda.synchronize()
    assert _same(out, got[0]) and _same(out_len, got[1])


def test_srtp_f8_phase_probe_matches_shipped(cuda_device):
    """K's and L's phase probe (`ljt_srtp_f8_phases`, the shipped tile with
    clock64 stamps) writes what K and L write at a mix batch's two widths,
    planned as shipped and for 1, 2 and 4 tiles an SM."""
    rng = np.random.default_rng(16)
    s, tag_len = 64, 10
    d = cuda_device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(d)

    tab_rk, tab_f8 = (t(aes.expand_keys_batch(rng.integers(
        0, 256, (s, 16), np.uint8))) for _ in range(2))
    tab_mid = t(sha1.hmac_precompute_batch(rng.integers(
        0, 256, (s, 20), np.uint8)).view(np.int32))
    lib = kbuild.library()
    stream_h = kbuild.stream_handle(d)
    for n, width, plen in ((4096, 224, 100), (1024, 1536, 950)):
        lens = np.full(n, 12 + plen, np.int32)
        args = [tab_rk, tab_mid, t(rng.integers(0, s, n).astype(np.int32)),
                t(rng.integers(0, 256, (n, width), np.uint8)), t(lens),
                t(np.full(n, 12, np.int32)),
                t(rng.integers(0, 256, (n, 16), np.uint8)),
                t(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))]
        kp = srtp_kernel.srtp_protect(*args, tag_len, "f8", tab_f8)
        uargs = args[:3] + [kp[0], kp[1]] + args[5:]
        ku = srtp_kernel.srtp_unprotect(*uargs, tag_len, "f8", tab_f8)
        for unprotect, a, want in ((0, args, kp), (1, uargs, ku)):
            for per_sm in (0, 1, 2, 4):
                out = torch.empty_like(a[3])
                out_len = torch.empty_like(a[4])
                ok = torch.zeros(n, dtype=torch.bool, device=d)
                stamps = torch.zeros((n, 40), dtype=torch.int64, device=d)
                plan = np.zeros(4, np.int32)
                assert lib.ljt_srtp_f8_phases(
                    tab_rk.data_ptr(), tab_f8.data_ptr(),
                    tab_mid.data_ptr(), a[2].data_ptr(), s,
                    *(x.data_ptr() for x in a[3:]), out.data_ptr(),
                    out_len.data_ptr(), ok.data_ptr(), stamps.data_ptr(),
                    plan.ctypes.data, n, width, tag_len, unprotect, per_sm,
                    stream_h) == 0
                torch.cuda.synchronize()
                got = (out, out_len, ok) if unprotect else (out, out_len)
                assert all(_same(x, y) for x, y in zip(got, want))
                assert int(plan[2]) * int(plan[0]) >= n
        assert bool(ku[2].all())


def test_srtcp_null_phase_probe_matches_shipped(cuda_device):
    """I-NULL's and J-NULL's phase probe (`ljt_srtcp_null_phases`: their
    tiles with clock64 stamps, planned as shipped and for 1, 2 and 4
    tiles an SM) writes what I-NULL and J-NULL write at their three
    launches on the paths."""
    rng = np.random.default_rng(18)
    s, tag_len, width = 64, 10, 1504
    d = cuda_device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(d)

    tab_rk = t(aes.expand_keys_batch(rng.integers(0, 256, (s, 16),
                                                  np.uint8)))
    tab_mid = t(sha1.hmac_precompute_batch(rng.integers(
        0, 256, (s, 20), np.uint8)).view(np.int32))
    lib = kbuild.library()
    for n, lo, hi in ((1100, 60, 201), (275, 60, 201), (1100, 32, 33)):
        pa = [tab_rk, tab_mid, t(rng.integers(0, s, n).astype(np.int32)),
              t(rng.integers(0, 256, (n, width), np.uint8)),
              t(rng.integers(lo, hi, n).astype(np.int32)),
              t(rng.integers(0, 256, (n, 16), np.uint8)),
              t(rng.integers(0, 2 ** 31, n).astype(np.int32))]
        kp = srtp_kernel.srtcp_protect(*pa, tag_len, "null")
        ua = pa[:3] + [kp[0], kp[1], pa[5]]
        ku = srtp_kernel.srtcp_unprotect(*ua, tag_len, "null")
        assert bool(ku[2].all())
        for unprotect, a, want in ((0, pa, kp), (1, ua, ku)):
            for per_sm in (0, 1, 2, 4):
                got = [torch.empty_like(a[3]), torch.empty_like(a[4]),
                       torch.zeros(n, dtype=torch.bool, device=d),
                       torch.empty_like(a[4]), torch.empty_like(a[4])]
                stamps = torch.zeros((n, 46), dtype=torch.int64, device=d)
                plan = np.zeros(3, np.int32)
                assert lib.ljt_srtcp_null_phases(
                    tab_mid.data_ptr(), a[2].data_ptr(), s,
                    a[3].data_ptr(), a[4].data_ptr(),
                    None if unprotect else a[6].data_ptr(),
                    *(x.data_ptr() for x in got), stamps.data_ptr(),
                    plan.ctypes.data, n, width, tag_len, unprotect, per_sm,
                    kbuild.stream_handle(d)) == 0
                torch.cuda.synchronize()
                assert all(_same(x, y) for x, y in zip(got, want))
                assert int(plan[1]) * int(plan[0]) >= n
                assert int(stamps[:int(plan[1]), 3].sum()) == n


# H-F8's own tile on the card: MAC messages ending exactly at and inside a
# 64-byte SHA-1 block, a header-only copy, 1,504-byte rows, odd copy
# counts, a single copy, the SFU tick's 1,100 x 10, AES-128 and AES-256
@pytest.mark.parametrize("key_len,lens,counts,width", [
    (16, [60, 124, 100, 20, 208, 150], [10] * 6, 208),
    (32, [1504, 20, 1000], [10, 10, 7], 1504),
    (16, [128], [1], 192),
    (32, None, [10] * 1100, 192),
    (16, None, [10] * 1100, 192),
])
def test_fanout_f8_copies_match_plain(cuda_device, key_len, lens, counts,
                                      width):
    rng = np.random.default_rng(key_len + width + len(counts))
    p, s = len(counts), 1100
    tab_rk, tab_f8 = (aes.expand_keys_batch(
        rng.integers(0, 256, (s, key_len), np.uint8)) for _ in range(2))
    tab_mid = sha1.hmac_precompute_batch(
        rng.integers(0, 256, (s, 20), np.uint8)).view(np.int32)
    length = (np.asarray(lens) if lens is not None
              else rng.integers(80, 181, p)).astype(np.int32)
    iv = rng.integers(0, 256, (p, 16), np.uint8)
    iv[::2, 12:] = 0xFF
    src = np.repeat(np.arange(p), counts).astype(np.int32)
    d = [torch.from_numpy(x).to(cuda_device) for x in (
        tab_rk, tab_mid, rng.integers(0, 256, (p, width), np.uint8), length,
        np.full(p, 20, np.int32), rng.integers(0, 2 ** 48, p,
                                               dtype=np.int64), src,
        rng.integers(0, s, len(src)).astype(np.int32), tab_f8, iv)]
    args = d[:2] + [None] + d[2:5] + [None] + d[5:8]
    before = kbuild.launches["srtp_fanout_f8"]
    got = srtp_kernel.srtp_fanout_protect(*args, 10, "f8", d[8], d[9])
    torch.cuda.synchronize()
    assert kbuild.launches["srtp_fanout_f8"] == before + 1
    want = srtp_kernel.srtp_fanout_protect_plain(*args, 10, "f8", d[8], d[9])
    assert all(_same(a, b) for a, b in zip(got, want))


def test_gcm_table_on_card_equals_table_on_cpu(cuda_device):
    """An AEAD_AES_128_GCM table on the card and one on the CPU, fed the
    same RTP and SRTCP, give the same wire and verdicts; the keystream
    cache's hits give the stock path's bytes."""
    prof = SrtpProfile.AEAD_AES_128_GCM
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 256, (8, 16), np.uint8)
    salts = rng.integers(0, 256, (8, 12), np.uint8)
    tabs = []
    for dev in (cuda_device, "cpu"):
        tx = SrtpStreamTable(8, prof, device=dev)
        rx = SrtpStreamTable(8, prof, device=dev)
        for t in (tx, rx):
            t.add_streams(range(8), keys, salts)
        tabs.append((tx, rx))
    cache = tabs[0][0].enable_keystream_cache(window=32, ks_bytes=256,
                                               pool=8)
    pays = [bytes(rng.integers(0, 256, int(k), np.uint8))
            for k in rng.integers(20, 200, 32)]
    batch = rtp_header.build(pays, list(range(32)), [0] * 32,
                             [0x1000 + i % 8 for i in range(32)], [96] * 32,
                             stream=[i % 8 for i in range(32)])
    cache.prime(np.arange(8), 0x1000 + np.arange(8), start=0)
    outs = []
    for tx, rx in tabs:
        wire = tx.protect_rtp(batch)
        dec, ok = rx.unprotect_rtp(wire)
        outs.append((wire, dec, ok))
    assert cache.misses == 0 and cache.hits >= 32   # padding rows count too
    (w1, d1, ok1), (w2, d2, ok2) = outs
    assert np.array_equal(w1.data, w2.data)
    assert np.array_equal(w1.length, w2.length)
    assert ok1.all() and ok2.all()
    assert np.array_equal(d1.data, d2.data)


# kernel R at chip_smoke.py's shapes: the mixed conference's deposit and
# egress (2/1, 1/2), 10,240 streams at the Opus clock both ways (6/1,
# 1/6), the 44.1k -> 48k bank (L = 160, the general instance) and a
# conference past 65,535 rows; and its other instances, 16k <-> 48k (3/1,
# 1/3), and 48k -> 44.1k (147/160, general)
@pytest.mark.parametrize("rows,rate_in,rate_out", [
    (255, 8000, 16000), (255, 16000, 8000), (10240, 8000, 48000),
    (10240, 48000, 8000), (256, 44100, 48000), (65540, 8000, 16000),
    (255, 16000, 48000), (255, 48000, 16000), (256, 48000, 44100)])
def test_resample_kernel_matches_plain(cuda_device, rows, rate_in, rate_out):
    from libjitsi_tpu_torch.kernels import resample

    rng = np.random.default_rng(rows + rate_in)
    x = rng.integers(-32768, 32768, (rows, rate_in // 50)).astype(np.int16)
    x[0], x[1] = 32767, -32768                 # rows at the rails
    x_d = torch.from_numpy(x).to(cuda_device)
    l, m = resample.ratio(rate_in, rate_out)
    before = kbuild.launches["resample"]
    got = resample.resample(x_d, rate_in, rate_out)
    torch.cuda.synchronize()
    assert kbuild.launches["resample"] == before + 1
    assert got.shape == (rows, rate_out // 50)
    assert _same(got, resample.resample_plain(x_d, l, m))
    assert _same(got[:64], resample.resample_plain(torch.from_numpy(x[:64]),
                                                   l, m))


@pytest.mark.parametrize("rate_in,rate_out", [
    (8000, 16000), (16000, 8000), (8000, 48000), (48000, 8000),
    (16000, 48000), (48000, 16000), (44100, 48000)])
def test_resample_kernel_ragged_and_off_alignment(cuda_device, rate_in,
                                                  rate_out):
    """Kernel R where its whole-word loads and stores cannot run: rows of
    1, 7 and 161 samples, and rows that start 2 bytes past a 16-byte
    boundary, each equal to its plain version."""
    from libjitsi_tpu_torch.kernels import resample

    rng = np.random.default_rng(rate_in + rate_out)
    l, m = resample.ratio(rate_in, rate_out)
    for rows, t in ((3, 1), (37, 7), (5, 161)):
        x = torch.from_numpy(rng.integers(-32768, 32768, (rows, t))
                             .astype(np.int16)).to(cuda_device)
        assert _same(resample.resample(x, rate_in, rate_out),
                     resample.resample_plain(x, l, m))
    buf = torch.from_numpy(rng.integers(-32768, 32768, 5 * 160 + 1)
                           .astype(np.int16)).to(cuda_device)
    x = buf[1:].view(5, 160)
    assert x.data_ptr() % 16 == 2
    assert _same(resample.resample(x, rate_in, rate_out),
                 resample.resample_plain(x, l, m))


def test_off_rate_receive_bank_tick_on_card_equals_cpu(cuda_device):
    """A receive bank at a 16 kHz mixer clock with PCMU and PCMA legs at
    8 kHz: one tick on the card (kernels G, R) deposits what the same
    tick on the CPU deposits."""
    from libjitsi_tpu_torch.conference.mixer import AudioMixer
    from libjitsi_tpu_torch.service.pump import ReceiveBank, g711_codec

    rng = np.random.default_rng(13)
    n = 40
    pcm = rng.integers(-9000, 9000, (n, 160)).astype(np.int16)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        mix = AudioMixer(n, 320, device=dev)
        bank = ReceiveBank(n, mixer=mix, mixer_rate=16000, device=dev)
        for sid in range(n):
            bank.add_stream(sid, g711_codec(sid % 2 == 0, device=dev))
            mix.add_participant(sid)
        codes = [g711.encode(torch.from_numpy(pcm[s]), s % 2).numpy()
                 for s in range(n)]
        batch = rtp_header.build([c.tobytes() for c in codes],
                                 [10] * n, [0] * n, 0x77 + np.arange(n), 0,
                                 stream=list(range(n)))
        bank.push_decrypted(batch, np.ones(n, bool), now=5.0)
        kbuild.reset_counts()
        bank.tick(now=5.0)
        out[dev.type] = (mix._frame.copy(), dict(kbuild.launches),
                         dict(kbuild.plain_calls))
    frames, launches, plain = out["cuda"]
    assert np.array_equal(frames, out["cpu"][0])
    assert frames.any() and launches["resample"] == 2   # a group a law
    assert launches["g711_decode"] == 2 and plain["resample"] == 0


@pytest.mark.parametrize("profile", ["AES_CM_128_HMAC_SHA1_80",
                                     "AEAD_AES_128_GCM"])
def test_quick_start_on_the_card(cuda_device, profile):
    """README's Quick start with no device argument: `init()` and
    `media_service()` build on the card, each send is one protect launch
    (C, or M under GCM) and each receive one unprotect launch (D, or N),
    no plain version runs, and the payload comes back as sent."""
    import libjitsi_tpu_torch

    libjitsi_tpu_torch.stop()
    try:
        libjitsi_tpu_torch.init()
        svc = libjitsi_tpu_torch.media_service()
        assert svc.device.type == "cuda"
        prof = SrtpProfile(profile)
        a = svc.create_media_stream(profile=prof)
        b = svc.create_media_stream("audio", profile=prof)
        answer = b.sdes.create_answer(a.sdes.create_offer())
        a.sdes.accept_answer(answer)
        a.set_remote_ssrc(b.local_ssrc)
        b.set_remote_ssrc(a.local_ssrc)
        a.start()
        b.start()
        kbuild.reset_counts()
        wire = a.send([b"opus-frame"])
        batch, ok = b.receive(wire)
        seal, open_ = (("srtp_gcm_seal", "srtp_gcm_open")
                       if profile == "AEAD_AES_128_GCM" else
                       ("srtp_protect_cm", "srtp_unprotect_cm"))
        assert kbuild.launches[seal] == 1 and kbuild.launches[open_] == 1
        assert sum(kbuild.plain_calls.values()) == 0
        assert ok.tolist() == [True]
        assert batch.to_bytes(0)[12:] == b"opus-frame"
        assert b.stats["rx_packets"] == 1
    finally:
        libjitsi_tpu_torch.stop()


def _zrtp_pair(a_algs):
    from libjitsi_tpu_torch.control.zrtp import ZrtpEndpoint

    a, b = ZrtpEndpoint(ssrc=1, algorithms=a_algs), ZrtpEndpoint(ssrc=2)
    wire = [(b, p) for p in a.hello_packets()] + \
        [(a, p) for p in b.hello_packets()]
    started = False
    for _ in range(30):
        wire = [(a if dst is b else b, r) for dst, p in wire
                for r in dst.feed(p)]
        if not started and b"Hello   " in a._peer:
            wire += [(b, p) for p in a.initiate()]
            started = True
    assert a.complete and b.complete and a.sas == b.sas
    return a, b


def test_zrtp_keyed_streams_at_aes256_on_the_card(cuda_device):
    """A ZRTP pair that negotiates AES3 keys two `MediaStream`s on the
    card and two on the CPU: the card's sends run C's AES-256 instance
    (`srtp_protect_cm nr=14`) and its receives D's, and both put on the
    wire and take off it exactly what the plain versions do."""
    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.service.media_service import MediaService

    a_ctl, b_ctl = _zrtp_pair({"cipher": (b"AES3",), "auth": (b"HS32",)})
    prof = SrtpProfile.AES_256_CM_HMAC_SHA1_32
    assert a_ctl.srtp_keys()[0] == prof
    rng = np.random.default_rng(14)
    payloads = [rng.bytes(int(n)) for n in rng.integers(20, 900, 33)]
    out = {}
    for dev in (cuda_device, "cpu"):
        svc = MediaService(ConfigurationService(), device=dev)
        a = svc.create_media_stream(local_ssrc=0x5A, profile=prof)
        b = svc.create_media_stream(local_ssrc=0x5B, profile=prof)
        a.set_remote_ssrc(b.local_ssrc)
        b.set_remote_ssrc(a.local_ssrc)
        a.start(srtp_control=a_ctl)
        b.start(srtp_control=b_ctl)
        a._tx_seq, a._tx_ts = 65530, 0xFFFFFF00        # both wrap
        kbuild.reset_counts()
        wire = a.send(payloads)
        got, ok = b.receive(wire)
        out[str(dev)] = (list(wire), got.to_payloads(),
                         np.asarray(ok).tolist(),
                         dict(kbuild.instance_launches),
                         sum(kbuild.plain_calls.values()),
                         {k: kbuild.launches[k] for k in
                          ("srtp_protect_cm", "srtp_unprotect_cm")})
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert card[:3] == cpu[:3] and all(card[2])
    # every launch (one a size bucket) is the AES-256 instance
    assert card[5]["srtp_protect_cm"] >= 1 and card[4] == 0
    assert card[3] == {f"{k} nr=14": v for k, v in card[5].items()}
    assert [g[-len(p):] for g, p in zip(card[1], payloads)] == payloads


def test_dtls_keyed_sfu_on_the_card(cuda_device):
    """Two endpoints join an `SfuBridge` on the card by DTLS over
    loopback (OpenSSL where `cryptography` is installed, else the stub):
    each one's media reaches the other through D and H, and opens under
    the keys the other exported."""
    from libjitsi_tpu_torch.control import dtls
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    kind = (dtls.DtlsSrtpEndpoint if dtls.HAVE_CRYPTOGRAPHY
            else dtls.StubDtlsEndpoint)
    sfu = SfuBridge(port=0, capacity=4, recv_window_ms=0, device=cuda_device)
    sfu._dtls.endpoint_factory = kind
    peers = []
    try:
        for ssrc in (0x901, 0x902):
            eng = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=64)
            sid, ep = sfu.add_endpoint_dtls(
                ssrc, remote_addr=(0x7F000001, eng.port))
            cli = kind("client", remote_fingerprint=ep.local_fingerprint)
            ep.remote_fingerprint = cli.local_fingerprint
            out = cli.handshake_packets()
            for _ in range(20):
                if out:
                    eng.send_batch(PacketBatch.from_payloads(out),
                                   "127.0.0.1", sfu.port)
                for _ in range(3):
                    sfu.tick(now=10.0)
                got, _, _ = eng.recv_batch(timeout_ms=5)
                out = [r for d in got.to_payloads() for r in cli.feed(d)]
                if cli.complete and not sfu._dtls.pending:
                    break
            assert cli.complete and sid not in sfu._dtls.pending
            peers.append((ssrc, eng, cli))
        wires = []          # the endpoints' media, on the CPU
        for k, (ssrc, eng, cli) in enumerate(peers):
            _p, tk, ts, _rk, _rs = cli.srtp_keys()
            up = SrtpStreamTable(1, device="cpu")
            up.add_stream(0, tk, ts)
            b = rtp_header.build([b"dtls-%d-%d" % (k, i) for i in range(3)],
                                 [100 + i for i in range(3)],
                                 [960 * i for i in range(3)], [ssrc] * 3,
                                 111, stream=[0] * 3)
            wires.append(up.protect_rtp(b))
        kbuild.reset_counts()
        for (ssrc, eng, cli), wire in zip(peers, wires):
            eng.send_batch(wire, "127.0.0.1", sfu.port)
            for _ in range(3):
                sfu.tick(now=10.1)
        assert kbuild.launches["srtp_unprotect_cm"] >= 1
        assert kbuild.launches["srtp_fanout_cm"] >= 1
        assert sum(kbuild.plain_calls.values()) == 0
        for k, (ssrc, eng, cli) in enumerate(peers):
            _p, _tk, _ts, rk, rs = cli.srtp_keys()
            down = SrtpStreamTable(1, device="cpu")
            down.add_stream(0, rk, rs)
            copies = []
            for _ in range(5):
                got, _, _ = eng.recv_batch(timeout_ms=5)
                copies += [p for p in got.to_payloads()
                           if not 192 <= p[1] <= 223]
            dec, ok = down.unprotect_rtp(PacketBatch.from_payloads(
                copies, stream=[0] * len(copies)))
            assert len(copies) == 3 and bool(np.asarray(ok).all())
            hdr = rtp_header.parse(dec)
            assert [dec.to_bytes(i)[int(hdr.payload_off[i]):]
                    for i in range(3)] == [b"dtls-%d-%d" % (1 - k, i)
                                           for i in range(3)]
    finally:
        sfu.close()
        for _s, eng, _c in peers:
            eng.close()
