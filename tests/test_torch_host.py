"""The port's host-side copies against the JAX package's originals.

Packet bucketing, RTP index arithmetic, the RTP header codec, the SRTP
policies, key derivation, key schedules, HMAC midstates and the replay
window are NumPy in both packages; the port keeps its own copies.  Same
inputs (numpy, seeded) through both; tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

from libjitsi_tpu.core import packet as j_packet
from libjitsi_tpu.core import rtp_math as j_math
from libjitsi_tpu.kernels import aes as j_aes
from libjitsi_tpu.kernels import sha1 as j_sha1
from libjitsi_tpu.rtp import header as j_header
from libjitsi_tpu.transform.srtp import kdf as j_kdf
from libjitsi_tpu.transform.srtp import policy as j_policy
from libjitsi_tpu.transform.srtp import replay as j_replay
from libjitsi_tpu_torch.core import packet as t_packet
from libjitsi_tpu_torch.core import rtp_math as t_math
from libjitsi_tpu_torch.kernels import aes as t_aes
from libjitsi_tpu_torch.kernels import sha1 as t_sha1
from libjitsi_tpu_torch.rtp import header as t_header
from libjitsi_tpu_torch.transform.srtp import kdf as t_kdf
from libjitsi_tpu_torch.transform.srtp import policy as t_policy
from libjitsi_tpu_torch.transform.srtp import replay as t_replay


def _payloads(rng, n, sizes=(5, 100, 180, 400, 950, 1400)):
    return [rng.integers(0, 256, int(rng.choice(sizes)), np.uint8).tobytes()
            for _ in range(n)]


def test_header_build_and_parse_match():
    rng = np.random.default_rng(1)
    n = 40
    pls = _payloads(rng, n)
    seq = rng.integers(0, 65536, n)
    ts = rng.integers(0, 2 ** 32, n)
    ssrc = rng.integers(0, 2 ** 32, n)
    csrcs = [list(rng.integers(0, 2 ** 32, k)) for k in rng.integers(0, 4, n)]
    ext = [None if k % 3 else (0xBEDE, bytes(range(k % 7)))
           for k in range(n)]
    kw = dict(csrcs=csrcs, ext=ext, marker=rng.integers(0, 2, n))
    a = j_header.build(pls, seq, ts, ssrc, 96, **kw)
    b = t_header.build(pls, seq, ts, ssrc, 96, **kw)
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.length, b.length)
    ha, hb = j_header.parse(a), t_header.parse(b)
    for f in ("version", "cc", "marker", "pt", "seq", "ts", "ssrc",
              "header_len", "payload_off", "payload_len", "valid"):
        assert np.array_equal(getattr(ha, f), getattr(hb, f)), f
    for setter, val in (("set_seq", seq[::-1]), ("set_ts", ts[::-1]),
                        ("set_ssrc", ssrc[::-1]), ("set_pt", seq % 128),
                        ("set_marker", seq % 2)):
        assert np.array_equal(getattr(j_header, setter)(a.data.copy(), val),
                              getattr(t_header, setter)(b.data.copy(), val))


def test_bucketing_round_trip_matches():
    rng = np.random.default_rng(2)
    pls = _payloads(rng, 300)
    a = j_packet.PacketBatch.from_payloads(pls, stream=np.arange(300))
    b = t_packet.PacketBatch.from_payloads(pls, stream=np.arange(300))
    assert t_packet.LENGTH_CLASSES == j_packet.LENGTH_CLASSES
    assert t_packet.ROW_CLASSES == j_packet.ROW_CLASSES
    pa, pb = j_packet.bucket_by_size(a), t_packet.bucket_by_size(b)
    assert len(pa) == len(pb) == 3
    for (ra, sa, na), (rb, sb, nb) in zip(pa, pb):
        assert np.array_equal(ra, rb) and na == nb
        assert np.array_equal(sa.data, sb.data)
        assert np.array_equal(sa.stream, sb.stream)
    oa, _ = j_packet.unbucket(pa, 300, 1504)
    ob, _ = t_packet.unbucket(pb, 300, 1504)
    assert np.array_equal(oa.data, ob.data)
    assert np.array_equal(ob.data[:, :1504], b.data)


def test_packet_index_arithmetic_matches():
    rng = np.random.default_rng(3)
    n = 500
    stream = rng.integers(0, 20, n)
    seq = rng.integers(0, 65536, n)
    base = rng.integers(-1, 2 ** 20, 20)
    assert np.array_equal(j_math.chain_packet_indices(stream, seq, base),
                          t_math.chain_packet_indices(stream, seq, base))
    s_l = rng.integers(0, 65536, n)
    roc = rng.integers(0, 5, n)
    for x, y in zip(j_math.estimate_packet_index(seq, s_l, roc),
                    t_math.estimate_packet_index(seq, s_l, roc)):
        assert np.array_equal(x, y)
    for k in range(50):
        args = (seq[k], rng.integers(0, 3), s_l[k], 1)
        assert (j_math.update_index_state(*args)
                == t_math.update_index_state(*args))
    assert np.array_equal(j_math.seq_delta(seq, s_l),
                          t_math.seq_delta(seq, s_l))


def test_policies_match():
    for jp in j_policy.SrtpProfile:
        tp = t_policy.SrtpProfile(jp.value)
        assert tp.policy.__dict__.keys() == jp.policy.__dict__.keys()
        assert ([getattr(tp.policy, f) for f in ("enc_key_len", "auth_key_len",
                                                 "auth_tag_len", "salt_len",
                                                 "window_size")]
                == [getattr(jp.policy, f) for f in ("enc_key_len",
                                                    "auth_key_len",
                                                    "auth_tag_len", "salt_len",
                                                    "window_size")])
        assert tp.policy.cipher.name == jp.policy.cipher.name
        assert tp.master_key_len == jp.master_key_len


@pytest.mark.parametrize("key_len", [16, 32])
def test_key_derivation_and_schedules_match(key_len):
    rng = np.random.default_rng(key_len)
    mks = rng.integers(0, 256, (12, key_len), np.uint8)
    mss = rng.integers(0, 256, (12, 14), np.uint8)
    ka = j_kdf.derive_session_keys_batch(mks, mss, enc_key_len=key_len)
    kb = t_kdf.derive_session_keys_batch(mks, mss, enc_key_len=key_len)
    for f in ("rtp_enc", "rtp_auth", "rtp_salt", "rtcp_enc", "rtcp_auth",
              "rtcp_salt"):
        assert np.array_equal(getattr(ka, f), getattr(kb, f)), f
    one_a = j_kdf.derive_session_keys(bytes(mks[3]), bytes(mss[3]),
                                      enc_key_len=key_len)
    one_b = t_kdf.derive_session_keys(bytes(mks[3]), bytes(mss[3]),
                                      enc_key_len=key_len)
    assert (dataclasses.astuple(one_a) == dataclasses.astuple(one_b)
            == dataclasses.astuple(kb.row(3)))
    assert np.array_equal(j_aes.expand_keys_batch(mks),
                          t_aes.expand_keys_batch(mks))
    assert np.array_equal(j_aes.expand_key(bytes(mks[0])),
                          t_aes.expand_key(bytes(mks[0])))
    keys = rng.integers(0, 256, (12, 20), np.uint8)
    assert np.array_equal(j_sha1.hmac_precompute_batch(keys),
                          t_sha1.hmac_precompute_batch(keys))
    long_key = bytes(range(80))
    assert np.array_equal(j_sha1.hmac_precompute(long_key),
                          t_sha1.hmac_precompute(long_key))
    iv = rng.integers(0, 256, 16, np.uint8)
    iv[13:] = 0xFF
    rk = j_aes.expand_key(bytes(mks[1]))
    assert np.array_equal(j_aes.ctr_keystream_np(rk, iv, 70),
                          t_aes.ctr_keystream_np(rk, iv, 70))


def test_replay_window_matches():
    rng = np.random.default_rng(4)
    s = 6
    state = {k: (np.full(s, -1, np.int64), np.zeros(s, np.uint64))
             for k in ("jax", "torch")}
    for _ in range(30):
        n = 24
        stream = rng.integers(0, s, n)
        index = rng.integers(0, 300, n)
        verdicts = {}
        for name, mod in (("jax", j_replay), ("torch", t_replay)):
            mx, mask = state[name]
            ok = mod.check(mx, mask, stream, index)
            ok &= ~mod.dedup_first(stream, index, ok)
            mod.update(mx, mask, stream, index, ok)
            verdicts[name] = ok
        assert np.array_equal(verdicts["jax"], verdicts["torch"])
        for a, b in zip(state["jax"], state["torch"]):
            assert np.array_equal(a, b)
