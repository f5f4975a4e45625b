"""The port's bandwidth estimators and RTP arithmetic against the JAX
package's, on the CPU.

- `core/rtp_math.py`: `is_newer_seq`, `is_older_seq`, `ts_delta`,
  `as_seq`, `as_ts` over seeded values across both wraps, and
  `SeqNumUnwrapper` over a reordered run that wraps.
- `bwe/`: `RateStatistics`, `InterArrival`, `OveruseEstimator` with
  `OveruseDetector`, `AimdRateControl`, `RemoteBitrateEstimator` (an
  abs-send-time trace that wraps its 64 s window) and
  `SendSideBandwidthEstimation` (RR loss, REMB caps and TCC feedback),
  each fed the same seeded trace in both packages, state for state and
  estimate for estimate.

Every input comes from a numpy seed.  Tolerance: exact equality (the
same float operations in the same order give the same bits).
"""

import numpy as np
import pytest

from libjitsi_tpu.bwe import aimd as j_aimd
from libjitsi_tpu.bwe import inter_arrival as j_ia
from libjitsi_tpu.bwe import overuse as j_ov
from libjitsi_tpu.bwe import rate_stats as j_rate
from libjitsi_tpu.bwe import remote_estimator as j_remote
from libjitsi_tpu.bwe import send_side as j_send
from libjitsi_tpu.core import rtp_math as j_math
from libjitsi_tpu.rtp import rtcp as j_rtcp
from libjitsi_tpu_torch.bwe import aimd as p_aimd
from libjitsi_tpu_torch.bwe import inter_arrival as p_ia
from libjitsi_tpu_torch.bwe import overuse as p_ov
from libjitsi_tpu_torch.bwe import rate_stats as p_rate
from libjitsi_tpu_torch.bwe import remote_estimator as p_remote
from libjitsi_tpu_torch.bwe import send_side as p_send
from libjitsi_tpu_torch.core import rtp_math as p_math
from libjitsi_tpu_torch.rtp import rtcp as p_rtcp

SEEDS = (0, 1, 2)


def _trace(seed, n=400):
    """Send times (ms, 20 ms apart with jitter), arrivals with a queue
    that builds and drains, and sizes."""
    rng = np.random.default_rng(seed)
    send = np.cumsum(rng.uniform(2.0, 25.0, n))
    queue = np.concatenate([np.linspace(0, 80, n // 2),
                            np.linspace(80, 0, n - n // 2)])
    arrival = send + 40.0 + queue + rng.uniform(0, 6.0, n)
    sizes = rng.integers(60, 1200, n)
    return send, arrival, sizes


@pytest.mark.parametrize("seed", SEEDS)
def test_rtp_math_helpers_and_unwrapper_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, 500)
    b = np.concatenate([(a[:250] + rng.integers(-40000, 40000, 250)) & 0xFFFF,
                        rng.integers(0, 1 << 16, 250)])
    ta = rng.integers(0, 1 << 32, 500, dtype=np.int64)
    tb = (ta + rng.integers(-(1 << 31), 1 << 31, 500)) & 0xFFFFFFFF
    for f in ("is_newer_seq", "is_older_seq"):
        assert np.array_equal(getattr(p_math, f)(a, b),
                              getattr(j_math, f)(a, b))
    assert np.array_equal(p_math.ts_delta(ta, tb), j_math.ts_delta(ta, tb))
    big = rng.integers(-(1 << 40), 1 << 40, 500)
    assert np.array_equal(p_math.as_seq(big), j_math.as_seq(big))
    assert np.array_equal(p_math.as_ts(big), j_math.as_ts(big))
    # a reordered, lossy run that wraps 2^16 twice
    seqs = (65000 + np.arange(140000)) & 0xFFFF
    seqs = seqs[rng.random(len(seqs)) > 0.1][:3000]
    swap = rng.integers(0, len(seqs) - 1, 200)
    seqs[swap], seqs[swap + 1] = seqs[swap + 1], seqs[swap].copy()
    pu, ju = p_math.SeqNumUnwrapper(), j_math.SeqNumUnwrapper()
    assert [pu.unwrap(s) for s in seqs] == [ju.unwrap(s) for s in seqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_rate_statistics_match_jax(seed):
    rng = np.random.default_rng(seed)
    p, j = p_rate.RateStatistics(500), j_rate.RateStatistics(500)
    now = 1000
    for _ in range(600):
        # steps within the window, late packets and gaps past it
        now += int(rng.choice([0, 1, 5, 20, -30, 700], p=[.1, .3, .3, .2,
                                                          .05, .05]))
        size = int(rng.integers(1, 1500))
        p.update(size, now)
        j.update(size, now)
        assert p.rate(now) == j.rate(now)
        assert p._total == j._total and p._oldest_ms == j._oldest_ms


@pytest.mark.parametrize("seed", SEEDS)
def test_inter_arrival_overuse_and_aimd_match_jax(seed):
    send, arrival, sizes = _trace(seed)
    pia, jia = p_ia.InterArrival(), j_ia.InterArrival()
    pe, je = p_ov.OveruseEstimator(), j_ov.OveruseEstimator()
    pd, jd = p_ov.OveruseDetector(), j_ov.OveruseDetector()
    pa, ja = p_aimd.AimdRateControl(), j_aimd.AimdRateControl()
    states, groups = set(), 0
    for s, a, z in zip(send, arrival, sizes):
        # an out-of-order send time now and then: ignored by both
        s = float(s - 30.0) if a > arrival[0] + 900 and z < 80 else float(s)
        dp = pia.add(s, float(a), int(z))
        assert dp == jia.add(s, float(a), int(z))
        if dp is None:
            continue
        groups += 1
        pe.update(dp[1], dp[0], dp[2], pd.state)
        je.update(dp[1], dp[0], dp[2], jd.state)
        assert (pe.offset, pe._slope, pe._var_noise, pe._e) == \
            (je.offset, je._slope, je._var_noise, je._e)
        sig = pd.detect(pe.offset, dp[0], pe.num_deltas, float(a))
        assert sig == jd.detect(je.offset, dp[0], je.num_deltas, float(a))
        assert pd.threshold == jd.threshold
        states.add(sig)
        incoming = float(z) * 8 * 50
        assert pa.update(sig, incoming, float(a)) == \
            ja.update(sig, incoming, float(a))
        assert (pa.state, pa.region) == (ja.state, ja.region)
    assert groups > 50
    assert states == {p_ov.NORMAL, p_ov.OVERUSING, p_ov.UNDERUSING}
    pa.set_rtt(80.0)
    ja.set_rtt(80.0)
    for k in range(20):         # additive increase after the decreases
        assert pa.update(p_ov.NORMAL, 4e5, 1e6 + 100 * k) == \
            ja.update(j_ov.NORMAL, 4e5, 1e6 + 100 * k)


@pytest.mark.parametrize("seed", SEEDS)
def test_remote_estimator_matches_jax(seed):
    send, arrival, sizes = _trace(seed)
    p, j = p_remote.RemoteBitrateEstimator(), j_remote.RemoteBitrateEstimator()
    # abs-send-time stamps from 62 s on, so the 64 s window wraps
    ast = (np.round((62_000.0 + send) / 1000.0 * (1 << 18)).astype(np.int64)
           & 0xFFFFFF)
    est = []
    for i in range(len(send)):
        p.incoming_packet(float(arrival[i]), int(ast[i]), int(sizes[i]))
        j.incoming_packet(float(arrival[i]), int(ast[i]), int(sizes[i]))
        assert p.state == j.state
        if i % 10 == 9:
            if i == 199:
                p.set_rtt(120.0)
                j.set_rtt(120.0)
            est.append(p.update_estimate(float(arrival[i])))
            assert est[-1] == j.update_estimate(float(arrival[i]))
    assert p._send_unwrapped == j._send_unwrapped > 64_000
    assert p_remote.abs_send_time_to_ms(0xABCDE) == \
        j_remote.abs_send_time_to_ms(0xABCDE)
    pb, jb = p_remote.RemoteBitrateEstimator(), j_remote.RemoteBitrateEstimator()
    pb.incoming_batch(arrival, ast, sizes)
    jb.incoming_batch(arrival, ast, sizes)
    assert pb.update_estimate(arrival[-1]) == jb.update_estimate(arrival[-1])


def _tcc(mod, rng, base_seq, n, ref):
    received = rng.random(n) > 0.2
    arrival = np.where(received, np.cumsum(rng.integers(0, 120, n)), 0)
    return mod.TccFeedback(0xF00D, 0xBEEF, base_seq, ref, 1, received,
                           arrival)


@pytest.mark.parametrize("seed", SEEDS)
def test_send_side_estimation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    p = p_send.SendSideBandwidthEstimation()
    j = j_send.SendSideBandwidthEstimation()
    now, seq = 5_000.0, 65_500
    for step in range(120):
        now += float(rng.uniform(5, 400))
        kind = rng.choice(["rr", "remb", "tcc"], p=[.5, .15, .35])
        if kind == "rr":
            lost = int(rng.choice([0, 2, 10, 40, 120, 255]))
            assert p.on_receiver_report(lost, now) == \
                j.on_receiver_report(lost, now)
        elif kind == "remb":
            cap = float(rng.integers(50_000, 3_000_000))
            assert p.on_remb(cap) == j.on_remb(cap)
        else:
            n = int(rng.integers(1, 40))
            st = np.sort(rng.uniform(now - 900, now, n))
            sends = [None if rng.random() < 0.1 else float(t) for t in st]
            ref = int(now // 64)
            state = rng.bit_generator.state
            fp = _tcc(p_rtcp, rng, seq, n, ref)
            rng.bit_generator.state = state
            fj = _tcc(j_rtcp, rng, seq, n, ref)
            assert p.on_tcc_feedback(fp, sends, now) == \
                j.on_tcc_feedback(fj, sends, now)
            seq = (seq + n) & 0xFFFF
        assert (p.bitrate, p.loss_estimate, p.last_fraction_lost,
                p.remb_cap, p.delay_cap) == \
            (j.bitrate, j.loss_estimate, j.last_fraction_lost, j.remb_cap,
             j.delay_cap)
        assert p.estimate_bps == j.estimate_bps
