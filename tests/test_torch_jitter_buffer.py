"""The port's adaptive jitter buffer against the JAX package's, on the CPU.

Seeded arrival traces go through both buffers with the same `now`:
reordered and lost packets, late arrivals after their slot played, a
sender's sequence reset past `MAX_MISORDER`, a forward jump of the
arrival clock, sequence numbers wrapping mod 2^16, and an RTP timestamp
wrapping mod 2^32.  After every insert and pop, the released payload (or
None), `lost`, `late_dropped`, `resets`, `target_delay` and the buffered
count must be equal.  The timestamp wrap is a fault of the reference,
mirrored: the buffer does not unwrap RTP timestamps, so a wrap reads as
~2^32 / clock_rate seconds of transit jitter and pins `target_delay` at
`max_delay` (ROADMAP Queue 3).

Tolerance: exact equality.
"""

import numpy as np
import pytest

from libjitsi_tpu.rtp.jitter_buffer import JitterBuffer as JaxJitterBuffer
from libjitsi_tpu_torch.rtp.jitter_buffer import JitterBuffer

CLOCK, FRAME_MS = 8000, 20.0
STEP = CLOCK * int(FRAME_MS) // 1000


def _trace(seed, n=120, seq0=65_500, ts0=0x1234_0000, reset_at=None,
           jump_at=None, loss=0.05, late=0.03, swap=0.1):
    """(kind, args) events of one sender at 20 ms: each packet's insert
    at its (jittered) arrival and one pop a ptime; a share of packets
    lost, swapped with the next one, or held until after their slot;
    optionally a sequence reset (seq + 40,000) at packet `reset_at` and
    a 3 s forward jump of the arrival clock at packet `jump_at`."""
    rng = np.random.default_rng(seed)
    arrivals = []
    seq, clock = seq0, 100.0
    for i in range(n):
        if i == reset_at:
            seq = (seq + 40_000) & 0xFFFF
        if i == jump_at:
            clock += 3.0
        ts = (ts0 + i * STEP) & 0xFFFFFFFF
        at = clock + i * 0.020 + float(rng.uniform(0.0, 0.012))
        r = rng.random()
        if r < loss:
            pass
        elif r < loss + late:
            arrivals.append((at + 0.150, seq, ts, i))
        else:
            arrivals.append((at, seq, ts, i))
        seq = (seq + 1) & 0xFFFF
    arrivals.sort()
    for k in range(len(arrivals) - 1):          # swap neighbours
        if rng.random() < swap:
            (a0, *r0), (a1, *r1) = arrivals[k], arrivals[k + 1]
            arrivals[k], arrivals[k + 1] = (a0, *r1), (a1, *r0)
    events = [("insert", (s, ts, b"p%d" % i, at))
              for at, s, ts, i in arrivals]
    t_end = max(at for at, *_ in arrivals) + 0.5
    t = arrivals[0][0]
    while t < t_end:
        events.append(("pop", (t,)))
        t += 0.020
    # the order of the two kinds at one instant: inserts first
    return sorted(events, key=lambda e: (e[1][-1], e[0] == "pop"))


def _run(trace, **kw):
    out = []
    bufs = (JitterBuffer(CLOCK, FRAME_MS, **kw),
            JaxJitterBuffer(CLOCK, FRAME_MS, **kw))
    for kind, args in trace:
        step = []
        for jb in bufs:
            got = getattr(jb, kind)(*args)
            step.append((got, jb.lost, jb.late_dropped, jb.resets,
                         jb.target_delay, len(jb)))
        assert step[0] == step[1], (kind, args)
        out.append(step[0])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_reorder_loss_and_late_match_jax(seed):
    out = _run(_trace(seed))
    released = [o[0] for o in out if o[0] is not None]
    assert len(released) > 80
    assert out[-1][1] > 0 and out[-1][2] > 0      # losses and late drops
    assert len(set(released)) == len(released)    # never one twice


def test_sequence_reset_past_misorder_resyncs_like_jax():
    out = _run(_trace(7, reset_at=50, loss=0.0, late=0.0))
    assert out[-1][3] == 1                        # one resync
    assert sum(o[0] is not None for o in out) > 100


def test_clock_jump_and_min_max_delay_match_jax():
    out = _run(_trace(11, jump_at=60), min_delay_ms=10.0,
               max_delay_ms=80.0)
    delays = {o[4] for o in out}
    assert min(delays) >= 0.010 and max(delays) <= 0.080
    assert sum(o[0] is not None for o in out) > 80


def test_rtp_timestamp_wrap_reads_as_jitter_in_both():
    """The reference's fault, mirrored: across the 2^32 wrap the transit
    jumps by 2^32 / 8,000 s, and `target_delay` sits at `max_delay`."""
    out = _run(_trace(13, ts0=0xFFFF_FFFF - 30 * STEP, loss=0.0, late=0.0,
                      swap=0.0))
    assert out[-1][4] == 0.2
    assert sum(o[0] is not None for o in out) == 120
