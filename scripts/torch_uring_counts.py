#!/usr/bin/env python3
"""Count the port's ingest syscalls under the io_uring and recvmmsg
engines for the same echo traffic, on the host's CPU.

    python3 scripts/torch_uring_counts.py [--streams 1024] [--ticks 3]

Runs `chip_smoke.py`'s engine-echo traffic (one production-mix packet
from each of `--batch` streams a tick, sent in `--burst`-packet bursts
from one client socket over loopback) through two echo bridges on the
CPU SRTP tables (`device="cpu"`: the kernels' plain versions), one on
`UdpEngine(engine_mode="recvmmsg")` and one on
`UdpEngine(engine_mode="io_uring")`, and prints one JSON line: each
engine's `syscall_enters`, `ring_reaps`, busy ticks and packets a busy
tick, and whether the replies were byte-equal.  The counts are the
host's; the tick times on this path measure the CPU's plain crypto, not
a device, and are left out.  Exits 2 where the host gives no ring
(`uring_available()` false).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from libjitsi_tpu_torch.io.udp import uring_available

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--burst", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=3)
    opts = ap.parse_args(argv)
    if not uring_available():
        print("io_uring unavailable on this host", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cs.N_STREAMS, cs.BATCH, cs.ECHO_BURST = (opts.streams, opts.batch,
                                             opts.burst)
    cs.ENGINE_TICKS = opts.ticks
    dev = torch.device("cpu")
    rng = np.random.default_rng(9)
    keys = {"mks": rng.integers(0, 256, (opts.streams, 16), np.uint8),
            "mss": rng.integers(0, 256, (opts.streams, 14), np.uint8)}
    setup = cs.engine_echo_setup(torch, dev, keys)   # the recvmmsg run
    ring = cs._echo_udp(torch, dev, setup, "io_uring")
    out = {"streams": opts.streams, "batch": opts.batch,
           "burst": opts.burst, "ticks": opts.ticks,
           "replies_equal": ring["replies"] == setup["ref"]["replies"]}
    for name, run in (("recvmmsg", setup["ref"]), ("io_uring", ring)):
        out[name] = dict(
            engine_mode=run["engine_mode"],
            syscall_enters=run["syscall_enters"],
            ring_reaps=run["ring_reaps"], busy_ticks=len(run["tick_s"]),
            packets_per_busy_tick=float(np.mean([n for n, _ in
                                                 run["tick_s"]])))
    print(json.dumps(out), flush=True)
    return 0 if out["replies_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
