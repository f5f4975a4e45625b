#!/usr/bin/env python3
"""Time the port's SfuBridge tick with one and two SO_REUSEPORT ingest
rings, in turns, on one NVIDIA GPU.

    python3 scripts/torch_rings_turns.py        (from the repository root)

Drives `chip_smoke.py`'s sfu_rings input (100 conferences x 11 endpoints,
AES-CM, RRs and NACKs, `emit_feedback` every 5 ticks) through three
bridges, each fresh, in the order A, B, C, C, B, A so that a host's drift
reads on both sides:

  A  `serial`        one ring, the clients on one socket, no kernel
                     stamps (`chip_smoke._sfu_drive`, the sfu path's
                     client);
  B  `one_ring_16`   one ring, the clients on 16 sockets, kernel stamps
                     (`chip_smoke.sfu_rings_run` with `rings=1`);
  C  `two_rings_16`  two rings, 16 sockets, kernel stamps (the
                     sfu_rings path).

Each turn prints one JSON line: the timed ticks' p50/p99 and each tick's
milliseconds (host clock, the bridge's `tick` calls only), each ring's
datagrams, and for B and C the profiled ticks' host time by span (the
same spans as the sfu path's profile) and the card's idle share.  Exits
2 when there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

TURNS = ("serial", "one_ring_16", "two_rings_16", "two_rings_16",
         "one_ring_16", "serial")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_rings_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from libjitsi_tpu_torch.kernels import build as kbuild

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kbuild.library()
    setup = cs._sfu_setup(torch, dev,
                          ticks=cs.SFU_RINGS_TICKS + cs.SFU_RINGS_PROFILED,
                          rr_ticks=(cs.SFU_RINGS_RR,),
                          nack_tick=cs.SFU_RINGS_NACK)
    for turn, kind in enumerate(TURNS):
        if kind == "serial":
            run = cs._sfu_drive(torch, dev, setup, cs.SFU_RINGS_TICKS,
                                feedback_every=cs.SFU_RINGS_FEEDBACK)
            prof, per_ring = None, None
            run["client"].close()
        else:
            run = cs.sfu_rings_run(torch, dev, setup,
                                   rings=1 if kind == "one_ring_16" else 2)
            prof, per_ring = run["profile"], run["per_ring"]
            run["fan"].close()
        run["bridge"].close()
        secs = np.array(run["tick_s"])
        print(json.dumps(dict(
            turn=turn, kind=kind, tick_ms_p50=float(np.median(secs)) * 1e3,
            tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
            ticks_ms=(secs * 1e3).tolist(), per_ring=per_ring,
            profile=prof)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
