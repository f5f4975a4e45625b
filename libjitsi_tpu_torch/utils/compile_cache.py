"""What stands in for a compile on the port's data path, counted.

Counterpart: `libjitsi_tpu/utils/compile_cache.py`.  The JAX package
compiles an XLA program per shape and counts those compiles (and its
persistent cache's hits and misses) from `jax.monitoring` events.  The
port compiles nothing per shape: `kernels/build.py` builds one kernel
library with nvcc, and every shape runs the same kernels.  What a tick
can still pay for the first time is

- a build of the kernel library (a cache miss, with its seconds), or the
  reuse of one already built for the same sources (a hit), and
- the first launch of each kernel instance in the process: under CUDA's
  lazy module loading that launch loads the function.  The wrappers
  report it through `kernels/build.py` (`count_instance` and the launch
  counters); each first sight is one `compile_events`.

The lifecycle plane brackets every tick with `compile_events`
(`StreamLifecycleManager.tick_begin` / `tick_end`): a step inside a tick
is a first launch on the data path, which the warm-ups exist to prevent.
`compile_stats()` is a process singleton.
"""

from __future__ import annotations

import os
from typing import Optional, Set


class CompileCacheStats:
    """Process-wide counters, exported by the `PhaseProfiler` as
    `compile_cache_hits` / `compile_cache_misses` / `compile_events` /
    `compile_seconds_total`."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.compile_events = 0
        self.compile_seconds = 0.0
        self.instances: Set[str] = set()

    def on_build(self, built: bool, seconds: float = 0.0) -> None:
        """The kernel library was loaded: built now (a miss) or found
        built (a hit)."""
        if built:
            self.misses += 1
            self.compile_seconds += float(seconds)
        else:
            self.hits += 1

    def on_launch(self, key: str) -> None:
        """A kernel instance launched; its first launch in the process
        is a compile event."""
        if key not in self.instances:
            self.instances.add(key)
            self.compile_events += 1


_STATS: Optional[CompileCacheStats] = None


def compile_stats() -> CompileCacheStats:
    """The process's counters."""
    global _STATS
    if _STATS is None:
        _STATS = CompileCacheStats()
    return _STATS


def enable_compile_cache(path: str = "") -> str:
    """Keep the built kernel library in `path` (default: the package's
    git-ignored `build/`), so a later process on the same sources reuses
    it instead of running nvcc.  Takes effect for a library not yet
    loaded in this process.  Returns the directory."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    if not path:
        path = kbuild.BUILD_DIR
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    kbuild.BUILD_DIR = path
    return path
