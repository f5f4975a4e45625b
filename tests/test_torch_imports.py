"""The port imports nothing of JAX and nothing of the JAX package.

`tests/conftest.py` imports JAX into the pytest process, so the check
runs in a fresh interpreter with a meta-path hook that refuses `jax`,
`jaxlib` and `libjitsi_tpu` (exactly, or as a dotted prefix — so
`libjitsi_tpu_torch` itself passes) and then imports every module of
the port (the pipelined tick's `utils` modules, the AEAD-GCM slice's
`kernels.ghash`, `kernels.gcm` and `transform.srtp.keystream`, and the
resampler's `kernels.resample`, the host codecs' `codecs.*`, the
host I/O plane's `io.pcap` and `io.batching`, and the public stream
API's `control`, `rtp.stats`, `bwe.*`, `transform.dtmf` / `red` and
`service.*` among them), and `chip_smoke.py`.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "libjitsi_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import libjitsi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    libjitsi_tpu_torch.__path__, "libjitsi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every module was seen
    seen = set(out.stdout.split())
    for util in ("metrics", "tracing", "perf", "flight", "logging"):
        assert f"libjitsi_tpu_torch.utils.{util}" in seen, util
    # the AEAD-GCM slice's modules
    for mod in ("kernels.ghash", "kernels.gcm", "transform.srtp.keystream",
                "transform.srtp.kernel", "sfu.translator"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    # the resampler's and the host codecs' modules
    for mod in ("kernels.resample", "codecs", "codecs.g722", "codecs.opus"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    # the host I/O plane's own copies
    for mod in ("io.pcap", "io.batching", "io.udp", "io.loop"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    # the public stream API's modules
    for mod in ("core.config", "control", "control.sdes", "rtp.stats",
                "rtp.stats2", "bwe.aimd", "bwe.inter_arrival", "bwe.overuse",
                "bwe.rate_stats", "bwe.remote_estimator", "bwe.send_side",
                "transform.dtmf", "transform.red", "transform.header_ext",
                "service.media_stream", "service.typed_streams",
                "service.encodings", "service.media_service",
                "service.aux_services", "codecs.gsm", "codecs.speex"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
