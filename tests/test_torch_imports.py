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
`service.*`, and the media graph's `io.tcp`, `rtp.jitter_buffer` and
`device.*`, and the keying slice's `control.dtls`, `control.zrtp` and
`recording` among them), and `chip_smoke.py` (with its paths over the
io_uring engine, TCP and the pumps).  A second child refuses
`cryptography` too: the keying controls import without it.
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
    # the io_uring engine's loader, the TCP connector and the media graph
    for mod in ("io.tcp", "rtp.jitter_buffer", "device", "device.sources",
                "device.sinks", "device.system", "service.pump"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    # the keying slice: DTLS-SRTP, ZRTP and the recorder
    for mod in ("control.dtls", "control.zrtp", "recording",
                "recording.recorder", "sfu.recovery"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod


_NO_CRYPTOGRAPHY = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
from libjitsi_tpu_torch.control import dtls, zrtp
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
assert not dtls.HAVE_CRYPTOGRAPHY and not zrtp.HAVE_CRYPTOGRAPHY
assert dtls.is_dtls(b"\x16") and not dtls.is_dtls(b"\x80")
try:
    dtls.DtlsSrtpEndpoint("server")
    raise SystemExit("an OpenSSL endpoint without cryptography")
except RuntimeError as e:
    assert "cryptography" in str(e)
c, s = dtls.StubDtlsEndpoint("client"), dtls.StubDtlsEndpoint("server")
out = c.handshake_packets()
while out:
    out = [r for d in out for x in s.feed(d) for r in c.feed(x)]
assert c.complete and s.complete
a = zrtp.ZrtpEndpoint(ssrc=1, algorithms={"ka": (zrtp.KA_DH3K,)})
b = zrtp.ZrtpEndpoint(ssrc=2)
wire = [(b, p) for p in a.hello_packets()] + [(a, p) for p in b.hello_packets()]
started = False
for _ in range(30):
    wire = [(a if dst is b else b, r) for dst, p in wire for r in dst.feed(p)]
    if not started and b"Hello   " in a._peer:
        wire += [(b, p) for p in a.initiate()]
        started = True
assert a.complete and b.complete and a.sas == b.sas
print("ok")
"""


def test_keying_controls_import_without_cryptography():
    """`cryptography` is a gated dependency of `control.dtls` and
    `control.zrtp`: without it both import, the stub endpoint handshakes,
    ZRTP agrees by DH3k, and only an OpenSSL endpoint refuses."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_CRYPTOGRAPHY], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr
