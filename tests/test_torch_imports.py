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
`recording` among them, and the video plane's `codecs.vp8`, `vp9`,
`h264`, `vpx`, `avcodec`, `audio_avcodec`, `sfu.rtx`, `simulcast`, `svc`
and `recording.webm`, and the operations plane's `utils.health`,
`faults`, `slo`, `capacity`, `compile_cache`, `profiling` and
`service.supervisor`, `lifecycle`, `obs_server`), `chip_smoke.py` (with
its paths over the io_uring engine, TCP, the pumps, the video SFU and the
operations plane) and the scripts `scripts/torch_obs_smoke.py` and
`scripts/torch_churn_soak.py`.  A second child
refuses `cryptography` too: the keying controls import without it.  A
third makes libvpx and libavcodec fail to load: `codecs` and `sfu`
import all the same, and the bindings report themselves unavailable.
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
# the operations plane's scripts (their `main` is not run)
import importlib.util
for script in ("torch_obs_smoke", "torch_churn_soak"):
    spec = importlib.util.spec_from_file_location(
        script, "scripts/" + script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append("scripts." + script)
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
    # the video plane and the libavcodec legs
    for mod in ("codecs.vp8", "codecs.vp9", "codecs.h264", "codecs.vpx",
                "codecs.avcodec", "codecs.audio_avcodec", "sfu.rtx",
                "sfu.simulcast", "sfu.svc", "recording.webm",
                "service.sfu_bridge"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    # the operations plane and its scripts
    for mod in ("utils.health", "utils.faults", "utils.slo",
                "utils.capacity", "utils.compile_cache", "utils.profiling",
                "service.supervisor", "service.lifecycle",
                "service.obs_server"):
        assert f"libjitsi_tpu_torch.{mod}" in seen, mod
    assert {"scripts.torch_obs_smoke", "scripts.torch_churn_soak"} <= seen


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


_NO_MEDIA_LIBS = r"""
import ctypes, ctypes.util

real_cdll = ctypes.CDLL.__init__

def refuse(self, name, *a, **k):
    if name and ("vpx" in str(name) or "avcodec" in str(name)
                 or "avutil" in str(name)):
        raise OSError("no such library: " + str(name))
    real_cdll(self, name, *a, **k)

ctypes.CDLL.__init__ = refuse
from libjitsi_tpu_torch import codecs, sfu
from libjitsi_tpu_torch.codecs import audio_avcodec, avcodec, vpx
from libjitsi_tpu_torch.service import pump
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
assert not codecs.vpx_available() and not avcodec.h264_available()
assert not audio_avcodec.audio_decoder_available("g729")
try:
    pump.codec_from_name("G729", 20)
    raise SystemExit("a G.729 leg without libavcodec")
except OSError:
    pass
print("ok")
"""


def test_video_plane_imports_without_libvpx_or_libavcodec():
    """The bindings load their library at first use: without libvpx and
    libavcodec the packages import, report the codecs unavailable, and a
    G.729 leg raises the JAX binding's error."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_MEDIA_LIBS], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr
