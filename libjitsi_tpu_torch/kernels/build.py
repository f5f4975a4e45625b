"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in `libjitsi_tpu_torch/csrc/*.cu` behind a plain C
interface.  On first use each source is compiled by its own `nvcc`
(all started together) for `sm_90a`, the objects are linked into one
shared library under the package's `build/` directory (git-ignored),
and the library is loaded with ctypes.  The library is keyed by a hash
of the sources, so an edited kernel is rebuilt and an unchanged one is
reused.  Nothing here runs at import: the CPU tests import every module
of the port on a machine without `nvcc`.

Launch accounting: every wrapper adds one to `launches[name]` where it
launches its kernel (every wrapper of a kernel that runs AES, C, D, H,
I, J, K, L, M, N and O, also to `instance_launches` under the
instance's AES rounds), and every plain PyTorch version adds one to
`plain_calls[name]` when it runs.  A run shows it went through the
kernels by resetting both, driving its path, and reading them back.
The first launch of each kernel and of each counted instance in the
process, and the library's build or reuse, also feed
`utils/compile_cache.compile_stats()` (a reset leaves those alone).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

from libjitsi_tpu_torch.utils.compile_cache import compile_stats

KERNELS = ("aes_encrypt", "hmac_sha1", "srtp_protect_cm", "srtp_unprotect_cm",
           "mix_minus", "g711_encode", "g711_decode", "srtp_fanout_cm",
           "srtcp_protect_cm", "srtcp_unprotect_cm",
           # AES-F8 (K, L and I's and J's F8 instances) and the NULL cipher
           # (C's, D's, I's and J's NULL instances)
           "srtp_protect_f8", "srtp_unprotect_f8", "srtcp_protect_f8",
           "srtcp_unprotect_f8", "srtp_protect_null", "srtp_unprotect_null",
           "srtcp_protect_null", "srtcp_unprotect_null",
           # kernel H's NULL and AES-F8 instances (the SFU fan-out)
           "srtp_fanout_null", "srtp_fanout_f8",
           # AEAD-GCM: kernels M and N and their cached instances, H's GCM
           # instance and kernel O (the keystream cache's fill)
           "srtp_gcm_seal", "srtp_gcm_open", "srtp_gcm_seal_cached",
           "srtp_gcm_open_cached", "srtp_fanout_gcm", "gcm_ks_fill",
           # kernel R: the polyphase resampler (K13b)
           "resample")

class _LaunchCounts(dict):
    """The launch counters; a count that rises reports the kernel's
    launch to `compile_stats()`, whose first sight of it is a compile
    event."""

    def __setitem__(self, name: str, value: int) -> None:
        if value > self.get(name, 0):
            compile_stats().on_launch(name)
        super().__setitem__(name, value)


launches: Dict[str, int] = _LaunchCounts.fromkeys(KERNELS, 0)
plain_calls: Dict[str, int] = dict.fromkeys(KERNELS, 0)
#: launches of each AES-rounds instance of the SRTP, SRTCP, fan-out and
#: GCM kernels (C, D, H, I, J, K, L, M, N, O and their NULL and GCM
#: instances; not the cached GCM instances, which run no AES), keyed as
#: "srtp_protect_cm nr=14": a wrapper counts its instance beside its
#: kernel, where it launches
instance_launches: Dict[str, int] = {}

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# per-argument element cap: sizes and grid-stride indices are C ints
MAX_ELEMENTS = 1 << 30

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: seconds the last build of this process took (0.0 when reused/unbuilt)
build_seconds = 0.0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ljt_aes_encrypt": [_P, _P, _P, _I, _I, _P],
    "ljt_hmac_sha1": [_P, _P, _P, _P, _I, _I, _P],
    "ljt_srtp_protect_cm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    "ljt_srtp_unprotect_cm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _P],
    "ljt_srtp_protect_null": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P],
    "ljt_srtp_unprotect_null": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _P],
    "ljt_srtp_protect_f8": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    "ljt_srtp_unprotect_f8": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _I, _I, _I, _I, _P],
    "ljt_srtp_fanout_cm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                           _P, _P, _I, _I, _I, _I, _P],
    "ljt_srtp_fanout_null": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                             _P, _P, _I, _I, _I, _I, _P],
    "ljt_srtp_fanout_f8": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                           _P, _P, _I, _I, _I, _I, _P],
    "ljt_srtcp_protect_cm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P],
    "ljt_srtcp_unprotect_cm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _P],
    "ljt_srtcp_protect_null": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _P],
    "ljt_srtcp_unprotect_null": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _P],
    "ljt_srtcp_protect_f8": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _P],
    "ljt_srtcp_unprotect_f8": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _I, _I, _P],
    "ljt_srtp_gcm_seal": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _P],
    "ljt_srtp_gcm_open": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _P],
    "ljt_srtp_gcm_seal_cached": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                                 _P, _P, _P, _I, _I, _P],
    "ljt_srtp_gcm_open_cached": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                                 _P, _P, _P, _P, _I, _I, _P],
    "ljt_srtp_fanout_gcm": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                            _P, _P, _I, _I, _I, _P],
    "ljt_srtp_gcm_phases": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _P],
    "ljt_gcm_ks_fill": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the phase probes of O and H-F8 (clock64 stamps; on no path)
    "ljt_gcm_ks_fill_phases": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _P],
    "ljt_srtp_fanout_f8_phases": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                                  _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # I-NULL's and J-NULL's phase probe (clock64 stamps; on no path)
    "ljt_srtcp_null_phases": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _I, _I, _I, _I, _I, _P],
    # K's and L's phase probe (clock64 stamps; on no path)
    "ljt_srtp_f8_phases": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ljt_mix_minus": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ljt_g711_encode": [_P, _P, _I, _I, _P],
    "ljt_g711_decode": [_P, _P, _I, _I, _P],
    "ljt_resample": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # R's phase probe (clock64 stamps; on no path)
    "ljt_resample_phases": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                            _P, _P],
    "ljt_probe_sha1_chain": [_P, _P, _I, _P],
    "ljt_probe_ghash_chain": [_P, _P, _P, _P, _I, _P],
    "ljt_probe_aes_chain": [_P, _P, _P, _I, _I, _P],
    "ljt_probe_empty": [_P],
    "ljt_probe_cluster": [_I, _P],
    "ljt_probe_hmac_row": [_P, _P, _I, _I, _P, _P, _I, _I, _P],
    "ljt_mix_minus_plan": [_P, _P, _I, _I, _I, _P],
}


def reset_counts() -> None:
    for name in KERNELS:
        launches[name] = 0
        plain_calls[name] = 0
    instance_launches.clear()


def count_instance(name: str, nr: int) -> None:
    key = f"{name} nr={nr}"
    instance_launches[key] = instance_launches.get(key, 0) + 1
    compile_stats().on_launch(key)


def _nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    return ([os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")],
            [os.path.join(CSRC_DIR, n) for n in names
             if n.endswith((".cu", ".cuh"))])


def build() -> str:
    """Compile the kernels (if their sources changed) and return the
    path of the shared library."""
    global build_seconds
    cus, all_src = _sources()
    h = hashlib.sha1()
    for p in all_src:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    key = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libljt_kernels_{key}.so")
    if os.path.exists(so):
        compile_stats().on_build(False)
        return so
    t0 = time.perf_counter()
    work = os.path.join(BUILD_DIR, f"obj_{key}_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in cus:
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log = []
    failed = []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(src)} (rc {p.returncode})\n"
                   + out.decode(errors="replace"))
        if p.returncode:
            failed.append(src)
    with open(os.path.join(BUILD_DIR, f"build_{key}.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(log))
    tmp = os.path.join(work, "lib.so")
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                    *[o for _s, o, _p in procs]], check=True,
                   capture_output=True)
    os.replace(tmp, so)            # atomic: concurrent builders agree
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    compile_stats().on_build(True, build_seconds)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expect(t: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device, shape=None) -> None:
    """Validate a kernel argument: device, dtype, contiguity, shape, and
    a size whose element indices stay inside the kernels' 32-bit ints."""
    if t.numel() > MAX_ELEMENTS:
        raise ValueError(f"{name}: {t.numel()} elements, the kernels take "
                         f"at most {MAX_ELEMENTS}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def route(t: torch.Tensor) -> str:
    """'cuda' or 'cpu' for a kernel wrapper's input; any other device
    is refused (there is no silent fallback)."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")
