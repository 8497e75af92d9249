"""K0, the launch layer: build the CUDA sources and bind them with ctypes.

Counterpart of ``paddle_tpu/kernels/primitives/contract.py`` (the one
``pallas_call`` site).  Every hand-written kernel of the port is a
``csrc/<name>.cu`` file with a plain C interface.  On first use this
module:

- compiles it with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
  -shared -Xcompiler -fPIC`` into ``paddle_tpu_torch/_build/`` (listed
  in ``.gitignore``);
- names the ``.so`` by a hash of the source and the flags, so an
  unchanged source builds once per checkout;
- loads it with ``ctypes`` and declares every C function's argument
  types (a pointer or a stream passed without a declaration would be
  cut to 32 bits).

A failed build raises with the compiler's output.  Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all",
           "build_log", "library_path", "load", "device_launches", "ptr",
           "stream_of"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def _so_path(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None):
    """Build every named kernel (default: all of ``csrc``) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns
    {name: seconds} for the builds that ran; raises on any failure."""
    names = list(names or sources())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT),
                         tmp, so, log, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, so, log, t0) in started.items():
        rc = proc.wait()
        took[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          f"{so.with_suffix('.log').read_text()[-4000:]}")
            continue
        os.replace(tmp, so)  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def library_path(name):
    """Path of the built library of kernel ``name`` (it may not exist
    yet)."""
    return _so_path(name)


def build_log(name):
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``, or '' if it was not built."""
    log = _so_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name, signatures):
    """The loaded library of kernel ``name``, built on first use.
    ``signatures`` maps each C function to its argtypes; every function
    returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_so_path(name)))
            signatures = dict(signatures, pt_device_launch_counts=(
                ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def device_launches(name, n):
    """The first ``n`` device launch counters of kernel library ``name``
    on the current device (``csrc/launch_count.cuh``: launches the card
    ran, graph replays included), or None when the library is not
    loaded (nothing of it ran).  Synchronizes the device."""
    lib = _libs.get(name)
    if lib is None:
        return None
    out = (ctypes.c_ulonglong * n)()
    check(f"{name} device launch counters",
          lib.pt_device_launch_counts(out, n))
    return list(out)


def ptr(t):
    """Device pointer of a tensor as a ctypes void pointer."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device):
    """PyTorch's current stream on ``device`` as a ctypes void pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name, err):
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")
