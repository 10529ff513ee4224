"""Build the package's CUDA C++ kernels with ``nvcc`` and load them.

Each ``csrc/<stem>.cu`` compiles on its own into a shared library with a
plain ``extern "C"`` launcher, for ``sm_90a``, and is loaded with
``ctypes``; headers (``csrc/*.cuh``) hold what several sources share.
The build runs at first use, into ``mxnet_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, the
headers and the flags, so an edited source or header rebuilds and an
unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library",
           "build_all", "build_info"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_STEM_LOCKS = {}   # stem -> threading.Lock, so two sources build at once
_LIBS = {}         # stem -> ctypes.CDLL
_INFO = {}         # stem -> {"path", "seconds", "log"}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                         "are built from source at first use")
    return found


def _compile(stem):
    src = os.path.join(CSRC_DIR, stem + ".cu")
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "lib%s-%s.so" % (stem, digest))
    if os.path.exists(out):
        return out, 0.0, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed on %s (rc %d):\n%s%s"
                             % (src, proc.returncode, proc.stdout,
                                proc.stderr))
        os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def load_library(stem):
    """The loaded ``ctypes.CDLL`` for ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        stem_lock = _STEM_LOCKS.setdefault(stem, threading.Lock())
    with stem_lock:
        if stem not in _LIBS:
            path, seconds, log = _compile(stem)
            _LIBS[stem] = ctypes.CDLL(path)
            _INFO[stem] = {"path": path, "seconds": seconds, "log": log}
        return _LIBS[stem]


def build_all(stems):
    """Build several sources at once, one ``nvcc`` process each; returns
    ``{stem: seconds}`` (0.0 for a library already built).  The first
    build error is raised."""
    with ThreadPoolExecutor(max_workers=max(len(stems), 1)) as pool:
        for fut in [pool.submit(load_library, s) for s in stems]:
            fut.result()
    return {s: _INFO[s]["seconds"] for s in stems}


def build_info(stem):
    """``{"path", "seconds", "log"}`` of a loaded library (``log`` holds
    the ``-Xptxas -v`` register and shared-memory report)."""
    return dict(_INFO[stem])
