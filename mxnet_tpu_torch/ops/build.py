"""Build the port's hand-written CUDA kernel at first use.

``csrc/<name>.cu`` exports a plain C launcher.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library, cached under
``build/mxnet_tpu_torch/`` beside the package by a hash of the source and
the flags, and loaded with ``ctypes``.  Nothing is compiled when the
package is imported: :func:`load` builds on the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mxnet_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (looked in %s/bin and on PATH): the "
                         "CUDA kernels of mxnet_tpu_torch are compiled at "
                         "first use and need the CUDA toolkit" % home)
    return found


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest[:16]))
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (so, os.getpid())
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise MXNetError("nvcc failed on %s (exit %d):\n%s%s"
                                 % (src, proc.returncode, proc.stdout, proc.stderr))
            # rename is atomic: a concurrent builder never loads a half file
            os.replace(tmp, so)
        lib = _LIBS[name] = ctypes.CDLL(so)
        return lib
