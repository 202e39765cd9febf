"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object, all of them at once in parallel, and the objects are linked into one
shared library with a plain C interface that ctypes loads. Nothing includes
PyTorch's headers, so a build takes seconds. The library lands in
``build/torchft_tpu_torch/`` at the repo root (listed in ``.gitignore``),
named by a digest of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build. An exclusive ``flock`` serialises
builds across processes. The ptxas report of a build (registers, shared
memory, spills per kernel) is kept beside its library.

``build_library`` takes extra nvcc flags for builds other than the
library's own, such as ``-DTFT_SPLIT_LO=0`` (the kernels without the lo
half of their bf16 split, which the tolerance tests must reject); the flags
enter the digest, and ``load_kernels`` never passes any.

Nothing here runs at import time: the kernels are built on the first launch,
and only where there is a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torchft_tpu_torch")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# ptxas report (registers, shared memory, spills per kernel) of the last
# library this process loaded, read back from beside it when it was built
# earlier.
build_log = ""


def _sources(csrc: str) -> List[str]:
    return sorted(
        os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cu")
    )


def _digest(csrc: str, extra_flags: Sequence[str] = ()) -> str:
    flags = [*ARCH_FLAGS, *NVCC_FLAGS, *extra_flags]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(os.listdir(csrc)):
        if not f.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of torchft_tpu_torch are built from "
            "torchft_tpu_torch/csrc on first use"
        )
    return path


def _compile(csrc: str, lib_path: str, extra_flags: Sequence[str]) -> None:
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in _sources(csrc):
        obj = lib_path + "." + os.path.basename(src) + ".o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra_flags, "-c", src,
             "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(log)
        )
    tmp = lib_path + ".tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    with open(lib_path + ".log", "w") as fh:
        fh.write("\n".join(log))
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)


def _configure(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tft_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
    lib.tft_flash_fwd.restype = i
    lib.tft_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.tft_flash_bwd_dq.restype = i
    lib.tft_flash_bwd_dkv.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, f, i, p,
    ]
    lib.tft_flash_bwd_dkv.restype = i
    ll = ctypes.c_longlong
    lib.tft_quant_int8.argtypes = [p, ll, p, ll, p, ll, ll, ll, p]
    lib.tft_quant_int8.restype = i
    lib.tft_dequant_acc_int8.argtypes = [p, ll, p, ll, p, i, ll, ll, ll, ll,
                                         ll, i, p]
    lib.tft_dequant_acc_int8.restype = i


def build_library(csrc: str, build_dir: str,
                  extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The library of the kernel sources in ``csrc`` compiled with
    ``extra_flags`` besides the usual ones, built into ``build_dir`` unless
    a build of the same sources and flags is there already."""
    global build_log
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(
        build_dir, f"libtft_kernels_{_digest(csrc, extra_flags)}.so")
    if not os.path.exists(lib_path):
        with open(os.path.join(build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(lib_path):
                _compile(csrc, lib_path, extra_flags)
    if os.path.exists(lib_path + ".log"):
        with open(lib_path + ".log") as fh:
            build_log = fh.read()
    lib = ctypes.CDLL(lib_path)
    _configure(lib)
    return lib


def load_kernels() -> ctypes.CDLL:
    """The library of this tree's kernels, built first if this tree has not
    built it yet. Every wrapper launches through it."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build_library(_CSRC, BUILD_DIR)
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned right after a launch."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError_t {rc} (1 is "
            "cudaErrorInvalidValue: a shape the kernel does not take)"
        )
