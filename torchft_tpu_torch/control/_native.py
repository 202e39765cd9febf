"""ctypes loader for the native control plane.

The control plane is the repo's framework-neutral C++ library in native/,
the same sources the JAX package loads, so quorum decisions are
byte-identical through both bindings. The port compiles its own copy of the
library from those sources, with the Makefile's ``SRCS`` and ``CXXFLAGS``,
together with the port's own host helpers (``csrc/host/*.cc``: the heal
wire's CRC32C) into ``build/torchft_tpu_torch/native/`` (one compiler per
source, all in parallel), and links the C++ runtime into it privately
(``_LINK_FLAGS``). On an H100 host, in a process that has imported torch, the stock link of
``make -C native`` segfaults in the first Lighthouse or in the next thread
start: the libraries torch loads interpose the control plane's C++
runtime symbols. A static libstdc++/libgcc whose symbols stay local, with
the library's own references bound to its own definitions, is immune. The
build runs once per change of the sources, under an exclusive ``flock``,
so several processes never build at once.
The C ABI is defined in native/capi.cc; ctypes releases the GIL for every
native call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_HOST_DIR = os.path.join(_REPO_ROOT, "torchft_tpu_torch", "csrc", "host")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torchft_tpu_torch", "native")

_LINK_FLAGS = ["-shared", "-pthread", "-static-libstdc++", "-static-libgcc",
               "-Wl,-Bsymbolic", "-Wl,--exclude-libs,ALL"]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _makefile_var(text: str, name: str) -> List[str]:
    m = re.search(rf"^{name}\s*\??=\s*(.+)$", text, re.MULTILINE)
    if not m:
        raise RuntimeError(f"native/Makefile has no {name} line")
    return m.group(1).split()


def _host_srcs() -> List[str]:
    return sorted(os.path.join(_HOST_DIR, f) for f in os.listdir(_HOST_DIR)
                  if f.endswith(".cc"))


def lib_path() -> str:
    """Where this tree's build of the library lives (named by a digest of
    the sources, headers, flags and Makefile)."""
    h = hashlib.sha256(" ".join(_LINK_FLAGS).encode())
    inputs = [os.path.join(_NATIVE_DIR, n)
              for n in sorted(os.listdir(_NATIVE_DIR))
              if n.endswith((".cc", ".h")) or n == "Makefile"]
    for path in inputs + _host_srcs():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(_BUILD_DIR,
                        f"libtorchft_tpu_native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    with open(os.path.join(_NATIVE_DIR, "Makefile")) as f:
        text = f.read()
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _makefile_var(text, "SRCS")]
    srcs += _host_srcs()
    cxxflags = _makefile_var(text, "CXXFLAGS")
    cxx = os.environ.get("CXX", "g++")
    # niced: a first-use build must not starve the caller's siblings (e.g.
    # timing-sensitive tests running beside it)
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    objs, procs = [], []
    for src in srcs:
        obj = f"{path}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [*nice, cxx, *cxxflags, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = [(p, p.communicate()[0]) for p in procs]
    failed = [out for p, out in outs if p.returncode != 0]
    if failed:
        raise RuntimeError("failed to build the native control plane:\n"
                           + "\n".join(failed))
    tmp = path + ".tmp"
    link = subprocess.run(
        [cxx, *_LINK_FLAGS, *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("failed to link the native control plane:\n"
                           + link.stdout)
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)


def _configure(lib: ctypes.CDLL) -> None:
    c_char_p = ctypes.c_char_p
    c_void_p = ctypes.c_void_p
    c_i64 = ctypes.c_int64
    c_u64 = ctypes.c_uint64
    c_int = ctypes.c_int
    err_p = ctypes.POINTER(c_char_p)

    lib.ft_free.argtypes = [c_void_p]
    lib.ft_free.restype = None

    lib.ft_lighthouse_new.argtypes = [
        c_char_p, c_int, c_char_p, c_u64, c_u64, c_u64, c_u64, c_char_p,
        err_p,
    ]
    lib.ft_lighthouse_new.restype = c_void_p
    lib.ft_lighthouse_address.argtypes = [c_void_p]
    lib.ft_lighthouse_address.restype = c_void_p  # char* we must free
    lib.ft_lighthouse_shutdown.argtypes = [c_void_p]
    lib.ft_lighthouse_shutdown.restype = None
    lib.ft_lighthouse_free.argtypes = [c_void_p]
    lib.ft_lighthouse_free.restype = None

    lib.ft_manager_new.argtypes = [
        c_char_p, c_char_p, c_char_p, c_char_p, c_int, c_char_p,
        c_u64, c_u64, c_u64, c_int, c_char_p, err_p,
    ]
    lib.ft_manager_new.restype = c_void_p
    lib.ft_manager_address.argtypes = [c_void_p]
    lib.ft_manager_address.restype = c_void_p
    lib.ft_manager_kill_requested.argtypes = [c_void_p]
    lib.ft_manager_kill_requested.restype = c_int
    lib.ft_manager_shutdown.argtypes = [c_void_p]
    lib.ft_manager_shutdown.restype = None
    lib.ft_manager_free.argtypes = [c_void_p]
    lib.ft_manager_free.restype = None

    lib.ft_manager_client_new.argtypes = [c_char_p, c_u64, err_p]
    lib.ft_manager_client_new.restype = c_void_p
    lib.ft_manager_client_quorum.argtypes = [
        c_void_p, c_i64, c_i64, c_char_p, c_int, c_int, c_i64, c_u64, err_p,
    ]
    lib.ft_manager_client_quorum.restype = c_void_p
    lib.ft_manager_client_epoch_watch.argtypes = [
        c_void_p, c_i64, c_u64, err_p,
    ]
    lib.ft_manager_client_epoch_watch.restype = c_void_p
    lib.ft_manager_client_checkpoint_metadata.argtypes = [
        c_void_p, c_i64, c_u64, err_p,
    ]
    lib.ft_manager_client_checkpoint_metadata.restype = c_void_p
    lib.ft_manager_client_should_commit.argtypes = [
        c_void_p, c_i64, c_i64, c_int, c_u64, err_p,
    ]
    lib.ft_manager_client_should_commit.restype = c_int
    lib.ft_manager_client_kill.argtypes = [c_void_p, c_char_p, c_u64, err_p]
    lib.ft_manager_client_kill.restype = c_int
    lib.ft_manager_client_free.argtypes = [c_void_p]
    lib.ft_manager_client_free.restype = None

    # one-shot lighthouse RPCs (a connection per call)
    lib.ft_lighthouse_client_heartbeat.argtypes = [
        c_char_p, c_char_p, c_u64, err_p,
    ]
    lib.ft_lighthouse_client_heartbeat.restype = c_int
    lib.ft_lighthouse_client_quorum.argtypes = [
        c_char_p, c_char_p, c_u64, err_p,
    ]
    lib.ft_lighthouse_client_quorum.restype = c_void_p
    # persistent lighthouse client handles (pooled keep-alive)
    lib.ft_lighthouse_client_new.argtypes = [c_char_p, err_p]
    lib.ft_lighthouse_client_new.restype = c_void_p
    lib.ft_lighthouse_client_free.argtypes = [c_void_p]
    lib.ft_lighthouse_client_free.restype = None
    lib.ft_lighthouse_client_heartbeat2.argtypes = [
        c_void_p, c_char_p, c_u64, err_p,
    ]
    lib.ft_lighthouse_client_heartbeat2.restype = c_int
    lib.ft_lighthouse_client_quorum2.argtypes = [
        c_void_p, c_char_p, c_u64, err_p,
    ]
    lib.ft_lighthouse_client_quorum2.restype = c_void_p
    # generic POST (RegisterJob, a raw EpochWatch)
    lib.ft_lighthouse_client_post.argtypes = [
        c_void_p, c_char_p, c_char_p, c_u64, err_p,
    ]
    lib.ft_lighthouse_client_post.restype = c_void_p

    lib.ft_quorum_compute.argtypes = [c_i64, c_char_p, c_char_p, err_p]
    lib.ft_quorum_compute.restype = c_void_p
    lib.ft_compute_quorum_results.argtypes = [c_char_p, c_i64, c_char_p,
                                              err_p]
    lib.ft_compute_quorum_results.restype = c_void_p
    lib.ft_json_roundtrip.argtypes = [c_char_p, err_p]
    lib.ft_json_roundtrip.restype = c_void_p

    # incremental-quorum driver (the byte-identity oracle in the tests)
    lib.ft_iq_new.argtypes = [c_char_p, c_int, c_i64, err_p]
    lib.ft_iq_new.restype = c_void_p
    lib.ft_iq_free.argtypes = [c_void_p]
    lib.ft_iq_free.restype = None
    lib.ft_iq_heartbeat.argtypes = [c_void_p, c_char_p, c_i64]
    lib.ft_iq_heartbeat.restype = None
    lib.ft_iq_join.argtypes = [c_void_p, c_i64, c_char_p, err_p]
    lib.ft_iq_join.restype = c_int
    lib.ft_iq_decision.argtypes = [c_void_p, c_i64, err_p]
    lib.ft_iq_decision.restype = c_void_p
    lib.ft_iq_install.argtypes = [c_void_p, c_i64, c_i64, err_p]
    lib.ft_iq_install.restype = c_void_p
    lib.ft_iq_state.argtypes = [c_void_p, err_p]
    lib.ft_iq_state.restype = c_void_p
    lib.ft_iq_counters.argtypes = [c_void_p, err_p]
    lib.ft_iq_counters.restype = c_void_p

    # the heal wire's CRC32C (csrc/host/crc32c.cc)
    lib.tft_crc32c.argtypes = [ctypes.c_uint32, c_void_p, ctypes.c_size_t]
    lib.tft_crc32c.restype = ctypes.c_uint32


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(path):  # another process built it
                        _build(path)
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
    return _lib


def take_string(ptr: int) -> str:
    """Copy a malloc'd char* into a Python str and free it."""
    lib = get_lib()
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode()  # type: ignore[union-attr]
    finally:
        lib.ft_free(ptr)


def check_error(err: "ctypes.c_char_p") -> None:
    """Raise from a `char** err` out-param; TIMEOUT: prefix → TimeoutError
    (the native Status mapping)."""
    if err.value is None:
        return
    msg = err.value.decode()
    get_lib().ft_free(err)  # the C side malloc'd the message
    if msg.startswith("TIMEOUT: "):
        raise TimeoutError(msg[len("TIMEOUT: "):])
    raise RuntimeError(msg)
