"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded through
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries
land in ``apex_tpu_torch/_build/`` (git-ignored) under a name keyed on
a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one
loads the library already there.  A build runs at
first use.

Every failure raises: a missing ``nvcc``, a compile error, a library
that does not load.  There is no fallback to the plain PyTorch version
for a tensor on the card.

Host C++ (``csrc/<name>.cpp``, no CUDA) builds the same way with ``g++``
(:func:`host_library`): the checkpoint helpers of :mod:`apex_tpu_torch._native`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills) of each library built or loaded in this
# process (kept beside the library as ``<library>.log``)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's kernels are built from source at first use")


def _lib_path(name: str, host: bool = False) -> str:
    """The library's path, named by a hash of ``csrc/<name>.cu``, every
    header ``csrc/*.cuh`` (any source may include one) and the flags; for
    host C++, of ``csrc/<name>.cpp`` and the ``g++`` flags."""
    h = hashlib.sha256()
    if host:
        srcs, flags = [f"{name}.cpp"], GXX_FLAGS
    else:
        srcs = [f"{name}.cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh"))
        flags = NVCC_FLAGS
    for src in srcs:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str, host: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` (``host``: ``csrc/<name>.cpp`` with
    ``g++``) unless its library exists; returns the library's path."""
    path = _lib_path(name, host)
    if os.path.exists(path):
        if not host and os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                build_logs[name] = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    if host:
        src = f"{name}.cpp"
        tool, cmd = "g++", ["g++", *GXX_FLAGS, os.path.join(CSRC, src),
                            "-o", tmp]
    else:
        src = f"{name}.cu"
        tool, cmd = "nvcc", [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                             os.path.join(CSRC, src)]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=600)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{tool} timed out building {src}")
    except FileNotFoundError:
        raise RuntimeError(f"{tool} not found: {src} is built from "
                           "source at first use")
    if out.returncode != 0:
        raise RuntimeError(f"{tool} failed on {src} "
                           f"(exit {out.returncode}):\n{out.stdout}")
    if not host:
        build_logs[name] = out.stdout
    # publish atomically, the log first: a concurrent process never loads
    # a torn file
    with open(f"{tmp}.log", "w") as f:
        f.write(out.stdout)
    os.replace(f"{tmp}.log", f"{path}.log")
    os.replace(tmp, path)
    return path


def build_all(names: Sequence[str]) -> None:
    """Compile several sources at once, one ``nvcc`` each, all started
    together (each build publishes its library atomically, so this only
    overlaps the compiles that :func:`library` would run one by one)."""
    todo = sorted(set(names))
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        for f in [pool.submit(_build, n) for n in todo]:
            f.result()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build(name))
        return _libs[name]


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``csrc/<name>.cpp``,
    built with ``g++`` on first use; raises when it cannot be built or
    loaded."""
    key = f"{name}.cpp"
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(_build(name, host=True))
        return _libs[key]


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``library`` names the source (``csrc/<library>.cu``); ``name`` is the
    kernel's own name in counts and reports (default: the library's).

    The C function launches on the stream it is given and returns
    ``cudaGetLastError()`` (0 on success); :meth:`launch` raises on any
    other value and counts only launches that were accepted.  Every
    pointer and the stream pass as ``c_void_p`` — ``argtypes`` is set
    before the first call so ctypes never truncates a 64-bit pointer."""

    def __init__(self, library: str, symbol: str, argtypes: Sequence,
                 name: Optional[str] = None):
        self.library = library
        self.name = name or library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def function(self):
        if self._fn is None:
            fn = getattr(library(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{rc}")
        self.launches += 1


KERNELS: List[Kernel] = []


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
