"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``tikv_tpu_torch/_build/``
(ignored by git) the first time a kernel is needed, then loaded with
``ctypes``.  Pointers cross as ``c_void_p``; the stream is torch's current
stream; each launcher returns ``cudaGetLastError()`` so a refused launch
raises in the wrapper instead of leaving zeros behind.

A library's file name carries a digest of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and never
confused with a stale binary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# every kernel source, csrc/<name>.cu: one library each
SOURCES = ("hash_agg", "twolevel", "selection", "topn", "agg_fold",
           "digest", "mvcc", "sort", "join", "window", "analyze")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):   # shared by sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    compiler's output (the ptxas register and shared-memory report), or ""
    when there was nothing to build; raises if ``nvcc`` fails."""
    out = lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                           str(SRC_DIR / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


# ----------------------------------------------------- wrapper helpers


def load_checked(name: str, layout: dict, error_fn: str) -> ctypes.CDLL:
    """``load(name)``, with each ``layout`` entry checked: the library's
    int-returning function of that name (a parameter struct's size, a
    tile's rows) must give the value the wrapper was written for.
    ``error_fn`` (int → const char*) is typed for ``raise_on``."""
    lib = load(name)
    for fn, want in layout.items():
        getattr(lib, fn).restype = ctypes.c_int
        got = getattr(lib, fn)()
        if got != want:
            raise RuntimeError(f"{name}: the kernel's {fn} is {got}, the "
                               f"wrapper's layout is {want}")
    err = getattr(lib, error_fn)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, error_fn: str, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + getattr(lib, error_fn)(err).decode())


def check_vector(t, name: str, n: int, device, dtypes) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of ``n`` rows on
    ``device`` with a dtype in ``dtypes``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of {n} "
                         f"rows, got {tuple(t.shape)}")
