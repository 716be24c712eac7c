"""The native (C++) host module: the MVCC parse and build, the CHECKSUM
fold and the bulk-load SST builder (``fastbuild.cpp``).

Counterpart of the JAX package's ``native/__init__.py``, with one
difference of contract: a failed compile raises with the compiler's
output instead of leaving the entries unset, so no caller drops to a
slower rung without saying so.

``g++`` compiles the CPython extension at first use (never at import)
into ``tikv_tpu_torch/_build/``, under a name keyed by a digest of the
source and the command, through a temporary file and ``os.replace``, so
processes that build at once all load a whole file.  The four entries:

- ``mvcc_build_columnar(keys, vals, read_ts, prefix_skip, col_ids,
  col_kinds)`` → dict: the one-pass resolve and decode;
- ``mvcc_parse_planes(keys, vals, prefix_skip, col_ids, col_kinds,
  release_gil)`` → dict of flat planes (no schema: discovery mode);
- ``checksum_pairs(keys, vals)`` → (crc64-xz XOR fold, bytes);
- ``build_mvcc_sst(table_id, handles, col_ids, col_kinds, col_bufs,
  col_valid, commit_ts, start_ts)`` → the v2 SST container.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "fastbuild.cpp"
BUILD_DIR = SRC.parent.parent / "_build"

_LOCK = threading.Lock()
_MOD = None


def compile_command(out: str) -> list:
    """The ``g++`` command that builds the module into ``out``."""
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{sysconfig.get_paths()['include']}", str(SRC), "-o", out]


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(compile_command("")).encode())
    return BUILD_DIR / f"_fastbuild-{h.hexdigest()[:16]}.so"


def _load():
    so = lib_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(compile_command(tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"native module build failed: g++ exit "
                               f"{proc.returncode}\n{proc.stderr}")
        os.replace(tmp, so)
    spec = importlib.util.spec_from_file_location("_fastbuild", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def module():
    """The loaded extension, built on first use; raises when it cannot
    be built or loaded."""
    global _MOD
    with _LOCK:
        if _MOD is None:
            _MOD = _load()
        return _MOD


def mvcc_build_columnar(*args):
    return module().mvcc_build_columnar(*args)


def mvcc_parse_planes(*args):
    return module().mvcc_parse_planes(*args)


def checksum_pairs(keys, vals):
    return module().checksum_pairs(keys, vals)


def build_mvcc_sst(*args):
    return module().build_mvcc_sst(*args)
