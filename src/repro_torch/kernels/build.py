"""Build and load the CUDA kernels of ``kernels/csrc/``.

Each ``*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Libraries go
into ``kernels/_build/`` (listed in ``.gitignore``) under a name keyed on
a hash of the sources, so an edited source is rebuilt and a stale build
never loads.  Builds run at first use, all sources in parallel, and a
finished library is moved into place atomically, so two processes that
build at once both end with a whole file.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flashsketch_fwd.cu", "flashsketch_transpose.cu",
           "flashsketch_blockrow.cu", "flashsketch_v1.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        "source at first use")


def _key(source: str) -> str:
    """Hash of the source, every header of csrc/ and the flags."""
    h = hashlib.sha256()
    for name in [source] + sorted(p.name for p in CSRC.glob("*.cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_key(source)}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library of ``sources`` in parallel, one
    ``nvcc`` per source; raise with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: _lib_path(s) for s in sources}
    procs = []
    for src, out in todo.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            errors.append(f"{src}:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return todo


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]))
            _LIBS[source] = lib
        return lib
