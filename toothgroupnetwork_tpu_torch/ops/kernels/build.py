"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into ONE shared library
with a plain C interface and loaded with ``ctypes``. The library lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``), under a
name keyed by a hash of the sources and the compiler flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is compiled at
import: the first CUDA launch of any kernel builds the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_SIGNATURES = {
    # name: (argtypes, restype)
    "tgn_fps": ([_P, _P, _I, _I, _I, _P, _P, _P], _I),
    "tgn_knn": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
    "tgn_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "tgn_attention_gathered": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P], _I),
    "tgn_attention_smem_bytes": ([_I, _I, _I], _Z),
    "tgn_cell_select_x": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
    "tgn_cell_select_p": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "tgn_error_string": ([_I], ctypes.c_char_p),
}

# The loaded library is a process-wide resource: one handle, built once.
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on any failure."""
    global _lib
    if _lib is not None:
        return _lib
    key = source_hash()
    out = BUILD_DIR / f"libtgn_kernels_{key}.so"
    log = BUILD_DIR / f"libtgn_kernels_{key}.log"
    t0 = time.perf_counter()
    built = False
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        built = True
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    build_info.update(path=str(out), key=key, built=built,
                      seconds=time.perf_counter() - t0, log=str(log))
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (refused launch, bad config)."""
    if status != 0:
        msg = library().tgn_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")
