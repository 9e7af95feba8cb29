"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` process
per source, all started together, and linked into ONE shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
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
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _Z, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: (argtypes, restype)
    "tgn_fps": ([_P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
    "tgn_fps_chain": ([_I, _I, _I, _I, _P, _P], _I),
    "tgn_knn": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
    "tgn_knn_c": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "tgn_knn_any": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "tgn_knn_scratch": ([_I, _I, _I, _I, _I, ctypes.POINTER(_Z)], _I),
    "tgn_knn_geometry": ([_I, _IP], _I),
    "tgn_project_kv": ([_P, _P, _P, _I, _I, _I, _P, _I, _P], _I),
    "tgn_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P], _I),
    "tgn_attention_gathered": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                                _P], _I),
    "tgn_attention_projected": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
                                _I),
    "tgn_attention_smem_bytes": ([_I, _I, _I, _I, _I], _Z),
    "tgn_attention_param_map": ([_I, _I, _IP], _I),
    "tgn_cell_select_x": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
    "tgn_gather_rows": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
    "tgn_cell_select_p": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "tgn_dbscan": ([_P, _I, _D, _I, _P, _P, _P], _I),
    "tgn_mean_shift": ([_P, _P, _P, _P, _I, _D, _D, _I, _P, _P, _P], _I),
    "tgn_error_string": ([_I], ctypes.c_char_p),
}

# The loaded library is a process-wide resource: one handle, built once,
# under a lock, so that threads arriving together (the scans of
# ``TgnInferencePipeline.run_many``) neither compile nor load it twice.
_lib: ctypes.CDLL | None = None
_LOCK = threading.Lock()
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


def _run(cmds: list[list[str]], log: list[str]) -> None:
    """Run the commands side by side, their output appended to ``log``;
    raise if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        stdout, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{stdout}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(out: Path, log_path: Path) -> None:
    """Each source to an object file (all at once), then one link; the
    compiler's output goes to ``log_path`` whether or not it succeeds."""
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.d")
    tmp.mkdir(exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp / (s.stem + ".o") for s in sources]
    log: list[str] = []
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
              for s, o in zip(sources, objs)], log)
        _run([[nvcc, "-shared", "-o", str(tmp / out.name), *map(str, objs)]], log)
        os.replace(tmp / out.name, out)
    finally:
        log_path.write_text("\n".join(log))
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on any failure."""
    if _lib is not None:
        return _lib
    with _LOCK:
        return _lib or _load()


def _load() -> ctypes.CDLL:
    """Build (if the library of these sources is absent) and load; called
    under ``_LOCK``."""
    global _lib
    key = source_hash()
    out = BUILD_DIR / f"libtgn_kernels_{key}.so"
    log = BUILD_DIR / f"libtgn_kernels_{key}.log"
    t0 = time.perf_counter()
    built = False
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(out, log)
        built = True
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    build_info.update(path=str(out), key=key, built=built,
                      seconds=time.perf_counter() - t0, log=str(log),
                      loads=build_info.get("loads", 0) + 1)
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (refused launch, bad config)."""
    if status != 0:
        msg = library().tgn_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")
