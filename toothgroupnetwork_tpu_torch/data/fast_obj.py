"""ctypes binding to the native C++ .obj parser (``native/fast_obj.cpp`` at
the repository root; counterpart of toothgroupnetwork_tpu/data/fast_obj.py).

The library is optional: :func:`parse_obj_fast` returns None when
``native/libfast_obj.so`` is not built or does not load, and
``mesh_io.parse_obj`` then parses with numpy. Build: ``make -C native``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libfast_obj.so"

_lib = None
_tried = False
# scans prepared in several threads at once load the library once
_LOCK = threading.Lock()


def _load():
    with _LOCK:
        if not _tried:
            _open()
        return _lib


def _open():
    global _lib, _tried
    _tried = True
    if not LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    lib.fast_obj_parse.restype = ctypes.c_void_p
    lib.fast_obj_parse.argtypes = [ctypes.c_char_p]
    lib.fast_obj_nverts.restype = ctypes.c_long
    lib.fast_obj_nverts.argtypes = [ctypes.c_void_p]
    lib.fast_obj_nfaces.restype = ctypes.c_long
    lib.fast_obj_nfaces.argtypes = [ctypes.c_void_p]
    lib.fast_obj_copy.restype = None
    lib.fast_obj_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fast_obj_free.restype = None
    lib.fast_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def parse_obj_fast(path: str):
    """``(vertices [N, 3] float64, faces [F, 3] int64)`` from the native
    parser, or None when the library is absent or cannot open the file."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.fast_obj_parse(path.encode())
    if not handle:
        return None
    try:
        verts = np.empty((lib.fast_obj_nverts(handle), 3), dtype=np.float64)
        faces = np.empty((lib.fast_obj_nfaces(handle), 3), dtype=np.int64)
        lib.fast_obj_copy(handle, verts.ctypes.data_as(ctypes.c_void_p),
                          faces.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.fast_obj_free(handle)
    return verts, faces
