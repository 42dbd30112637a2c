"""ctypes binding to the framework-free C++ host runtime's OBJ parser
(native/rtc_native.cpp, built as native/librtc_native.so with
`make -C native`). Counterpart of rtc_tpu/native.py, OBJ part only.

Parsing is host work: when the library is absent, io/obj.py parses in
Python and gets the same result.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "native", "librtc_native.so")


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.obj_last_error.restype = ctypes.c_char_p
    lib.obj_last_error.argtypes = []
    for name in ("obj_num_vertices", "obj_num_faces", "obj_num_groups",
                 "obj_ignored_lines"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name, ctype in (("obj_copy_vertices", ctypes.c_double),
                        ("obj_copy_faces", ctypes.c_int64),
                        ("obj_copy_face_groups", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctype)]
    lib.obj_group_name.restype = ctypes.c_int64
    lib.obj_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_int64]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_obj(text: str):
    """(vertices (V, 3) f64, faces (F, 3) i64 0-based, face_group (F,) i64,
    group_names, ignored_lines), or None when the library is absent.
    Raises ValueError on malformed input, as the Python parser does."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    handle = lib.obj_parse(raw, len(raw))
    if not handle:
        raise ValueError(lib.obj_last_error().decode())
    try:
        nv = lib.obj_num_vertices(handle)
        nf = lib.obj_num_faces(handle)
        ng = lib.obj_num_groups(handle)
        verts = np.empty((nv, 3), dtype=np.float64)
        faces = np.empty((nf, 3), dtype=np.int64)
        fgroups = np.empty((nf,), dtype=np.int64)
        if nv:
            lib.obj_copy_vertices(
                handle, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if nf:
            lib.obj_copy_faces(
                handle, faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            lib.obj_copy_face_groups(
                handle, fgroups.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        names = []
        buf = ctypes.create_string_buffer(256)
        for i in range(ng):
            lib.obj_group_name(handle, i, buf, 256)
            names.append(buf.value.decode())
        ignored = lib.obj_ignored_lines(handle)
        return verts, faces, fgroups, names, int(ignored)
    finally:
        lib.obj_free(handle)
