"""ctypes bindings to the framework-free C++ host runtime's OBJ parser and
PPM encoder (native/rtc_native.cpp, built as native/librtc_native.so with
`make -C native`), and its Morton order of points. Counterpart of
rtc_tpu/native.py.

All are host work: when the library is absent, io/obj.py parses and
io/canvas.py encodes in Python, with the same result, and morton_order
returns None (the renderer orders its rays in render/order.py).
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
    lib.ppm_encode.restype = ctypes.c_int64
    lib.ppm_encode.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.morton_order.restype = None
    lib.morton_order.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64)]
    return lib


def available() -> bool:
    """Whether native/librtc_native.so was found and loaded."""
    return _load() is not None


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


def encode_ppm(pixels: np.ndarray) -> Optional[bytes]:
    """P3 PPM bytes of an (H, W, 3) float image, or None when the library is
    absent. The encoder reads float64: a float32 image is widened first,
    exactly, so both packages quantize the same values."""
    lib = _load()
    if lib is None:
        return None
    pixels = np.ascontiguousarray(pixels, dtype=np.float64)
    if pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"encode_ppm: expected an (H, W, 3) image, got "
                         f"shape {pixels.shape}")
    h, w = pixels.shape[0], pixels.shape[1]
    ptr = pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    size = lib.ppm_encode(ptr, w, h, None, 0)
    out = ctypes.create_string_buffer(size)
    lib.ppm_encode(ptr, w, h, out, size)
    return out.raw[:size]


def morton_order(centroids: np.ndarray) -> Optional[np.ndarray]:
    """The Morton (Z-curve) order of (N, 3) points, (N,) i64 indices, or
    None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    if centroids.ndim != 2 or centroids.shape[1] != 3:
        raise ValueError(f"morton_order: expected (N, 3) points, got shape "
                         f"{centroids.shape}")
    order = np.empty((len(centroids),), dtype=np.int64)
    lib.morton_order(centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     len(centroids), order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order
