"""A frozen Wavefront OBJ reader for the reference: `v x y z` vertices and
`f i j k [l ...]` faces, fan-triangulated, in file order across `g`
groups (the default group's faces first, then each named group's in the
order the names first appear); every other record is skipped. Smooth
normals, where a configuration asks for them, are the area-weighted sums
of the faces' (p3 - p1) x (p2 - p1) at each vertex index, normalised (the
Ray Tracer Challenge's triangle winding)."""

from __future__ import annotations

import numpy as np


def read_obj(path: str):
    """(vertices (V, 3) float64, faces (F, 3) int64, 0-based)."""
    verts, default, named, order, current = [], [], {}, [], None
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in tok[1:]]
                faces = default if current is None else named[current]
                faces.extend((idx[0], a, b) for a, b in zip(idx[1:-1], idx[2:]))
            elif tok[0] == "g":
                current = tok[1]
                named[current] = []
                if current not in order:
                    order.append(current)
    faces = default + [f for name in order for f in named[name]]
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64).reshape(-1, 3)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 3) unit normals per vertex index (zero where none)."""
    p1, p2, p3 = (verts[faces[:, c]] for c in range(3))
    fn = np.cross(p3 - p1, p2 - p1)
    out = np.zeros_like(verts)
    for c in range(3):
        np.add.at(out, faces[:, c], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return np.divide(out, norm, out=np.zeros_like(out), where=norm > 0)
