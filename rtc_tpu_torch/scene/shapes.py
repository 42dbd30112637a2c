"""Host-side scene-graph builder shapes (counterpart of
rtc_tpu/scene/shapes.py; reference: src/shape.rs:13-229).

`set_transform` on a group composes the matrix into every leaf at once
(reference: src/shape.rs:196-218), so by compile time the tree is flat in
the transform sense; a second `set_transform` raises (src/shape.rs:199-201).

Kinds: 'sphere' | 'plane' | 'cube' | 'cylinder' | 'cone' | 'group' |
'triangle' | 'mesh'. 'mesh' is a block of triangles sharing one transform
and material.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .materials import Material

KIND_CODES = {"sphere": 0, "plane": 1, "cube": 2, "cylinder": 3, "cone": 4}


@dataclasses.dataclass
class Shape:
    kind: str
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )
    material: Material = dataclasses.field(default_factory=Material)
    children: List["Shape"] = dataclasses.field(default_factory=list)
    # cylinder/cone
    minimum: float = -np.inf
    maximum: float = np.inf
    capped: bool = False
    # triangle
    p1: Optional[np.ndarray] = None
    p2: Optional[np.ndarray] = None
    p3: Optional[np.ndarray] = None
    # mesh: (T, 3) per-corner vertex arrays, plus optional per-corner normals
    v1: Optional[np.ndarray] = None
    v2: Optional[np.ndarray] = None
    v3: Optional[np.ndarray] = None
    vn1: Optional[np.ndarray] = None
    vn2: Optional[np.ndarray] = None
    vn3: Optional[np.ndarray] = None
    _transformed: bool = False

    def set_transform(self, m) -> "Shape":
        """Once-only, group push-down (reference: src/shape.rs:196-205)."""
        if self._transformed:
            raise RuntimeError("Can't call set_transform more than once.")
        self._transformed = True
        self._set_transform_internal(np.asarray(m, dtype=np.float64).reshape(4, 4))
        return self

    def _set_transform_internal(self, m: np.ndarray) -> None:
        """(reference: src/shape.rs:207-218)"""
        if self.kind == "group":
            for child in self.children:
                child._set_transform_internal(m)
        else:
            self.transform = m @ self.transform

    def set_material(self, material: Material) -> "Shape":
        """Recursive over groups (reference: src/shape.rs:220-229)."""
        if self.kind == "group":
            for child in self.children:
                child.set_material(material)
        else:
            self.material = dataclasses.replace(material)
        return self

    def push_shape(self, shape: "Shape") -> "Shape":
        """(reference: src/shape.rs:528-535)"""
        if self.kind != "group":
            raise RuntimeError("push_shape was called on something that isn't a group")
        self.children.append(shape)
        return self


def _pt(p) -> np.ndarray:
    return np.asarray(p, dtype=np.float64).reshape(3)


def _leaf(kind: str, transform, material: Optional[Material], **kw) -> Shape:
    s = Shape(kind, **kw)
    if material is not None:
        s.material = material
    if transform is not None:
        s.set_transform(transform)
    return s


def sphere(transform=None, material: Optional[Material] = None) -> Shape:
    return _leaf("sphere", transform, material)


def plane(transform=None, material: Optional[Material] = None) -> Shape:
    return _leaf("plane", transform, material)


def cube(transform=None, material: Optional[Material] = None) -> Shape:
    return _leaf("cube", transform, material)


def cylinder(minimum=-np.inf, maximum=np.inf, capped=False,
             transform=None, material: Optional[Material] = None) -> Shape:
    """(reference: src/shape.rs:100-128)"""
    return _leaf("cylinder", transform, material, minimum=float(minimum),
                 maximum=float(maximum), capped=bool(capped))


def cone(minimum=-np.inf, maximum=np.inf, capped=False,
         transform=None, material: Optional[Material] = None) -> Shape:
    """(reference: src/shape.rs:130-158)"""
    return _leaf("cone", transform, material, minimum=float(minimum),
                 maximum=float(maximum), capped=bool(capped))


def triangle(p1, p2, p3, material: Optional[Material] = None) -> Shape:
    """(reference: src/shape.rs:171-193)"""
    return _leaf("triangle", None, material, p1=_pt(p1), p2=_pt(p2), p3=_pt(p3))


def group(children=(), transform=None) -> Shape:
    g = Shape("group", children=list(children))
    if transform is not None:
        g.set_transform(transform)
    return g


def mesh(v1, v2, v3, vn1=None, vn2=None, vn3=None,
         transform=None, material: Optional[Material] = None) -> Shape:
    """A triangle soup: v1/v2/v3 are (T, 3) per-corner vertex arrays.
    vn1/vn2/vn3 (optional, (T, 3)) ask for smooth normals."""
    def rows(a):
        return None if a is None else np.asarray(a, dtype=np.float64).reshape(-1, 3)

    return _leaf("mesh", transform, material, v1=rows(v1), v2=rows(v2),
                 v3=rows(v3), vn1=rows(vn1), vn2=rows(vn2), vn3=rows(vn3))


def smooth_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex normals as the area-weighted average of adjacent face
    normals. verts: (V, 3); faces: (F, 3) 0-based. Face orientation follows
    the reference's winding n = (p3-p1) x (p2-p1) (src/shape.rs:171-193)."""
    p1, p2, p3 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(p3 - p1, p2 - p1)  # length-weighted (2x area)
    out = np.zeros_like(verts)
    for c in range(3):
        np.add.at(out, faces[:, c], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.divide(out, norm, out=np.zeros_like(out), where=norm > 0)


def triangle_edges(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray):
    """Precomputed e1/e2/normal exactly as the reference ctor
    (src/shape.rs:171-193): e1 = p2-p1, e2 = p3-p1, n = normalize(e2 x e1)."""
    e1 = p2 - p1
    e2 = p3 - p1
    n = np.cross(e2, e1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.divide(n, norm, out=np.zeros_like(n), where=norm != 0)
    return e1, e2, n
