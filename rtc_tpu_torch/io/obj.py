"""Wavefront OBJ parser (counterpart of rtc_tpu/io/obj.py; reference:
src/obj_file.rs).

Host-side and numpy-native, with the reference's subset: `v x y z`
vertices, `f i j k [l ...]` faces with fan triangulation, `g name` groups;
anything else counts toward `ignored_lines`. strict=False also reads `vn`
records and `f v/vt/vn` faces. Each group becomes ONE `mesh` shape.

Strict parses go through the C++ runtime when native/librtc_native.so is
present (rtc_tpu_torch.native); the Python parser gives the same result.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..scene.shapes import Shape, group, mesh, smooth_vertex_normals


def _parse_native(text: str) -> Optional["Parser"]:
    parsed = native.parse_obj(text)
    if parsed is None:
        return None
    verts, faces, fgroups, names, ignored = parsed
    p = Parser()
    p.vertices_list = list(verts)
    p.ignored_lines = int(ignored)
    p._group_order = list(names)
    p.named_faces = {n: [] for n in names}
    for (a, b, c), g in zip(faces + 1, fgroups):
        tri = (int(a), int(b), int(c))
        if g < 0:
            p.default_faces.append(tri)
        else:
            p.named_faces[names[g]].append(tri)
    return p


class Parser:
    def __init__(self) -> None:
        self.vertices_list: List[np.ndarray] = []
        self.normals_list: List[np.ndarray] = []  # extension: `vn` records
        self.ignored_lines: int = 0
        # face index triples per group; the default group is kept apart
        self.default_faces: List[tuple] = []
        self.named_faces: Dict[str, List[tuple]] = {}
        # parallel per-face normal-index triples (None when unspecified)
        self.default_face_normals: List[Optional[tuple]] = []
        self.named_face_normals: Dict[str, List[Optional[tuple]]] = {}
        self._group_order: List[str] = []

    @classmethod
    def from_obj_file(cls, filename: str, strict: bool = True) -> "Parser":
        with open(filename, "r") as f:
            return cls.from_obj_str(f.read(), strict=strict)

    @classmethod
    def from_obj_str(cls, text: str, strict: bool = True) -> "Parser":
        """strict=True matches the reference exactly (slash-form face
        indices raise, `vn` lines count as ignored — src/obj_file.rs:58-76,
        107). strict=False reads `vn` records and `f v/vt/vn` faces."""
        if strict:
            parsed = _parse_native(text)
            if parsed is not None:
                return parsed
        return cls._from_obj_str_py(text, strict=strict)

    @classmethod
    def _from_obj_str_py(cls, text: str, strict: bool = True) -> "Parser":
        self = cls()
        current: Optional[str] = None
        for line in text.splitlines():
            tokens = line.split()
            if not tokens:
                continue
            cmd = tokens[0]
            if cmd == "v":
                if len(tokens) < 4:
                    raise ValueError(f'vertex needs x y z in "{line}"')
                self.vertices_list.append(
                    np.array([float(tokens[1]), float(tokens[2]), float(tokens[3])]))
            elif cmd == "vn" and not strict:
                if len(tokens) < 4:
                    raise ValueError(f'vn needs x y z in "{line}"')
                self.normals_list.append(
                    np.array([float(tokens[1]), float(tokens[2]), float(tokens[3])]))
            elif cmd == "f":
                if strict:
                    idx = [int(t) for t in tokens[1:]]  # raises on "1/2/3" like the reference
                    nidx = [None] * len(idx)
                else:
                    idx, nidx = [], []
                    for tok in tokens[1:]:
                        parts = tok.split("/")
                        idx.append(int(parts[0]))
                        nidx.append(
                            int(parts[2]) if len(parts) >= 3 and parts[2] else None)
                if len(idx) < 3:
                    raise ValueError(f'face needs at least 3 vertices in "{line}"')
                v1, n1 = idx[0], nidx[0]
                # fan triangulation (src/obj_file.rs:70-94)
                for (a, na), (b, nb) in zip(zip(idx[1:-1], nidx[1:-1]),
                                            zip(idx[2:], nidx[2:])):
                    tri = (v1, a, b)
                    tri_n = (n1, na, nb) if (n1 and na and nb) else None
                    if current is None:
                        self.default_faces.append(tri)
                        self.default_face_normals.append(tri_n)
                    else:
                        self.named_faces[current].append(tri)
                        self.named_face_normals[current].append(tri_n)
            elif cmd == "g":
                if len(tokens) < 2:
                    raise ValueError(f'group needs a name in "{line}"')
                name = tokens[1]
                # a repeated name resets the group, like HashMap::insert
                # (src/obj_file.rs:101-103)
                self.named_faces[name] = []
                self.named_face_normals[name] = []
                if name not in self._group_order:
                    self._group_order.append(name)
                current = name
            else:
                self.ignored_lines += 1
        return self

    def vertices(self, one_based_index: int) -> np.ndarray:
        """1-based lookup (src/obj_file.rs:115-117)."""
        return self.vertices_list[one_based_index - 1]

    def _faces_to_mesh(self, faces: List[tuple],
                       face_normals: Optional[List[Optional[tuple]]] = None,
                       smooth: bool = False) -> Shape:
        verts = np.stack(self.vertices_list) if self.vertices_list else np.zeros((0, 3))
        tri = np.asarray(faces, dtype=np.int64).reshape(-1, 3) - 1
        v1, v2, v3 = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]

        vn1 = vn2 = vn3 = None
        has_vn = (face_normals is not None and len(face_normals) == len(faces)
                  and all(fn is not None for fn in face_normals) and len(faces))
        if has_vn:
            norms = np.stack(self.normals_list)
            nidx = np.asarray(face_normals, dtype=np.int64).reshape(-1, 3) - 1
            vn1, vn2, vn3 = norms[nidx[:, 0]], norms[nidx[:, 1]], norms[nidx[:, 2]]
        elif smooth and len(faces):
            vnorm = smooth_vertex_normals(verts, tri)
            vn1, vn2, vn3 = vnorm[tri[:, 0]], vnorm[tri[:, 1]], vnorm[tri[:, 2]]
        return mesh(v1, v2, v3, vn1, vn2, vn3)

    def group_names(self) -> List[str]:
        return list(self._group_order)

    def group_mesh(self, name: Optional[str] = None, smooth: bool = False) -> Shape:
        """The triangles of one group as a mesh shape; None == default group."""
        faces = self.default_faces if name is None else self.named_faces[name]
        fns = (self.default_face_normals if name is None
               else self.named_face_normals.get(name))
        return self._faces_to_mesh(faces, fns, smooth=smooth)

    def obj_to_group(self, smooth: bool = False) -> Shape:
        """Wrap default + named groups into one group (src/obj_file.rs:120-128)."""
        children = [self.group_mesh(None, smooth=smooth)]
        for name in self._group_order:
            children.append(self.group_mesh(name, smooth=smooth))
        return group(children)


def load_obj(filename: str, smooth: bool = False, strict: Optional[bool] = None) -> Shape:
    """Parse a file and wrap its groups in one group (rtc_tpu
    io/obj.py:189-193). strict defaults to not smooth: a smooth load
    reads `vn` records and `f v/vt/vn` faces."""
    if strict is None:
        strict = not smooth
    return Parser.from_obj_file(filename, strict=strict).obj_to_group(smooth=smooth)
