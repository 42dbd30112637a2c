"""Scene compiler: builder tree -> SoA tensors (counterpart of
rtc_tpu/scene/compile.py, mesh path).

The host work is rtc_tpu's, in numpy and float64: group transforms are
already pushed into the leaves by the builder, triangle vertices are baked
into world space (t is invariant under the object-to-world map when the
direction is not renormalized, src/ray.rs:19-24), and the triangles are
ordered by a balanced k-d split and chunked into fixed-size clusters with
AABBs. So the port's tables equal rtc_tpu's element for element, in the
same cluster order, and the two packages' kernels compare index for index.
Tensors are made once, at the end, on the requested device.

Only the main path is ported. A world that needs anything else raises
NotImplementedError naming the ROADMAP item that brings it, rather than
rendering wrongly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .shapes import KIND_CODES, Shape, triangle_edges
from .world import World

# triangles per cluster, rtc_tpu's default
CLUSTER_SIZE = 128

# clusters per supercluster of the K7 debug hierarchy (kept so the tables
# equal rtc_tpu's; the port's kernels read cluster_aabb only)
SUPER_WIDTH = 8

# above this many triangles rtc_tpu renders a multi-mesh world through its
# instanced TLAS tables (rtc_tpu/ops/pallas/mesh_intersect.py VMEM_TRI_BUDGET)
TLAS_TRI_THRESHOLD = 49152


class SceneStatic(NamedTuple):
    """Compile-time facts, named as rtc_tpu's SceneStatic fields."""

    n_prims: int
    n_tris: int
    n_objects: int
    any_reflective: bool
    any_refractive: bool
    any_pattern: bool
    n_clusters: int = 0       # triangle clusters (tris padded to C * L)
    cluster_size: int = 0     # triangles per cluster
    any_smooth: bool = False
    n_super: int = 0          # superclusters (groups of SUPER_WIDTH clusters)
    # object id shared by every triangle (-1 when there are several
    # triangle objects): the integrator then skips the tri_obj gather
    single_tri_obj: int = -1


@dataclasses.dataclass
class Scene:
    """SoA scene: T triangles in C clusters, O objects."""

    # triangles, baked to world space, in cluster order
    tri_p1: torch.Tensor      # (T, 3)
    tri_e1: torch.Tensor      # (T, 3)
    tri_e2: torch.Tensor      # (T, 3)
    tri_n: torch.Tensor       # (T, 3) unit world face normals
    tri_obj: torch.Tensor     # (T,) i32 object ids

    # cluster acceleration: C is padded to a multiple of SUPER_WIDTH with
    # empty boxes (lo = 1, hi = -1) that no ray may overlap
    cluster_aabb: torch.Tensor  # (C, 6): min xyz, max xyz
    super_aabb: torch.Tensor    # (S, 6): union of SUPER_WIDTH clusters

    # per-object material table (reference: src/material.rs:3-29)
    mat_color: torch.Tensor        # (O, 3)
    mat_ambient: torch.Tensor      # (O,)
    mat_diffuse: torch.Tensor      # (O,)
    mat_specular: torch.Tensor     # (O,)
    mat_shininess: torch.Tensor    # (O,)
    mat_reflective: torch.Tensor   # (O,)
    mat_transparency: torch.Tensor  # (O,)
    mat_ior: torch.Tensor          # (O,)

    # the single point light (reference: src/light.rs:5-8)
    light_pos: torch.Tensor        # (3,)
    light_intensity: torch.Tensor  # (3,)

    static: SceneStatic = None


_INT_FIELDS = ("tri_obj",)
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(Scene) if f.name != "static")


def _kd_order(centroid: np.ndarray, leaf: int) -> np.ndarray:
    """Balanced k-d ordering: recursively split the triangle set at a
    leaf-aligned median of the widest centroid axis, so consecutive
    `leaf`-sized chunks are compact spatial cells."""
    out = []

    def rec(idx):
        n = len(idx)
        if n <= leaf:
            out.append(idx)
            return
        c = centroid[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n_leaves = -(-n // leaf)
        mid = (n_leaves // 2) * leaf
        part = np.argpartition(c[:, ax], mid)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])

    rec(np.arange(len(centroid)))
    return np.concatenate(out)


def _empty_boxes(n: int) -> np.ndarray:
    box = np.zeros((n, 6))
    box[:, :3] = 1.0
    box[:, 3:] = -1.0
    return box


def _cluster_triangles(p1, e1, e2, n, obj, leaf: int):
    """Spatially order the triangles (balanced k-d median split) and chunk
    them into fixed-size clusters with AABBs. Padding rows have zero edges,
    which the Möller-Trumbore det guard rejects."""
    t = len(p1)
    order = _kd_order(p1 + (e1 + e2) / 3.0, leaf)
    p1, e1, e2, n, obj = p1[order], e1[order], e2[order], n[order], obj[order]

    n_clusters = -(-t // leaf)
    # pad clusters to a multiple of SUPER_WIDTH; rows to n_clusters * leaf
    n_padded = -(-n_clusters // SUPER_WIDTH) * SUPER_WIDTH
    pad = n_padded * leaf - t
    if pad:
        z3 = np.zeros((pad, 3))
        p1, e1, e2, n = (np.concatenate([a, z3]) for a in (p1, e1, e2, n))
        obj = np.concatenate([obj, np.zeros((pad,), dtype=obj.dtype)])

    aabb = _empty_boxes(n_padded)
    for c in range(n_clusters):
        s = slice(c * leaf, min((c + 1) * leaf, t))
        verts = np.concatenate([p1[s], p1[s] + e1[s], p1[s] + e2[s]])
        aabb[c, :3] = verts.min(axis=0)
        aabb[c, 3:] = verts.max(axis=0)

    n_super = n_padded // SUPER_WIDTH
    sup = _empty_boxes(n_super)
    for si in range(n_super):
        block = aabb[si * SUPER_WIDTH:(si + 1) * SUPER_WIDTH]
        real = block[:, 0] <= block[:, 3]
        if real.any():
            sup[si, :3] = block[real, :3].min(axis=0)
            sup[si, 3:] = block[real, 3:].max(axis=0)
    return p1, e1, e2, n, obj, aabb, sup


def _flatten(world: World):
    leaves = []

    def walk(s: Shape):
        if s.kind == "group":
            for c in s.children:
                walk(c)
        else:
            leaves.append(s)

    for obj in world.objects:
        walk(obj)
    return leaves


def _refuse_unported(leaves, n_tris: int) -> None:
    """Raise for any feature of the world outside the ported main path."""
    tri_leaves = [s for s in leaves if s.kind in ("triangle", "mesh")]
    checks = (
        (any(s.kind in KIND_CODES for s in leaves),
         "analytic primitives (ROADMAP queue 1 item 11)"),
        (any(s.material.pattern is not None for s in leaves),
         "patterns (ROADMAP queue 1 item 11)"),
        (any(s.material.transparency > 0.0 or s.material.refractive_index != 1.0
             for s in leaves),
         "refractive containers (ROADMAP queue 1 item 12)"),
        (any(s.kind == "mesh" and s.vn1 is not None for s in tri_leaves),
         "smooth normals (ROADMAP queue 1 item 10)"),
        (len(tri_leaves) >= 2 and n_tris > TLAS_TRI_THRESHOLD
         and all(s.kind == "mesh" for s in tri_leaves),
         "instanced multi-mesh worlds (TLAS, ROADMAP queue 1 item 14)"),
    )
    for failed, what in checks:
        if failed:
            raise NotImplementedError(f"rtc_tpu_torch does not render {what} yet")


def compile_scene(world: World, dtype: torch.dtype = torch.float32,
                  device="cpu") -> Scene:
    """Compile a world of flat triangle meshes into tensors on `device`."""
    leaves = _flatten(world)
    tri_leaves = [s for s in leaves if s.kind in ("triangle", "mesh")]
    n_tris_raw = sum(1 if s.kind == "triangle" else len(s.v1) for s in tri_leaves)
    _refuse_unported(leaves, n_tris_raw)

    tp1, te1, te2, tn, tobj = [], [], [], [], []
    for obj_id, s in enumerate(tri_leaves):
        if s.kind == "triangle":
            v1, v2, v3 = s.p1[None, :], s.p2[None, :], s.p3[None, :]
        else:
            v1, v2, v3 = s.v1, s.v2, s.v3
        # object-space normal exactly as the reference triangle ctor
        # (src/shape.rs:171-193), then bake into world space
        _, _, n_obj = triangle_edges(v1, v2, v3)
        m = s.transform
        inv = np.linalg.inv(m)
        w1 = v1 @ m[:3, :3].T + m[:3, 3]
        w2 = v2 @ m[:3, :3].T + m[:3, 3]
        w3 = v3 @ m[:3, :3].T + m[:3, 3]
        # world normal = normalize(invT @ n_obj) (src/shape.rs:623-635)
        nw = n_obj @ inv[:3, :3]
        norm = np.linalg.norm(nw, axis=-1, keepdims=True)
        nw = np.divide(nw, norm, out=np.zeros_like(nw), where=norm != 0)
        tp1.append(w1)
        te1.append(w2 - w1)
        te2.append(w3 - w1)
        tn.append(nw)
        tobj.append(np.full((len(w1),), obj_id, dtype=np.int32))

    n_clusters = 0
    if n_tris_raw:
        (tri_p1, tri_e1, tri_e2, tri_n, tri_obj, cluster_aabb,
         super_aabb) = _cluster_triangles(
            np.concatenate(tp1), np.concatenate(te1), np.concatenate(te2),
            np.concatenate(tn), np.concatenate(tobj), CLUSTER_SIZE)
        n_clusters = len(cluster_aabb)
    else:
        tri_p1 = tri_e1 = tri_e2 = tri_n = np.zeros((0, 3))
        tri_obj = np.zeros((0,), dtype=np.int32)
        cluster_aabb = super_aabb = np.zeros((0, 6))

    mats = [o.material for o in tri_leaves]

    def col(getter):
        return np.array([getter(m) for m in mats], dtype=np.float64)

    arrays = dict(
        tri_p1=tri_p1, tri_e1=tri_e1, tri_e2=tri_e2, tri_n=tri_n,
        tri_obj=tri_obj, cluster_aabb=cluster_aabb, super_aabb=super_aabb,
        mat_color=(np.array([m.color for m in mats], dtype=np.float64)
                   if mats else np.zeros((0, 3))),
        mat_ambient=col(lambda m: m.ambient),
        mat_diffuse=col(lambda m: m.diffuse),
        mat_specular=col(lambda m: m.specular),
        mat_shininess=col(lambda m: m.shininess),
        mat_reflective=col(lambda m: m.reflective),
        mat_transparency=col(lambda m: m.transparency),
        mat_ior=col(lambda m: m.refractive_index),
        light_pos=np.asarray(world.light.position, dtype=np.float64),
        light_intensity=np.asarray(world.light.intensity, dtype=np.float64),
    )
    static = SceneStatic(
        n_prims=0,
        n_tris=len(tri_p1),
        n_objects=len(tri_leaves),
        any_reflective=any(m.reflective > 0.0 for m in mats),
        any_refractive=False,
        any_pattern=False,
        n_clusters=n_clusters,
        cluster_size=CLUSTER_SIZE if n_clusters else 0,
        any_smooth=False,
        n_super=len(super_aabb),
        single_tri_obj=0 if len(tri_leaves) == 1 else -1,
    )
    return _to_scene(arrays, static, dtype, device)


def _to_scene(arrays: dict, static: SceneStatic, dtype, device) -> Scene:
    tensors = {
        k: torch.tensor(np.asarray(arrays[k]),
                        dtype=torch.int32 if k in _INT_FIELDS else dtype,
                        device=device)
        for k in TENSOR_FIELDS
    }
    return Scene(**tensors, static=static)


def scene_from_numpy(arrays: dict, static: dict, device) -> Scene:
    """The port's Scene from another compiler's tables, passed as numpy.

    arrays: field name -> numpy array (rtc_tpu's Scene fields of the same
    names; extra fields are ignored), in float32 or float64. static:
    rtc_tpu's SceneStatic as a dict. Raises NotImplementedError for a scene
    outside the ported main path, as compile_scene does.
    """
    unported = dict(n_prims=0, any_refractive=False, any_pattern=False,
                    any_smooth=False, tlas_n_inst=0)
    for key, ok in unported.items():
        if static.get(key, ok) != ok:
            raise NotImplementedError(
                f"scene_from_numpy: {key}={static[key]!r} is outside the "
                "ported main path (see ROADMAP queue 1)")
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[np.asarray(arrays["tri_p1"]).dtype]
    st = SceneStatic(**{k: static[k] for k in SceneStatic._fields})
    return _to_scene(arrays, st, dtype, device)
