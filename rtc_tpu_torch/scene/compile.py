"""Scene compiler: builder tree -> SoA tensors (counterpart of
rtc_tpu/scene/compile.py).

The host work is rtc_tpu's, in numpy and float64: group transforms are
already pushed into the leaves by the builder, every inverse and
inverse-transpose is computed once, triangle vertices are baked into world
space (t is invariant under the object-to-world map when the direction is
not renormalized, src/ray.rs:19-24), and the triangles are ordered by a
balanced k-d split and chunked into fixed-size clusters with AABBs. So the
port's tables equal rtc_tpu's element for element, in the same cluster
order, and the two packages' kernels compare index for index. Tensors are
made once, at the end, on the requested device.

Object ids: analytic prims come first, then triangle leaves
(n_prims + leaf index), as in rtc_tpu.

Not ported: the instanced (TLAS) tables. A multi-mesh world large enough
for rtc_tpu to instance raises NotImplementedError naming its ROADMAP item
rather than rendering on another path. rtc_tpu's refr_tri_* container
slabs are not kept: the port's census reads tri_cid over the global
triangle tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .materials import NONE
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

# infinite cylinder/cone extents are clamped so f32 arithmetic stays finite
Y_INF = 1e9


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
    any_smooth: bool = False  # some mesh carries per-corner normals
    n_super: int = 0          # superclusters (groups of SUPER_WIDTH clusters)
    # object id shared by every triangle (-1 when there are several
    # triangle objects): the integrator then skips the tri_obj gather
    single_tri_obj: int = -1
    # n1/n2 census containers: analytic prim ids, and mesh object ids whose
    # triangles carry slot k = position in this tuple in Scene.tri_cid
    refr_prim_ids: Tuple[int, ...] = ()
    refr_mesh_obj_ids: Tuple[int, ...] = ()


@dataclasses.dataclass
class Scene:
    """SoA scene: N analytic prims, T triangles in C clusters, O objects."""

    # analytic primitives
    prim_kind: torch.Tensor    # (N,) i32: 0 sphere 1 plane 2 cube 3 cylinder 4 cone
    prim_inv: torch.Tensor     # (N, 3, 4) world->object affine
    prim_invT: torch.Tensor    # (N, 3, 3) inverse-transpose linear part
    prim_params: torch.Tensor  # (N, 3): ymin, ymax, capped
    prim_obj: torch.Tensor     # (N,) i32 object ids

    # triangles, baked to world space, in cluster order
    tri_p1: torch.Tensor      # (T, 3)
    tri_e1: torch.Tensor      # (T, 3)
    tri_e2: torch.Tensor      # (T, 3)
    tri_n: torch.Tensor       # (T, 3) unit world face normals
    tri_obj: torch.Tensor     # (T,) i32 object ids
    # container slot of each triangle for the n1/n2 census (index into
    # static.refr_mesh_obj_ids; -1: not a container, or padding)
    tri_cid: torch.Tensor     # (T,) i32
    # unit world corner normals ((0, 3) when no mesh is smooth); flat
    # meshes in a smooth scene carry their face normal in all three
    tri_sn1: torch.Tensor     # (T, 3)
    tri_sn2: torch.Tensor     # (T, 3)
    tri_sn3: torch.Tensor     # (T, 3)

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

    # per-object pattern table; kind NONE rows carry the material color in
    # pat_a (reference: src/material.rs:42-46)
    pat_kind: torch.Tensor    # (O,) i32
    pat_a: torch.Tensor       # (O, 3)
    pat_b: torch.Tensor       # (O, 3)
    pat_inv: torch.Tensor     # (O, 3, 4) pattern_inv @ object_inv

    # the single point light (reference: src/light.rs:5-8)
    light_pos: torch.Tensor        # (3,)
    light_intensity: torch.Tensor  # (3,)

    static: SceneStatic = None


_INT_FIELDS = ("prim_kind", "prim_obj", "tri_obj", "tri_cid", "pat_kind")
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


def _cluster_triangles(p1, e1, e2, n, obj, sn, leaf: int):
    """Spatially order the triangles (balanced k-d median split) and chunk
    them into fixed-size clusters with AABBs. sn: (3, T, 3) corner normals
    or None, permuted and padded with the rows. Padding rows have zero
    edges, which the Möller-Trumbore det guard rejects."""
    t = len(p1)
    order = _kd_order(p1 + (e1 + e2) / 3.0, leaf)
    p1, e1, e2, n, obj = p1[order], e1[order], e2[order], n[order], obj[order]
    if sn is not None:
        sn = sn[:, order]

    n_clusters = -(-t // leaf)
    # pad clusters to a multiple of SUPER_WIDTH; rows to n_clusters * leaf
    n_padded = -(-n_clusters // SUPER_WIDTH) * SUPER_WIDTH
    pad = n_padded * leaf - t
    if pad:
        z3 = np.zeros((pad, 3))
        p1, e1, e2, n = (np.concatenate([a, z3]) for a in (p1, e1, e2, n))
        obj = np.concatenate([obj, np.zeros((pad,), dtype=obj.dtype)])
        if sn is not None:
            sn = np.concatenate([sn, np.zeros((3, pad, 3))], axis=1)

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
    return p1, e1, e2, n, obj, sn, aabb, sup


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


def _refuse_unported(tri_leaves, n_tris: int) -> None:
    """Raise for a world that rtc_tpu renders through its instanced tables."""
    if (len(tri_leaves) >= 2 and n_tris > TLAS_TRI_THRESHOLD
            and all(s.kind == "mesh" for s in tri_leaves)):
        raise NotImplementedError(
            "rtc_tpu_torch does not render instanced multi-mesh worlds "
            "(TLAS, ROADMAP queue 1 item 14) yet")


def _unit_rows(a: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(a, axis=-1, keepdims=True)
    return np.divide(a, norm, out=np.zeros_like(a), where=norm != 0)


def compile_scene(world: World, dtype: torch.dtype = torch.float32,
                  device="cpu", containers: str = "refractive") -> Scene:
    """Compile a world into tensors on `device`.

    containers selects the n1/n2 census membership, as rtc_tpu:
    "refractive" (default) takes objects with ior != 1 or transparency > 0;
    "all" takes every object, which reproduces the reference's walk over
    the whole intersection list (src/intersection.rs:29-62) exactly.
    """
    if containers not in ("refractive", "all"):
        raise ValueError(f"containers must be 'refractive' or 'all', "
                         f"got {containers!r}")
    leaves = _flatten(world)
    prims = [s for s in leaves if s.kind in KIND_CODES]
    tri_leaves = [s for s in leaves if s.kind in ("triangle", "mesh")]
    objects = prims + tri_leaves  # object-id space
    n_prims, n_objects = len(prims), len(prims) + len(tri_leaves)
    n_tris_raw = sum(1 if s.kind == "triangle" else len(s.v1) for s in tri_leaves)
    _refuse_unported(tri_leaves, n_tris_raw)
    inv_of = {id(s): np.linalg.inv(s.transform) for s in objects}

    # --- analytic prims ---------------------------------------------------
    prim_inv = np.zeros((n_prims, 3, 4))
    prim_invT = np.zeros((n_prims, 3, 3))
    prim_params = np.zeros((n_prims, 3))
    for i, s in enumerate(prims):
        inv = inv_of[id(s)]
        prim_inv[i] = inv[:3, :4]
        prim_invT[i] = inv[:3, :3].T
        prim_params[i] = [np.clip(s.minimum, -Y_INF, Y_INF),
                          np.clip(s.maximum, -Y_INF, Y_INF),
                          1.0 if s.capped else 0.0]

    # --- triangles ----------------------------------------------------------
    any_smooth = any(s.kind == "mesh" and s.vn1 is not None for s in tri_leaves)
    tp1, te1, te2, tn, tobj, tsn = [], [], [], [], [], []
    for li, s in enumerate(tri_leaves):
        if s.kind == "triangle":
            v1, v2, v3 = s.p1[None, :], s.p2[None, :], s.p3[None, :]
        else:
            v1, v2, v3 = s.v1, s.v2, s.v3
        # object-space normal exactly as the reference triangle ctor
        # (src/shape.rs:171-193), then bake into world space
        _, _, n_obj = triangle_edges(v1, v2, v3)
        m = s.transform
        inv = inv_of[id(s)]
        w1 = v1 @ m[:3, :3].T + m[:3, 3]
        w2 = v2 @ m[:3, :3].T + m[:3, 3]
        w3 = v3 @ m[:3, :3].T + m[:3, 3]
        # world normal = normalize(invT @ n_obj) (src/shape.rs:623-635)
        nw = _unit_rows(n_obj @ inv[:3, :3])
        tp1.append(w1)
        te1.append(w2 - w1)
        te2.append(w3 - w1)
        tn.append(nw)
        tobj.append(np.full((len(w1),), n_prims + li, dtype=np.int32))
        if any_smooth:
            if s.kind == "mesh" and s.vn1 is not None:
                # the inverse-transpose applied in row-vector form
                tsn.append(np.stack([_unit_rows(vn @ inv[:3, :3])
                                     for vn in (s.vn1, s.vn2, s.vn3)]))
            else:
                tsn.append(np.stack([nw, nw, nw]))  # flat: the blend is a no-op
    tri_sn = np.concatenate(tsn, axis=1) if tsn else None

    n_clusters = 0
    if n_tris_raw:
        (tri_p1, tri_e1, tri_e2, tri_n, tri_obj, tri_sn, cluster_aabb,
         super_aabb) = _cluster_triangles(
            np.concatenate(tp1), np.concatenate(te1), np.concatenate(te2),
            np.concatenate(tn), np.concatenate(tobj), tri_sn, CLUSTER_SIZE)
        n_clusters = len(cluster_aabb)
    else:
        tri_p1 = tri_e1 = tri_e2 = tri_n = np.zeros((0, 3))
        tri_obj = np.zeros((0,), dtype=np.int32)
        cluster_aabb = super_aabb = np.zeros((0, 6))
    n_tris = len(tri_p1)
    if tri_sn is None:
        tri_sn = np.zeros((3, 0, 3))

    # --- per-object material and pattern tables -----------------------------
    mats = [o.material for o in objects]

    def col(getter):
        return np.array([getter(m) for m in mats], dtype=np.float64)

    mat_color = (np.array([m.color for m in mats], dtype=np.float64)
                 if mats else np.zeros((0, 3)))
    pat_kind = np.full((n_objects,), NONE, dtype=np.int32)
    pat_a = mat_color.copy()
    pat_b = np.zeros((n_objects, 3))
    pat_inv = np.zeros((n_objects, 3, 4))
    for i, o in enumerate(objects):
        obj_inv = inv_of[id(o)]
        p = o.material.pattern
        if p is None:
            pat_inv[i] = obj_inv[:3, :4]
        else:
            # a mesh's pattern space follows its leaf transform, although
            # its triangles are baked to world space
            pat_kind[i] = p.kind
            pat_a[i] = p.a
            pat_b[i] = p.b
            pat_inv[i] = (np.linalg.inv(p.transform) @ obj_inv)[:3, :4]

    # --- n1/n2 census containers ------------------------------------------
    def is_container(m) -> bool:
        return (containers == "all" or m.transparency > 0.0
                or m.refractive_index != 1.0)

    refr_prim_ids = tuple(i for i, s in enumerate(prims)
                          if is_container(s.material))
    refr_mesh_obj_ids = tuple(n_prims + li for li, s in enumerate(tri_leaves)
                              if is_container(s.material))
    tri_cid = np.full((n_tris,), -1, dtype=np.int32)
    if refr_mesh_obj_ids and n_tris:
        # padding rows (zero edges) stay -1, which keeps all-padding
        # clusters out of the census kernel's schedule
        real = (np.abs(tri_e1).sum(axis=1) > 0) | (np.abs(tri_e2).sum(axis=1) > 0)
        for k, oid in enumerate(refr_mesh_obj_ids):
            tri_cid[(tri_obj == oid) & real] = k
    else:
        refr_mesh_obj_ids = ()

    arrays = dict(
        prim_kind=np.array([KIND_CODES[s.kind] for s in prims], dtype=np.int32),
        prim_inv=prim_inv, prim_invT=prim_invT, prim_params=prim_params,
        prim_obj=np.arange(n_prims, dtype=np.int32),
        tri_p1=tri_p1, tri_e1=tri_e1, tri_e2=tri_e2, tri_n=tri_n,
        tri_obj=tri_obj, tri_cid=tri_cid,
        tri_sn1=tri_sn[0], tri_sn2=tri_sn[1], tri_sn3=tri_sn[2],
        cluster_aabb=cluster_aabb, super_aabb=super_aabb,
        mat_color=mat_color,
        mat_ambient=col(lambda m: m.ambient),
        mat_diffuse=col(lambda m: m.diffuse),
        mat_specular=col(lambda m: m.specular),
        mat_shininess=col(lambda m: m.shininess),
        mat_reflective=col(lambda m: m.reflective),
        mat_transparency=col(lambda m: m.transparency),
        mat_ior=col(lambda m: m.refractive_index),
        pat_kind=pat_kind, pat_a=pat_a, pat_b=pat_b, pat_inv=pat_inv,
        light_pos=np.asarray(world.light.position, dtype=np.float64),
        light_intensity=np.asarray(world.light.intensity, dtype=np.float64),
    )
    static = SceneStatic(
        n_prims=n_prims,
        n_tris=n_tris,
        n_objects=n_objects,
        any_reflective=any(m.reflective > 0.0 for m in mats),
        any_refractive=any(m.transparency > 0.0 for m in mats),
        any_pattern=any(m.pattern is not None for m in mats),
        n_clusters=n_clusters,
        cluster_size=CLUSTER_SIZE if n_clusters else 0,
        any_smooth=bool(any_smooth and n_tris),
        n_super=len(super_aabb),
        single_tri_obj=n_prims if len(tri_leaves) == 1 else -1,
        refr_prim_ids=refr_prim_ids,
        refr_mesh_obj_ids=refr_mesh_obj_ids,
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
    rtc_tpu's SceneStatic as a dict (extra keys are ignored). Raises
    NotImplementedError for an instanced (TLAS) scene, as compile_scene
    does.
    """
    if static.get("tlas_n_inst", 0):
        raise NotImplementedError(
            "scene_from_numpy: instanced (TLAS) scenes are not ported yet "
            "(ROADMAP queue 1 item 14)")
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[np.asarray(arrays["tri_p1"]).dtype]
    st = SceneStatic(**{k: static[k] for k in SceneStatic._fields})
    return _to_scene(arrays, st, dtype, device)
