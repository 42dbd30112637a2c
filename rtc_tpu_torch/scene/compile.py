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

A world of many mesh leaves that rtc_tpu renders through its instanced
(TLAS) path also gets rtc_tpu's TlasTables (_build_tlas), minus inst_rf,
the Plücker feature transform that only feeds rtc_tpu's MXU. rtc_tpu's
refr_tri_* container slabs are not kept: the port's census reads tri_cid
over the global triangle tables.

The walking kernels (K2, K3's shadow phase, K4 and K6) read tables of
their own, which rtc_tpu has no counterpart of (OcclusionTables, built by
occlusion_tables): a copy of the rows in a finer spatial order with a box
for every 8 of them, boxes widened once, here, and the census's container
slots in the copy's order.

compile_scene's host work records the program's spans (utils/profiling.py
span): the root rtc.compile, and inside it rtc.compile.cluster (the k-d
clustering of the world table), rtc.compile.tlas (the instanced tables,
only where the world takes the instanced path), rtc.compile.occlusion
(each level's occlusion tables, uploaded) and rtc.compile.upload (the
other tables' copy to the device).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.kernels.mesh_intersect import ELEMENTWISE_MAX_LEAF, SUPER_WIDTH
from ..utils.constants import VMEM_TRI_BUDGET
from ..utils.profiling import span
from .materials import NONE
from .shapes import KIND_CODES, Shape, triangle_edges
from .world import World

# triangles per cluster, rtc_tpu's default (compile_scene's cluster_size)
CLUSTER_SIZE = 128

# SUPER_WIDTH clusters per supercluster: the elementwise kernels' (K7a/K7b)
# middle level. A world of mesh leaves whose padded table exceeds
# VMEM_TRI_BUDGET, and whose unique meshes fit it, takes the instanced
# (TLAS) path, as in rtc_tpu, so the tables compare element for element.

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
    # instanced (TLAS) tables: tlas_n_inst instances (0: Scene.tlas is
    # None) of tlas_n_mesh unique meshes, each padded to tlas_cm clusters,
    # so an instance-local winner is enc = inst * tlas_cm * cluster_size +
    # row; tlas_sn: TlasTables.sn carries object-space corner normals
    tlas_n_inst: int = 0
    tlas_n_mesh: int = 0
    tlas_cm: int = 0
    tlas_sn: bool = False


class TlasTables(NamedTuple):
    """Instanced two-level tables (rtc_tpu/scene/compile.py:78-108): the
    unique meshes once, in OBJECT space, and per instance the world->object
    map and world box. A ray mapped by A o + b, A d (not renormalized) hits
    at the same t as in world space, so one carried t_best serves every
    instance. Padding instances carry the identity, mesh 0 and an empty box
    (lo 1 > hi -1): only the box keeps them out."""

    p1: torch.Tensor         # (M * cm * leaf, 3) object space
    e1: torch.Tensor         # (M * cm * leaf, 3)
    e2: torch.Tensor         # (M * cm * leaf, 3)
    n: torch.Tensor          # (M * cm * leaf, 3) unit object face normals
    caabb: torch.Tensor      # (M * cm, 6) object-space cluster boxes
    inst_ab: torch.Tensor    # (I, 12) world->object [A row-major | b]
    inst_aabb: torch.Tensor  # (I, 6) world box per instance
    inst_obj: torch.Tensor   # (I,) i32 object id
    inst_mesh: torch.Tensor  # (I,) i32 unique-mesh index
    gid: torch.Tensor        # (I, cm * leaf) i32 world-table row (pad 0)
    # (M * cm * leaf, 9) object-space corner normals [sn1 | sn2 | sn3]
    # ((0, 9) unless static.tlas_sn); flat meshes repeat the face normal
    sn: torch.Tensor


class OcclusionTables(NamedTuple):
    """What the occlusion walk of K2, K3's phase 3 and K6, and the census
    walk of K4, read, built once at compile time (occlusion_tables): three
    box levels above a copy of a table's rows.

    Each cluster's rows are ordered by a k-d split of their centroids down
    to sub_rows (8 of the 128) and copied, packed as three float4 (p1, e1,
    e2, each with w = 0), so a pair test makes three 16-byte loads. The
    copy is a permutation inside each cluster of the table's rows: the same
    values, so a pair test on it rounds as on the table. Every box is
    widened here, in f32, with cluster_slab's operations (widen_boxes), so
    the walk tests it as stored; an empty box (padding) becomes EMPTY_BOX.
    A group box is the union of its 8 children's unwidened boxes, widened
    afterwards, so its slab interval contains each child's (widen_boxes).

    For an instanced scene (Scene.tlas_occ) the tables are the unique
    meshes', and the instances get a level of their own: the real
    instances in a k-d order of their boxes' centres (inst_perm, -1 for
    padding slots), their widened world boxes in that order, and a box a
    group of 8. Only K6 reads the order; K5's instance ids do not change.
    A world-table scene (Scene.occ) has no instances: inst_* are empty.

    The census (K4) reads, of a world table built with its container
    slots tri_cid, each copied row's table row (row_id, for the exclusion
    of the ray's own hit) and slot (row_cid), and which clusters and
    groups hold a container row at all (cluster_census, group_census):
    the others it skips unseen. tri_cid is the slots these were built
    from (the caller's own tensor where it gave one), which a K4 launch
    holds its tri_cid argument to. Without tri_cid (an instanced scene's
    unique meshes) these five are empty."""

    rows: torch.Tensor         # (T, 12) f32: p1, 0, e1, 0, e2, 0 of row_id
    row_id: torch.Tensor       # (T,) i32: the table row each row copies
    sub_box: torch.Tensor      # (T / sub_rows, 6) widened
    cluster_box: torch.Tensor  # (C, 6) widened cluster boxes
    group_box: torch.Tensor    # (ceil(C / 8), 6) widened
    inst_perm: torch.Tensor    # (I,) i32 instance in each slot, -1: none
    inst_box: torch.Tensor     # (I, 6) widened world box of each slot
    inst_group: torch.Tensor   # (I / 8, 6) widened
    row_cid: torch.Tensor      # (T,) i32 tri_cid[row_id], -1: no container
    cluster_census: torch.Tensor  # (C,) bool: the cluster holds a container row
    group_census: torch.Tensor    # (ceil(C / 8),) bool: a cluster of the group does
    tri_cid: torch.Tensor      # (C * leaf,) i32: the slots of the table's rows


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

    # instanced tables; None unless static.tlas_n_inst
    tlas: TlasTables = None
    static: SceneStatic = None
    # the occlusion walk's tables of the world table and of the instanced
    # meshes (None without triangles, or without TLAS tables)
    occ: OcclusionTables = None
    tlas_occ: OcclusionTables = None
    # the row of the whole table that tri_p1's first row is: a prim shard's
    # first row (parallel/shard.py shard_scene), 0 for a whole table
    tri_offset: int = 0


_INT_FIELDS = ("prim_kind", "prim_obj", "tri_obj", "tri_cid", "pat_kind",
               "inst_obj", "inst_mesh", "gid")
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(Scene)
                      if f.name not in ("tlas", "static", "occ", "tlas_occ",
                                        "tri_offset"))


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
    edges, which the Möller-Trumbore det guard rejects. Also returns src
    (T_padded,) i32, the input row of each output row (-1 for padding),
    which the TLAS gid table needs."""
    t = len(p1)
    order = _kd_order(p1 + (e1 + e2) / 3.0, leaf)
    p1, e1, e2, n, obj = p1[order], e1[order], e2[order], n[order], obj[order]
    src = order.astype(np.int32)
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
        src = np.concatenate([src, np.full((pad,), -1, dtype=np.int32)])
        if sn is not None:
            sn = np.concatenate([sn, np.zeros((3, pad, 3))], axis=1)

    aabb = _empty_boxes(n_padded)
    for c in range(n_clusters):
        s = slice(c * leaf, min((c + 1) * leaf, t))
        verts = np.concatenate([p1[s], p1[s] + e1[s], p1[s] + e2[s]])
        aabb[c, :3] = verts.min(axis=0)
        aabb[c, 3:] = verts.max(axis=0)
    return p1, e1, e2, n, obj, sn, aabb, _group_boxes(aabb), src


def _group_boxes(aabb: np.ndarray, width: int = SUPER_WIDTH) -> np.ndarray:
    """The union box of each run of `width` boxes, over its non-empty ones
    (empty where it has none): super_aabb, and the occlusion walk's group
    boxes (before widening)."""
    out = _empty_boxes(-(-len(aabb) // width))
    for g in range(len(out)):
        block = aabb[g * width:(g + 1) * width]
        real = block[:, 0] <= block[:, 3]
        if real.any():
            out[g, :3] = block[real, :3].min(axis=0)
            out[g, 3:] = block[real, 3:].max(axis=0)
    return out


# --- the occlusion walk's tables (OcclusionTables) ---------------------------

SUB_ROWS = 8       # rows a sub-box, where the cluster size is a multiple of it
GROUP = SUPER_WIDTH  # boxes a group, at the cluster and the instance level
# every coordinate of an empty box once widened: a point no ray reaches
# before any max_t it is given (the kernels' kBig)
EMPTY_BOX = 1e30


def widen_boxes(box) -> np.ndarray:
    """Boxes (n, 6) rounded to f32 and widened as the kernels' cluster_slab
    widens them, each operation rounded in f32: pad = 4e-6f times the
    largest |coordinate| of the box, then lo - pad and hi + pad. An empty
    box (lo > hi on an axis) becomes EMPTY_BOX.

    Why a group box (the union of its children's unwidened boxes, widened
    afterwards) never culls a ray that enters a child: f32 rounding is
    monotone, so the union's largest |coordinate| is at least each
    child's, its pad at least the child's, its lo - pad at most the
    child's and its hi + pad at least the child's; and a slab interval,
    (lo - o) * inv and (hi - o) * inv per axis with min and max, only grows
    as lo falls and hi rises."""
    b = np.asarray(box, np.float32).reshape(-1, 6)
    lo, hi = b[:, :3], b[:, 3:]
    empty = (lo > hi).any(1)
    scale = np.maximum(np.abs(lo), np.abs(hi)).max(1, keepdims=True)
    pad = np.float32(4e-6) * scale
    out = np.concatenate([lo - pad, hi + pad], 1)
    out[empty] = EMPTY_BOX
    return out


def _sub_order(centroid, real, leaf: int, sub_rows: int) -> np.ndarray:
    """(T,) table rows in the occlusion order: inside each cluster of leaf
    rows, a balanced k-d split at the median of the widest centroid axis,
    halving down to sub_rows, with padding rows (real False) last. Every
    cluster splits at once (each level sorts equal-sized segments)."""
    order = np.arange(len(centroid))
    size = leaf
    while size > sub_rows and size % (2 * sub_rows) == 0:
        seg = order.reshape(-1, size)
        c, r = centroid[seg], real[seg]
        lo = np.where(r[..., None], c, np.inf).min(1)
        hi = np.where(r[..., None], c, -np.inf).max(1)
        ax = np.argmax(hi - lo, 1)
        key = np.where(r, np.take_along_axis(c, ax[:, None, None], 2)[..., 0], np.inf)
        order = np.take_along_axis(seg, np.argsort(key, 1, kind="stable"), 1).reshape(-1)
        size //= 2
    return order


def _instance_order(inst_aabb: np.ndarray, inst_mesh: np.ndarray, n_mesh: int):
    """(I,) i32 slots: the instances that K6 may enter (a non-empty box, a
    mesh in the tables) in a k-d order of their boxes' centres, then -1."""
    real = np.nonzero((inst_aabb[:, :3] <= inst_aabb[:, 3:]).all(1)
                      & (inst_mesh >= 0) & (inst_mesh < n_mesh))[0]
    perm = np.full((len(inst_aabb),), -1, np.int32)
    if len(real):
        centre = (inst_aabb[real, :3] + inst_aabb[real, 3:]) / 2.0
        perm[:len(real)] = real[_kd_order(centre, GROUP)]
    return perm


def occlusion_tables(p1, e1, e2, aabb, leaf: int, device=None, inst_aabb=None,
                     inst_mesh=None, n_mesh: int = 0, tri_cid=None) -> OcclusionTables:
    """The occlusion walk's tables (OcclusionTables) of a table of C
    clusters of leaf rows (p1, e1, e2 (C * leaf, 3); aabb (C, 6) the
    unwidened cluster boxes), as numpy or tensors in f32 or f64, on device
    (by default p1's: a tensor's device, the CPU for numpy): the same
    tables from either, built from the f32 values. A sub-box
    holds SUB_ROWS rows where leaf is a multiple of it, else a whole
    cluster. With inst_aabb and inst_mesh (I,), the instance level of an
    instanced scene's n_mesh unique meshes; with tri_cid (C * leaf,), the
    census's fields for those container slots."""
    if device is None:
        device = p1.device if isinstance(p1, torch.Tensor) else "cpu"
    npy = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a))
    # the f32 values the kernels read, in f64 for the vertex sums
    p1, e1, e2, aabb = (npy(a).astype(np.float32).astype(np.float64)
                        for a in (p1, e1, e2, aabb))
    sub_rows = SUB_ROWS if leaf % SUB_ROWS == 0 else leaf
    real = (e1 != 0).any(1) | (e2 != 0).any(1)  # padding rows have zero edges
    order = _sub_order(p1 + (e1 + e2) / 3.0, real, leaf, sub_rows)
    rows = np.zeros((len(order), 12), np.float32)
    for k, a in enumerate((p1, e1, e2)):
        rows[:, 4 * k:4 * k + 3] = a[order]
    verts = np.stack([p1, p1 + e1, p1 + e2], 1)[order].reshape(-1, 3 * sub_rows, 3)
    keep = np.repeat(real[order], 3).reshape(verts.shape[:2])[..., None]
    sub = np.concatenate([np.where(keep, verts, np.inf).min(1),
                          np.where(keep, verts, -np.inf).max(1)], 1)
    sub[~keep.any(1)[:, 0]] = _empty_boxes(1)[0]
    out = dict(rows=rows, row_id=order.astype(np.int32), sub_box=widen_boxes(sub),
               cluster_box=widen_boxes(aabb), group_box=widen_boxes(_group_boxes(aabb)),
               inst_perm=np.zeros((0,), np.int32), inst_box=np.zeros((0, 6), np.float32),
               inst_group=np.zeros((0, 6), np.float32), row_cid=np.zeros((0,), np.int32),
               cluster_census=np.zeros((0,), bool), group_census=np.zeros((0,), bool),
               tri_cid=np.zeros((0,), np.int32))
    if tri_cid is not None:
        slots = npy(tri_cid).astype(np.int32)
        cid = slots[order]
        has = (cid.reshape(-1, leaf) >= 0).any(1)
        out.update(row_cid=cid, cluster_census=has, group_census=np.pad(
            has, (0, -len(has) % GROUP)).reshape(-1, GROUP).any(1), tri_cid=slots)
    if inst_aabb is not None:
        inst_aabb = npy(inst_aabb).astype(np.float32).astype(np.float64)
        perm = _instance_order(inst_aabb, npy(inst_mesh), n_mesh)
        boxes = np.where((perm >= 0)[:, None], inst_aabb[np.maximum(perm, 0)],
                         _empty_boxes(1))
        out.update(inst_perm=perm, inst_box=widen_boxes(boxes),
                   inst_group=widen_boxes(_group_boxes(boxes)))
    types = {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}
    tables = {k: torch.tensor(v, dtype=types.get(v.dtype, torch.float32), device=device)
              for k, v in out.items()}
    if isinstance(tri_cid, torch.Tensor):
        # the caller's tensor, which a K4 launch then knows by identity
        tables["tri_cid"] = torch.as_tensor(tri_cid, dtype=torch.int32, device=device)
    return OcclusionTables(**tables)


def _box(verts: np.ndarray) -> np.ndarray:
    return np.concatenate([verts.min(axis=0), verts.max(axis=0)])


def _cluster_mesh(p1, e1, e2, n, sn, leaf: int):
    """One unique mesh in object space for the TLAS tables (rtc_tpu
    :305-331): k-d order, chunks of `leaf`, cluster boxes. sn: (T, 9) or
    None. Returns the padded rows, src (-1 for padding) and the boxes."""
    t = len(p1)
    order = _kd_order(p1 + (e1 + e2) / 3.0, leaf)
    rows = [a[order] for a in (p1, e1, e2, n)]
    sn = None if sn is None else sn[order]
    src = order.astype(np.int32)
    pad = (-t) % leaf
    if pad:
        rows = [np.concatenate([a, np.zeros((pad, 3))]) for a in rows]
        sn = None if sn is None else np.concatenate([sn, np.zeros((pad, 9))])
        src = np.concatenate([src, np.full((pad,), -1, np.int32)])
    p1, e1, e2, n = rows
    boxes = np.stack([
        _box(np.concatenate([p1[s], p1[s] + e1[s], p1[s] + e2[s]]))
        for s in (slice(c * leaf, min((c + 1) * leaf, t))
                  for c in range(len(p1) // leaf))])
    return p1, e1, e2, n, sn, src, boxes


def _mesh_key(s: Shape):
    """Meshes with equal object-space vertices (and normals) share rows."""
    h = hashlib.blake2b(digest_size=16)
    for a in (s.v1, s.v2, s.v3, s.vn1, s.vn2, s.vn3):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.digest(), len(s.v1), s.vn1 is not None


def _build_tlas(tri_leaves, inv_of, leaf: int, n_tris: int, tri_src,
                leaf_offsets, n_prims: int):
    """rtc_tpu's instanced tables (scene/compile.py:334-471), as numpy.

    Eligible, exactly as rtc_tpu: at least 2 triangle leaves, all meshes,
    the PADDED world table above VMEM_TRI_BUDGET, and the unique meshes'
    rows within it (43/49 of it when any mesh is smooth: rtc_tpu's VMEM
    cost of the 9-row corner slab). Returns (tables | None, n_inst padded
    to 8, n_mesh, cm)."""
    if (len(tri_leaves) < 2 or n_tris <= VMEM_TRI_BUDGET
            or any(s.kind != "mesh" for s in tri_leaves)):
        return None, 0, 0, 0
    with span("rtc.compile.tlas"):
        return _tlas_tables(tri_leaves, inv_of, leaf, tri_src, leaf_offsets, n_prims)


def _tlas_tables(tri_leaves, inv_of, leaf: int, tri_src, leaf_offsets, n_prims: int):
    """_build_tlas's tables for an eligible world, or (None, 0, 0, 0) where
    the unique meshes exceed the budget."""
    use_sn = any(s.vn1 is not None for s in tri_leaves)
    unique, inst_mesh = {}, []
    for s in tri_leaves:
        inst_mesh.append(unique.setdefault(_mesh_key(s), (len(unique), s))[0])
    meshes = [rep for _, rep in sorted(unique.values(), key=lambda v: v[0])]

    clustered = []
    for rep in meshes:
        e1o, e2o, no = triangle_edges(rep.v1, rep.v2, rep.v3)
        sn_m = None
        if use_sn:
            corners = ((rep.vn1, rep.vn2, rep.vn3) if rep.vn1 is not None
                       else (no, no, no))
            sn_m = np.concatenate([_unit_rows(c) for c in corners], axis=1)
        clustered.append(_cluster_mesh(rep.v1, e1o, e2o, no, sn_m, leaf))
    cm = -(-max(len(c[6]) for c in clustered) // 8) * 8
    n_mesh = len(meshes)
    budget = VMEM_TRI_BUDGET * 43 // 49 if use_sn else VMEM_TRI_BUDGET
    if n_mesh * cm * leaf > budget:
        return None, 0, 0, 0

    tm = cm * leaf
    p1, e1, e2, nrm = (np.zeros((n_mesh * tm, 3)) for _ in range(4))
    snc = np.zeros((n_mesh * tm if use_sn else 0, 9))
    caabb = _empty_boxes(n_mesh * cm)
    mesh_src = np.full((n_mesh, tm), -1, np.int32)
    for m, (mp1, me1, me2, mn, msn, msrc, mab) in enumerate(clustered):
        rows = slice(m * tm, m * tm + len(mp1))
        p1[rows], e1[rows], e2[rows], nrm[rows] = mp1, me1, me2, mn
        if use_sn:
            snc[rows] = msn
        mesh_src[m, :len(mp1)] = msrc
        caabb[m * cm:m * cm + len(mab)] = mab

    # pre-cluster row of the world table -> its final (clustered) row
    world_of = np.zeros((max(int(tri_src.max()) + 1, 1),), np.int64)
    real = tri_src >= 0
    world_of[tri_src[real]] = np.nonzero(real)[0]

    n_inst = len(tri_leaves)
    i_pad = -(-n_inst // 8) * 8
    inst_ab = np.zeros((i_pad, 12))
    inst_ab[:, [0, 4, 8]] = 1.0  # identity padding
    inst_aabb = _empty_boxes(i_pad)
    inst_obj = np.zeros((i_pad,), np.int32)
    inst_mesh_p = np.zeros((i_pad,), np.int32)
    inst_mesh_p[:n_inst] = inst_mesh
    gid = np.zeros((i_pad, tm), np.int32)
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"),
                       axis=-1).reshape(8, 3)
    for i, s in enumerate(tri_leaves):
        m = inst_mesh[i]
        inv = inv_of[id(s)]
        inst_ab[i, :9] = inv[:3, :3].reshape(9)
        inst_ab[i, 9:] = inv[:3, 3]
        inst_obj[i] = n_prims + i
        # world box: the mesh's cluster boxes' 8 corners through the
        # instance's object->world map
        boxes = clustered[m][6]
        pts = (boxes[:, None, :3] * (1 - corners)[None]
               + boxes[:, None, 3:] * corners[None]).reshape(-1, 3)
        o2w = s.transform
        inst_aabb[i] = _box(pts @ o2w[:3, :3].T + o2w[:3, 3])
        msrc = mesh_src[m]
        gid[i] = np.where(msrc >= 0,
                          world_of[leaf_offsets[i] + np.maximum(msrc, 0)], 0)
    tables = dict(p1=p1, e1=e1, e2=e2, n=nrm, caabb=caabb, inst_ab=inst_ab,
                  inst_aabb=inst_aabb, inst_obj=inst_obj,
                  inst_mesh=inst_mesh_p, gid=gid, sn=snc)
    return tables, i_pad, n_mesh, cm


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


def _unit_rows(a: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(a, axis=-1, keepdims=True)
    return np.divide(a, norm, out=np.zeros_like(a), where=norm != 0)


def compile_scene(world: World, dtype: torch.dtype = torch.float32,
                  device="cuda", containers: str = "refractive", *,
                  cluster_size: int = CLUSTER_SIZE) -> Scene:
    """Compile a world into tensors on `device`: the card by default, so
    that render() runs the kernels; pass device="cpu" for the plain
    versions. Without a card the default raises, as torch does.

    containers selects the n1/n2 census membership, as rtc_tpu:
    "refractive" (default) takes objects with ior != 1 or transparency > 0;
    "all" takes every object, which reproduces the reference's walk over
    the whole intersection list (src/intersection.rs:29-62) exactly.

    cluster_size is the leaf, as rtc_tpu's: the triangles per cluster of
    the k-d clustering, the TLAS and the occlusion tables. 0 keeps the
    triangle table unclustered, in leaf order and unpadded, with no TLAS;
    the integrator then takes the plain sweep on every backend, as
    rtc_tpu's takes its brute force (rtc_tpu/render/integrator.py
    _resolve_mesh_impl). A leaf above ELEMENTWISE_MAX_LEAF raises: K7
    stages two clusters in shared memory and refuses larger ones.

    The call is the span rtc.compile (module doc).
    """
    with span("rtc.compile"):
        return _compile_scene(world, dtype, device, containers, cluster_size)


def _compile_scene(world: World, dtype, device, containers: str, cluster_size: int) -> Scene:
    if containers not in ("refractive", "all"):
        raise ValueError(f"containers must be 'refractive' or 'all', "
                         f"got {containers!r}")
    if not 0 <= cluster_size <= ELEMENTWISE_MAX_LEAF:
        raise ValueError(
            f"cluster_size must be 0 (unclustered) or a leaf of 1 to "
            f"{ELEMENTWISE_MAX_LEAF} rows, the most K7 (the elementwise "
            f"kernels) stages in shared memory; got {cluster_size}")
    leaves = _flatten(world)
    prims = [s for s in leaves if s.kind in KIND_CODES]
    tri_leaves = [s for s in leaves if s.kind in ("triangle", "mesh")]
    objects = prims + tri_leaves  # object-id space
    n_prims, n_objects = len(prims), len(prims) + len(tri_leaves)
    n_tris_raw = sum(1 if s.kind == "triangle" else len(s.v1) for s in tri_leaves)
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
    leaf_offsets = []  # first pre-cluster row of each leaf
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
        leaf_offsets.append(sum(len(a) for a in tp1))
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
    tlas, n_inst, n_mesh, cm = None, 0, 0, 0
    cluster_aabb = super_aabb = np.zeros((0, 6))
    if n_tris_raw and cluster_size:
        with span("rtc.compile.cluster"):
            (tri_p1, tri_e1, tri_e2, tri_n, tri_obj, tri_sn, cluster_aabb,
             super_aabb, tri_src) = _cluster_triangles(
                np.concatenate(tp1), np.concatenate(te1), np.concatenate(te2),
                np.concatenate(tn), np.concatenate(tobj), tri_sn, cluster_size)
        n_clusters = len(cluster_aabb)
        tlas, n_inst, n_mesh, cm = _build_tlas(
            tri_leaves, inv_of, cluster_size, len(tri_p1), tri_src,
            leaf_offsets, n_prims)
    elif n_tris_raw:
        tri_p1, tri_e1, tri_e2, tri_n, tri_obj = (
            np.concatenate(a) for a in (tp1, te1, te2, tn, tobj))
    else:
        tri_p1 = tri_e1 = tri_e2 = tri_n = np.zeros((0, 3))
        tri_obj = np.zeros((0,), dtype=np.int32)
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
        cluster_size=cluster_size if n_clusters else 0,
        any_smooth=bool(any_smooth and n_tris),
        n_super=len(super_aabb),
        single_tri_obj=n_prims if len(tri_leaves) == 1 else -1,
        refr_prim_ids=refr_prim_ids,
        refr_mesh_obj_ids=refr_mesh_obj_ids,
        tlas_n_inst=n_inst,
        tlas_n_mesh=n_mesh,
        tlas_cm=cm,
        tlas_sn=bool(tlas is not None and len(tlas["sn"])),
    )
    return _to_scene(arrays, static, dtype, device, tlas)


def _tensors(arrays: dict, names, dtype, device) -> dict:
    with span("rtc.compile.upload"):
        return {k: torch.tensor(np.asarray(arrays[k]),
                                dtype=torch.int32 if k in _INT_FIELDS else dtype,
                                device=device)
                for k in names}


def _to_scene(arrays: dict, static: SceneStatic, dtype, device,
              tlas: dict | None = None) -> Scene:
    leaf = static.cluster_size
    tensors = _tensors(arrays, TENSOR_FIELDS, dtype, device)
    occ = tlas_occ = None
    if static.n_clusters:
        with span("rtc.compile.occlusion"):
            occ = occlusion_tables(arrays["tri_p1"], arrays["tri_e1"], arrays["tri_e2"],
                                   arrays["cluster_aabb"], leaf, device,
                                   tri_cid=tensors["tri_cid"])
    if tlas is not None:
        with span("rtc.compile.occlusion"):
            tlas_occ = occlusion_tables(tlas["p1"], tlas["e1"], tlas["e2"], tlas["caabb"],
                                        leaf, device, tlas["inst_aabb"], tlas["inst_mesh"],
                                        static.tlas_n_mesh)
        tlas = TlasTables(**_tensors(tlas, TlasTables._fields, dtype, device))
    return Scene(**tensors, tlas=tlas, static=static, occ=occ, tlas_occ=tlas_occ)


def scene_from_numpy(arrays: dict, static: dict, device) -> Scene:
    """The port's Scene from another compiler's tables, passed as numpy.

    arrays: field name -> numpy array (rtc_tpu's Scene fields of the same
    names; extra fields are ignored), in float32 or float64; for an
    instanced scene (static["tlas_n_inst"] > 0) also arrays["tlas"], a
    dict of rtc_tpu's TlasTables fields (inst_rf and other extra fields
    are ignored). static: rtc_tpu's SceneStatic as a dict (extra keys are
    ignored).
    """
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[np.asarray(arrays["tri_p1"]).dtype]
    st = SceneStatic(**{k: static[k] for k in SceneStatic._fields})
    tlas = arrays.get("tlas") if st.tlas_n_inst else None
    if st.tlas_n_inst and tlas is None:
        raise ValueError("scene_from_numpy: static.tlas_n_inst > 0 but "
                         "arrays has no 'tlas' tables")
    return _to_scene(arrays, st, dtype, device, tlas)


def params_from_numpy(params: dict, device, dtype=None) -> dict:
    """The port's trainable parameters from another package's parameter
    dict (rtc_tpu's diff.render_grad.extract_params, as numpy): name ->
    a leaf tensor on device that requires grad, in dtype (default: the
    array's own), so both packages start an optimisation from the same
    values."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device).requires_grad_()
            for k, v in params.items()}


# the triangle rows that the boxes and the occlusion tables derive from
GEOMETRY_FIELDS = ("tri_p1", "tri_e1", "tri_e2")


def derived_tables(scene: Scene, p1, e1, e2) -> dict:
    """The fields of scene derived from its triangle rows, rebuilt for the
    rows p1, e1, e2 (tensors, read detached): the boxes of every cluster
    whose rows changed (over its real rows, as compile_scene), the
    supercluster boxes, and the occlusion walk's tables (Scene.occ) as
    _to_scene builds them. Returns the fields to replace: none when no row
    changed. An instanced scene's kernels read its TLAS tables, which the
    world table's rows do not determine, so new rows there raise."""
    st = scene.static
    npy = lambda a: a.detach().cpu().numpy().astype(np.float64)
    new = [npy(a) for a in (p1, e1, e2)]
    old = [npy(a) for a in (scene.tri_p1, scene.tri_e1, scene.tri_e2)]
    if not st.n_clusters or all(np.array_equal(a, b) for a, b in zip(new, old)):
        return {}
    if scene.tlas is not None:
        raise ValueError(
            "new triangle rows on an instanced scene: its kernels read the "
            "TLAS tables (unique meshes in object space), which cannot be "
            "rebuilt from the world table's rows; compile the changed world")
    leaf = st.cluster_size
    p1, e1, e2 = new
    changed = np.zeros(len(p1) // leaf, bool)
    for a, b in zip(new, old):
        changed |= (a != b).reshape(-1, leaf * 3).any(1)
    real = (e1 != 0).any(1) | (e2 != 0).any(1)
    aabb = npy(scene.cluster_aabb)
    for c in np.nonzero(changed)[0]:
        rows = slice(c * leaf, (c + 1) * leaf)
        keep = real[rows]
        verts = np.concatenate([p1[rows][keep], (p1 + e1)[rows][keep],
                                (p1 + e2)[rows][keep]])
        aabb[c] = _box(verts) if len(verts) else _empty_boxes(1)[0]
    as_box = lambda a: torch.tensor(a, dtype=scene.cluster_aabb.dtype,
                                    device=scene.cluster_aabb.device)
    return dict(cluster_aabb=as_box(aabb), super_aabb=as_box(_group_boxes(aabb)),
                occ=occlusion_tables(p1, e1, e2, aabb, leaf, scene.tri_p1.device,
                                     tri_cid=scene.tri_cid))
