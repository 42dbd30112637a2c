"""Sharded rendering over the rank grid (counterpart of
rtc_tpu/parallel/shard.py).

Two axes (parallel/mesh.py):
  * rays over 'rays' (data parallel, always): Morton tiles dealt round
    robin over the rays ranks, each rank shading its own;
  * optionally the triangle table over 'prims' (tensor parallel): each
    rank of a prims group holds one contiguous cluster range of the
    table, with its own boxes and occlusion tables, so K1, K2 and K4 run
    on the shard as on a whole table; the integrator combines the
    partial results per sweep (render/integrator.py: the closest hit by
    least t, occlusion by OR, the crossing census by SUM and MAX).

Every rank holds the whole scene and calls the same function; the prims,
materials, patterns and light stay whole on every rank. An instanced
scene's TLAS tables are left unused under the prim axis, which takes the
world table, as rtc_tpu does (render/integrator.py plan).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..render.camera import Camera, camera_rays_for_pixels
from ..render.order import morton_perm
from ..render.renderer import _shade_rays
from ..scene.compile import Scene, _empty_boxes, occlusion_tables
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from ..utils.constants import FAR, PARK
from . import collectives as coll
from .mesh import DeviceMesh, active_grid, make_mesh, mesh_axis

_TRI_FIELDS = ("tri_p1", "tri_e1", "tri_e2", "tri_n", "tri_obj", "tri_cid",
               "tri_sn1", "tri_sn2", "tri_sn3")


def _pad_rows(arr, n: int, name: str):
    # tri_cid pads with -1 (0 is a valid container slot)
    return torch.cat([arr, arr.new_full((n,) + arr.shape[1:],
                                        -1 if name == "tri_cid" else 0)])


def _with_occ(scene: Scene) -> Scene:
    """scene with the occlusion walk's tables of its own rows and its own
    tri_cid tensor, which K4 then knows by identity."""
    if not scene.static.n_clusters:
        return scene
    occ = occlusion_tables(scene.tri_p1, scene.tri_e1, scene.tri_e2,
                           scene.cluster_aabb, scene.static.cluster_size,
                           scene.tri_p1.device, tri_cid=scene.tri_cid)
    return dataclasses.replace(scene, occ=occ)


def pad_tris(scene: Scene, multiple: int) -> Scene:
    """Pad the triangle table so it splits evenly over `multiple` prims
    ranks, with rows that never hit (zero edges: Möller-Trumbore's det
    guard rejects them), as rtc_tpu's pad_tris (:55-104).

    A clustered table pads at cluster granularity: empty cluster boxes
    (1, 1, 1, -1, -1, -1) and zero-edge leaves, tri_cid -1, and the
    supercluster boxes padded with empty ones to a multiple too, so each
    shard keeps whole clusters. The occlusion walk's tables are rebuilt
    for the padded rows. A table without clusters pads its rows."""
    st = scene.static
    n, leaf = st.n_tris, st.cluster_size
    if leaf and st.n_clusters:
        cpad = (-st.n_clusters) % multiple
        spad = (-st.n_super) % multiple
        if cpad == 0 and spad == 0:
            return scene
        box = lambda a, k: torch.cat([a, torch.as_tensor(
            _empty_boxes(k), dtype=a.dtype, device=a.device)])
        repl = {"cluster_aabb": box(scene.cluster_aabb, cpad)}
        if scene.super_aabb.shape[0]:
            repl["super_aabb"] = box(scene.super_aabb, spad)
        rows = cpad * leaf
        static = st._replace(n_tris=n + rows, n_clusters=st.n_clusters + cpad,
                             n_super=st.n_super + spad)
    else:
        if n % multiple == 0 and n > 0:
            return scene
        rows = multiple - n % multiple if n else multiple
        repl, static = {}, st._replace(n_tris=n + rows)
    for name in _TRI_FIELDS:
        arr = getattr(scene, name)
        if arr.shape[0] == n:  # not the empty smooth-normal slabs
            repl[name] = _pad_rows(arr, rows, name)
    return _with_occ(dataclasses.replace(scene, **repl, static=static))


def shard_scene(scene: Scene, index: int, n: int) -> Scene:
    """Shard `index` of n of a scene whose triangle table splits evenly
    over n (pad_tris): the rows of the triangle fields, the cluster boxes
    and the supercluster boxes of one contiguous cluster range, as
    rtc_tpu's scene_pspecs (:31-52) lays them out over 'prims'.

    The shard is a table of its own: its static counts its own rows,
    clusters and superclusters (so it streams through the superblock
    drivers exactly when its rows exceed the budget, as rtc_tpu's shard
    does, which decides by its local shapes), its occlusion tables are
    built from its rows and its own tri_cid tensor, and tri_offset is the
    whole table's row of its first row. Everything else is the scene's."""
    st = scene.static
    if n == 1:
        return scene
    if st.n_tris % n or st.n_clusters % n or st.n_super % n:
        raise ValueError(f"{st.n_tris} rows, {st.n_clusters} clusters and "
                         f"{st.n_super} superclusters do not split over {n} "
                         "ranks: pad_tris(scene, n) first")
    if not 0 <= index < n:
        raise ValueError(f"shard {index} of {n}")
    rows, n_c, n_s = st.n_tris // n, st.n_clusters // n, st.n_super // n
    first = index * rows
    repl = {name: getattr(scene, name)[first:first + rows] for name in _TRI_FIELDS
            if getattr(scene, name).shape[0] == st.n_tris}
    if n_c:
        repl["cluster_aabb"] = scene.cluster_aabb[index * n_c:(index + 1) * n_c]
    if scene.super_aabb.shape[0]:
        repl["super_aabb"] = scene.super_aabb[index * n_s:(index + 1) * n_s]
    static = st._replace(n_tris=rows, n_clusters=n_c, n_super=n_s)
    return _with_occ(dataclasses.replace(scene, **repl, static=static,
                                         tri_offset=scene.tri_offset + first))


def prim_shard(scene: Scene, index: int, n: int) -> Scene:
    """shard_scene(pad_tris(scene, n), index, n), built once for each scene
    object and kept on it (its occlusion tables are built on the host, a
    cost a frame should not pay again). dataclasses.replace() makes a new
    scene object, which builds its own."""
    memo = scene.__dict__.setdefault("_prim_shards", {})
    if (index, n) not in memo:
        memo[index, n] = shard_scene(pad_tris(scene, n), index, n)
    return memo[index, n]


@functools.lru_cache(maxsize=4)
def _balanced_morton_perm(vsize: int, hsize: int, n_shards: int, tile: int):
    """(perm, inv) of rtc_tpu (:149-175), two static reorderings composed:

    1. Morton order: each `tile`-ray block is a compact screen region, so
       the kernels' traversal culls sharply (render/order.py);
    2. round-robin tile dealing: tile k goes to rays rank k % D, so every
       rank receives a spatially spread mix of screen regions, and the
       geometry-heavy ones do not all land on one rank.

    Index arrays over the padded ray count (a multiple of D * tile), int32
    and read-only (the cache hands the same arrays to every caller)."""
    mperm, _ = morton_perm(vsize, hsize)
    n = vsize * hsize
    padded = -(-n // (n_shards * tile)) * (n_shards * tile)
    full = np.concatenate([mperm, np.arange(n, padded, dtype=np.int32)])
    # perm[slot] = source pixel; slot layout (D, nb/D, tile) gives rank d
    # the Morton tiles d, d+D, d+2D, ...
    perm = (full.reshape(-1, n_shards, tile)
            .transpose(1, 0, 2)
            .reshape(-1))
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    perm = perm.astype(np.int32)
    perm.flags.writeable = inv.flags.writeable = False
    return perm, inv


def sharded_colors(scene: Scene, camera: Camera,
                   cfg: RenderConfig = DEFAULT_CONFIG,
                   mesh: DeviceMesh | None = None, shard_prims: bool = False):
    """Shade this rank's rays (and, with shard_prims, its triangle shard)
    and gather the colors over 'rays'. Returns (colors, inv_perm, n_rays):
    colors (padded R, 3) in the sharded traversal order, on every rank;
    inv_perm (numpy, or None) undoes the Morton deal.

    The tile and the padding are rtc_tpu's, the same on every rank: Morton
    tiles of min(cfg.ray_tile, max(128, n_rays // n_ray_shards)) rays,
    dealt round robin; scanline order splits the padded rays evenly. Each
    rank makes only its own rays, pad rays parked."""
    mesh = mesh if mesh is not None else make_mesh(
        device_type=scene.tri_p1.device.type)
    rays, prims = mesh_axis(mesh, "rays"), mesh_axis(mesh, "prims")
    shard_p = shard_prims and prims.size > 1
    if shard_p:
        scene = prim_shard(scene, prims.rank, prims.size)

    vsize, hsize = camera.vsize, camera.hsize
    n_rays = vsize * hsize
    inv = None
    if cfg.ray_order == "morton":
        tile = min(cfg.ray_tile, max(128, n_rays // rays.size))
        perm, inv = _balanced_morton_perm(vsize, hsize, rays.size, tile)
        n_local = len(perm) // rays.size
        pix = perm[rays.rank * n_local:(rays.rank + 1) * n_local]
    else:
        n_local = -(-n_rays // rays.size)
        pix = np.arange(rays.rank * n_local, (rays.rank + 1) * n_local)
    device = scene.tri_p1.device
    pix = torch.tensor(pix, dtype=torch.int64, device=device)
    o, d = camera_rays_for_pixels(camera.transform_inverse, pix % hsize,
                                  pix // hsize, camera.half_width,
                                  camera.half_height, camera.pixel_size,
                                  cfg.torch_dtype())
    real = (pix < n_rays)[:, None]
    o, d = torch.where(real, o, FAR), torch.where(real, d, PARK)
    inner = dataclasses.replace(cfg, prim_axis="prims" if shard_p else None)
    with active_grid(mesh):
        local = _shade_rays(scene, o, d, inner)
    return coll.all_gather(local, rays).reshape(-1, 3), inv, n_rays


@torch.no_grad()
def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG,
                   mesh: DeviceMesh | None = None, shard_prims: bool = False):
    """Render with rays sharded over the grid's 'rays' axis and, with
    shard_prims, the triangle table over 'prims' (rtc_tpu :255-268).
    Every rank calls it with the whole scene; every rank gets the whole
    (V, H, 3) image. mesh defaults to every rank on 'rays' (make_mesh(),
    which makes new process groups: pass one mesh to repeated calls)."""
    colors, inv, n_rays = sharded_colors(scene, camera, cfg, mesh, shard_prims)
    if inv is not None:
        colors = colors[torch.tensor(inv, dtype=torch.int64, device=colors.device)]
    return colors[:n_rays].reshape(camera.vsize, camera.hsize, 3)
