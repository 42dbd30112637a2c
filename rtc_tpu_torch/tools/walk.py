"""The visits of the ordered walk, counted in plain PyTorch, and the scans
and box tests modelled from them (chip_smoke.py's walk lines and
perf_probe --visits).

The visits are counted, the scans modelled from them; the kernels count
neither. A walk over a range of n boxes that visits v of them scans the
range v + 1 times when each visit finds the next box by a scan (the last
scan finds none), and v // L + 1 times with the ordered walk's list of L
keys (a refill follows L visits), which is one too many where v is a
multiple of L and the scan that filled the list found no more. The visits
are counted as the bounds count them: the boxes entered by the ray's
final t. That is K1's visits on one launch; a streamed block or a later
instance may also visit boxes entered before a t_best not yet lowered, so
there it is a lower bound.
"""

from __future__ import annotations

import torch

from ..ops.kernels import mesh_intersect as mi

BOX_CHUNK = 1 << 24   # (rays x boxes) entries per counting pass


def entered(o, d, aabb, limit, strict: bool = False, signed: bool = False,
            keep=None, widen: bool = True):
    """The (ray, box) pairs, as two (P,) index tensors, of the boxes of aabb
    each ray enters at or before limit (strictly before with strict).
    signed: the census's test, a signed slab interval starting before
    limit, behind the origin included. keep (C,) bool: only those boxes.
    widen=False: boxes widened at compile time (the occlusion walk's)."""
    R, C = o.shape[0], aabb.shape[0]
    none = torch.zeros((0,), dtype=torch.int64, device=o.device)
    rays, boxes = [none], [none]
    step = max(1, BOX_CHUNK // max(C, 1))
    for s in range(0, R, step):
        tmin, tmax, empty = mi.box_slabs(o[s:s + step], d[s:s + step], aabb, widen)
        lim = limit[s:s + step, None]
        ok = ~empty[None] & (tmax >= tmin)
        if signed:
            ok &= tmin < lim
        else:
            e = torch.clamp_min(tmin, 0.0)
            ok &= (tmax >= 0.0) & ((e < lim) if strict else (e <= lim))
        if keep is not None:
            ok &= keep[None]
        r, c = ok.nonzero(as_tuple=True)
        rays.append(r + s)
        boxes.append(c)
    return torch.cat(rays), torch.cat(boxes)


def walk_census(visits, n_boxes: int, L: int) -> dict:
    """Per ray, of one walk over a range of n_boxes boxes that visits
    visits (R,) of them: the scans and box tests, modelled, of a scan per
    visit (old) and of the ordered walk with a list of L keys (new)."""
    old, new = visits + 1, visits // L + 1
    return {"old_scans": old, "new_scans": new, "old_tests": old * n_boxes,
            "new_tests": new * n_boxes}


def block_census(counts, n_boxes: int, L: int) -> dict:
    """walk_census summed over a streamed table's blocks, each walked for
    every ray; counts (R, B): each ray's visits in each block of
    ceil(n_boxes / B) boxes."""
    per = -(-n_boxes // counts.shape[1])
    parts = [walk_census(v, min(per, n_boxes - b * per), L)
             for b, v in enumerate(counts.unbind(1))]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def k1_visits(o, d, aabb, t_final):
    """(R,) the clusters of aabb K1's ordered walk visits on each ray that
    ends at t_final (R,): those it enters by that t."""
    return torch.bincount(entered(o, d, aabb, t_final)[0], minlength=o.shape[0])


def k1_walk_line(what: str, rays, R: int, n_clusters: int, L: int) -> str:
    """walk_line of K1's walk over one range with a list of L keys, from
    the (ray, cluster) visits' ray indices."""
    visits = torch.bincount(rays, minlength=R)
    return walk_line(what, {"clusters": visits}, walk_census(visits, n_clusters, L), L)


def walk_line(what: str, visits: dict, census: dict, L: int) -> str:
    """Visits per ray (median, 99th percentile, max), counted, and the mean
    scans and box tests a ray of a scan per visit against the ordered walk,
    modelled from the visits (walk_census)."""
    parts = []
    for name, v in visits.items():
        q = torch.quantile(v.double(), torch.tensor([0.5, 0.99], dtype=torch.float64,
                                                    device=v.device)).tolist()
        parts.append(f"{name} median {q[0]:g}, p99 {q[1]:g}, max {int(v.max())}")
    mean = lambda k: float(census[k].double().mean())
    return (f"{what}: visits a ray, " + "; ".join(parts)
            + "; modelled from the visits: scans a ray "
            f"{mean('old_scans'):.3f} per visit -> "
            f"{mean('new_scans'):.3f} with L={L}; box tests a ray "
            f"{mean('old_tests'):.1f} -> {mean('new_tests'):.1f}")
