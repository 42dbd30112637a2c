import sys

FUSED = ("closest_shadow", "closest_shadow_sn")
SPLIT = ("closest_hit", "closest_hit_sn", "closest_hit_t0", "closest_hit_uv",
         "closest_hit_tlas", "closest_hit_tlas_sn", "closest_hit_elementwise")


def read(r):
    """% : the fused closest-hit and shadow kernel's launches (K3, flat and
    with_sn: mesh_intersect.LAUNCHES closest_shadow, closest_shadow_sn)
    over every closest-hit launch on a triangle table, those and the
    split kernels' (K1 in each mode, K5, K7a), over the run: each replay
    repeats one frame's launches, so the run's share is a frame's. None
    where the program has no such counter, or launched no closest hit on
    triangles."""
    try:
        from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
    except ImportError:
        return None
    launches = getattr(mi, "LAUNCHES", None)
    if not launches:
        return None
    fused = sum(launches.get(k, 0) for k in FUSED)
    split = sum(launches.get(k, 0) for k in SPLIT)
    if fused + split == 0:
        return None
    print(f"rtbench: fused_share.frame from {fused} fused and {split} split closest-hit "
          "launches over the run", file=sys.stderr)
    return 100.0 * fused / (fused + split)
