import sys


def read(r):
    """% : the prims' plain sweeps (intersect.PLAIN_SWEEPS) over every prim
    sweep, those and the prim kernel's launches (mesh_intersect.LAUNCHES
    prim_closest and prim_any), over the run: each replay repeats one
    frame's mix, so the run's share is a frame's. None where the program
    has no such counter, or made no prim sweep."""
    try:
        from rtc_tpu_torch.ops import intersect
        from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
    except ImportError:
        return None
    plain = getattr(intersect, "PLAIN_SWEEPS", {}).get("prims")
    launches = getattr(mi, "LAUNCHES", {})
    if plain is None:
        return None
    kernel = launches.get("prim_closest", 0) + launches.get("prim_any", 0)
    if plain + kernel == 0:
        return None
    print(f"rtbench: prim_plain_share.frame from {plain} plain sweeps and {kernel} "
          "prim kernel launches over the run", file=sys.stderr)
    return 100.0 * plain / (plain + kernel)
