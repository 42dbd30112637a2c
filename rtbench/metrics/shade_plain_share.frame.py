import sys


def read(r):
    """% : the shading nodes on the plain versions (integrator.SHADE_NODES
    "plain") over every shaded node, those and the shading kernels' nodes,
    over the run: each replay repeats one frame's nodes, so the run's share
    is a frame's. None where the program has no such counter, or shaded no
    node."""
    try:
        from rtc_tpu_torch.render import integrator
    except ImportError:
        return None
    nodes = getattr(integrator, "SHADE_NODES", None)
    if not nodes or "plain" not in nodes or "kernel" not in nodes:
        return None
    plain, kernel = nodes["plain"], nodes["kernel"]
    if plain + kernel == 0:
        return None
    print(f"rtbench: shade_plain_share.frame from {plain} plain and {kernel} kernel "
          "shading nodes over the run", file=sys.stderr)
    return 100.0 * plain / (plain + kernel)
