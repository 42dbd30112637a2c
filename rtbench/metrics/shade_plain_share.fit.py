import sys


def read(r):
    """% : the shading nodes on the plain versions (integrator.SHADE_NODES
    "plain") over every shaded node, those, the shading kernels' ("kernel")
    and the shading kernels' under autograd ("grad", 0 where the program
    has no such key), over the run: the fit's steps, each replay repeating
    one step's nodes, and its set-up's target renders. None where the
    program has no such counter, or shaded no node."""
    try:
        from rtc_tpu_torch.render import integrator
    except ImportError:
        return None
    nodes = getattr(integrator, "SHADE_NODES", None)
    if not nodes or "plain" not in nodes or "kernel" not in nodes:
        return None
    plain, kernel, grad = nodes["plain"], nodes["kernel"], nodes.get("grad", 0)
    if plain + kernel + grad == 0:
        return None
    print(f"rtbench: shade_plain_share.fit from {plain} plain, {kernel} kernel and {grad} "
          "grad shading nodes over the run", file=sys.stderr)
    return 100.0 * plain / (plain + kernel + grad)
