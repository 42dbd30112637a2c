import sys

from rtbench import accounting, accounting_prims


def read(r):
    """% : the least time a frame's prim queries need (accounting_prims.py)
    over the program's kernels' device time a frame; None where the
    configuration holds a mesh, or nothing was traced."""
    s, peak = r.summary, accounting.peaks(r.device_name)
    q = accounting_prims.frame_queries(r.ctx.config)
    if q is None or peak is None or s is None or s.iterations <= 0 or s.kernel_s <= 0:
        return None
    least = max(q["bytes"] / peak["hbm_bytes_per_s"], q["flop"] / peak["fp32_flop_per_s"])
    print(f"rtbench: prim_roofline.frame from {q['queries']} ray-prim queries, "
          f"{q['bytes']} bytes and {q['flop']} FLOP a frame", file=sys.stderr)
    return 100.0 * least / (s.kernel_s / s.iterations)
