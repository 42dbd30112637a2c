"""Numeric tolerance policy (counterpart of rtc_tpu/utils/constants.py).

EPSILON is the reference's single tolerance (src/utils.rs:2): the
triangle parallel-ray guard, the shadow-acne offset of over_point and the
book's float comparisons (is_almost_equal).
"""

EPSILON = 1e-5

# Large-but-finite sentinel for "no hit", so min-reductions stay NaN-free.
BIG = 1e30

# Lanes that cast no ray (misses, pad rays, non-reflective hits) are parked
# far out on (+1, +1, +1) with a direction pointing further out, so every
# cluster box lies behind them and the kernels' traversal drops them at once.
FAR = 1e12
PARK = 0.5773502692

# rtc_tpu's VMEM triangle budget (ops/pallas/mesh_intersect.py:1408-1410),
# a TPU artifact kept unchanged so that both packages take the same route
# on the same world: a mesh table of more padded rows streams in
# superblocks (render/integrator.py plan), and a world of mesh leaves over
# it takes the instanced path (scene/compile.py). The CUDA kernels
# themselves take a table of any size.
VMEM_TRI_BUDGET = 49152


def is_almost_equal(a, b, eps: float = EPSILON):
    """Scalar or elementwise approximate equality (reference:
    src/utils.rs:4-6): |a - b| < eps, a bool for floats, a bool tensor
    for tensors."""
    return abs(a - b) < eps
