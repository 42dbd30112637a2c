"""rtc_tpu_torch.tools.graft_entry against __graft_entry__.py on the CPU:
entry()'s forward step against rtc_tpu's, and dryrun_multichip(2) over a
gloo group of two CPU ranks (processes of the module): every gate of
__graft_entry__.py passes, and the printed line has its field names.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_graft_entry.py -q
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from rtc_tpu_torch.tools import graft_entry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pallas_mesh.py's f32 image budget (the kernel render against
# brute force): every channel within 2e-3
IMAGE_ATOL = 2e-3


def _line_fields() -> list:
    """The field names of __graft_entry__.py's dryrun line, in order."""
    with open(os.path.join(ROOT, "__graft_entry__.py")) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "print" and n.args
                and isinstance(n.args[0], ast.JoinedStr))
    text = "".join(v.value for v in call.args[0].values if isinstance(v, ast.Constant))
    return re.findall(r"(\w+)=", text)


def test_entry_matches_rtc_tpu():
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args).detach().numpy()
    jfn, jargs = jax_graft.entry()
    ref = np.asarray(jfn(*jargs))
    assert out.shape == ref.shape == (2048, 3)
    assert np.abs(out - ref).max() < IMAGE_ATOL


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (2, 2)),
                                     (6, (3, 2)), (8, (2, 4)), (12, (3, 4)), (16, (4, 4))])
def test_grid_shape(n, shape):
    """__graft_entry__.py's rule: a 4-way prims axis from 8 ranks on, else
    2-way where the count is even."""
    assert graft_entry.grid_shape(n) == shape


def test_dryrun_multichip_two_ranks(capsys):
    m = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip(2): ")]
    assert re.findall(r"(\w+)=", line) == _line_fields()
    assert m["mesh"] == {"rays": 1, "prims": 2}
    assert m["img_err_f64"] < 1e-12 and m["grad_err_f64"] < 1e-12
    assert m["kernel_shard_err"] == 0.0 and m["herd_523k_shard_err"] == 0.0
