"""The benchmark loads neither JAX nor the JAX package (rtc_tpu), and
its reference loads nothing of the program (rtc_tpu_torch). Module
names are compared by their top-level name, whole: rtc_tpu_torch begins
with rtc_tpu."""

import ast
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "rtbench")
JAX = {"jax", "jaxlib", "flax", "rtc_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_traffic_and_reference_load_no_jax():
    mods = sorted("rtbench." + os.path.relpath(p, BENCH)[:-3].replace(os.sep, ".")
                  for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
                  if "tests" not in p and "metrics" not in p and "__init__" not in p)
    code = "\n".join(["import sys", f"sys.path.insert(0, {ROOT!r})"]
                     + [f"import {m}" for m in mods] + [
        "from rtbench import harness",
        "for loop in ('frames', 'fit'): harness.kind(loop)",
        "import glob, os",
        "for p in glob.glob(os.path.join(harness.HERE, 'metrics', '*.py')):",
        "    harness.load_module(p, 'm_' + os.path.basename(p).replace('.', '_'))",
        # what the program under test imports on a run
        "import rtc_tpu_torch.render.renderer, rtc_tpu_torch.diff.render_grad",
        "import rtc_tpu_torch.scene.compile, rtc_tpu_torch.io.obj, rtc_tpu_torch.ops.transforms",
    ])
    loaded = _loaded(code)
    assert "rtbench" in loaded and "rtc_tpu_torch" in loaded
    assert not loaded & JAX, loaded & JAX


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded(f"import sys\nsys.path.insert(0, {ROOT!r})\n"
                     "import rtbench.reference.tracer, rtbench.reference.geometry")
    assert not loaded & (JAX | {"rtc_tpu_torch"})
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"numpy", "torch", "os", "math", "dataclasses",
                                           "contextlib", "contextvars", "__future__"}, (path, n)
