"""The benchmark's command rehearsed on the CPU (--rehearse WIDTH: a
canvas WIDTH wide and a 1 s window), the contract's refusals, and a new
configuration, traffic mix, cell and per-layer metric added as files
only."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _run(cwd, workload, trace=0, rehearse=24, seed=3_000_000_017, timeout=600):
    cmd = [sys.executable, "rtbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", "1", "--trace", str(trace)]
    if rehearse:
        cmd += ["--rehearse", str(rehearse)]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line) and list(line)[-1] == "compared"
    assert DEVICE_KEYS <= set(line["device"])
    for k, v in line["compared"].items():
        assert f"compared {k} {v['value']!r} limit {v['limit']!r}" in proc.stderr
    return line


@pytest.mark.parametrize("workload, trace", [
    ("cow.orbit", 0), ("cow.orbit", 1), ("cow.fit", 0), ("glass_teapot.fit", 1)])
def test_rehearsal_prints_the_contracts_line(workload, trace):
    line = _result(_run(ROOT, workload, trace))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert {"scene_compile_s", "first_call_s"} <= set(line["metrics"])
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0


def test_no_card_no_result():
    proc = _run(ROOT, "cow.orbit", rehearse=0)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_bare_checkout_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = _run(tmp_path, "cow.orbit")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_added_files_make_a_new_cell(tmp_path):
    """A configuration, a traffic mix with a loop kind of its own, a cell
    and a per-layer metric, each as new files and BENCHMARK.json entries;
    no file of rtbench/ edited."""
    bench_dir = tmp_path / "rtbench"
    shutil.copytree(os.path.join(ROOT, "rtbench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("rtc_tpu_torch", "assets"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    before = {p: (bench_dir / p).read_bytes() for p in _files(bench_dir)}
    config = json.load(open(bench_dir / "configs" / "cow.json"))
    config["name"] = "cow_red"
    config["objects"][0]["material"]["color"] = [0.9, 0.2, 0.2]
    (bench_dir / "configs" / "cow_red.json").write_text(json.dumps(config))
    # a traffic mix whose loop kind is new too (kinds/<loop>.py), here a
    # turntable under another name
    (bench_dir / "traffic" / "spin.json").write_text(json.dumps(
        {"loop": "spin", "azimuth_step_deg": 30.0}))
    (bench_dir / "kinds").mkdir()
    (bench_dir / "kinds" / "spin.py").write_text(
        "from rtbench.check import frame_numbers as numbers\n"
        "from rtbench.loops import frames as run\n")
    (bench_dir / "workloads" / "cow_red.spin.json").write_text(json.dumps(
        {"check": {"pixels_kept_per_frame": 64, "pixels_compared": 4096, "bad_gap": 0.05},
         "limits": {"bad_share": 0.05, "gap_p90": 1e-4},
         "trace": {"skip": 0, "iterations": 2}}))
    (bench_dir / "metrics" / "first_call_ms.py").write_text(
        "def read(r):\n    return r.host['first_call_s'] * 1e3\n")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "cow_red", "source": "test", "reduced": [], "why": "test",
                             "file": "rtbench/configs/cow_red.json"})
    bench["workloads"].append({"name": "cow_red.spin", "config": "cow_red", "traffic": "spin",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cow.orbit" in m["workloads"]:
            m["workloads"].append("cow_red.spin")
    bench["per_layer"].append({"name": "first_call_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "frame and step cache",
                               "moves": "setup_s", "workloads": ["cow_red.spin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = _result(_run(tmp_path, "cow_red.spin", trace=1))
    assert line["metrics"]["first_call_ms"]["value"] > 0
    line = _result(_run(tmp_path, "cow_red.spin", trace=0))
    assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert {p: (bench_dir / p).read_bytes() for p in before} == before


def _files(base):
    return [os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base)
            for f in fs if "__pycache__" not in d]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _result(_run(ROOT, "cow.orbit", rehearse=0))
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
