"""Whole runs of the benchmark on the CPU at a tiny size (`tiny.py`): every
cell runs and is correct with the program in f32; a fault planted in the
program's timed path makes `correct` false; nothing of JAX loads; and a
cell, a configuration, a traffic mix, a metric and a kernel group are added
by new files and entries alone."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [HERE]

import tiny  # noqa: E402

MANIFEST = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
MAP_CELLS = [w["name"] for w in MANIFEST["workloads"] if w["config"] == "pmn-infer"]
TRAIN_CELLS = [w["name"] for w in MANIFEST["workloads"] if w["config"] == "pmn-train"]
DP_CELLS = [tiny.DP_CELL["workload"]["name"]]
if DP_CELLS[0] not in TRAIN_CELLS:
    TRAIN_CELLS += DP_CELLS
    MANIFEST["end_to_end"].append(tiny.DP_CELL["end_to_end"])

ALTER_ANSWER = """
import patchmatchnet_torch.infer.depth as depth_module
_call = depth_module.DepthEstimator.__call__
def _altered(self, batch, generator):
    depth, confidence = _call(self, batch, generator)
    return depth * 1.01, confidence
depth_module.DepthEstimator.__call__ = _altered
"""
STATE_UNCHANGED = """
import torch
import patchmatchnet_torch.train.loop as loop
_step = loop.train_step
def _unchanged(model, optimizer, batch, *args, **kwargs):
    saved = [p.detach().clone() for p in model.parameters()]
    out = _step(model, optimizer, batch, *args, **kwargs)
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return out
loop.train_step = _unchanged
"""
HALF_BATCH = """
import patchmatchnet_torch.train.loop as loop
_step = loop.train_step
def _half(model, optimizer, batch, lr, noise, *args, **kwargs):
    keep = batch["images"].shape[0] // 2
    return _step(model, optimizer, {k: v[:keep] for k, v in batch.items()}, lr, noise[:keep],
                 *args, **kwargs)
loop.train_step = _half
"""
NO_EXCHANGE = """
import patchmatchnet_torch.parallel as parallel
import patchmatchnet_torch.parallel.mesh as mesh
def _alone(model, group):
    return model
parallel.replicate = mesh.replicate = _alone
"""
FAKE_JAX = """
import sys, types
sys.modules["jax"] = types.ModuleType("jax")
"""


@pytest.fixture(scope="module")
def copy_f32(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("pmnbench_f32")), precision="f32")


@pytest.mark.parametrize("workload", MAP_CELLS + TRAIN_CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(copy_f32, workload, traced):
    line = tiny.result(tiny.run(copy_f32, workload, trace=traced))
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
    if traced:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:  # the CPU has no allocator peak to read
        names = {m["name"] for m in MANIFEST["end_to_end"]
                 if workload in m.get("workloads", [workload])}
        assert names - {"peak_device_gib"} == set(line["metrics"])


@pytest.mark.parametrize("workload", MAP_CELLS)
def test_altered_answer_is_not_correct(copy_f32, workload):
    line = tiny.result(tiny.run(copy_f32, workload, plant=ALTER_ANSWER))
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [STATE_UNCHANGED, HALF_BATCH], ids=["unchanged", "half"])
def test_train_fault_is_not_correct(copy_f32, workload, fault):
    line = tiny.result(tiny.run(copy_f32, workload, plant=fault))
    assert line["correct"] is False


@pytest.mark.parametrize("workload", DP_CELLS)
def test_exchange_left_out_is_not_correct(copy_f32, workload):
    line = tiny.result(tiny.run(copy_f32, workload, plant=NO_EXCHANGE))
    assert line["correct"] is False


def test_no_jax_loads_and_the_check_sees_it(copy_f32):
    proc = tiny.run(copy_f32, MAP_CELLS[0], plant=FAKE_JAX)
    assert proc.returncode == 3 and not proc.stdout.strip()
    assert "jax" in proc.stderr
    # the program's own name starts with the JAX package's: whole names count
    line = tiny.result(tiny.run(copy_f32, MAP_CELLS[0]))
    assert line["correct"] is True


def test_reference_imports_nothing_of_the_program():
    source = open(os.path.join(REPO, "pmnbench", "reference.py")).read()
    imports = [ln.split()[1].split(".")[0] for ln in source.splitlines()
               if ln.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "contextlib", "struct", "typing", "numpy", "torch"}


def test_no_card_no_result(copy_f32):
    """Without a card the run prints no result and exits with 2."""
    import subprocess

    proc = subprocess.run([sys.executable, os.path.join(copy_f32, "pmnbench", "run.py"),
                           "--workload", MAP_CELLS[0], "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2 and not proc.stdout.strip()


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory of BENCHMARK.json and pmnbench/ alone, a run fails
    and prints no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "pmnbench"), os.path.join(tmp_path, "pmnbench"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = tiny.run(str(tmp_path), MAP_CELLS[0], with_program=False)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_cell_added_by_files_and_entries_alone(tmp_path):
    root = tiny.make_copy(str(tmp_path), precision="f32")
    bench = os.path.join(root, "pmnbench")
    before = {os.path.relpath(os.path.join(d, f), bench): open(os.path.join(d, f), "rb").read()
              for d, _, files in os.walk(bench) for f in files}

    def write(rel, text):
        assert rel not in before
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)

    config = json.load(open(os.path.join(bench, "configs", "pmn-infer.json")))
    config["name"] = "dummy-config"
    write("configs/dummy-config.json", json.dumps(config))
    traffic = json.load(open(os.path.join(bench, "traffic", "dtu-1600x1200-v5.json")))
    traffic.update(views=3, height=48, width=64)
    write("traffic/dummy-traffic.json", json.dumps(traffic))
    write("limits/dummy-cell.json",
          open(os.path.join(bench, "limits", f"{MAP_CELLS[0]}.json")).read())
    write("metrics/dummy_rate.py", "def read(window):\n    return window.count / window.window_s\n")
    write("metrics/dummy_glue_ms.py", "def read(window):\n"
          "    t = window.trace\n    return None if t is None else 1e3 * t.window_s\n")
    write("kernel_groups/50-dummy.json",
          json.dumps({"why": "test", "groups": [{"match": "^dummy_kernel", "group": "dummy"}]}))
    manifest = json.load(open(os.path.join(root, "BENCHMARK.json")))
    manifest["configs"].append({"name": "dummy-config", "source": "test",
                                "file": "pmnbench/configs/dummy-config.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                                  "traffic": "dummy-traffic", "chips": 1, "why": "test"})
    manifest["end_to_end"].append({"name": "dummy_rate", "unit": "maps/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["dummy-cell"]})
    manifest["per_layer"].append({"name": "dummy_glue_ms", "unit": "ms", "better": "lower",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "dummy_rate", "workloads": ["dummy-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    plain = tiny.result(tiny.run(root, "dummy-cell"))
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"dummy_rate", "setup_s"}
    traced = tiny.result(tiny.run(root, "dummy-cell", trace=1))
    assert set(traced["metrics"]) == {"dummy_glue_ms"}
    probe = tiny.run(root, "dummy-cell", plant=(
        f"sys.path.insert(0, {root!r})\nfrom pmnbench import devtrace\n"
        "assert devtrace.group_of('dummy_kernel<1>', devtrace.kernel_groups()) == 'dummy'\n"))
    assert probe.returncode == 0, probe.stderr[-2000:]
    after = {os.path.relpath(os.path.join(d, f), bench): open(os.path.join(d, f), "rb").read()
             for d, _, files in os.walk(bench) for f in files if "__pycache__" not in d}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k)
