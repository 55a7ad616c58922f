"""Whole runs of the benchmark on the CPU at a tiny size (`tiny.py`): every
cell runs and is correct with the program in f32; its readings at two
seeds are those frozen in `frozen_readings.json`; a fault planted in the
program's timed path makes `correct` false; nothing of JAX loads; and a
cell, a configuration, a traffic mix, a metric and a kernel group, or a
second architecture with its cells (`stub_arch/`), are added by new files
and entries alone."""

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
STUB_ALTERED = """
import stubnet
_call = stubnet.Estimator.__call__
def _altered(self, batch, generator):
    depth, confidence = _call(self, batch, generator)
    return depth * 1.01, confidence
stubnet.Estimator.__call__ = _altered
"""
STUB_UNCHANGED = """
import torch
import stubnet
_step = stubnet.train_step
def _unchanged(model, optimizer, batch, lr):
    saved = [p.detach().clone() for p in model.parameters()]
    out = _step(model, optimizer, batch, lr)
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return out
stubnet.train_step = _unchanged
"""
FAKE_JAX = """
import sys, types
sys.modules["jax"] = types.ModuleType("jax")
"""


FROZEN = json.load(open(os.path.join(HERE, "frozen_readings.json")))["readings"]


@pytest.fixture(scope="module")
def copy_f32(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("pmnbench_f32")), precision="f32")


@pytest.fixture(scope="module")
def copy_as_configured(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("pmnbench_configured")))


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


@pytest.mark.parametrize("key", sorted(FROZEN))
def test_readings_are_frozen(copy_f32, copy_as_configured, key):
    """The numbers compared, and those printed beside them, of each cell at
    two seeds, to the bit."""
    precision, workload, seed = key.split("/")
    copy = copy_f32 if precision == "f32" else copy_as_configured
    proc = tiny.run(copy, workload, seed=int(seed))
    line = tiny.result(proc)
    said = [ln for ln in proc.stderr.splitlines() if ln.startswith(("map ", "steps: "))]
    assert {k: v["value"] for k, v in line["checks"].items()} == FROZEN[key]["checks"]
    assert said == FROZEN[key]["said"]


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


def _add_stub(root):
    """Add `stub_arch/`'s files and its cells' entries to the copy `root`;
    return the cells with their end-to-end metric."""
    import shutil

    stub = os.path.join(HERE, "stub_arch")
    for d, _, files in os.walk(stub):
        for f in files:
            if f.endswith((".py", ".json")):
                rel = os.path.relpath(os.path.join(d, f), stub)
                assert not os.path.exists(os.path.join(root, rel)), rel
                os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
                shutil.copy(os.path.join(d, f), os.path.join(root, rel))
    manifest = json.load(open(os.path.join(root, "BENCHMARK.json")))
    manifest["configs"].append({"name": "stub-net", "source": "test",
                                "file": "pmnbench/configs/stub-net.json", "reduced": [],
                                "why": "test"})
    cells = {"stub-maps": "stub_map_ms", "stub-train": "stub_samples_per_s"}
    for cell, metric in cells.items():
        manifest["workloads"].append({"name": cell, "config": "stub-net", "traffic": cell,
                                      "chips": 1, "why": "test"})
        manifest["end_to_end"].append({"name": metric, "unit": "u", "better": "lower",
                                       "bound": 0.05, "source": "host_clock",
                                       "workloads": [cell]})
        manifest["per_layer"].append({"name": f"mfu.{cell}", "unit": "%", "better": "higher",
                                      "source": "host_clock", "layer": "whole forward or step",
                                      "moves": metric, "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return cells


def test_architecture_added_by_files_and_entries_alone(tmp_path):
    """A second architecture (`stub_arch/`: `archs/stub.py`, a plane-sweep
    net with seeded weights and no random input, whose program `stubnet.py`
    lies outside the benchmark as the port does) with a configuration, a
    maps and a train traffic, limits, metrics and a kernel group: both
    cells run correct, a fault planted in its program makes each not
    correct, and no file of the benchmark changed."""
    root = tiny.make_copy(str(tmp_path), precision="f32")
    bench = os.path.join(root, "pmnbench")
    before = {os.path.relpath(os.path.join(d, f), bench): open(os.path.join(d, f), "rb").read()
              for d, _, files in os.walk(bench) for f in files}
    cells = _add_stub(root)
    for cell, metric in cells.items():
        line = tiny.result(tiny.run(root, cell))
        assert line["correct"] is True and line["failed"] == 0, line
        assert set(line["metrics"]) == {metric, "setup_s"}
        traced = tiny.result(tiny.run(root, cell, trace=1))
        assert traced["correct"] is True
        assert set(traced["metrics"]) == {f"mfu.{cell}"}
    plant = f"import sys\nsys.path.insert(0, {root!r})\n"
    for cell, fault in (("stub-maps", STUB_ALTERED), ("stub-train", STUB_UNCHANGED)):
        line = tiny.result(tiny.run(root, cell, plant=plant + fault))
        assert line["correct"] is False, line
    after = {os.path.relpath(os.path.join(d, f), bench): open(os.path.join(d, f), "rb").read()
             for d, _, files in os.walk(bench) for f in files if "__pycache__" not in d}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k)


def _calibrate(root, workload):
    """`calibrate.py` of the copy `root` on the CPU, two seeds, the first
    with the control, the witness and the planted faults."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="4", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(root, "pmnbench", "calibrate.py"),
                           "--workload", workload, "--seeds", "2", "--control-seeds", "1",
                           "--device", "cpu"],
                          capture_output=True, text=True, env=env, timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    head, *lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert head == {"device": "cpu", "workload": workload}
    return lines


@pytest.mark.parametrize("workload", MAP_CELLS + TRAIN_CELLS[:1] + ["stub-maps", "stub-train"])
def test_calibrate_reads_through_the_traffic_kind(tmp_path, copy_f32, workload):
    """`calibrate.py` takes its readings from the traffic's own
    `drive_<kind>.py`, for PatchmatchNet's cells and a second
    architecture's alike: the program in f32 reads inside the cell's
    limits, and the first seed also reads the control, the witness and,
    for a train cell, the half batch."""
    root = copy_f32
    if workload.startswith("stub-"):
        root = tiny.make_copy(str(tmp_path), precision="f32")
        _add_stub(root)
    limits = json.load(open(os.path.join(root, "pmnbench", "limits", f"{workload}.json")))
    lines = _calibrate(root, workload)
    assert [ln["seed"] for ln in lines] == [2718281828, 2718281828 + 7919]
    for ln in lines:
        assert all(ln["program"][n] <= limit for n, limit in limits["numbers"].items()), ln
    assert {"control", "witness_bf16"} <= set(lines[0]) and "control" not in lines[1]
    if "ref_losses" in lines[0]:
        assert "half_batch" in lines[0]
