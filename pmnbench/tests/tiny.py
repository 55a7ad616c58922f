"""A copy of the benchmark at a size the CPU runs in seconds, for the
tests: the same files, with tiny traffic, driven on the CPU (the run skips
its look for a card) in a child process, optionally with a fault planted
in the program first."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {  # textured at the scale of a tiny image, so that the matches are well posed
    "maps": {"height": 64, "width": 96, "scenes": 2, "warmup": 1, "check_maps": 2,
             "check_among_first": 2, "trace_maps": 1, "texture_period_px": [3.0, 24.0]},
    "train": {"height": 64, "width": 80, "batch": 2, "pool": 4, "trace_steps": 1,
              "texture_period_px": [3.0, 24.0]},
}
# The four-card cell, which BENCHMARK.json leaves out until its runs are
# steady: its files stay under pmnbench/, and the copies add it so that
# its path stays tested (four gloo ranks on the CPU).
DP_CELL = {
    "workload": {"name": "dtu-train-dp4", "config": "pmn-train",
                 "traffic": "train-640x512-v5-b8x4", "chips": 4,
                 "why": "data-parallel fine-tuning on four cards over NCCL"},
    "end_to_end": {"name": "dp_train_samples_per_s", "unit": "samples/s", "better": "higher",
                   "bound": 0.25, "source": "host_clock", "workloads": ["dtu-train-dp4"]},
    "per_layer": [{"name": f"{m}.dp", "unit": u, "better": b, "source": "device_trace",
                   "layer": "device", "moves": "dp_train_samples_per_s",
                   "workloads": ["dtu-train-dp4"]}
                  for m, u, b in (("launches_per_step", "launches", "lower"),
                                  ("mfu", "%", "higher"), ("nccl_ms_per_step", "ms", "lower"),
                                  ("device_idle_share", "%", "lower"))],
}
RUNNER = """
import sys, time
t0 = time.perf_counter()
sys.path[:0] = [{copy!r}] + ([{repo!r}] if {with_program} else [])
from pmnbench import harness
class A: pass
a = A(); a.workload, a.seed, a.seconds, a.trace = {workload!r}, {seed}, {seconds}, {trace}
sys.exit(harness.run(a, t0, device="cpu"))
"""


def make_copy(root: str, traffic_edits: Optional[Dict[str, dict]] = None,
              precision: Optional[str] = None) -> str:
    """A copy of BENCHMARK.json and pmnbench/ under `root` whose traffic is
    tiny (plus `traffic_edits` by traffic name) and, with `precision`,
    whose configurations run in it. Returns the copy's root."""
    shutil.copytree(os.path.join(REPO, "pmnbench"), os.path.join(root, "pmnbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    if all(w["name"] != DP_CELL["workload"]["name"] for w in manifest["workloads"]):
        manifest["workloads"].append(DP_CELL["workload"])
        manifest["end_to_end"].append(DP_CELL["end_to_end"])
        manifest["per_layer"] += DP_CELL["per_layer"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    os.symlink(os.path.join(REPO, "checkpoints"), os.path.join(root, "checkpoints"))
    folder = os.path.join(root, "pmnbench", "traffic")
    for name in os.listdir(folder):
        path = os.path.join(folder, name)
        with open(path) as f:
            traffic = json.load(f)
        traffic.update(TINY[traffic["kind"]])
        traffic.update((traffic_edits or {}).get(name[:-5], {}))
        with open(path, "w") as f:
            json.dump(traffic, f)
    if precision:
        folder = os.path.join(root, "pmnbench", "configs")
        for name in os.listdir(folder):
            path = os.path.join(folder, name)
            with open(path) as f:
                config = json.load(f)
            config["precision"] = config["train_precision"] = precision
            with open(path, "w") as f:
                json.dump(config, f)
    return root


def run(copy: str, workload: str, seed: int = 12345678901, seconds: float = 0.5,
        trace: int = 0, plant: str = "", with_program: bool = True
        ) -> subprocess.CompletedProcess:
    """Run a cell of the copy on the CPU in a child process. `plant`
    (Python source) runs first in it and in every process it starts (rank
    processes too), as a `sitecustomize` module. Without `with_program`,
    the program is not on the child's path."""
    code = RUNNER.format(copy=copy, repo=REPO, workload=workload, seed=seed,
                         seconds=seconds, trace=trace, with_program=with_program)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "4"
    if plant:
        folder = os.path.join(copy, "planted")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "sitecustomize.py"), "w") as f:
            f.write(plant)
        env["PYTHONPATH"] = os.pathsep.join([folder, REPO])
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)


def result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
