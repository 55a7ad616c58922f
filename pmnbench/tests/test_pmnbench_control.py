"""The control, the plain reference one precision step below the
configuration's bf16 (fp8: e4m3 forward, e5m2 backward) put in the
program's place, is not correct by the cells' own limits: at a tiny size
on the CPU, and at each cell's own size on the card (marked `cuda`; it
skips without one)."""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [REPO, HERE]

import tiny  # noqa: E402
from pmnbench import check, scenes  # noqa: E402
from pmnbench.drive_train import CHECK_STEPS, make_batches  # noqa: E402
from pmnbench.harness import load_cell  # noqa: E402

MANIFEST = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
SEEDS = (3141592653, 2718281828, 1414213562)


def _shrunk(cell):
    cell.traffic.update(tiny.TINY[cell.traffic["kind"]])
    return cell


def _fails(cell, numbers):
    return any(numbers[name] > limit for name, limit in cell.limits["numbers"].items())


def _map_control(cell, seed, dev):
    traffic, arch = cell.traffic, cell.arch
    sc = scenes.make_scenes(torch.Generator(device=dev).manual_seed(seed), 1, traffic)
    h, w = traffic["height"], traffic["width"]
    extra = arch.extra_inputs(torch.Generator(device=dev).manual_seed(seed + 1), 1, h, w, dev)
    tensors = {k: sc[k] for k in ("images", "intrinsics", "extrinsics", "depth_min",
                                  "depth_max")}
    with torch.no_grad():
        ref = arch.reference_map(arch.reference_model(cell.config, "f32", dev, seed),
                                 tensors, extra)
        low = arch.reference_map(arch.reference_model(cell.config, "fp8", dev, seed),
                                 tensors, extra)
    return check.map_numbers(low[0], low[1], ref[0], ref[1],
                             float(sc["depth_max"][0] - sc["depth_min"][0]),
                             cell.limits["params"])


def _train_control(cell, seed, dev):
    traffic, config, arch = cell.traffic, cell.config, cell.arch
    batches, extras = make_batches(arch, traffic, seed, dev, world=int(traffic["ranks"]),
                                   rows=slice(None))
    sides = [arch.reference_train_steps(arch.reference_model(config, precision, dev, seed),
                                        batches[:CHECK_STEPS], extras[:CHECK_STEPS],
                                        float(config["learning_rate"]))
             for precision in ("f32", "fp8")]
    return check.train_numbers(sides[1], sides[0])


def _control(cell, seed, dev):
    kind = cell.traffic["kind"]
    return (_map_control if kind == "maps" else _train_control)(cell, seed, dev)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_a_tiny_size(workload):
    cell = _shrunk(load_cell(workload))
    if cell.traffic["kind"] == "train":
        cell.traffic["ranks"] = 1  # the reference is one process whatever the ranks
    for seed in SEEDS:
        assert _fails(cell, _control(cell, seed, torch.device("cpu"))), seed


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = load_cell(workload)
    for seed in SEEDS:
        assert _fails(cell, _control(cell, seed, torch.device("cuda"))), seed
