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
from pmnbench import check, reference, scenes  # noqa: E402
from pmnbench.drive_train import CHECK_STEPS, make_batches  # noqa: E402
from pmnbench.harness import load_cell, reference_model  # noqa: E402

MANIFEST = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
SEEDS = (3141592653, 2718281828, 1414213562)


def _shrunk(cell):
    cell.traffic.update(tiny.TINY[cell.traffic["kind"]])
    return cell


def _fails(cell, numbers):
    return any(numbers[name] > limit for name, limit in cell.limits["numbers"].items())


def _map_control(cell, seed, dev):
    traffic = cell.traffic
    sc = scenes.make_scenes(torch.Generator(device=dev).manual_seed(seed), 1, traffic)
    h, w = traffic["height"], traffic["width"]
    noise = torch.rand((1, 48, h // 8, w // 8), generator=torch.Generator(device=dev)
                       .manual_seed(seed + 1), device=dev)
    args = [sc[k] for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    with torch.no_grad():
        ref = reference_model(cell.config, "f32", dev).forward(*args, noise)
        low = reference_model(cell.config, "fp8", dev).forward(*args, noise)
    return check.map_numbers(low[0], low[1], ref[0], ref[1],
                             float(sc["depth_max"][0] - sc["depth_min"][0]),
                             cell.limits["params"])


def _train_control(cell, seed, dev):
    traffic, config = cell.traffic, cell.config
    batches, noises = make_batches(traffic, seed, dev, world=int(traffic["ranks"]),
                                   rows=slice(None))
    sides = []
    for precision in ("f32", "fp8"):
        ref = reference_model(config, precision, dev)
        out = reference.train_steps(ref, batches[:CHECK_STEPS], noises[:CHECK_STEPS],
                                    float(config["learning_rate"]))
        sides.append({"losses": out["losses"],
                      "grad_norms": {k: float(g.norm()) for k, g in out["grads"].items()},
                      "change_norms": {k: float((ref.params[k] - out["params0"][k]).norm())
                                       for k in out["grads"]}})
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
