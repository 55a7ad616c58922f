"""The plain reference against the program's plain path on the CPU, at a
tiny size: one inference map and one train step, both in f32."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [REPO, HERE]

from pmnbench import check, reference, scenes  # noqa: E402
from pmnbench.harness import architecture, load_json  # noqa: E402

CONFIG = load_json(REPO, "pmnbench", "configs", "pmn-train.json")
ARCH = architecture(CONFIG)
# textured at the scale of a tiny image, so that the matches are well posed
TRAFFIC = dict(load_json(REPO, "pmnbench", "traffic", "train-640x512-v5-b8.json"),
               height=64, width=96, texture_period_px=[3.0, 24.0])


def _program(train: bool):
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.train.driver import load_any_checkpoint

    model = PatchmatchNet(compute_dtype=None)
    model.load_state_dict(load_any_checkpoint(os.path.join(REPO, CONFIG["checkpoint"])))
    return model.train() if train else model


def _scenes(count: int, seed: int):
    return scenes.make_scenes(torch.Generator().manual_seed(seed), count, TRAFFIC)


def test_map_matches_program():
    sc = _scenes(1, 11)
    noise = torch.rand((1, 48, 8, 12), generator=torch.Generator().manual_seed(3))
    args = [sc[k] for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    with torch.no_grad():
        depth, conf, stages = _program(False)(*args, init_noise=noise)
        ref_depth, ref_conf, ref_stages = ARCH.reference_model(CONFIG, "f32", "cpu", 0).forward(
            *args, noise)
    scale = float(sc["depth_max"][0] - sc["depth_min"][0])
    assert (depth - ref_depth).abs().max().item() < 1e-5 * scale
    assert (conf - ref_conf).abs().max().item() < 1e-4
    for s in (1, 2, 3):
        for a, b in zip(stages[s], ref_stages[s]):
            assert (a - b).abs().max().item() < 1e-5 * scale


def test_train_step_matches_program():
    from patchmatchnet_torch.train.loop import make_optimizer, train_step

    sc = _scenes(2, 12)
    noise = torch.rand((2, 48, 8, 12), generator=torch.Generator().manual_seed(4))
    model = _program(True)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = make_optimizer(model.parameters(), 1e-3)
    metrics, _ = train_step(model, opt, sc, 1e-3, noise, with_grads=True)
    ref = ARCH.reference_model(CONFIG, "f32", "cpu", 0)
    out = reference.train_steps(ref, [sc], [noise], 1e-3)
    assert float(metrics["loss"]) == pytest.approx(out["losses"][0], rel=1e-5)
    norms = sorted(float(g.norm()) for g in out["grads"].values())
    median = norms[len(norms) // 2]
    for key, g in out["grads"].items():
        mine = metrics["grads"][ARCH.program_key(key)].reshape(g.shape)
        assert (mine - g).norm().item() <= 1e-3 * max(float(g.norm()), median), key
    # the change, as the benchmark compares it (single elements with a
    # gradient near Adam's eps move by round-off in either)
    change = {k: (params[ARCH.program_key(k)].detach()
                  - before[ARCH.program_key(k)]).norm().item() for k in out["grads"]}
    ref_change = {k: (ref.params[k] - out["params0"][k]).norm().item() for k in out["grads"]}
    grads = {k: float(g.norm()) for k, g in out["grads"].items()}
    numbers = check.train_numbers(
        {"losses": [float(metrics["loss"])], "grad_norms": grads, "change_norms": change},
        {"losses": out["losses"], "grad_norms": grads, "change_norms": ref_change})
    assert numbers["change_median_gap"] < 1e-3


@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_lower_precision_moves_the_map(precision):
    sc = _scenes(1, 13)
    noise = torch.rand((1, 48, 8, 12), generator=torch.Generator().manual_seed(5))
    args = [sc[k] for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    with torch.no_grad():
        exact, _, _ = ARCH.reference_model(CONFIG, "f32", "cpu", 0).forward(*args, noise)
        low, _, _ = ARCH.reference_model(CONFIG, precision, "cpu", 0).forward(*args, noise)
    gap = (exact - low).abs().mean().item()
    assert 0 < gap < 0.05 * float(sc["depth_max"][0] - sc["depth_min"][0])


def test_checkpoint_reader_matches_program():
    from patchmatchnet_torch.train.driver import load_any_checkpoint

    params, stats = reference.load_weights(os.path.join(REPO, CONFIG["checkpoint"]))
    program = load_any_checkpoint(os.path.join(REPO, CONFIG["checkpoint"]))
    for key, value in params.items():
        np.testing.assert_array_equal(
            program[ARCH.program_key(key)].numpy().reshape(value.shape), value.numpy())
    assert len(params) + len(stats) == len(program)
