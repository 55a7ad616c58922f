"""PatchmatchNet (Wang et al., CVPR 2021): what the harness needs of the
architecture, found by a configuration's `"architecture": "patchmatchnet"`.

Every architecture module of `archs/` gives the same functions, and the
drivers and `calibrate.py` reach the program, the plain reference and the
bound through them alone:

- `program_model(config, inference, seed)`: the program's model with its
  weights, on the host;
- `estimator(model, device)`: the callable a maps window sends each
  request to, `(request, generator) -> (depth, confidence)` as numpy;
- `extra_inputs(generator, batch, height, width, device)`: the random
  input the program draws per map or sample, or None;
- `reference_model(config, precision, device, seed)` and
  `reference_map(ref, tensors, extra) -> (depth, confidence)`;
- `make_optimizer(params, lr)`, `train_step(model, optimizer, batch, lr,
  extra, group) -> metrics` and `reference_train_steps(ref, batches,
  extras, lr)`: the reference's readings of the first steps (`check.py`'s
  "losses", "grad_norms" and "change_norms", keyed by the reference's
  names); `program_key(reference_key)` is the program's name of a
  reference parameter;
- `bound(config, traffic)`: `roofline/count.py`'s `summary` of one map or
  one rank's step.

An architecture whose configuration has no "checkpoint" makes its weights
from `seed`, the same for the program and the reference. PatchmatchNet's
configurations name the released checkpoint, which the program reads with
its own loader and the reference with its own reader; the seed goes
unused. The program's functions are looked up when they are called, never
when this module is imported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import torch

from pmnbench import reference
from pmnbench.roofline import count

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INITIAL_SAMPLES = 48  # stage 3's random depth samples a pixel


def program_config(config: Dict[str, Any]):
    """The program's `Config` for a configuration file."""
    from patchmatchnet_torch.config import Config, ModelConfig

    model = ModelConfig(**{k: tuple(v) for k, v in config["model"].items()},
                        precision=config["precision"],
                        train_precision=config["train_precision"])
    return Config(model=model)


def program_model(config: Dict[str, Any], inference: bool, seed: int):
    """The program's model of the configuration, with the checkpoint's
    weights loaded by the program's own loader (on the host)."""
    from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint

    model = build_model(program_config(config), inference=inference)
    model.load_state_dict(load_any_checkpoint(os.path.join(ROOT, config["checkpoint"])),
                          strict=True)
    return model


def estimator(model, device: torch.device):
    from patchmatchnet_torch.infer.depth import DepthEstimator

    return DepthEstimator(model, device)


def extra_inputs(generator: torch.Generator, batch: int, height: int, width: int,
                 device: torch.device) -> torch.Tensor:
    """Stage 3's uniform noise [batch, 48, H/8, W/8], as the program's
    `DepthEstimator` draws it."""
    return torch.rand((batch, INITIAL_SAMPLES, height // 8, width // 8), generator=generator,
                      device=device)


def reference_model(config: Dict[str, Any], precision: str, device, seed: int):
    """The plain reference on `device`, from the same checkpoint file."""
    params, stats = reference.load_weights(os.path.join(ROOT, config["checkpoint"]))
    m = config["model"]
    features = dict(zip((1, 2, 3), config["feature_channels"][1:]))
    stages = {s: {"interval_scale": m["patchmatch_interval_scale"][s - 1],
                  "propagation_range": m["propagation_range"][s - 1],
                  "iterations": m["patchmatch_iteration"][s - 1],
                  "num_samples": m["patchmatch_num_sample"][s - 1],
                  "propagate_neighbors": m["propagate_neighbors"][s - 1],
                  "evaluate_neighbors": m["evaluate_neighbors"][s - 1],
                  "features": features[s], "groups": config["stage_groups"][s - 1]}
              for s in (1, 2, 3)}
    return reference.ReferenceModel({k: v.to(device) for k, v in params.items()},
                                    {k: v.to(device) for k, v in stats.items()},
                                    stages, precision)


def reference_map(ref, tensors: Dict[str, torch.Tensor], extra: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's depth and confidence of one request (`tensors`:
    images, intrinsics, extrinsics, depth_min, depth_max on the device)."""
    depth, confidence, _ = ref.forward(tensors["images"], tensors["intrinsics"],
                                       tensors["extrinsics"], tensors["depth_min"],
                                       tensors["depth_max"], extra)
    return depth, confidence


def make_optimizer(params, lr: float):
    from patchmatchnet_torch.train import loop

    return loop.make_optimizer(params, lr)


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], lr: float, extra, group):
    """One step of the program's `train_step`; its metrics."""
    from patchmatchnet_torch.train import loop

    return loop.train_step(model, optimizer, batch, lr, extra, group=group)[0]


def reference_train_steps(ref, batches: Sequence[Dict[str, torch.Tensor]],
                          extras: List[torch.Tensor], lr: float) -> Dict[str, Any]:
    out = reference.train_steps(ref, batches, extras, lr)
    return {"losses": out["losses"],
            "grad_norms": {k: float(g.norm()) for k, g in out["grads"].items()},
            "change_norms": {k: float((ref.params[k] - out["params0"][k]).norm())
                             for k in out["grads"]}}


def program_key(key: str) -> str:
    """The program's parameter name of a flax path
    ("feature/conv0/conv/kernel" -> "feature.conv0.conv.weight")."""
    scope, leaf = key.rsplit("/", 1)
    return scope.replace("/", ".") + "." + {"kernel": "weight", "scale": "weight",
                                            "bias": "bias"}[leaf]


def bound(config: Dict[str, Any], traffic: Dict[str, Any]) -> dict:
    return count.cell_bound(config, traffic)
