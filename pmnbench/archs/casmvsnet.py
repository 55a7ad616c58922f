"""CasMVSNet (Gu et al., CVPR 2020): what the harness needs of the
architecture, found by a configuration's `"architecture": "casmvsnet"`.

It gives every function that `archs/patchmatchnet.py` documents. The
configuration names no checkpoint: the program and the plain reference
(`reference_casmvsnet.py`) take one state, drawn from the seed by the
reference's `seeded_state`, whose `prob` layers are set on the pool of
scenes that the configuration's `"seeded_state_traffic"` draws from the
same seed (the cell's own pool, where it names the cell's traffic), on a
card where there is one; the state is made once a process and seed.
CasMVSNet draws nothing at random per map, so
`extra_inputs` is None, and it runs inference only: its cells are `maps`
cells, and the training functions raise. The program's functions are
looked up when they are called, never when this module is imported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from pmnbench import reference_casmvsnet, scenes
from pmnbench.roofline import casmvsnet as roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_states: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}


def seeded_state(config: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """The state both sides take (on the host)."""
    key = (config["name"], seed)
    if key not in _states:
        with open(os.path.join(HERE, "traffic", f"{config['seeded_state_traffic']}.json")) as f:
            traffic = json.load(f)
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        pool = scenes.make_scenes(torch.Generator(device=dev).manual_seed(seed),
                                  traffic["scenes"], traffic)
        names = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")
        probes = [(tuple(pool[k][i:i + 1] for k in names), pool["depth_gt"][i:i + 1])
                  for i in range(traffic["scenes"])]
        _states[key] = reference_casmvsnet.seeded_state(seed, probes)
    return _states[key]


def program_model(config: Dict[str, Any], inference: bool, seed: int):
    """The program's CasMVSNet, built by the program's `build_model` at its
    published settings (which must be the configuration's), with the state
    the seed draws (on the host)."""
    from patchmatchnet_torch.config import Config, ModelConfig
    from patchmatchnet_torch.models import casmvsnet
    from patchmatchnet_torch.train.driver import build_model

    settings = (tuple(config["ndepths"]), tuple(config["depth_interval_ratio"]))
    if settings != (casmvsnet.NDEPTHS, casmvsnet.DEPTH_INTERVAL_RATIO):
        raise ValueError(f"the program runs ndepths {casmvsnet.NDEPTHS} at ratios "
                         f"{casmvsnet.DEPTH_INTERVAL_RATIO}; the configuration asks {settings}")
    cfg = Config(model=ModelConfig(precision=config["precision"],
                                   train_precision=config["train_precision"]),
                 architecture="casmvsnet")
    model = build_model(cfg, inference=inference)
    model.load_state_dict(seeded_state(config, seed), strict=True)
    return model


def estimator(model, device: torch.device):
    from patchmatchnet_torch.infer.depth import DepthEstimator

    return DepthEstimator(model, device)


def extra_inputs(generator: torch.Generator, batch: int, height: int, width: int,
                 device: torch.device) -> None:
    return None


def reference_model(config: Dict[str, Any], precision: str, device, seed: int):
    """The plain reference on `device`, with the same seeded state."""
    state = {k: v.to(device) for k, v in seeded_state(config, seed).items()}
    return reference_casmvsnet.CasMVSNetReference(state, precision, config["ndepths"],
                                                  config["depth_interval_ratio"])


def reference_map(ref, tensors: Dict[str, torch.Tensor], extra
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    depth, confidence, _ = ref.forward(tensors["images"], tensors["intrinsics"],
                                       tensors["extrinsics"], tensors["depth_min"],
                                       tensors["depth_max"])
    return depth, confidence


def _inference_only(*args, **kwargs):
    raise ValueError("CasMVSNet runs inference only: its cells are maps cells")


make_optimizer = train_step = reference_train_steps = program_key = _inference_only


def bound(config: Dict[str, Any], traffic: Dict[str, Any]) -> dict:
    return roofline.cell_bound(config, traffic)
