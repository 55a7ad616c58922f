"""Reference PyTorch checkpoints (`params_*.ckpt` of the original
PatchmatchNet) into the port's state dict (reference:
`patchmatchnet_tpu/compat/torch_convert.py`).

The conversion is the reference's chain: the reference state dict goes to
the JAX package's variable layout ({'params', 'batch_stats'} of numpy
arrays) by the reference's rules, and `weights.state_dict_from_jax` takes
that to the port, so a reference checkpoint, a converted `.msgpack` and
the port agree to the bit. The rules:
- `module.` prefixes (DataParallel) are stripped;
- `num_batches_tracked` entries are dropped;
- modules the model never calls are dropped (`_EXPECTED_UNUSED_PREFIXES`);
- `feature_weight_net` moves under `evaluation`;
- conv weights [O, I, kH, kW] -> HWIO; 1x1 convs and 1x1x1 Conv3d -> dense
  [I, O]; the Refinement ConvTranspose2d -> flipped HWIO; BatchNorm
  weight/bias -> scale/bias and running_mean/var -> batch_stats.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from patchmatchnet_torch.compat.weights import state_dict_from_jax

# Reference keys with no counterpart because the module is never called:
# stage 1 has no propagation (the reference defines the conv anyway for
# TorchScript export), and the pixel-wise view-weight net only runs on
# stage 3 (its weights are reused downstream).
_EXPECTED_UNUSED_PREFIXES = (
    "patchmatch_1.propa_conv",
    "patchmatch_1.evaluation.pixel_wise_net",
    "patchmatch_2.evaluation.pixel_wise_net",
)


def _to_np(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _conv2d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _dense_kernel(w: np.ndarray) -> np.ndarray:
    # [O, I, 1, 1], [O, I, 1, 1, 1] or [O, I] -> [I, O]
    return np.transpose(w.reshape(w.shape[0], w.shape[1]), (1, 0))


def _deconv_kernel(w: np.ndarray) -> np.ndarray:
    # [I, O, kH, kW] -> flipped HWIO [kH, kW, I, O]
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)).copy()


def jax_variables_from_torch(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A reference state dict (tensors or numpy arrays) -> the JAX
    package's {'params': ..., 'batch_stats': ...} tree of f32 numpy arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    skipped: List[str] = []
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith(_EXPECTED_UNUSED_PREFIXES):
            skipped.append(key)
            continue
        w = _to_np(value)
        key = key.replace(".feature_weight_net.", ".evaluation.feature_weight_net.")
        parts = key.split(".")
        leaf, scope = parts[-1], tuple(parts[:-1])

        if scope and scope[-1] == "bn":
            names = {"weight": (params, "scale"), "bias": (params, "bias"),
                     "running_mean": (stats, "mean"), "running_var": (stats, "var")}
            if leaf not in names:
                raise ValueError(f"Unhandled BN key: {key}")
            tree, name = names[leaf]
            _set(tree, scope + (name,), w)
        elif scope and scope[-1] == "deconv":
            if leaf != "weight":
                raise ValueError(f"Unexpected deconv key: {key}")
            _set(params, scope + ("kernel",), _deconv_kernel(w))
        elif scope and scope[-1] in ("propa_conv", "eval_conv"):  # learned-offset convs
            _set(params, scope + ("conv2d", "kernel" if leaf == "weight" else "bias"),
                 _conv2d_kernel(w) if leaf == "weight" else w)
        elif scope and scope[-1] in ("conv2", "similarity") and "net" in ".".join(scope):
            # Dense1 blocks (1x1x1 Conv3d with bias)
            _set(params, scope + ("dense", "kernel" if leaf == "weight" else "bias"),
                 _dense_kernel(w) if leaf == "weight" else w)
        elif leaf == "weight":
            if w.ndim == 5 or (w.ndim == 4 and w.shape[2] == w.shape[3] == 1):
                _set(params, scope + ("kernel",), _dense_kernel(w))
            elif w.ndim == 4:
                _set(params, scope + ("kernel",), _conv2d_kernel(w))
            else:
                raise ValueError(f"Unhandled weight shape {w.shape} for {key}")
        elif leaf == "bias":
            _set(params, scope + ("bias",), w)
        else:
            raise ValueError(f"Unhandled key: {key}")
    return {"params": params, "batch_stats": stats}


def convert_torch_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the port's state dict (f32 tensors) for
    `models.PatchmatchNet` of the released configuration."""
    return state_dict_from_jax(jax_variables_from_torch(state_dict))


def convert_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference `params_*.ckpt` (a `torch.save` dict holding the
    state dict under 'model', or the state dict itself) and convert it.
    The file is a pickle (`weights_only=False`, as the reference saved
    it): load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_state_dict(ckpt["model"] if "model" in ckpt else ckpt)
