"""Train and eval steps, learning-rate schedule, optimizer and checkpoints
(reference: `patchmatchnet_tpu/train/loop.py`).

The step is eager PyTorch: the forward runs the model in train mode
(batch-statistic BatchNorm, K1/K3 forward and K4/K5 backward kernels on
CUDA), the loss is the masked smooth-L1 over the GT pyramid, and Adam
applies the update. The f32 trainer (`compute_dtype=None`) keeps TF32 off
through forward and backward, as the inference forward does.

Data parallel: each rank steps its rows of the global batch with the model
that `parallel.replicate` wrapped (sync-BN, DistributedDataParallel) and
the group's process group. The loss divides by the global mask counts and
each rank backpropagates world size x its share, so DDP's gradient average
is the gradient of the global batch's loss, as in the JAX package's
sharded step; the returned loss and metrics are the global ones.

A step is the span `pmn.step`, with `pmn.step.forward`, `.loss`,
`.backward`, `.optimizer` and `.metrics` under it (`utils.profiling`).

Checkpoints are `torch.save` files {epoch, step, model, optimizer};
`load_train_checkpoint` also resumes from the reference's
`params_*.ckpt.msgpack` (through `compat.train_state_from_jax`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from patchmatchnet_torch.compat import read_flax_msgpack, train_state_from_jax
from patchmatchnet_torch.models.net import PatchmatchNet, full_f32, patchmatchnet_loss
from patchmatchnet_torch.ops.resize import downsample_nearest
from patchmatchnet_torch.utils.metrics import absolute_depth_error, threshold_error
from patchmatchnet_torch.utils.profiling import span

BATCH_KEYS = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max",
              "depth_gt", "mask")


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The array fields of a loader batch as tensors on `device` (images,
    cameras and depth range f32, mask bool)."""
    out = {}
    for key in BATCH_KEYS:
        t = torch.as_tensor(np.asarray(batch[key]))
        out[key] = t.to(device, torch.bool if key == "mask" else torch.float32)
    return out


def build_stage_pyramid(depth_gt: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """GT and mask [B, H, W] at scales 1, 1/2, 1/4, 1/8 by nearest
    downsampling (reference: `build_stage_pyramid`)."""
    gts = [depth_gt] + [downsample_nearest(depth_gt, f) for f in (2, 4, 8)]
    masks = [mask.bool()] + [downsample_nearest(mask.bool(), f) for f in (2, 4, 8)]
    return gts, masks


def multistep_lr(base_lr: float, lr_epochs: str, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's "e1,e2,e3:gamma_inv" spec as a function of the step
    index: the rate is divided by gamma_inv at step m * steps_per_epoch of
    every milestone epoch m (the optax piecewise-constant schedule the
    reference builds)."""
    epochs, gamma_inv = lr_epochs.split(":")
    boundaries = [int(e) * steps_per_epoch for e in epochs.split(",")]
    gamma = 1.0 / float(gamma_inv)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8). `weight_decay` is L2 added to the
    gradient before the moments, as the reference's
    `optax.add_decayed_weights` before `optax.adam` (not AdamW)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def _unwrap(model: torch.nn.Module) -> torch.nn.Module:
    return model.module if isinstance(model, DistributedDataParallel) else model


def _precision(model: torch.nn.Module):
    return full_f32() if _unwrap(model).compute_dtype is None else contextlib.nullcontext()


def _compute_metrics(dp: Dict[int, List[torch.Tensor]], gts: Sequence[torch.Tensor],
                     masks: Sequence[torch.Tensor],
                     thresholds: Sequence[float] = (1.0, 2.0, 4.0, 8.0)
                     ) -> Dict[str, torch.Tensor]:
    metrics = {f"depth-error-stage-{i}": absolute_depth_error(dp[i][-1], gts[i], masks[i])
               for i in range(4)}
    for t in thresholds:
        metrics[f"threshold-{t:g}mm-error"] = threshold_error(dp[0][-1], gts[0], masks[0], t)
    return metrics


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], lr: float, init_noise: torch.Tensor,
               with_grads: bool = False, group: Optional[dist.ProcessGroup] = None
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step at learning rate `lr` on a device batch
    (`batch_to_device`); `init_noise` [B, 48, H/8, W/8] is the stage-3
    noise. Returns (metrics, image summaries) as device tensors: "loss", the
    per-stage depth errors and threshold errors, and with `with_grads` the
    parameter gradients by name under "grads". With `group`, `model` is a
    `parallel.replicate` replica, the batch and noise are this rank's rows
    of the global batch, and the metrics are reduced over the group (one
    all-reduce: the loss summed, the per-image means averaged over equal
    shares)."""
    with span("pmn.step"):
        world = 1 if group is None else dist.get_world_size(group)
        model.train()
        gts, masks = build_stage_pyramid(batch["depth_gt"], batch["mask"])
        optimizer.zero_grad(set_to_none=True)
        with _precision(model):
            with span("pmn.step.forward"):
                _, _, dp = model(batch["images"], batch["intrinsics"], batch["extrinsics"],
                                 batch["depth_min"], batch["depth_max"], init_noise=init_noise)
            with span("pmn.step.loss"):
                loss = patchmatchnet_loss(dp, gts, masks, group)
            with span("pmn.step.backward"):
                (loss * world if world > 1 else loss).backward()
        grads = ({name: p.grad.detach().clone() for name, p in _unwrap(model).named_parameters()
                  if p.grad is not None} if with_grads else None)
        with span("pmn.step.optimizer"):
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
            optimizer.step()
        with span("pmn.step.metrics"), torch.no_grad():
            dp = {s: [d.detach() for d in v] for s, v in dp.items()}
            metrics: Dict[str, Any] = {"loss": loss.detach(), **_compute_metrics(dp, gts, masks)}
            if group is not None:
                packed = torch.stack(list(metrics.values()))
                dist.all_reduce(packed, group=group)
                metrics = {k: v if k == "loss" else v / world
                           for k, v in zip(metrics, packed)}
            if grads is not None:
                metrics["grads"] = grads
            m0 = masks[0].float()
            images = {
                "ref-image": batch["images"][:, 0],
                "depth-gt-stage-0": gts[0] * m0,
                "depth-refined-stage-0": dp[0][-1] * m0,
                "error-map-stage-0": (dp[0][-1] - gts[0]).abs() * m0,
            }
            for i in (1, 2, 3):
                images[f"depth-stage-{i}"] = dp[i][-1] * masks[i].float()
    return metrics, images


@torch.no_grad()
def eval_step(model: PatchmatchNet, batch: Dict[str, torch.Tensor],
              init_noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Validation on running statistics: loss and depth metrics."""
    model.eval()
    gts, masks = build_stage_pyramid(batch["depth_gt"], batch["mask"])
    with _precision(model):
        _, _, dp = model(batch["images"], batch["intrinsics"], batch["extrinsics"],
                         batch["depth_min"], batch["depth_max"], init_noise=init_noise)
    return {"loss": patchmatchnet_loss(dp, gts, masks), **_compute_metrics(dp, gts, masks)}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

CHECKPOINT_SUFFIX = ".ckpt.pt"


def save_train_checkpoint(path: str, model: PatchmatchNet, optimizer: torch.optim.Optimizer,
                          step: int, epoch: int) -> None:
    """Write {epoch, step, model, optimizer} with `torch.save` (atomically)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"epoch": epoch, "step": step, "model": model.state_dict(),
               "optimizer": optimizer.state_dict()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_checkpoint(path: str, model: PatchmatchNet,
                          optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    """Restore model and optimizer from the port's checkpoint or from the
    reference's `*.ckpt.msgpack`. Returns (step, epoch)."""
    if path.endswith(".msgpack"):
        state = train_state_from_jax(read_flax_msgpack(path))
        model.load_state_dict(state.state_dict, strict=True)
        params = dict(model.named_parameters())
        if set(state.adam) != set(params):
            raise ValueError("the checkpoint's Adam state does not cover the model's parameters")
        optimizer.state.clear()
        for name, adam in state.adam.items():
            p = params[name]
            optimizer.state[p] = {"step": adam["step"].clone(),
                                  "exp_avg": adam["exp_avg"].to(p.device),
                                  "exp_avg_sq": adam["exp_avg_sq"].to(p.device)}
        return state.step, state.epoch
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"]), int(payload["epoch"])


def find_latest_checkpoint(folder: str, suffix: str = CHECKPOINT_SUFFIX) -> str:
    """The `params_XXXXXX<suffix>` file of the highest epoch in `folder`, or
    "" if there is none."""
    if not os.path.isdir(folder):
        return ""
    saved = [fn for fn in os.listdir(folder)
             if fn.startswith("params_") and fn.endswith(suffix)]
    if not saved:
        return ""
    saved.sort(key=lambda fn: int(fn[len("params_"):-len(suffix)]))
    return os.path.join(folder, saved[-1])
