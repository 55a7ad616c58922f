"""Training driver: epochs, warm start and resume, logging, checkpoints and
validation on one device (reference: `patchmatchnet_tpu/train/driver.py`).

Per epoch it trains on a shuffled, drop-last loader of the train scans,
writes `params_{epoch:06d}.ckpt.pt` (full training state) and
`module_{epoch:06d}.pt` (model state dict, for inference) every `save_freq`
epochs, and validates on the test scans with running statistics. Scalars go
to `<output_folder>/metrics.jsonl` (and TensorBoard when importable).

The stage-3 noise of global step s is drawn from a generator seeded with
(rand_seed, s), and the loader's order and view choice depend on (seed,
epoch) only, so a run resumed from a checkpoint continues with the batches
and noise the uninterrupted run would have used.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import torch

from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, MVSDataset
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.patchmatch import INITIAL_NUM_SAMPLES
from patchmatchnet_torch.train.loop import (
    batch_to_device,
    eval_step,
    find_latest_checkpoint,
    load_train_checkpoint,
    make_optimizer,
    multistep_lr,
    save_train_checkpoint,
    train_step,
)
from patchmatchnet_torch.utils.logging import MetricsLogger
from patchmatchnet_torch.utils.metrics import DictAverageMeter

_NOISE_STRIDE = 1000003


def build_model(cfg: Config) -> PatchmatchNet:
    precision = cfg.model.train_precision
    if precision not in ("bf16", "f32"):
        raise ValueError(f"train_precision must be bf16 or f32, got {precision!r}")
    return PatchmatchNet(compute_dtype=torch.bfloat16 if precision == "bf16" else None)


def load_model_weights(model: PatchmatchNet, path: str) -> None:
    """Warm start from inference weights: a flax `.msgpack` of {params,
    batch_stats}, a `module_*.pt` state dict, or a port training
    checkpoint (its model part)."""
    if path.endswith(".msgpack"):
        state = state_dict_from_jax(read_flax_msgpack(path))
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        state = state.get("model", state)
    model.load_state_dict(state, strict=True)


def step_noise(batch: Dict[str, torch.Tensor], seed: int, step: int) -> torch.Tensor:
    """Stage-3 noise [B, 48, H/8, W/8] of global step `step`."""
    b, _, h, w = batch["images"].shape[:4]
    dev = batch["images"].device
    gen = torch.Generator(device=dev).manual_seed(seed * _NOISE_STRIDE + step)
    return torch.rand((b, INITIAL_NUM_SAMPLES, h // 8, w // 8), generator=gen, device=dev)


def run_training(cfg: Config) -> List[Dict[str, Any]]:
    """Train as configured; returns the logged train records (one per
    `summary_freq` steps: loss, metrics, lr, step_ms, data_ms)."""
    t, d = cfg.train, cfg.data
    device = torch.device(t.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    os.makedirs(t.output_folder, exist_ok=True)
    cfg.save(os.path.join(t.output_folder, "config.json"))

    def dataset(scan_list: str, robust: bool) -> MVSDataset:
        return MVSDataset(d.input_folder, d.num_views, d.image_extension,
                          max_dim=d.image_max_dim, scan_list=scan_list,
                          num_light_idx=d.num_light_idx, robust_train=robust,
                          seed=t.rand_seed)

    train_loader = BatchLoader(dataset(t.train_list, t.robust_train), d.batch_size,
                               shuffle=True, drop_last=True, seed=t.rand_seed)
    val_loader = BatchLoader(dataset(t.test_list, False), d.batch_size)
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("the train set holds fewer samples than one batch")

    torch.manual_seed(t.rand_seed)
    model = build_model(cfg).to(device)
    schedule = multistep_lr(t.learning_rate, t.lr_epochs, steps_per_epoch)
    optimizer = make_optimizer(model.parameters(), t.learning_rate, t.weight_decay)

    start_epoch = 0
    ckpt_path = t.checkpoint_path or find_latest_checkpoint(t.output_folder)
    if t.resume and ckpt_path and os.path.isfile(ckpt_path):
        print(f"Resuming from {ckpt_path}")
        _, last_epoch = load_train_checkpoint(ckpt_path, model, optimizer)
        start_epoch = last_epoch + 1
    elif t.checkpoint_path and os.path.isfile(t.checkpoint_path):
        load_model_weights(model, t.checkpoint_path)
    print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}; "
          f"device {device}; steps/epoch: {steps_per_epoch}")

    logger = MetricsLogger(t.output_folder)
    history: List[Dict[str, Any]] = []
    try:
        for epoch in range(start_epoch, t.epochs):
            train_loader.set_epoch(epoch)
            tick = time.perf_counter()
            for batch_idx, batch in enumerate(train_loader):
                global_step = epoch * steps_per_epoch + batch_idx
                tensors = batch_to_device(batch, device)
                start = time.perf_counter()
                lr = schedule(global_step)
                metrics, images = train_step(model, optimizer, tensors, lr,
                                             step_noise(tensors, t.rand_seed, global_step))
                if global_step % t.summary_freq == 0:
                    record = {k: float(v) for k, v in metrics.items()}  # waits for the step
                    done = time.perf_counter()
                    record.update(lr=lr, step_ms=(done - start) * 1e3, data_ms=(start - tick) * 1e3)
                    logger.scalars("train", record, global_step)
                    history.append(dict(record, step=global_step))
                    print(f"Epoch {epoch + 1}/{t.epochs}, Iter {batch_idx + 1}/{steps_per_epoch}, "
                          f"loss = {record['loss']:.3f}, step {record['step_ms']:.1f} ms")
                if global_step % (50 * t.summary_freq) == 0:
                    for name, img in images.items():
                        logger.image("train", name, img[0].float().cpu().numpy(), global_step)
                tick = time.perf_counter()

            if (epoch + 1) % t.save_freq == 0:
                step = (epoch + 1) * steps_per_epoch
                save_train_checkpoint(os.path.join(t.output_folder, f"params_{epoch:06d}.ckpt.pt"),
                                      model, optimizer, step, epoch)
                torch.save(model.state_dict(),
                           os.path.join(t.output_folder, f"module_{epoch:06d}.pt"))

            meter = DictAverageMeter()
            for i, batch in enumerate(val_loader):
                tensors = batch_to_device(batch, device)
                noise = step_noise(tensors, t.rand_seed + 1, epoch * len(val_loader) + i)
                meter.update({k: float(v) for k, v in eval_step(model, tensors, noise).items()})
            means = meter.mean()
            logger.scalars("full_test", means, (epoch + 1) * steps_per_epoch)
            print(f"avg_test_scalars: {means}")
    finally:
        logger.close()
    return history

