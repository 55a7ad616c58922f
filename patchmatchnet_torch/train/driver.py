"""Training driver: epochs, warm start and resume, logging, checkpoints and
validation, on one device or data parallel over ranks (reference:
`patchmatchnet_tpu/train/driver.py`).

Per epoch it trains on a shuffled, drop-last loader of the train scans
(the unified layout's `MVSDataset`, or the raw DTU layout's
`DTULegacyDataset` with `cfg.data.dataset == "dtu_legacy"`), writes
`params_{epoch:06d}.ckpt.pt` (full training state) and
`module_{epoch:06d}.pt` (model state dict, for inference) every `save_freq`
epochs, and validates on the test scans with running statistics. Scalars go
to `<output_folder>/metrics.jsonl` (and TensorBoard when importable), with
the logged step's data and step wall times (`utils.profiling.PhaseTimer`,
which waits for the device only at the end of a logged or traced step, as
the reference blocks only where it reads); each epoch prints the phases'
means. `profile_dir` captures a torch.profiler trace of the first epoch's
second step.

The stage-3 noise of global step s is drawn from a generator seeded with
(rand_seed, s), and the loader's order and view choice depend on (seed,
epoch) only, so a run resumed from a checkpoint continues with the batches
and noise the uninterrupted run would have used. Data parallel ranks load
their rows of the same global batches and take their rows of the same
noise, so their step is the one-device step of the global batch.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from patchmatchnet_torch.compat import (
    convert_torch_checkpoint,
    read_flax_msgpack,
    state_dict_from_jax,
)
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, DTULegacyDataset, MVSDataset
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.casmvsnet import CasMVSNet
from patchmatchnet_torch.parallel import Group, launch, replicate, shard_batch
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
from patchmatchnet_torch.utils.profiling import PhaseTimer, torch_trace

_NOISE_STRIDE = 1000003


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `torch.save` state dict: the file's dict, or its "model" entry."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state.get("model", state)


def load_any_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Inference weights as the port's state dict, from a flax `.msgpack`
    (variables {params, batch_stats}, or those of a JAX training
    checkpoint), a reference PyTorch `.ckpt` (`compat.torch_convert`), or
    any other file as the port writes it with `torch.save`: a
    `module_*.pt` state dict or a training checkpoint (its model part)."""
    if path.endswith(".msgpack"):
        tree = read_flax_msgpack(path)
        return state_dict_from_jax({k: tree[k] for k in ("params", "batch_stats") if k in tree})
    if path.endswith(".ckpt"):
        return convert_torch_checkpoint(path)
    return read_state_dict(path)


def _casmvsnet(cfg: Config, dtype: Optional[torch.dtype], inference: bool) -> CasMVSNet:
    if not inference:
        raise ValueError("CasMVSNet runs inference only: K8 has no backward")
    return CasMVSNet(compute_dtype=dtype)


# each network the port serves: (build(cfg, dtype, inference), read(checkpoint path))
ARCHITECTURES: Dict[str, Tuple[Callable[..., torch.nn.Module], Callable[[str], Dict]]] = {
    "patchmatchnet": (lambda cfg, dtype, _: PatchmatchNet(cfg.model, compute_dtype=dtype),
                      load_any_checkpoint),
    "casmvsnet": (_casmvsnet, read_state_dict),
}


def _architecture(cfg: Config):
    if cfg.architecture not in ARCHITECTURES:
        raise ValueError(f"architecture must be one of {', '.join(ARCHITECTURES)}, got "
                         f"{cfg.architecture!r}")
    return ARCHITECTURES[cfg.architecture]


def build_model(cfg: Config, inference: bool = False) -> torch.nn.Module:
    """The model of `cfg.architecture`: PatchmatchNet with `cfg.model`'s
    options, or CasMVSNet (inference only), in the precision of
    `cfg.model.precision` (inference) or `train_precision` (training)."""
    knob = "precision" if inference else "train_precision"
    precision = getattr(cfg.model, knob)
    if precision not in ("bf16", "f32"):
        raise ValueError(f"{knob} must be bf16 or f32, got {precision!r}")
    build, _ = _architecture(cfg)
    return build(cfg, torch.bfloat16 if precision == "bf16" else None, inference)


def load_weights(cfg: Config, path: str) -> Dict[str, torch.Tensor]:
    """The state dict in checkpoint `path`, read by `cfg.architecture`'s reader."""
    return _architecture(cfg)[1](path)


def step_noise(batch: Dict[str, torch.Tensor], seed: int, step: int,
               group: Optional[Group] = None) -> torch.Tensor:
    """Stage-3 noise [B, 48, H/8, W/8] of global step `step`. With `group`,
    `batch` is the rank's rows of the global batch, and the noise is the
    rank's rows of the global batch's noise, so N ranks see what 1 sees."""
    b, _, h, w = batch["images"].shape[:4]
    world = 1 if group is None else group.world_size
    dev = batch["images"].device
    gen = torch.Generator(device=dev).manual_seed(seed * _NOISE_STRIDE + step)
    noise = torch.rand(PatchmatchNet.noise_shape(b * world, h, w), generator=gen, device=dev)
    return noise if group is None else shard_batch({"noise": noise}, group)["noise"]


def run_training(cfg: Config, num_devices: Optional[int] = None, profile_dir: str = "",
                 launches: Optional[List[Dict[str, int]]] = None) -> List[Dict[str, Any]]:
    """Train as configured; returns the logged train records (one per
    `summary_freq` steps: loss, metrics, lr, step_ms, data_ms). With
    `profile_dir`, writes a trace of the first epoch's second step (its
    only step if it has one) to `profile_dir/trace.json`.

    `num_devices` > 1 trains data parallel: that many ranks on
    `cfg.train.device`'s type (`parallel.launch`: NCCL, one rank per card,
    on CUDA; gloo on the CPU), each stepping its rows of every global batch
    of `batch_size` (which they must divide) with the global batch's
    statistics, loss and gradient. Rank 0 writes the config, the metrics,
    the checkpoints and the trace, prints, and validates unsharded while
    the others wait; the records returned are rank 0's, and `launches`, if
    given, receives each rank's hand-kernel launch counts."""
    n = num_devices or 1
    if cfg.data.batch_size % n != 0:
        raise ValueError(f"batch_size {cfg.data.batch_size} must be divisible by {n} devices")
    if n == 1:
        return _train(None, cfg, profile_dir)
    results = launch(_train, n, (cfg, profile_dir), device_type=torch.device(cfg.train.device).type)
    if launches is not None:
        launches.extend(r.launches for r in results)
    return results[0].value


def _train(group: Optional[Group], cfg: Config, profile_dir: str) -> List[Dict[str, Any]]:
    """The training run of one process: the whole run, or with `group` one
    rank of a data-parallel run."""
    t, d = cfg.train, cfg.data
    device = torch.device(t.device) if group is None else group.device
    lead = group is None or group.rank == 0
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if t.ckpt_backend != "msgpack":
        raise ValueError(f"ckpt_backend {t.ckpt_backend!r}: the port checkpoints with "
                         "torch.save (the default, 'msgpack'); orbax is the JAX package's "
                         "backend and stays out of the port (ROADMAP item 12)")
    if d.dataset not in ("unified", "dtu_legacy"):
        raise ValueError(f"dataset must be unified or dtu_legacy, got {d.dataset!r}")
    if lead:
        os.makedirs(t.output_folder, exist_ok=True)
        cfg.save(os.path.join(t.output_folder, "config.json"))

    def dataset(scan_list: str, robust: bool):
        if d.dataset == "dtu_legacy":  # num_views counts the reference view
            return DTULegacyDataset(d.input_folder, scan_list, num_views=d.num_views,
                                    robust_train=robust, seed=t.rand_seed)
        return MVSDataset(d.input_folder, d.num_views, d.image_extension,
                          max_dim=d.image_max_dim, scan_list=scan_list,
                          num_light_idx=d.num_light_idx, robust_train=robust,
                          seed=t.rand_seed)

    shard = None if group is None else (group.rank, group.world_size)
    train_loader = BatchLoader(dataset(t.train_list, t.robust_train), d.batch_size,
                               shuffle=True, drop_last=True, seed=t.rand_seed, shard=shard)
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
        if lead:
            print(f"Resuming from {ckpt_path}")
        _, last_epoch = load_train_checkpoint(ckpt_path, model, optimizer)
        start_epoch = last_epoch + 1
    elif t.checkpoint_path and os.path.isfile(t.checkpoint_path):
        model.load_state_dict(load_weights(cfg, t.checkpoint_path), strict=True)
    net = model if group is None else replicate(model, group)
    process_group = None if group is None else group.process_group
    if lead:
        ranks = "" if group is None else f"; {group.world_size} ranks"
        print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}; "
              f"device {device}{ranks}; steps/epoch: {steps_per_epoch}")

    logger = MetricsLogger(t.output_folder) if lead else None
    val_loader = BatchLoader(dataset(t.test_list, False), d.batch_size) if lead else None
    history: List[Dict[str, Any]] = []
    timer = PhaseTimer(device)
    traced_step = min(1, steps_per_epoch - 1)
    try:
        for epoch in range(start_epoch, t.epochs):
            train_loader.set_epoch(epoch)
            batches = iter(train_loader)
            for batch_idx in range(steps_per_epoch):
                global_step = epoch * steps_per_epoch + batch_idx
                with timer("data", sync=False):
                    tensors = batch_to_device(next(batches), device)
                lr = schedule(global_step)
                capture = (lead and bool(profile_dir) and epoch == start_epoch
                           and batch_idx == traced_step)
                logged = global_step % t.summary_freq == 0
                with torch_trace(profile_dir if capture else None), \
                        timer("step", sync=capture or logged):
                    metrics, images = train_step(
                        net, optimizer, tensors, lr,
                        step_noise(tensors, t.rand_seed, global_step, group),
                        group=process_group)
                if logged and lead:
                    record = {k: float(v) for k, v in metrics.items()}
                    record.update(lr=lr, step_ms=timer.last["step"] * 1e3,
                                  data_ms=timer.last["data"] * 1e3)
                    if device.type == "cuda":
                        record["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
                    logger.scalars("train", record, global_step)
                    history.append(dict(record, step=global_step))
                    peak = f", peak {record['peak_mib']:.1f} MiB" if "peak_mib" in record else ""
                    print(f"Epoch {epoch + 1}/{t.epochs}, Iter {batch_idx + 1}/{steps_per_epoch}, "
                          f"loss = {record['loss']:.3f}, step {record['step_ms']:.1f} ms{peak}")
                if global_step % (50 * t.summary_freq) == 0 and lead:
                    for name, img in images.items():
                        logger.image("train", name, img[0].float().cpu().numpy(), global_step)
            if lead:
                print(f"epoch phases: {timer.summary()}")
                _save_and_validate(cfg, model, optimizer, epoch, steps_per_epoch, device,
                                   val_loader, logger)
            if group is not None:
                dist.barrier(group=process_group)
    finally:
        if logger is not None:
            logger.close()
    return history


def _save_and_validate(cfg: Config, model: PatchmatchNet, optimizer: torch.optim.Optimizer,
                       epoch: int, steps_per_epoch: int, device: torch.device,
                       val_loader: BatchLoader, logger: MetricsLogger) -> None:
    """The end of an epoch (rank 0 alone under data parallel, as the JAX
    driver validates unsharded): checkpoints every `save_freq` epochs, then
    validation on running statistics."""
    t = cfg.train
    if (epoch + 1) % t.save_freq == 0:
        step = (epoch + 1) * steps_per_epoch
        save_train_checkpoint(os.path.join(t.output_folder, f"params_{epoch:06d}.ckpt.pt"),
                              model, optimizer, step, epoch)
        torch.save(model.state_dict(), os.path.join(t.output_folder, f"module_{epoch:06d}.pt"))

    meter = DictAverageMeter()
    for i, batch in enumerate(val_loader):
        tensors = batch_to_device(batch, device)
        noise = step_noise(tensors, t.rand_seed + 1, epoch * len(val_loader) + i)
        meter.update({k: float(v) for k, v in eval_step(model, tensors, noise).items()})
    means = meter.mean()
    logger.scalars("full_test", means, (epoch + 1) * steps_per_epoch)
    print(f"avg_test_scalars: {means}")
