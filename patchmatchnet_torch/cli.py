"""Command line of the port: train / eval / fuse / convert subcommands
(reference: `patchmatchnet_tpu/cli.py`, with its flag names, defaults and
choices, plus `--device`).

    python -m patchmatchnet_torch train --input_folder ... --train_list ... --test_list ...
    python -m patchmatchnet_torch eval  --input_folder ... --checkpoint_path ...
    python -m patchmatchnet_torch fuse  --input_folder ... --output_folder ...
    python -m patchmatchnet_torch convert --checkpoint_path X.ckpt --output Y.pt

Every subcommand that computes runs on `--device cuda` (the default) and
raises where CUDA is missing; `--device cpu` runs the kernels' plain
versions. `--checkpoint_path` takes a flax `.msgpack`, a reference PyTorch
`.ckpt` or a `.pt` the port wrote (`train.driver.load_any_checkpoint`).
`eval --no_derive_windows` is accepted and changes nothing: the port's
kernels read the source features directly, with no windows.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from patchmatchnet_torch.compat import convert_torch_checkpoint
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, MVSDataset
from patchmatchnet_torch.infer import DepthEstimator, FusionConfig, filter_and_fuse, save_depth_maps
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint, run_training

# Subcommands of the JAX command line that the port has not yet, and the
# ROADMAP item that brings each.
NOT_PORTED = {
    "export": "ROADMAP item 11 (export and ModuleEstimator)",
    "colmap-import": "ROADMAP item 12 (the host tools)",
    "colmap-export": "ROADMAP item 12 (the host tools)",
    "convert-dtu": "ROADMAP item 12 (the host tools)",
    "convert-eth3d": "ROADMAP item 12 (the host tools)",
    "visualize": "ROADMAP item 12 (the host tools)",
}


def _refuse(what: str, item: str) -> None:
    raise SystemExit(f"{what} is not ported to patchmatchnet_torch yet: {item}")


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--patchmatch_interval_scale", nargs="+", type=float,
                   default=[0.005, 0.0125, 0.025])
    p.add_argument("--patchmatch_range", "--propagation_range", dest="propagation_range",
                   nargs="+", type=int, default=[6, 4, 2])
    p.add_argument("--patchmatch_iteration", nargs="+", type=int, default=[1, 2, 2])
    p.add_argument("--patchmatch_num_sample", nargs="+", type=int, default=[8, 8, 16])
    p.add_argument("--propagate_neighbors", nargs="+", type=int, default=[0, 8, 16])
    p.add_argument("--evaluate_neighbors", nargs="+", type=int, default=[9, 9, 9])
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"],
                   help="inference precision: bf16 payloads with f32 weights, geometry "
                   "and accumulation, or full f32 (TF32 off)")
    p.add_argument("--train_precision", type=str, default="bf16", choices=["bf16", "f32"],
                   help="training precision: bf16 payloads with f32 parameters, "
                   "BatchNorm, loss and optimizer, or full f32 (TF32 off)")


def _add_data_args(p: argparse.ArgumentParser, eval_defaults: bool = False) -> None:
    p.add_argument("--input_folder", type=str, required=True)
    p.add_argument("--output_folder", type=str, default="")
    p.add_argument("--num_views", type=int, default=20 if eval_defaults else 5)
    p.add_argument("--image_max_dim", type=int, default=-1 if eval_defaults else 640)
    p.add_argument("--scan_list", type=str, default="")
    p.add_argument("--num_light_idx", type=int, default=-1)
    p.add_argument("--image_extension", type=str, default=".jpg")
    p.add_argument("--batch_size", type=int, default=1 if eval_defaults else 12)


def _add_fusion_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--geo_pixel_thres", type=float, default=1.0)
    p.add_argument("--geo_depth_thres", type=float, default=0.01)
    p.add_argument("--geo_mask_thres", type=int, default=5)
    p.add_argument("--photo_thres", type=float, default=0.5)
    p.add_argument("--file_format", type=str, default=".pfm", choices=[".bin", ".pfm"])


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; raises without CUDA) or cpu "
                   "(the kernels' plain versions)")


def build_parser(command: str) -> argparse.ArgumentParser:
    """The argument parser of a ported subcommand."""
    p = argparse.ArgumentParser(prog=f"patchmatchnet_torch {command}")
    if command == "train":
        _add_data_args(p)
        _add_model_args(p)
        p.add_argument("--checkpoint_path", type=str, default="")
        p.add_argument("--train_list", type=str, required=True)
        p.add_argument("--test_list", type=str, required=True)
        p.add_argument("--resume", action="store_true", default=False)
        p.add_argument("--robust_train", action="store_true", default=False)
        p.add_argument("--dataset", type=str, default="unified", choices=["unified", "dtu_legacy"],
                       help="unified cams/pair layout, or raw DTU (num_views then counts "
                       "the reference view)")
        p.add_argument("--epochs", type=int, default=16)
        p.add_argument("--learning_rate", type=float, default=0.001)
        p.add_argument("--lr_epochs", type=str, default="10,12,14:2")
        p.add_argument("--weight_decay", type=float, default=0.0)
        p.add_argument("--summary_freq", type=int, default=20)
        p.add_argument("--save_freq", type=int, default=1)
        p.add_argument("--rand_seed", type=int, default=1)
        p.add_argument("--ckpt_backend", type=str, default="msgpack", choices=["msgpack", "orbax"],
                       help="msgpack (the default) checkpoints with torch.save; orbax is "
                       "the JAX package's and is refused (run_training raises)")
        p.add_argument("--num_devices", type=int, default=None,
                       help="1 or unset: data parallel training is not ported yet")
        p.add_argument("--profile_dir", type=str, default="",
                       help="write a torch.profiler trace of one train step here")
        _add_device_arg(p)
    elif command == "eval":
        _add_data_args(p, eval_defaults=True)
        _add_model_args(p)
        _add_fusion_args(p)
        p.add_argument("--checkpoint_path", type=str, required=True)
        p.add_argument("--input_type", type=str, default="params", choices=["params", "module"],
                       help="params: a weights checkpoint; module (an exported model) is "
                       "not ported yet")
        p.add_argument("--output_type", type=str, default="both",
                       choices=["depth", "fusion", "both"])
        p.add_argument("--num_devices", type=int, default=None,
                       help="1 or unset: data parallel inference is not ported yet")
        p.add_argument("--shape_bucket", type=int, default=0,
                       help="round image sizes up to this multiple of 8 (edge-pad, crop "
                       "the outputs back); 0 = exact shapes")
        p.add_argument("--no_derive_windows", dest="derive_windows", action="store_false",
                       default=True, help="accepted, no effect: the port reads the source "
                       "features directly, with no windows")
        p.add_argument("--seed", type=int, default=0)
        _add_device_arg(p)
    elif command == "fuse":
        p.add_argument("--input_folder", type=str, required=True)
        p.add_argument("--output_folder", type=str, default="")
        p.add_argument("--scan_list", type=str, default="")
        p.add_argument("--image_max_dim", type=int, default=-1)
        p.add_argument("--image_extension", type=str, default=".jpg")
        _add_fusion_args(p)
        _add_device_arg(p)
    elif command == "convert":
        p.add_argument("--checkpoint_path", type=str, required=True,
                       help="params_*.ckpt of the original PyTorch PatchmatchNet")
        p.add_argument("--output", type=str, required=True,
                       help="output .pt path (the port's state dict)")
    else:
        raise ValueError(f"no parser for {command!r}")
    return p


def _config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    for section in (cfg.model, cfg.data, cfg.train, cfg.fuse):
        for name in vars(section):
            if hasattr(args, name):
                value = getattr(args, name)
                setattr(section, name, tuple(value) if isinstance(value, list) else value)
    return cfg


def _scan_names(scan_list: str) -> List[str]:
    if not scan_list:
        return [""]
    if not os.path.isfile(scan_list):
        raise FileNotFoundError(f"Invalid scan list file: {scan_list}")
    with open(scan_list) as f:
        return [line.rstrip() for line in f]


def _fuse_scans(args: argparse.Namespace, device: torch.device) -> None:
    cfg = FusionConfig(image_max_dim=args.image_max_dim, geo_pixel_thres=args.geo_pixel_thres,
                       geo_depth_thres=args.geo_depth_thres, geo_mask_thres=args.geo_mask_thres,
                       photo_thres=args.photo_thres, file_format=args.file_format,
                       image_extension=args.image_extension)
    for scan in _scan_names(args.scan_list):
        start = time.perf_counter()
        ply = filter_and_fuse(args.input_folder, args.output_folder, scan, cfg, device=device)
        print(f"Fused {ply} in {time.perf_counter() - start:.3f} s")


def cmd_train(argv: List[str]) -> None:
    args = build_parser("train").parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        _refuse("--num_devices > 1", "ROADMAP item 10 (data parallel)")
    if not args.output_folder:
        args.output_folder = args.input_folder
    run_training(_config_from_args(args), profile_dir=args.profile_dir)


def cmd_eval(argv: List[str]) -> None:
    args = build_parser("eval").parse_args(argv)
    if args.input_type == "module":
        _refuse("--input_type module", NOT_PORTED["export"])
    if args.num_devices is not None and args.num_devices > 1:
        _refuse("--num_devices > 1", "ROADMAP item 10 (data parallel)")
    if not args.output_folder:
        args.output_folder = args.input_folder
    device = torch.device(args.device)
    if args.output_type in ("depth", "both"):
        model = build_model(_config_from_args(args), inference=True)
        model.load_state_dict(load_any_checkpoint(args.checkpoint_path), strict=True)
        estimator = DepthEstimator(model, device, bucket_multiple=args.shape_bucket)
        dataset = MVSDataset(args.input_folder, args.num_views, args.image_extension,
                             max_dim=args.image_max_dim, scan_list=args.scan_list,
                             num_light_idx=args.num_light_idx)
        start, request_ms = time.perf_counter(), []
        n = save_depth_maps(estimator, BatchLoader(dataset, args.batch_size), args.output_folder,
                            seed=args.seed, file_format=args.file_format, request_ms=request_ms)
        seconds = time.perf_counter() - start
        first = request_ms[0] if request_ms else 0.0
        after = (f", then median {statistics.median(request_ms[1:]):.2f}"
                 if len(request_ms) > 1 else "")
        print(f"Wrote {n} depth/confidence map pairs in {seconds:.3f} s ("
              f"{seconds * 1e3 / max(n, 1):.2f} ms per map); request ms: first "
              f"{first:.2f} (set-up included){after}")
    if args.output_type in ("fusion", "both"):
        _fuse_scans(args, device)


def cmd_fuse(argv: List[str]) -> None:
    args = build_parser("fuse").parse_args(argv)
    if not args.output_folder:
        args.output_folder = args.input_folder
    _fuse_scans(args, torch.device(args.device))


def cmd_convert(argv: List[str]) -> None:
    args = build_parser("convert").parse_args(argv)
    state = convert_torch_checkpoint(args.checkpoint_path)
    torch.save(state, args.output)
    n = sum(t.numel() for t in state.values())
    print(f"Converted {args.checkpoint_path} -> {args.output} ({n} values)")


COMMANDS: Dict[str, Callable[[List[str]], None]] = {
    "train": cmd_train,
    "eval": cmd_eval,
    "fuse": cmd_fuse,
    "convert": cmd_convert,
}


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        print("not yet ported:")
        for c, item in NOT_PORTED.items():
            print(f"  {c:<14} {item}")
        return
    cmd = argv[0]
    if cmd in NOT_PORTED:
        _refuse(f"the {cmd} subcommand", NOT_PORTED[cmd])
    if cmd not in COMMANDS:
        raise SystemExit(f"Unknown command {cmd!r}; choose from {list(COMMANDS)}")
    COMMANDS[cmd](argv[1:])
    counts = cuda_build.launch_counts()  # launches of the hand kernels (CUDA only)
    if counts:
        print(f"kernel launches: {counts}")


if __name__ == "__main__":
    main()
