"""Command line of the port (reference: `patchmatchnet_tpu/cli.py`, with
its subcommands, flag names, defaults and choices, plus `--device`).

    python -m patchmatchnet_torch train --input_folder ... --train_list ... --test_list ...
    python -m patchmatchnet_torch eval  --input_folder ... --checkpoint_path ...
    python -m patchmatchnet_torch fuse  --input_folder ... --output_folder ...
    python -m patchmatchnet_torch convert --checkpoint_path X.ckpt --output Y.pt
    python -m patchmatchnet_torch export --checkpoint_path X --output Y.pt2
    python -m patchmatchnet_torch eval --input_type module --checkpoint_path Y.pt2 ...
    python -m patchmatchnet_torch colmap-import|colmap-export|convert-dtu|convert-eth3d|visualize
    python -m patchmatchnet_torch casmvsnet --input_folder ... --checkpoint_path state.pt

Every subcommand that computes runs on `--device cuda` (the default) and
raises where CUDA is missing; `--device cpu` runs the kernels' plain
versions. `--checkpoint_path` takes a flax `.msgpack`, a reference PyTorch
`.ckpt` or a `.pt` the port wrote (`train.driver.load_any_checkpoint`), or
with `eval --input_type module` an artifact of `export`, whose input
geometry is fixed: export's `--num_views` counts every view of a sample, so
eval's `--num_views 5` (sources) at 1600x1200 takes an artifact exported
with `--num_views 6 --height 1200 --width 1600`.
`casmvsnet` writes CasMVSNet's depth and confidence maps as `eval
--output_type depth` writes PatchmatchNet's (the port's own command: the
JAX package has no CasMVSNet), from a state dict of cascade-stereo's
parameter names (a `.pt` or `.ckpt` that `torch.load` reads, its "model"
entry if it has one).
`eval --no_derive_windows` is accepted and changes nothing: the port's
kernels read the source features directly, with no windows. The five host
tools run their `patchmatchnet_torch.tools` module's `main`.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from patchmatchnet_torch.compat import convert_torch_checkpoint, export_inference
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, MVSDataset
from patchmatchnet_torch.infer import (
    DepthEstimator,
    FusionConfig,
    ModuleEstimator,
    filter_and_fuse,
    save_depth_maps,
)
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.parallel import Group, launch
from patchmatchnet_torch.tools import (
    colmap_export,
    colmap_import,
    convert_dtu,
    convert_eth3d,
    visualize,
)
from patchmatchnet_torch.train.driver import build_model, load_weights, run_training
from patchmatchnet_torch.utils.profiling import reset_spans, span_records, trace_spans

# Options of the JAX command line that the port has not yet, and the
# ROADMAP item that brings each.
NOT_PORTED: Dict[str, str] = {}


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
                       help="train data parallel on this many ranks of --device (NCCL, "
                       "one rank per card, on cuda; gloo on cpu); batch_size must be a "
                       "multiple")
        p.add_argument("--profile_dir", type=str, default="",
                       help="write a torch.profiler trace of one train step here")
        _add_device_arg(p)
    elif command == "eval":
        _add_data_args(p, eval_defaults=True)
        _add_model_args(p)
        _add_fusion_args(p)
        p.add_argument("--checkpoint_path", type=str, required=True)
        p.add_argument("--input_type", type=str, default="params", choices=["params", "module"],
                       help="params: a weights checkpoint; module: an artifact of export "
                       "(fixed geometry; the model options are baked in)")
        p.add_argument("--output_type", type=str, default="both",
                       choices=["depth", "fusion", "both"])
        p.add_argument("--num_devices", type=int, default=None,
                       help="shard eval batches over this many ranks of --device (NCCL, "
                       "one rank per card, on cuda; gloo on cpu), each writing the maps "
                       "of its views; batch_size must be a multiple")
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
    elif command == "export":
        p.add_argument("--checkpoint_path", type=str, required=True)
        p.add_argument("--output", type=str, required=True,
                       help="output artifact path (torch.export program, .pt2)")
        p.add_argument("--batch", type=int, default=1)
        p.add_argument("--num_views", type=int, default=5)
        p.add_argument("--height", type=int, default=864)
        p.add_argument("--width", type=int, default=1152)
        _add_device_arg(p)
    elif command == "casmvsnet":
        _add_data_args(p, eval_defaults=True)
        p.set_defaults(num_views=4, architecture="casmvsnet", input_type="params")
        p.add_argument("--checkpoint_path", type=str, required=True,
                       help="a CasMVSNet state dict (cascade-stereo's names)")
        p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"],
                       help="bf16 features, cost volumes and 3D convolutions with f32 "
                       "weights, hypotheses and regression, or full f32 (TF32 off)")
        p.add_argument("--shape_bucket", type=int, default=0,
                       help="round image sizes up to this multiple of 32 (edge-pad, crop "
                       "the outputs back); 0 = exact shapes, which must be multiples of 32")
        p.add_argument("--file_format", type=str, default=".pfm", choices=[".bin", ".pfm"])
        p.set_defaults(seed=0)  # save_depth_maps' noise, which CasMVSNet does not draw
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
    cfg = Config(architecture=getattr(args, "architecture", "patchmatchnet"))
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
    # without CUDA, filter_and_fuse raises for a CUDA device
    on_card = device.type == "cuda" and torch.cuda.is_available()
    for scan in _scan_names(args.scan_list):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        start = time.perf_counter()
        ply = filter_and_fuse(args.input_folder, args.output_folder, scan, cfg, device=device)
        line = f"Fused {ply} in {time.perf_counter() - start:.3f} s"
        if on_card:
            line += (f" (peak device memory "
                     f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB)")
        print(line)


def _sum_launches(launches: List[Dict[str, int]]) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for counts in launches:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return total


def cmd_train(argv: List[str]) -> Dict[str, int]:
    """Returns the hand-kernel launches of the data-parallel ranks."""
    args = build_parser("train").parse_args(argv)
    if not args.output_folder:
        args.output_folder = args.input_folder
    launches: List[Dict[str, int]] = []
    run_training(_config_from_args(args), num_devices=args.num_devices,
                 profile_dir=args.profile_dir, launches=launches)
    return _sum_launches(launches)


def _write_depth_maps(group: Optional[Group], args: argparse.Namespace
                      ) -> Tuple[int, List[float]]:
    """The depth and confidence maps of eval: all of them, or with `group`
    those of the rank's rows of each global batch. Returns (maps written,
    host ms per request, from the `pmn.request` spans)."""
    device = torch.device(args.device) if group is None else group.device
    if args.input_type == "module":
        with open(args.checkpoint_path, "rb") as f:
            estimator = ModuleEstimator(f.read(), device)
    else:
        cfg = _config_from_args(args)
        model = build_model(cfg, inference=True)
        model.load_state_dict(load_weights(cfg, args.checkpoint_path), strict=True)
        estimator = DepthEstimator(model, device, bucket_multiple=args.shape_bucket)
    dataset = MVSDataset(args.input_folder, args.num_views, args.image_extension,
                         max_dim=args.image_max_dim, scan_list=args.scan_list,
                         num_light_idx=args.num_light_idx)
    shard = None if group is None else (group.rank, group.world_size)
    previous = trace_spans(True)
    reset_spans()
    try:
        n = save_depth_maps(estimator, BatchLoader(dataset, args.batch_size, shard=shard),
                            args.output_folder, args.file_format, seed=args.seed)
        request_ms = [r.host_ms for r in span_records("pmn.request")]
    finally:
        trace_spans(previous)
    return n, request_ms


def cmd_eval(argv: List[str]) -> Dict[str, int]:
    """Returns the hand-kernel launches of the data-parallel ranks."""
    args = build_parser("eval").parse_args(argv)
    if not args.output_folder:
        args.output_folder = args.input_folder
    num_devices = args.num_devices or 1
    if args.batch_size % num_devices != 0:
        raise ValueError(f"batch_size {args.batch_size} must be a multiple of "
                         f"--num_devices {num_devices}")
    device = torch.device(args.device)
    launches: List[Dict[str, int]] = []
    if args.output_type in ("depth", "both"):
        start = time.perf_counter()
        if num_devices == 1:
            ranks = [_write_depth_maps(None, args)]
        else:
            results = launch(_write_depth_maps, num_devices, (args,), device_type=device.type)
            ranks = [r.value for r in results]
            launches = [r.launches for r in results]
        seconds = time.perf_counter() - start
        n = sum(count for count, _ in ranks)
        line = (f"Wrote {n} depth/confidence map pairs in {seconds:.3f} s ("
                f"{seconds * 1e3 / max(n, 1):.2f} ms per map)")
        for rank, (count, request_ms) in enumerate(ranks):
            first = request_ms[0] if request_ms else 0.0
            after = (f", then median {statistics.median(request_ms[1:]):.2f}"
                     if len(request_ms) > 1 else "")
            who = f"rank {rank}: {count} maps, " if num_devices > 1 else ""
            line += f"; {who}request ms: first {first:.2f} (set-up included){after}"
        print(line)
    if args.output_type in ("fusion", "both"):
        _fuse_scans(args, device)
    return _sum_launches(launches)


def cmd_casmvsnet(argv: List[str]) -> None:
    args = build_parser("casmvsnet").parse_args(argv)
    if not args.output_folder:
        args.output_folder = args.input_folder
    start = time.perf_counter()
    n, request_ms = _write_depth_maps(None, args)
    seconds = time.perf_counter() - start
    print(f"Wrote {n} CasMVSNet depth/confidence map pairs in {seconds:.3f} s "
          f"({seconds * 1e3 / max(n, 1):.2f} ms per map; request ms: first "
          f"{request_ms[0] if request_ms else 0.0:.2f} (set-up included))")


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


def cmd_export(argv: List[str]) -> None:
    args = build_parser("export").parse_args(argv)
    start = time.perf_counter()
    blob = export_inference(load_weights(Config(), args.checkpoint_path), args.batch,
                            args.num_views, args.height, args.width, device=args.device)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"Exported f32 inference artifact -> {args.output} ({len(blob)} bytes, "
          f"{time.perf_counter() - start:.3f} s)")


COMMANDS: Dict[str, Callable[[List[str]], Optional[Dict[str, int]]]] = {
    "train": cmd_train,
    "eval": cmd_eval,
    "fuse": cmd_fuse,
    "convert": cmd_convert,
    "export": cmd_export,
    "colmap-import": colmap_import.main,
    "colmap-export": colmap_export.main,
    "convert-dtu": convert_dtu.main,
    "convert-eth3d": convert_eth3d.main,
    "visualize": visualize.main,
    "casmvsnet": cmd_casmvsnet,
}


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        if NOT_PORTED:
            print("not yet ported:")
            for c, item in NOT_PORTED.items():
                print(f"  {c:<14} {item}")
        return
    cmd = argv[0]
    if cmd not in COMMANDS:
        raise SystemExit(f"Unknown command {cmd!r}; choose from {list(COMMANDS)}")
    ranks = COMMANDS[cmd](argv[1:])  # data-parallel ranks' launches (train, eval)
    # launches of the hand kernels (CUDA only), this process's and its ranks'
    counts = _sum_launches([cuda_build.launch_counts(), ranks or {}])
    if counts:
        print(f"kernel launches: {counts}")


if __name__ == "__main__":
    main()
