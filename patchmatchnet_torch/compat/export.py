"""Export of the inference forward as a `torch.export` program (reference:
`patchmatchnet_tpu/compat/export.py`, `export_inference` and
`load_exported`).

The artifact is self-contained: the weights are baked in and the input
geometry is fixed, as in the reference. Its graph holds the hand kernels
as the operators `torch.ops.pmn.*` (`ops/library.py`: K1 `warp_group_corr`, K6
`warp_group_corr_views`, K2 `eval_grid_score`, K3 `neighbor_group_corr`),
so a loaded program launches the kernels on CUDA tensors and runs their
plain versions on CPU tensors. The precision, the input shape and the
device it was exported on travel in the artifact (`ARTIFACT_META`).

The reference refuses to export a reduced-precision model, because its TPU
sampler can drop samples that escape a window and only its runtime
estimator can fall back. The port reads every sample, so a bf16 model
exports as the f32 one does.
"""

from __future__ import annotations

import contextlib
import io
import json
from collections import Counter
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

from patchmatchnet_torch.models.net import PatchmatchNet, full_f32

ARTIFACT_META = "pmn_export.json"


class _InferenceForward(nn.Module):
    """(images, intrinsics, extrinsics, depth_min, depth_max, noise) ->
    (depth, confidence), the signature of the reference's artifact."""

    def __init__(self, model: PatchmatchNet):
        super().__init__()
        self.model = model

    def forward(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        depth, confidence, _ = self.model(images, intrinsics, extrinsics, depth_min,
                                          depth_max, init_noise=noise)
        return depth, confidence


def export_inference(
    state_dict: Mapping[str, torch.Tensor],
    batch: int,
    num_views: int,
    height: int,
    width: int,
    model: Optional[PatchmatchNet] = None,
    device: Union[str, torch.device] = "cuda",
) -> bytes:
    """Serialize the inference forward for a fixed input geometry.

    The exported function takes (images [B,N,H,W,3], intrinsics [B,N,3,3],
    extrinsics [B,N,4,4], depth_min [B], depth_max [B], noise
    [B,48,H/8,W/8]), all f32, and returns (depth [B,H,W], confidence
    [B,H,W]). `model` None builds the f32 `PatchmatchNet()`; `state_dict`
    is loaded into it. The program is traced under torch.no_grad() on
    `device` (cuda by default, raising without CUDA), so every evaluation
    that has view weights is one K6 node.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    model = model if model is not None else PatchmatchNet()
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    shapes = ((batch, num_views, height, width, 3), (batch, num_views, 3, 3),
              (batch, num_views, 4, 4), (batch,), (batch,),
              PatchmatchNet.noise_shape(batch, height, width))
    args = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
    with torch.no_grad():
        program = torch.export.export(_InferenceForward(model), args, strict=False)
    program._example_inputs = None  # the artifact carries no input tensors
    meta = {"precision": "f32" if model.compute_dtype is None else "bf16",
            "shape": list(shapes[0]), "device": str(device)}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={ARTIFACT_META: json.dumps(meta)})
    return buf.getvalue()


def kernel_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Count of each `pmn::` operator node (the hand kernels) in a graph."""
    counts: Counter = Counter()
    for node in program.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name) and name().startswith("pmn::"):
            counts[name()[len("pmn::"):].split(".")[0]] += 1
    return dict(counts)


class ExportedForward:
    """A loaded artifact: `program` (the ExportedProgram), `precision`
    ("f32" or "bf16"), `shape` (the images shape it takes) and `device`.
    Calling it runs the program with autograd off, and an f32 one with TF32
    off (`full_f32`), as the eager f32 forward runs: the flags are not part
    of the graph."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict[str, Any]):
        self.program = program
        self.precision: str = meta["precision"]
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.device = torch.device(meta["device"])
        self._module = program.module()

    def __call__(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        ctx = full_f32() if self.precision == "f32" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            return self._module(images, intrinsics, extrinsics, depth_min, depth_max, noise)


def load_exported(blob: bytes,
                  device: Optional[Union[str, torch.device]] = None) -> ExportedForward:
    """Deserialize an artifact of `export_inference`. With `device`, a
    program exported on another device is moved there (weights, constants
    and the devices named in the graph), so its kernel nodes dispatch to
    that device's implementation: the kernels on CUDA, the plain versions
    on the CPU."""
    extra = {ARTIFACT_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    if not extra[ARTIFACT_META]:
        raise ValueError("not an artifact of patchmatchnet_torch export_inference "
                         f"(no {ARTIFACT_META})")
    meta = json.loads(extra[ARTIFACT_META])
    if device is not None and torch.device(device) != torch.device(meta["device"]):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
        meta = dict(meta, device=str(device))
    return ExportedForward(program, meta)
