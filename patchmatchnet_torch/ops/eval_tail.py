"""K2: the eval-grid aggregation tail of PatchMatch evaluation (pre-softmax).

Replaces `patchmatchnet_tpu/ops/pallas/eval_tail.py` `_kernel` (API
`eval_grid_score`). The CUDA kernel is `csrc/eval_tail.cu`
(`pmn_eval_grid_score`). Unlike the TPU kernel it samples x_norm in f32
(no u16 fixed point) and takes any D.

    score = sum_k w_k c_k / sum_k w_k,
    w_k = sigmoid(4 - 2 * clip(|x_k - x_c| / interval, 0, 4)) * fw_k

where x_k, c_k are border, align_corners=False bilinear samples of the
normalized inverse depth and the cost at the K eval-grid neighbours.

K2 has no backward kernel (nor has the reference). Training runs the
plain version `eval_grid_score_reference` on every device, as the
reference's training tail is plain XLA.
"""

from __future__ import annotations

from typing import Sequence

import torch

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.grid_sample import grid_sample_2d
from patchmatchnet_torch.ops.library import define_kernel_op

_COST_DTYPES = (torch.float32, torch.bfloat16)


def eval_grid_score_reference(
    x_norm_img: torch.Tensor, cost_img: torch.Tensor, grid: Sequence[torch.Tensor],
    feature_weight: torch.Tensor, interval_scale: float,
) -> torch.Tensor:
    """Plain PyTorch version (`F.grid_sample` of [x_norm | cost]); same
    arguments and result as `eval_grid_score`. It is also the training tail
    (reference: `patchmatch.py` `Evaluation`, the unfused branch): x_norm and
    the depth weight carry no gradient, so the grid learns only through the
    sampled cost and the feature weights through the normalized weight.
    x_norm is sampled in f32 (the reference's bf16 hi/lo split only
    preserves f32 precision through bf16 payloads)."""
    d = x_norm_img.shape[-1]
    joint = torch.cat([x_norm_img.detach().float(), cost_img.float()], dim=-1)
    sampled = grid_sample_2d(joint, grid, align_corners=False, padding_mode="border")
    x_smp, c_smp = sampled[..., :d], sampled[..., d:]  # [B, Ke, H, W, D]
    with torch.no_grad():
        diff = (x_smp - x_norm_img[:, None]).abs() / interval_scale
        dw = torch.sigmoid(4.0 - 2.0 * diff.clamp(0.0, 4.0))
    weight = dw * feature_weight[..., None]
    weight = weight / weight.sum(dim=1, keepdim=True)
    return (c_smp * weight).sum(dim=1)


def _launch(x_norm_img: torch.Tensor, cost_img: torch.Tensor, gx: torch.Tensor,
            gy: torch.Tensor, feature_weight: torch.Tensor,
            interval_scale: float) -> torch.Tensor:
    b, h, w, d = x_norm_img.shape
    ke = gx.shape[1]
    if h < 2 or w < 2:
        raise ValueError("eval_grid_score needs H, W >= 2")
    dev = x_norm_img.device
    check = cuda_build.check_cuda_tensor
    f32 = (torch.float32,)
    check("x_norm_img", x_norm_img, dev, f32, (b, h, w, d))
    check("cost_img", cost_img, dev, _COST_DTYPES, (b, h, w, d))
    check("gx", gx, dev, f32, (b, ke, h, w))
    check("gy", gy, dev, f32, (b, ke, h, w))
    check("feature_weight", feature_weight, dev, f32, (b, ke, h, w))
    out = torch.empty((b, h, w, d), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_eval_grid_score(
            x_norm_img.data_ptr(), cost_img.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            feature_weight.data_ptr(), out.data_ptr(), b, ke, h, w, d,
            1.0 / interval_scale, int(cost_img.dtype == torch.bfloat16),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("eval_grid_score", rc)
    return out


# K2 as the operator `pmn::eval_grid_score` (ops/library.py); its backward
# raises, as the kernel has none
_eval_grid_score_op = define_kernel_op(
    "eval_grid_score",
    "(Tensor x_norm_img, Tensor cost_img, Tensor gx, Tensor gy, Tensor feature_weight, "
    "float interval_scale) -> Tensor",
    lambda x_norm_img, cost_img, gx, gy, feature_weight, interval_scale:
    eval_grid_score_reference(x_norm_img, cost_img, (gx, gy), feature_weight,
                              interval_scale).contiguous(),
    _launch, lambda x_norm_img, *rest: x_norm_img.new_empty(x_norm_img.shape))


def _no_backward(ctx, grad):
    raise RuntimeError("eval_grid_score (K2) has no backward, as its TPU kernel has none: "
                       "training runs eval_grid_score_reference")


torch.library.register_autograd(_eval_grid_score_op, _no_backward)


def eval_grid_score(
    x_norm_img: torch.Tensor, cost_img: torch.Tensor, grid: Sequence[torch.Tensor],
    feature_weight: torch.Tensor, interval_scale: float,
) -> torch.Tensor:
    """Adaptive spatial aggregation score.

    Args:
        x_norm_img: [B, H, W, D] f32 normalized inverse depth in [0, 1].
        cost_img: [B, H, W, D] SimilarityNet cost (f32 or bf16).
        grid: (gx, gy), each [B, Ke, H, W] f32 normalized eval-grid
            coordinates (align_corners=False convention, border padding).
        feature_weight: [B, Ke, H, W] f32.
        interval_scale: the stage's inverse-depth interval scale.
    Returns:
        [B, H, W, D] f32 score before the softmax.

    It calls the operator `torch.ops.pmn.eval_grid_score`: CPU tensors run
    the plain version; CUDA tensors launch the kernel, and anything the
    kernel does not take raises. It has no backward: one through it raises.
    """
    cuda_build.check_kernel_device("eval_grid_score", x_norm_img.device)
    gx, gy = grid
    return _eval_grid_score_op(x_norm_img, cost_img, gx, gy, feature_weight,
                               float(interval_scale))
