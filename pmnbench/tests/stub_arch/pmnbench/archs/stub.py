"""A stub architecture for the benchmark's tests: a few-layer plane-sweep
net (the program: `stubnet.py`, outside the benchmark), its weights made
from the seed (no checkpoint), no random input, and its plain twin below
as the reference. It gives what every module of `archs/` gives (see
`archs/patchmatchnet.py`)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from pmnbench import reference

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "roofline", "peaks.json")))


def weights(config: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """The state both sides start from, by parameter name, from the seed."""
    c, d = config["channels"], config["depths"]
    shapes = {"conv0.weight": (c, 3, 3, 3), "conv0.bias": (c,),
              "conv1.weight": (c, c, 3, 3), "conv1.bias": (c,),
              "cost.weight": (d, d, 3, 3), "cost.bias": (d,)}
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn(sum(torch.Size(s).numel() for s in shapes.values()), generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        fan_in = torch.Size(shape[1:]).numel() or 1
        out[name] = flat[at:at + n].reshape(shape) / fan_in ** 0.5
        at += n
    return out


def program_model(config: Dict[str, Any], inference: bool, seed: int):
    import stubnet

    model = stubnet.PlaneSweepNet(config["channels"], config["depths"])
    model.load_state_dict(weights(config, seed))
    return model.eval() if inference else model.train()


def estimator(model, device: torch.device):
    import stubnet

    return stubnet.Estimator(model, device)


def extra_inputs(generator, batch: int, height: int, width: int, device):
    return None


class Reference:
    def __init__(self, params: Dict[str, torch.Tensor], depths: int, precision: str):
        self.params, self.depths, self.p = params, depths, reference.Precision(precision)

    def conv(self, x, name, stride):
        p = self.params
        return self.p(F.conv2d(self.p(x), self.p(p[f"{name}.weight"]), p[f"{name}.bias"],
                               stride=stride, padding=1))

    def forward(self, t: Dict[str, torch.Tensor]):
        images = t["images"].float()
        b, v, height, width, _ = images.shape
        feats = self.conv(F.relu(self.conv(images.permute(0, 1, 4, 2, 3).reshape(
            b * v, 3, height, width), "conv0", 2)), "conv1", 2)
        c, h, w = feats.shape[1:]
        feats = feats.reshape(b, v, c, h, w)
        dmin, dmax = t["depth_min"].float(), t["depth_max"].float()
        depths = dmin[:, None] + (dmax - dmin)[:, None] * torch.linspace(
            0.0, 1.0, self.depths, device=images.device)
        k = t["intrinsics"].float().clone()
        k[:, :, :2] /= 4
        ext = t["extrinsics"].float()
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                                torch.arange(w, dtype=torch.float32, device=images.device),
                                indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
        points = ((torch.linalg.inv(k[:, 0]) @ pix)[:, :, None, :]
                  * depths[:, None, :, None]).reshape(b, 3, -1)
        cost = torch.zeros((b, self.depths, h, w), device=images.device)
        for view in range(1, v):
            rel = ext[:, view] @ torch.linalg.inv(ext[:, 0])
            uv = k[:, view] @ (rel[:, :3, :3] @ points + rel[:, :3, 3:])
            z = uv[:, 2].clamp(min=1e-6)
            grid = torch.stack([2 * (uv[:, 0] / z) / (w - 1) - 1,
                                2 * (uv[:, 1] / z) / (h - 1) - 1], dim=-1)
            warped = F.grid_sample(feats[:, view], grid.reshape(b, self.depths * h, w, 2),
                                   mode="bilinear", padding_mode="zeros", align_corners=True)
            cost = cost + (warped.reshape(b, c, self.depths, h, w)
                           * feats[:, 0, :, None]).mean(dim=1)
        prob = torch.softmax(self.conv(cost / (v - 1), "cost", 1), dim=1)
        depth = (prob * depths[:, :, None, None]).sum(dim=1, keepdim=True)
        conf = prob.max(dim=1, keepdim=True).values
        return (F.interpolate(depth, size=(height, width), mode="bilinear",
                              align_corners=False)[:, 0],
                F.interpolate(conf, size=(height, width), mode="nearest")[:, 0])


def reference_model(config: Dict[str, Any], precision: str, device, seed: int) -> Reference:
    return Reference({k: v.to(device) for k, v in weights(config, seed).items()},
                     config["depths"], precision)


def reference_map(ref: Reference, tensors: Dict[str, torch.Tensor], extra):
    return ref.forward(tensors)


def make_optimizer(params, lr: float):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model, optimizer, batch, lr: float, extra, group):
    import stubnet

    return stubnet.train_step(model, optimizer, batch, lr)


def reference_train_steps(ref: Reference, batches: Sequence[Dict[str, torch.Tensor]],
                          extras: List[None], lr: float) -> Dict[str, Any]:
    params = ref.params
    before = {k: p.clone() for k, p in params.items()}
    adam = reference.Adam(params)
    losses, first = [], None
    for batch in batches:
        for p in params.values():
            p.requires_grad_(True)
        depth, _ = ref.forward(batch)
        mask = batch["mask"].float()
        loss = (F.smooth_l1_loss(depth, batch["depth_gt"].float(), reduction="none")
                * mask).sum() / mask.sum().clamp(min=1.0)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        for p in params.values():
            p.requires_grad_(False)
        adam.step(params, grads, lr)
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
    return {"losses": losses,
            "grad_norms": {k: float(g.norm()) for k, g in first.items()},
            "change_norms": {k: float((params[k] - before[k]).norm()) for k in params}}


def program_key(key: str) -> str:
    return key


def bound(config: Dict[str, Any], traffic: Dict[str, Any]) -> dict:
    """One map's or step's least time at the published f32 and memory
    peaks: the convolutions' and the correlation's operations, the images
    read once (a step: three times the forward's operations)."""
    b, v, h, w = traffic["batch"], traffic["views"], traffic["height"], traffic["width"]
    c, d = config["channels"], config["depths"]
    q = (h // 4) * (w // 4)
    flops = 2 * b * (v * (4 * q * 27 * c + q * 9 * c * c) + (v - 1) * q * d * c
                     + q * 9 * d * d)
    if traffic["kind"] == "train":
        flops *= 3
    data = 4 * b * v * h * w * 3
    ms = 1e3 * max(flops / PEAKS["f32_ops_per_s"], data / PEAKS["memory_bytes_per_s"])
    return {"bytes": data, "flops": flops, "bound_ms": ms, "groups": {"glue": ms}}
