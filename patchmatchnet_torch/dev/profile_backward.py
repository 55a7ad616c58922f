"""K4 and K5, the training path's backward kernels, on the card.

    python -m patchmatchnet_torch.dev.profile_backward [--out FILE] [--steps N]
        [--calls FILE]

At the bf16 training geometry (640x512, B=2, the stage shapes of a train
step at N=5) it prints, per case, each kernel's device time (busy time per
call in a torch.profiler trace of 10 calls, `utils.trace.device_ms`), its
launches per train step and its largest error against the plain version
relative to the largest plain entry:

- K4 at stage 3 D64 and D32, stage 2 D16 and stage 1 D8, on two layouts of
  the depth hypotheses: "iid", uniform over the scene's range for every
  (hypothesis, pixel) with a few behind the camera, as `chip_smoke.py`
  phase 7 draws them; and "path", as the training path makes them:
  stratified inverse-depth bins (`init_random_depth`) at stage 3 D64, and
  `init_perturbed_depth` around a plane elsewhere.
- K5 at each stage on a learned-offset eval grid.

Then it traces N bf16 train steps (after a warm-up step) on a synthetic
12-view plane scene, warm-started from the released weights, and prints
device ms and launches per step for each hand kernel id (K1, K3, K4, K5)
and the step's device-busy time. With --calls FILE it also times K4 and
K5 on the arguments of one such train step's own calls (20 and 3), which
the first run records into FILE and later runs read, so that two trees
are timed on the same inputs. The last line is a JSON summary.

It uses only the port's public wrappers, so the same file also measures
an earlier tree of the port (copy it into that tree and run it there).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from patchmatchnet_torch import ops
from patchmatchnet_torch.models.patchmatch import (
    STAGE_CONFIG,
    build_offset_grid,
    evaluation_offsets,
    init_perturbed_depth,
    init_random_depth,
)
from patchmatchnet_torch.ops.warp import warp_proj_coeffs
from patchmatchnet_torch.utils.trace import (
    busy_union_us,
    device_ms,
    fmt_ms,
    hand_kernel_id,
    trace_device_events,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
TRAIN_H, TRAIN_W, TRAIN_VIEWS, TRAIN_BATCH, SCENE_VIEWS = 512, 640, 5, 2, 12
# (stage, C, G, scale, ((D, K4 launches per train step at N=5), ...))
STAGES = ((3, 64, 8, 8, ((64, 4), (32, 4))), (2, 32, 8, 4, ((16, 8),)),
          (1, 16, 4, 2, ((8, 4),)))
# the synthetic scene's depth range: 0.8 and 1.3 x the plane at 6
DEPTH_MIN, DEPTH_MAX, PLANE = 4.8, 7.8, 6.0


def rig_mat12(h: int, w: int, scale: int, b: int, device, baseline: float = 0.35):
    """[b, 12] warp of a stage's h x w reference onto a source camera
    `baseline` to its side (f = 1.1 x the full image's larger side / scale)."""
    f = 1.1 * max(TRAIN_H, TRAIN_W) / scale
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    projs = []
    for tx in (0.0, baseline):
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0]])
        projs.append(p)
    mat = warp_proj_coeffs(projs[1][None], projs[0][None])
    return mat.expand(b, 12).contiguous().to(device)


def iid_depth(b, d, h, w, gen, device):
    """Depths uniform over the scene's range per (hypothesis, pixel); the
    last hypothesis of the first 4 rows behind the source camera."""
    depth = DEPTH_MIN + (DEPTH_MAX - DEPTH_MIN) * torch.rand((b, d, h, w), generator=gen,
                                                             device=device)
    depth[:, -1, :4] = -1.0
    return depth


def path_depth(stage, b, d, h, w, gen, device):
    """Depths laid out as the training path makes them: the stratified
    first samples of stage 3 (D = 64), else `init_perturbed_depth` around a
    plane at PLANE with the stage's interval."""
    dmin = torch.full((b,), DEPTH_MIN, device=device)
    dmax = torch.full((b,), DEPTH_MAX, device=device)
    if stage == 3 and d == 64:
        return init_random_depth(torch.rand((b, d, h, w), generator=gen, device=device),
                                 dmin, dmax)
    plane = torch.full((b, h, w), PLANE, device=device)
    return init_perturbed_depth(plane, dmin, dmax, d, STAGE_CONFIG[stage].interval_scale)


def rel_error(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
               for g, w in zip(got, want))


def kernel_cases(device):
    """[(kernel, label, layout, args, launches per train step)] at the
    training stage shapes, bf16 payloads from a seeded generator: K4 on
    both depth layouts, K5 on an eval grid."""
    gen = torch.Generator(device=device).manual_seed(3)
    b, cases = TRAIN_BATCH, []
    for stage, c, g, scale, depths in STAGES:
        h, w = TRAIN_H // scale, TRAIN_W // scale
        mat12 = rig_mat12(h, w, scale, b, device)
        ref, src = (torch.randn((b, h, w, c), generator=gen, device=device).to(torch.bfloat16)
                    for _ in range(2))
        for d, launches in depths:
            dout = torch.randn((b, g, d, h, w), generator=gen, device=device)
            for layout in ("iid", "path"):
                depth = (iid_depth(b, d, h, w, gen, device) if layout == "iid"
                         else path_depth(stage, b, d, h, w, gen, device))
                cases.append(("K4", f"stage{stage} C{c} G{g} D{d} {layout}", layout,
                              (src, mat12, depth, ref, g, dout), launches))
        offset = torch.randn((b, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(STAGE_CONFIG[stage].propagation_range),
                                 h, w)
        dout = torch.randn((b, g, 9, h, w), generator=gen, device=device)
        cases.append(("K5", f"stage{stage} C{c} G{g} K9", "grid", (ref, grid, g, dout), 1))
    return cases


KERNELS = {
    "K4": (ops.warp_group_corr_backward, ops.warp_group_corr_backward_reference),
    "K5": (ops.neighbor_group_corr_backward, ops.neighbor_group_corr_backward_reference),
}


def profile_kernels(cases):
    """Device ms per call of each (kernel, label, layout, args, launches)."""
    rows = []
    for kid, label, layout, args, launches in cases:
        kernel, plain = KERNELS[kid]
        err = rel_error(kernel(*args), plain(*args))
        ms = device_ms(lambda: kernel(*args))
        rows.append({"kernel": kid, "case": label, "layout": layout, "device_ms": ms,
                     "launches": launches, "rel_err": err})
        print(f"{kid} {label}: device {fmt_ms(ms)} (x{launches}/train step), max |kernel - "
              f"plain| / max |plain| {err:.2e}", flush=True)
    return rows


def record_calls(step):
    """Run step() once and return the arguments of its K4 and K5 calls, as
    [(kernel, args)], the tensors detached and cloned."""
    from patchmatchnet_torch.ops import neighbor_similarity, warp_similarity

    calls = []
    patched = ((warp_similarity, "warp_group_corr_backward", "K4"),
               (neighbor_similarity, "neighbor_group_corr_backward", "K5"))
    originals = [getattr(module, name) for module, name, _ in patched]

    def recorder(kid, fn):
        def record(*args):
            calls.append((kid, [tuple(t.detach().clone() for t in a) if isinstance(a, tuple)
                                else a.detach().clone() if torch.is_tensor(a) else a
                                for a in args]))
            return fn(*args)
        return record

    for (module, name, kid), fn in zip(patched, originals):
        setattr(module, name, recorder(kid, fn))
    try:
        step()
    finally:
        for (module, name, _), fn in zip(patched, originals):
            setattr(module, name, fn)
    return calls


def call_cases(calls):
    """The recorded calls of a train step as profile_kernels cases."""
    cases = []
    for i, (kid, args) in enumerate(calls):
        c = args[0].shape[-1]
        shape = "x".join(map(str, (args[2].shape[1:] if kid == "K4" else args[1][0].shape[1:])))
        cases.append((kid, f"train call {i} C{c} {shape}", "train", tuple(args), 1))
    return cases


def profile_steps(device, steps: int, scratch: str, calls_file=None):
    """Device ms and launches per train step for each hand kernel id, and
    the device-busy ms per step, from a trace of `steps` bf16 steps; with
    `calls_file`, also the recorded K4 and K5 calls of one step, timed one
    by one (recorded into the file first where it does not exist)."""
    from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step
    from patchmatchnet_torch.train.driver import load_any_checkpoint, step_noise

    scene = os.path.join(scratch, "scene")
    make_synthetic_scene(scene, num_views=SCENE_VIEWS, height=TRAIN_H, width=TRAIN_W,
                         texture_scale=8.0)
    loader = BatchLoader(MVSDataset(scene, TRAIN_VIEWS - 1, ".png"), TRAIN_BATCH,
                         shuffle=True, drop_last=True, seed=1)
    batch = batch_to_device(next(iter(loader)), device)
    model = PatchmatchNet(compute_dtype=torch.bfloat16).to(device)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    opt = make_optimizer(model.parameters(), 1e-3)
    noise = step_noise(batch, 1, 1)

    def step():
        train_step(model, opt, batch, 1e-3, noise)

    step()  # warm-up: cuDNN algorithm selection, allocator growth
    events = trace_device_events(step, steps, os.path.join(scratch, "trace.json"))
    per_id = {}
    for cat, name, _, dur in events:
        kid = hand_kernel_id(name) if cat == "kernel" else None
        if kid is not None:
            entry = per_id.setdefault(kid, [0.0, 0])
            entry[0] += dur / steps / 1e3
            entry[1] += 1
    busy = busy_union_us((s, s + d) for _, _, s, d in events) / steps / 1e3
    launches = sum(1 for cat, *_ in events if cat == "kernel") / steps
    summary = {kid: {"device_ms": ms, "launches": n / steps}
               for kid, (ms, n) in sorted(per_id.items())}
    print(f"trace of {steps} train steps: {launches:.0f} kernel launches and device busy "
          f"{busy:.2f} ms per step; hand kernels per step: " + ", ".join(
              f"{kid} {v['device_ms']:.4f} ms ({v['launches']:.0f})" for kid, v in summary.items()),
          flush=True)
    out = {"busy_ms": busy, "launches": launches, "kernels": summary}
    if calls_file:
        if not os.path.isfile(calls_file):
            torch.save(record_calls(step), calls_file)
        calls = [(kid, [tuple(t.to(device) for t in a) if isinstance(a, tuple)
                        else a.to(device) if torch.is_tensor(a) else a for a in args])
                 for kid, args in torch.load(calls_file, weights_only=False)]
        rows = profile_kernels(call_cases(calls))
        out["calls"] = rows
        for kid in ("K4", "K5"):
            times = [r["device_ms"] for r in rows if r["kernel"] == kid]
            total = None if None in times else sum(times)
            out[f"{kid} train calls ms"] = total
            print(f"{kid} on one train step's {len(times)} recorded calls: {fmt_ms(total)} "
                  f"per step", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the JSON summary here too")
    parser.add_argument("--steps", type=int, default=2, help="train steps to trace")
    parser.add_argument("--calls", help="K4/K5 calls of a train step: recorded here, or read")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_backward needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    rows = profile_kernels(kernel_cases(device))
    per_step = {}  # "K4 iid", "K4 path", "K5 grid" -> device ms per train step
    for row in rows:
        key, ms = f"{row['kernel']} {row['layout']}", row["device_ms"]
        total = per_step.get(key, 0.0)
        per_step[key] = None if ms is None or total is None else total + ms * row["launches"]
    print("device ms per train step: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in per_step.items()),
          flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="profile_backward_", dir=os.path.join(REPO, "build"))
    try:
        steps = profile_steps(device, args.steps, scratch, args.calls)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    result = {"card": smi, "cases": rows, "per_step": per_step, "train_trace": steps}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
