"""The generator of "maps" traffic: a closed loop of depth-map requests
through the architecture's estimator (PatchmatchNet's: the program's
`DepthEstimator`).

Set-up makes the traffic's pool of scenes on the device from the seed and
moves them to the host as `save_depth_maps`' loader yields them (f32
images [1, N, H, W, 3], cameras, depth range); builds the estimator from
the configuration (`archs/<architecture>.py`: the program's model and
weights); and warms it up on the pool's shape. The window then sends one
request after another, cycling over the pool, each ending in the
estimator's numpy depth and confidence, until `--seconds` have passed.
What the program draws at random per map (PatchmatchNet's stage-3 noise)
comes from one generator on the card seeded from the seed, as
`save_depth_maps` draws it. A sample of the window's maps, drawn from the
seed, is kept with the generator's state before each, and once the window
has closed and the program is freed, the reference computes those maps
again from the same inputs and draws.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from pmnbench import check, devtrace, scenes
from pmnbench.harness import Window, now, peak_gib


def requests(pool: Dict[str, torch.Tensor]) -> List[Dict[str, Any]]:
    """The pool's scenes as loader batches of one sample on the host."""
    host = {k: pool[k].cpu().numpy() for k in ("images", "intrinsics", "extrinsics",
                                                 "depth_min", "depth_max")}
    h, w = host["images"].shape[2:4]
    return [{"images": host["images"][i:i + 1], "intrinsics": host["intrinsics"][i:i + 1],
             "extrinsics": host["extrinsics"][i:i + 1], "depth_min": host["depth_min"][i:i + 1],
             "depth_max": host["depth_max"][i:i + 1], "filename": [f"{i:08d}" + "/{}{}"],
             "orig_height": np.array([h]), "orig_width": np.array([w])}
            for i in range(host["images"].shape[0])]


def run(window: Window, args, t0: float, device: str) -> None:
    cell = window.cell
    traffic, config, arch = cell.traffic, cell.config, cell.arch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    window.device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"

    pool = scenes.make_scenes(torch.Generator(device=dev).manual_seed(args.seed),
                              traffic["scenes"], traffic)
    reqs = requests(pool)
    del pool
    estimator = arch.estimator(arch.program_model(config, True, args.seed), dev)
    noise = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for i in range(traffic["warmup"]):
        estimator(reqs[i % len(reqs)], noise)
    sync()
    rng = random.Random(args.seed)
    keep = set(rng.sample(range(traffic["check_among_first"]), traffic["check_maps"]))
    kept: Dict[int, Any] = {}

    window.setup_s = now() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = end = now()
    count = 0
    while end - start < args.seconds:
        req = reqs[count % len(reqs)]
        state = noise.get_state() if count in keep else None
        t = now()
        depth, conf = estimator(req, noise)
        end = now()
        window.request_s.append(end - t)
        if state is not None:
            kept[count] = (count % len(reqs), state, depth, conf)
        count += 1
    window.window_s = end - start
    window.count = count
    window.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    window.bound = arch.bound(config, traffic)

    if args.trace:
        served = iter(range(count, 1 << 62))
        window.trace = devtrace.traced(
            lambda: estimator(reqs[next(served) % len(reqs)], noise),
            traffic["trace_maps"], sync)

    del estimator
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge_maps(window, reqs, kept, args.seed, dev)


def judge_maps(window: Window, reqs, kept, seed: int, dev) -> None:
    """Compute the kept maps again with the reference and compare."""
    cell = window.cell
    limits, arch = cell.limits, cell.arch
    ref = arch.reference_model(cell.config, "f32", dev, seed)
    h, w = reqs[0]["images"].shape[2:4]
    worst: Dict[str, float] = {name: 0.0 for name in limits["numbers"]}
    for index in sorted(kept):
        scene, state, depth, conf = kept[index]
        req = reqs[scene]
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        extra = arch.extra_inputs(gen, 1, h, w, dev)
        t = {k: torch.from_numpy(np.asarray(req[k])).to(dev)
             for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")}
        with torch.no_grad():
            ref_depth, ref_conf = arch.reference_map(ref, t, extra)
        numbers = check.map_numbers(torch.from_numpy(depth).to(dev), torch.from_numpy(conf).to(dev),
                                    ref_depth, ref_conf,
                                    float(req["depth_max"][0] - req["depth_min"][0]),
                                    limits["params"])
        print(f"map {index}: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()),
              file=sys.stderr)
        wrong = False
        for name, limit in limits["numbers"].items():
            worst[name] = max(worst[name], numbers[name])
            wrong |= numbers[name] > limit
        window.wrong += int(wrong)
        window.checked += 1
    if window.checked:
        window.checks = [(name, worst[name], float(limit))
                         for name, limit in limits["numbers"].items()]


def calibrate(cell, args, dev) -> None:
    """`calibrate.py`'s readings of a maps cell: for each seed, the first
    `--maps-per-seed` maps of the seed's pool through the program against
    the f32 reference; on the first `--control-seeds` seeds also the
    control (the reference in fp8) and the witness (in bf16). The program
    and the references are built anew for each seed, since a
    configuration without a checkpoint takes its weights from the seed;
    with one they are built once."""
    traffic, config, arch = cell.traffic, cell.config, cell.arch
    params = cell.limits["params"]
    h, w = traffic["height"], traffic["width"]
    built = None
    for s in range(args.seeds):
        seed = args.first_seed + 7919 * s
        if built is None or "checkpoint" not in config:
            built = (arch.estimator(arch.program_model(config, True, seed), dev),
                     *(arch.reference_model(config, p, dev, seed)
                       for p in ("f32", "fp8", "bf16")))
        estimator, ref, control, witness = built
        reqs = requests(scenes.make_scenes(torch.Generator(device=dev).manual_seed(seed),
                                           traffic["scenes"], traffic))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        for i, req in enumerate(reqs[:args.maps_per_seed]):
            state = gen.get_state()
            depth, conf = estimator(req, gen)
            g2 = torch.Generator(device=dev)
            g2.set_state(state)
            extra = arch.extra_inputs(g2, 1, h, w, dev)
            t = {k: torch.from_numpy(np.asarray(req[k])).to(dev)
                 for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")}
            rng = float(req["depth_max"][0] - req["depth_min"][0])
            start = time.perf_counter()
            with torch.no_grad():
                rd, rc = arch.reference_map(ref, t, extra)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ref_s = time.perf_counter() - start
            line = {"seed": seed, "map": i, "ref_s": ref_s,
                    "ref_peak_gib": peak_gib(dev),
                    "program": check.map_numbers(torch.from_numpy(depth).to(dev),
                                                 torch.from_numpy(conf).to(dev), rd, rc, rng,
                                                 params)}
            if s < args.control_seeds:
                with torch.no_grad():
                    cd, cc = arch.reference_map(control, t, extra)
                line["control"] = check.map_numbers(cd, cc, rd, rc, rng, params)
                with torch.no_grad():
                    wd, wc = arch.reference_map(witness, t, extra)
                line["witness_bf16"] = check.map_numbers(wd, wc, rd, rc, rng, params)
            print(json.dumps(line), flush=True)
