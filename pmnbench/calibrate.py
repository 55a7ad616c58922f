"""The readings that the limits of `limits/<workload>.json` are set from:
the program's numbers over many seeds and the control's over a few, at the
cell's own sizes, in one process.

    python3 pmnbench/calibrate.py --workload <name> --seeds 12 --control-seeds 3

For each seed it makes the cell's inputs as a run does (`drive_maps` /
`drive_train`), runs the program's timed path on them, and compares with
the f32 reference by `check.py`'s numbers. On the first `--control-seeds`
seeds it also reads the control, the reference computed one precision step
below the configuration's bf16 (`fp8`: e4m3 forward, e5m2 backward) put in
the program's place; a witness, the reference in bf16, which tells a fault
of the program from the rounding of bf16 itself; and for a train cell the
program with a fault planted (each step on half of each rank's rows, and
on several ranks no exchange between them). Prints one JSON line a seed;
a tool for setting the limits, not part of a run.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def maps(cell, args, dev):
    import numpy as np

    from pmnbench import check, scenes
    from pmnbench.drive_maps import requests
    from pmnbench.harness import program_model, reference_model
    from patchmatchnet_torch.infer.depth import DepthEstimator

    traffic, config = cell.traffic, cell.config
    params = cell.limits["params"]
    estimator = DepthEstimator(program_model(config, inference=True), dev)
    ref = reference_model(config, "f32", dev)
    control = reference_model(config, "fp8", dev)
    witness = reference_model(config, "bf16", dev)
    h, w = traffic["height"], traffic["width"]
    for s in range(args.seeds):
        seed = args.first_seed + 7919 * s
        reqs = requests(scenes.make_scenes(torch.Generator(device=dev).manual_seed(seed),
                                           traffic["scenes"], traffic))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        for i, req in enumerate(reqs[:args.maps_per_seed]):
            state = gen.get_state()
            depth, conf = estimator(req, gen)
            g2 = torch.Generator(device=dev)
            g2.set_state(state)
            noise = torch.rand((1, 48, h // 8, w // 8), generator=g2, device=dev)
            t = {k: torch.from_numpy(np.asarray(req[k])).to(dev)
                 for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")}
            rng = float(req["depth_max"][0] - req["depth_min"][0])
            start = time.perf_counter()
            with torch.no_grad():
                rd, rc, _ = ref.forward(t["images"], t["intrinsics"], t["extrinsics"],
                                        t["depth_min"], t["depth_max"], noise)
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
                    cd, cc, _ = control.forward(t["images"], t["intrinsics"], t["extrinsics"],
                                                t["depth_min"], t["depth_max"], noise)
                line["control"] = check.map_numbers(cd, cc, rd, rc, rng, params)
                with torch.no_grad():
                    wd, wc, _ = witness.forward(t["images"], t["intrinsics"], t["extrinsics"],
                                                t["depth_min"], t["depth_max"], noise)
                line["witness_bf16"] = check.map_numbers(wd, wc, rd, rc, rng, params)
            print(json.dumps(line), flush=True)


def train(cell, args, dev):
    from pmnbench import check, reference
    from pmnbench.drive_train import CHECK_STEPS, calibration_rank, make_batches
    from pmnbench.harness import reference_model
    from patchmatchnet_torch.parallel import launch

    traffic, config = cell.traffic, cell.config
    lr = float(config["learning_rate"])
    ranks = int(traffic["ranks"])
    seeds = [args.first_seed + 7919 * s for s in range(args.seeds)]
    control_seeds = seeds[:args.control_seeds]
    cell_data = {"traffic": traffic, "config": config}

    def program(seed_list, fault=""):
        if ranks == 1:
            return calibration_rank(None, cell_data, seed_list, fault, str(dev))
        return launch(calibration_rank, ranks, (cell_data, seed_list, fault),
                      device_type=dev.type)[0].value

    readings = {"program": program(seeds), "half_batch": program(control_seeds, "half")}
    if ranks > 1:
        readings["no_exchange"] = program(control_seeds, "alone")

    def keyed(mine, keys):
        return {"losses": mine["losses"],
                "grad_norms": {k: mine["grad_norms"][check.flax_to_program(k)] for k in keys},
                "change_norms": {k: mine["change_norms"][check.flax_to_program(k)]
                                 for k in keys}}

    def reference_side(batches, noises, precision):
        ref = reference_model(config, precision, dev)
        out = reference.train_steps(ref, batches[:CHECK_STEPS], noises[:CHECK_STEPS], lr)
        return {"losses": out["losses"],
                "grad_norms": {k: float(g.norm()) for k, g in out["grads"].items()},
                "change_norms": {k: float((ref.params[k] - out["params0"][k]).norm())
                                 for k in out["grads"]}}

    for i, seed in enumerate(seeds):
        batches, noises = make_batches(traffic, seed, dev, world=ranks, rows=slice(None))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        theirs = reference_side(batches, noises, "f32")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        keys = list(theirs["grad_norms"])
        line = {"seed": seed, "ref_s": time.perf_counter() - start,
                "ref_peak_gib": peak_gib(dev), "ref_losses": theirs["losses"]}
        mine = keyed(readings["program"][i], keys)
        line["program"] = check.train_numbers(mine, theirs)
        line["program_worst"] = check.worst_leaves(mine, theirs)
        if i < len(control_seeds):
            control = reference_side(batches, noises, "fp8")
            line["control"] = check.train_numbers(control, theirs)
            witness = reference_side(batches, noises, "bf16")
            line["witness_bf16"] = check.train_numbers(witness, theirs)
            line["witness_worst"] = check.worst_leaves(witness, theirs)
            for fault in ("half_batch", "no_exchange"):
                if fault in readings:
                    line[fault] = check.train_numbers(keyed(readings[fault][i], keys), theirs)
        print(json.dumps(line), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2718281828)
    parser.add_argument("--maps-per-seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from pmnbench.harness import load_cell

    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "workload": args.workload}))
    (maps if cell.traffic["kind"] == "maps" else train)(cell, args, dev)


if __name__ == "__main__":
    main()
