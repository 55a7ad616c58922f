"""The readings that the limits of `limits/<workload>.json` are set from:
the program's numbers over many seeds and the control's over a few, at the
cell's own sizes, in one process.

    python3 pmnbench/calibrate.py --workload <name> --seeds 12 --control-seeds 3

The traffic's generator, `drive_<kind>.py`, takes the readings by its
`calibrate(cell, args, dev)`, so a new kind brings its own. For each seed
it makes the cell's inputs as a run does, runs the program's timed path on
them, and compares with the f32 reference by `check.py`'s numbers,
reaching the program and the reference through the configuration's
`archs/<architecture>.py`. On the first `--control-seeds`
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

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    from pmnbench.harness import driver, load_cell

    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "workload": args.workload}))
    driver(cell.traffic).calibrate(cell, args, dev)


if __name__ == "__main__":
    main()
