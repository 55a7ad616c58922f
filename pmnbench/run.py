"""Run one cell of the benchmark of `patchmatchnet_torch`.

    python3 pmnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the cell's inputs from the seed,
sets the program up and warms it up (`setup_s`), measures for `--seconds`,
checks the window's outputs against the plain reference, and prints one
JSON line: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each compared number
beside its limit (also the last lines on standard error). Without the
cards the cell asks for it prints no result and exits with 2.

Every build of the program goes to fixed folders inside the checkout (its
nvcc build under `build/kernels/`; torch's extension and Triton caches
under `build/`).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from pmnbench import harness

    return harness.run(args, T0)


if __name__ == "__main__":
    sys.exit(main())
