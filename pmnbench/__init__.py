"""The benchmark of `patchmatchnet_torch` on NVIDIA H100 cards.

`python3 pmnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` (see `run.py`). Everything a cell is made
of is data found by name: `configs/<config>.json`, `traffic/<traffic>.json`,
`metrics/<metric>.py`, `kernel_groups/*.json` and `limits/<workload>.json`.
"""
