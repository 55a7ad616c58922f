"""The benchmark of `patchmatchnet_torch` on NVIDIA H100 cards.

`python3 pmnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` (see `run.py`). Everything a cell is made
of is found by name: `configs/<config>.json`, whose "architecture" names
`archs/<architecture>.py` (the program, the plain reference and the bound of
one architecture), `traffic/<traffic>.json`, whose "kind" names the generator
`drive_<kind>.py`, `metrics/<metric>.py`, `kernel_groups/*.json` and
`limits/<workload>.json`.
"""
