"""One run of one cell: find the cell's data by name, drive its traffic,
read its metrics, judge its outputs, print the result line.

A cell (`workloads` entry of BENCHMARK.json) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`).
The configuration's "architecture" names the module
`archs/<architecture>.py` through which the run reaches the program, the
plain reference and the bound; the mix's "kind" names the generator that
drives it, `drive_<kind>.py`. The cell's limits are
`limits/<workload>.json`, and each metric is read by
`metrics/<name>.py`'s `read(window)`, which returns a number or None
(nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "patchmatchnet_tpu")
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load_json(*parts: str) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _module_path(what: str, name: str, stem: str) -> str:
    """`pmnbench/<stem>.py`, the module of the `what` named `name`, or a
    SystemExit that says which file is missing."""
    path = os.path.join(HERE, f"{stem}.py")
    if not MODULE_NAME.match(name) or not os.path.isfile(path):
        raise SystemExit(f"pmnbench: no {what} {name!r}: pmnbench/{stem}.py is not there")
    return path


def architecture(config: Dict[str, Any]) -> ModuleType:
    """The module `archs/<architecture>.py` of a configuration, loaded by
    file name once a process."""
    if "architecture" not in config:
        raise SystemExit(f"pmnbench: configuration {config.get('name')!r} names no "
                         "\"architecture\" (a module of pmnbench/archs/)")
    name = str(config["architecture"])
    path = _module_path("architecture", name, f"archs/{name}")
    key = f"pmnbench_arch_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def driver(traffic: Dict[str, Any]) -> ModuleType:
    """The generator `drive_<kind>.py` of a traffic mix."""
    kind = str(traffic.get("kind"))
    _module_path("traffic kind", kind, f"drive_{kind}")
    return importlib.import_module(f"pmnbench.drive_{kind}")


@dataclass
class Cell:
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    arch: ModuleType  # archs/<architecture>.py


def load_cell(name: str, manifest_path: Optional[str] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its data files, and the
    metrics it reports: each end-to-end metric whose "workloads" lists it
    (or that has no such list), and each per-layer metric whose
    "workloads" lists it, or that has none and moves a metric it reports."""
    manifest = load_json(manifest_path or os.path.join(ROOT, "BENCHMARK.json"))
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = found[0]
    config = load_json(HERE, "configs", f"{workload['config']}.json")
    traffic = load_json(HERE, "traffic", f"{workload['traffic']}.json")
    limits = load_json(HERE, "limits", f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, config, traffic, limits, e2e, layer, architecture(config))


@dataclass
class Window:
    """What a run measured, for the metric readers."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0  # the timed window, host clock
    count: int = 0  # maps or steps completed in it (per rank)
    samples: int = 0  # samples of all ranks trained in it
    request_s: List[float] = field(default_factory=list)  # each map's host seconds
    peak_bytes: int = 0  # fullest card
    ranks: int = 1
    trace: Any = None  # trace.TraceSummary of the traced window, averaged over ranks
    bound: Dict[str, Any] = field(default_factory=dict)  # roofline summary of one unit
    checks: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, value, limit)
    checked: int = 0  # answers compared
    wrong: int = 0  # answers that failed their comparison
    device_name: str = ""


def read_metric(name: str, window: Window) -> Optional[float]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pmnbench_metric_{len(name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(window)
    if value is None:
        return None
    value = float(value)
    return value if math.isfinite(value) else None


def peak_gib(dev) -> float:
    """The device's peak of allocated memory in GiB (0 on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(window: Window) -> bool:
    """Every compared number within its limit, and something compared."""
    return bool(window.checks) and all(v <= limit for _, v, limit in window.checks)


def result_line(window: Window, trace: bool, chips: int) -> Dict[str, Any]:
    cell = window.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": window.device_name, "count": chips,
              "memory_peak_bytes": int(window.peak_bytes)}
    out: Dict[str, Any] = {"correct": judge(window), "attempted": window.count * window.ranks,
                           "failed": window.wrong, "metrics": metrics, "device": device}
    if trace and window.trace is not None:
        device["busy_s"] = window.trace.busy_s
        device["window_s"] = window.trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in window.trace.device_ops],
                            "idle_gaps": [list(x) for x in window.trace.idle_gaps]}
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in window.checks}
    return out


def run(args, t0: float, device: Optional[str] = None) -> int:
    """Run the cell `args.workload`; print the result line; return the exit
    code. `device` other than None (the tests' "cpu") skips the look for
    cards."""
    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"pmnbench: the cell needs {chips} CUDA card(s); this machine has {have}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    window = Window(cell)
    driver(cell.traffic).run(window, args, t0, device)
    found = forbidden_modules()
    if found:
        print(f"pmnbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(window, bool(args.trace), chips)
    for name, v, limit in window.checks:
        print(f"check {name}: {v!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def now() -> float:
    return time.perf_counter()
