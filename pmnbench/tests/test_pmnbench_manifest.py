"""BENCHMARK.json against the rules it is held to, and every name in it
against the files of `pmnbench/`."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [REPO]

from pmnbench import harness  # noqa: E402

MANIFEST = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["pmnbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + WORKLOADS
                         + [c["name"] for c in MANIFEST["configs"]]
                         + [w["traffic"] for w in MANIFEST["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_units_and_readers(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert os.path.isfile(os.path.join(REPO, "pmnbench", "metrics", f"{metric['name']}.py"))
    if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


def test_names_are_unique():
    for group in (METRICS, MANIFEST["workloads"], MANIFEST["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells(workload):
    cell = harness.load_cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
    assert cell.workload["chips"] in (1, 4)
    assert cell.limits["numbers"]
    for c in MANIFEST["configs"]:
        if c["name"] == cell.workload["config"]:
            assert os.path.isfile(os.path.join(REPO, c["file"]))


def test_layers_are_spelled_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("config,said", [
    ({"name": "c"}, "names no \"architecture\""),
    ({"name": "c", "architecture": "absent"}, "pmnbench/archs/absent.py is not there"),
    ({"name": "c", "architecture": "../harness"}, "no architecture '../harness'"),
])
def test_an_architecture_is_named_and_found(config, said):
    with pytest.raises(SystemExit, match=re.escape(said)):
        harness.architecture(config)


def test_a_traffic_kind_is_found_by_file():
    assert harness.driver({"kind": "maps"}).__name__ == "pmnbench.drive_maps"
    with pytest.raises(SystemExit, match=re.escape("pmnbench/drive_absent.py is not there")):
        harness.driver({"kind": "absent"})
