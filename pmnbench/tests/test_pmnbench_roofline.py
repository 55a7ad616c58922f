"""The benchmark's frozen roofline count against the program's
`dev/roofline.py` at the cells' shapes: equal today, so that a later
drift in either shows."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [REPO]

from pmnbench.harness import load_json  # noqa: E402
from pmnbench.roofline import count  # noqa: E402

CELLS = [("pmn-infer", "dtu-1600x1200-v5"), ("pmn-infer", "eth3d-2688x1792-v7"),
         ("pmn-train", "train-640x512-v5-b8"), ("pmn-train", "train-640x512-v5-b8x4")]


def _rows(rows):
    return [(r.component, r.group, r.bytes, r.flops, r.ops_per_s) for r in rows]


@pytest.mark.parametrize("config_name,traffic_name", CELLS)
def test_counts_equal_the_programs(config_name, traffic_name):
    from patchmatchnet_torch.dev import roofline

    config = load_json(REPO, "pmnbench", "configs", f"{config_name}.json")
    traffic = load_json(REPO, "pmnbench", "traffic", f"{traffic_name}.json")
    train = traffic["kind"] == "train"
    precision = config["train_precision" if train else "precision"]
    shape = (traffic["height"], traffic["width"], traffic["views"], traffic["batch"], train)
    mine = count.count(count.Geometry(*shape), precision, config)
    theirs = roofline.count(roofline.Geometry(*shape), precision)
    assert _rows(mine) == _rows(theirs)
    assert count.summary(mine)["bound_ms"] == pytest.approx(roofline.summary(theirs)["bound_ms"])
    assert count.cell_bound(config, traffic)["bound_ms"] == count.summary(mine)["bound_ms"]


def test_f32_counts_equal_the_programs():
    from patchmatchnet_torch.dev import roofline

    config = load_json(REPO, "pmnbench", "configs", "pmn-infer.json")
    shape = (864, 1152, 5, 1, False)
    assert _rows(count.count(count.Geometry(*shape), "f32", config)) == _rows(
        roofline.count(roofline.Geometry(*shape), "f32"))


def test_parameter_count_is_the_models():
    from patchmatchnet_torch.models import PatchmatchNet

    config = load_json(REPO, "pmnbench", "configs", "pmn-train.json")
    model = PatchmatchNet()
    assert count.Architecture(config).parameters() == sum(p.numel() for p in model.parameters())
