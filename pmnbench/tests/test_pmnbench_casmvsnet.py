"""CasMVSNet's cell (`cas-dtu-maps`, architecture module `archs/casmvsnet.py`)
run whole on the CPU at a tiny size (`tiny.py`): it runs, traced and not,
and is correct with the program in f32 and as configured (bf16); each of
two faults planted in the program makes it not correct: one source view
left out of K8's variance, and a flat softmax at stage 3 (its `prob` layer
zeroed), which moves no depth by more than stage 3's 8 planes and is seen
by the confidence; and nothing of JAX loads."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import tiny  # noqa: E402

CELL = "cas-dtu-maps"
ONE_VIEW_LESS = """
import patchmatchnet_torch.ops.variance_volume as vv
_volume = vv.variance_volume
def _one_view_less(ref, src, mats, depth):
    return _volume(ref, src[:, :-1].contiguous(), mats[:, :-1].contiguous(), depth)
vv.variance_volume = _one_view_less
"""
FLAT_STAGE3 = """
import torch
import patchmatchnet_torch.models.casmvsnet as cas
_load = cas.CasMVSNet.load_state_dict
def _flat_stage3(self, state_dict, strict=True, assign=False):
    state = dict(state_dict)
    key = "cost_regularization.2.prob.weight"
    state[key] = torch.zeros_like(state[key])
    return _load(self, state, strict=strict, assign=assign)
cas.CasMVSNet.load_state_dict = _flat_stage3
"""


@pytest.fixture(scope="module")
def copy_f32(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("cas_f32")), precision="f32")


@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(copy_f32, traced):
    line = tiny.result(tiny.run(copy_f32, CELL, trace=traced))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"depth_off_tiles", "conf_mean_gap"}
    if traced:
        # no card: the readers of device time and spans find nothing to read
        assert set(line["metrics"]) <= {"mfu.cas"} and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"map_ms", "setup_s"}


def test_cell_runs_correct_as_configured(tmp_path):
    line = tiny.result(tiny.run(tiny.make_copy(str(tmp_path)), CELL))
    assert line["correct"] is True


def test_one_view_left_out_is_not_correct(copy_f32):
    line = tiny.result(tiny.run(copy_f32, CELL, plant=ONE_VIEW_LESS))
    assert line["correct"] is False and line["failed"] > 0


def test_flat_stage3_is_not_correct(copy_f32):
    line = tiny.result(tiny.run(copy_f32, CELL, plant=FLAT_STAGE3))
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["conf_mean_gap"]["value"] > line["checks"]["conf_mean_gap"]["limit"]
