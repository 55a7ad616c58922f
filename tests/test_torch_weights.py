"""Checkpoint loading of the port: the pure-Python msgpack reader against
flax, and the flax -> PyTorch state-dict conversion against the inverse
layout transforms of `patchmatchnet_tpu/compat/torch_convert.py`."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from patchmatchnet_tpu.compat.torch_convert import (
    _conv2d_kernel,
    _deconv_kernel,
    _dense_kernel,
)
from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.models import PatchmatchNet

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")
NUM_LEAVES = 182


@pytest.fixture(scope="module")
def trees():
    with open(CKPT, "rb") as f:
        flax_tree = serialization.msgpack_restore(f.read())
    return read_flax_msgpack(CKPT), flax_tree


def _paths(tree):
    return [
        (tuple(k.key for k in path), leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    ]


def test_reader_matches_flax_bit_for_bit(trees):
    ours, ref = _paths(trees[0]), _paths(trees[1])
    assert len(ours) == len(ref) == NUM_LEAVES
    for (pa, a), (pb, b) in zip(ours, ref):
        assert pa == pb
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        assert a.tobytes() == b.tobytes(), pa


def test_every_leaf_maps_and_nothing_is_left_over(trees):
    sd = state_dict_from_jax(trees[0])
    model_sd = PatchmatchNet().state_dict()
    assert len(sd) == NUM_LEAVES
    assert set(sd) == set(model_sd)
    for key, value in sd.items():
        assert value.shape == model_sd[key].shape, key
        assert value.dtype == torch.float32


def test_state_dict_loads_strict(trees):
    for dtype in (None, torch.bfloat16):
        model = PatchmatchNet(compute_dtype=dtype)
        result = model.load_state_dict(state_dict_from_jax(trees[0]), strict=True)
        assert not result.missing_keys and not result.unexpected_keys
    total = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for b in model.buffers()
    )
    assert total == 223045


def test_layouts_invert_torch_convert(trees):
    """Applying the reference's torch -> flax transforms to each converted
    tensor gives back the flax leaf exactly."""
    sd = state_dict_from_jax(trees[0])
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    for path, leaf in _paths(trees[0]):
        key = ".".join(path[1:-1] + (names[path[-1]],))
        w = sd[key].numpy()
        if path[-1] == "kernel":
            if path[-2] == "deconv":
                w = _deconv_kernel(w)
            elif leaf.ndim == 2:
                w = _dense_kernel(w)
            else:
                w = _conv2d_kernel(w)
        np.testing.assert_array_equal(w, leaf, err_msg=str(path))


def test_reader_rejects_truncated_data(tmp_path):
    data = open(CKPT, "rb").read()
    bad = tmp_path / "truncated.msgpack"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError):
        read_flax_msgpack(str(bad))
