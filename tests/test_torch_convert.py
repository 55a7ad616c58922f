"""The port's reference-checkpoint converter against the JAX package's.

A seeded state dict in the reference's own layout (the original PyTorch
PatchmatchNet: DataParallel `module.` prefixes, `num_batches_tracked`
entries, the stage-1 propagation conv and the stage-1/2 pixel-wise nets the
model never calls, `feature_weight_net` beside `evaluation`, Conv3d 1x1x1
weights) goes through the port's `convert_torch_state_dict` and through the
JAX `convert_torch_state_dict` followed by `state_dict_from_jax`: the two
state dicts are equal to the bit, as a dict and as a `.ckpt` written with
`torch.save` (with and without the 'model' wrapper), and the result loads
into the port's model.
"""

import numpy as np
import pytest
import torch

from patchmatchnet_tpu.compat import torch_convert as jax_convert
from patchmatchnet_torch.compat import (
    convert_torch_checkpoint,
    convert_torch_state_dict,
    state_dict_from_jax,
)
from patchmatchnet_torch.models import PatchmatchNet

# modules of the reference whose 1x1x1 Conv3d weights are [O, I, 1, 1, 1]
_CONV3D_NETS = ("pixel_wise_net", "similarity_net", "feature_weight_net")


def _reference_key(port_key: str) -> str:
    key = port_key.replace(".conv2d.", ".").replace(".dense.", ".")
    return key.replace(".evaluation.feature_weight_net.", ".feature_weight_net.")


def reference_state_dict(seed: int = 0):
    """The released configuration's weights in the reference's layout,
    filled with seeded values (running variances positive)."""
    rng = np.random.default_rng(seed)
    out = {}

    def add(key, shape):
        value = rng.standard_normal(shape).astype(np.float32)
        if key.endswith("running_var"):
            value = np.abs(value) + 0.1
        out["module." + key] = torch.from_numpy(value)
        if key.endswith("running_var"):
            out["module." + key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)

    for key, t in PatchmatchNet().state_dict().items():
        shape = tuple(t.shape)
        if any(n in key for n in _CONV3D_NETS) and len(shape) == 4:
            shape = shape + (1,)  # Conv3d 1x1x1
        add(_reference_key(key), shape)
    # modules the reference defines but never calls
    add("patchmatch_1.propa_conv.weight", (1, 16, 3, 3))
    add("patchmatch_1.propa_conv.bias", (1,))
    for stage, groups in ((1, 4), (2, 8)):
        net = f"patchmatch_{stage}.evaluation.pixel_wise_net"
        add(f"{net}.conv0.conv.weight", (16, groups, 1, 1, 1))
        for name in ("weight", "bias", "running_mean", "running_var"):
            add(f"{net}.conv0.bn.{name}", (16,))
    return out


def _jax_chain(state_dict):
    return state_dict_from_jax(jax_convert.convert_torch_state_dict(state_dict))


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_converter_matches_jax_chain():
    sd = reference_state_dict()
    got = convert_torch_state_dict(sd)
    _assert_equal(got, _jax_chain(sd))
    model = PatchmatchNet()
    model.load_state_dict(got, strict=True)
    # the Refinement deconv comes back in the reference's own layout
    key = "upsample_net.deconv.weight"
    assert torch.equal(got[key], sd["module." + key])


@pytest.mark.parametrize("wrapped", [True, False])
def test_checkpoint_file_matches_jax_chain(tmp_path, wrapped):
    sd = reference_state_dict(seed=1)
    path = str(tmp_path / "params_000007.ckpt")
    torch.save({"epoch": 7, "model": sd, "optimizer": {}} if wrapped else sd, path)
    _assert_equal(convert_torch_checkpoint(path), _jax_chain(sd))


def test_unknown_batchnorm_key_raises():
    sd = {"module.feature.conv0.bn.momentum": torch.zeros(8)}
    with pytest.raises(ValueError, match="BN"):
        convert_torch_state_dict(sd)
