"""The port's raw-DTU dataset against the JAX `DTULegacyDataset`, on the
raw-DTU fixture of tests/test_dtu_legacy.py: every field of every sample
equal to the bit (values, dtype, shape), alone and batched."""

import numpy as np
import pytest

from patchmatchnet_tpu.data import BatchLoader as JaxBatchLoader
from patchmatchnet_tpu.data import DTULegacyDataset as JaxDTULegacyDataset
from patchmatchnet_tpu.data.dtu_legacy import prepare_hr_image as jax_prepare_hr_image
from patchmatchnet_torch.data import BatchLoader, DTULegacyDataset
from patchmatchnet_torch.data.dtu_legacy import prepare_hr_image
from tests.test_dtu_legacy import raw_dtu  # noqa: F401  (the fixture)


def _assert_same(got, want):
    for key, value in want.items():
        if isinstance(value, str) or (isinstance(value, list) and isinstance(value[0], str)):
            assert got[key] == value, key
        else:
            value, mine = np.asarray(value), np.asarray(got[key])
            assert mine.dtype == value.dtype and mine.shape == value.shape, key
            assert np.array_equal(mine, value), key


def test_prepare_hr_image_matches_jax():
    img = np.random.default_rng(0).random((1200, 1600), dtype=np.float32)
    assert np.array_equal(prepare_hr_image(img), jax_prepare_hr_image(img))


@pytest.mark.parametrize("num_views", [3, 2])
def test_samples_match_jax(raw_dtu, num_views):  # noqa: F811
    root, list_file = raw_dtu
    ours = DTULegacyDataset(root, list_file, num_views=num_views)
    ref = JaxDTULegacyDataset(root, list_file, num_views=num_views)
    assert len(ours) == len(ref) == 3 * 7
    for idx in (0, 8, 20):
        _assert_same(ours[idx], ref[idx])


def test_batches_match_jax(raw_dtu):  # noqa: F811
    root, list_file = raw_dtu
    ours = next(iter(BatchLoader(DTULegacyDataset(root, list_file, num_views=2), 2,
                                 num_threads=1)))
    ref = next(iter(JaxBatchLoader(JaxDTULegacyDataset(root, list_file, num_views=2), 2,
                                   num_threads=1)))
    assert ours["images"].shape == (2, 2, 512, 640, 3)
    _assert_same(ours, ref)


def test_robust_views_are_seeded_per_epoch(raw_dtu):  # noqa: F811
    root, list_file = raw_dtu
    ds = DTULegacyDataset(root, list_file, num_views=2, robust_train=True, seed=3)
    picks = {}
    for epoch in range(6):
        ds.epoch = epoch
        picks[epoch] = [int(round(ds[i]["extrinsics"][1][0, 3] / 0.2)) for i in (0, 1)]
    ds.epoch = 2
    assert picks[2] == [int(round(ds[i]["extrinsics"][1][0, 3] / 0.2)) for i in (0, 1)]
    assert picks[0][0] in (1, 2) and picks[0][1] in (0, 2)
    assert len({tuple(p) for p in picks.values()}) > 1
