"""Data parallel (`patchmatchnet_torch.parallel`) on the CPU: gloo ranks
started by the port's launcher (`parallel.launch`, spawn, a FileStore in a
temporary directory, 1 thread per rank).

- (i) The port's f32 2-rank step of the released model (1 sample per rank
  of `plane_batch(2, 3, 64, 80)`, sample 1's mask cut to its left half, so
  the ranks' mask counts differ) against the JAX step jitted on the same
  batch sharded over `make_mesh(2)` with replicated parameters, at
  tests/test_torch_train.py's f32 bounds: loss 1e-4 relative; every
  gradient leaf above 1e-3 of the largest leaf norm with cosine > 0.999 and
  relative norm difference < 1e-2; batch statistics 1e-4 relative.
- (ii) The same step against the port's 1-rank step of the whole batch, at
  tighter bounds: loss 1e-5 relative; ||g_2 - g_1|| / ||g_1|| < 1e-3 over
  the whole gradient and cosine > 0.9999 per leaf above 1e-3 of the
  largest; statistics 2e-5 relative. (Measured on the CPU: loss 2.0e-6,
  2.9e-4 over the whole gradient, per-leaf cosine 1 - 2.9e-5 at worst, on
  the refinement's leaves, whose gradient moves by 1.1e-3 between 1 and 8
  threads of the same 1-rank step; statistics 4.2e-6: the mean of two
  1-sample means rounds otherwise than the mean over the batch, and E[x^2]
  - E[x]^2 cancels.) The negative
  control, two 1-sample steps with local statistics and denominators
  averaged, misses each of the loss, gradient and statistics bounds by at
  least 10x.
- (iii) After 2 steps both ranks hold the same parameters, running
  statistics and Adam state.
- (iv) `DryRunModel` over 2 ranks against the JAX `DryRunModel` through
  `make_train_step` on `make_mesh(2)`, at tests/test_train_step.py's
  data-parallel tolerances, its weights carried by `state_dict_from_jax`.
- (v) `run_training(num_devices=2)` against 1 rank (the full model at
  64x80, f32), and a 2-rank run resumed from its checkpoint.
- (vi) `eval --num_devices 2 --device cpu` writes the maps of
  `--num_devices 1` at the same seed, to the bit, with a short last batch.
- (vii) The refusals (and sync-BN's, of ranks holding unequal shares);
  (viii) `BatchNorm` without a group is bit-identical to the module before
  sync-BN.

The JAX package is imported inside the tests that use it: the ranks import
this module to find their functions, and need no JAX.
"""

import os

import numpy as np
import pytest
import torch

from patchmatchnet_torch import cli
from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import (
    BatchLoader,
    MVSDataset,
    make_synthetic_scene,
    plane_batch,
    read_map,
)
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.layers import BatchNorm
from patchmatchnet_torch.parallel import (
    DryRunModel,
    Group,
    launch,
    rank_rows,
    replicate,
    resolve_devices,
    shard_batch,
)
from patchmatchnet_torch.train import (
    batch_to_device,
    load_any_checkpoint,
    make_optimizer,
    run_training,
    train_step,
)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")
CPU = torch.device("cpu")
LR = 1e-3
RANK_TIMEOUT = 120  # seconds, each launch


def _masked_batch():
    batch = plane_batch(2, 3, 64, 80)
    batch["mask"][1, :, :40] = False  # the ranks' mask counts differ
    return batch


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _step(model, net, batch, group=None, lr=LR, optimizer=None):
    """(loss, gradients by name, running statistics) of one train step."""
    optimizer = optimizer or make_optimizer(model.parameters(), lr)
    metrics, _ = train_step(net, optimizer, batch_to_device(batch, CPU), lr,
                            torch.from_numpy(batch["noise"]), with_grads=True, group=group)
    return float(metrics["loss"]), metrics["grads"], _running_stats(model)


def _two_steps_rank(group: Group, state_dict, batch):
    """Rank function: two steps of the released f32 model on the rank's
    rows; the first step's (loss, gradients, statistics), then the state."""
    model = PatchmatchNet()
    model.load_state_dict(state_dict)
    optimizer = make_optimizer(model.parameters(), LR)
    net = replicate(model, group)
    local = shard_batch(batch, group)
    first = _step(model, net, local, group.process_group, optimizer=optimizer)
    _step(model, net, local, group.process_group, optimizer=optimizer)
    adam = {name: {k: v.clone() for k, v in optimizer.state[p].items()}
            for name, p in model.named_parameters()}
    return {"first": first, "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()}, "adam": adam}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two threads for this module's steps in this process, and so one for
    each rank `run_training` starts (it shares this process's threads out):
    beside the other test workers, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def released():
    return state_dict_from_jax(read_flax_msgpack(CKPT))


@pytest.fixture(scope="module")
def two_ranks(released):
    results = launch(_two_steps_rank, 2, (released, _masked_batch()), device_type="cpu",
                     timeout=RANK_TIMEOUT)
    return [r.value for r in results]


@pytest.fixture(scope="module")
def one_rank(released):
    model = PatchmatchNet()
    model.load_state_dict(released)
    return _step(model, model, _masked_batch())


def _leaf_rows(got, want):
    """{leaf: (cosine, ||want||, ||got||)} of the leaves above 1e-3 of the
    largest leaf norm of `want`."""
    top = max(float(g.norm()) for g in want.values())
    rows = {}
    for name, w in want.items():
        a, b = w.double().ravel(), got[name].double().ravel()
        na, nb = float(a.norm()), float(b.norm())
        if na >= 1e-3 * top:
            rows[name] = (float(a @ b) / (na * nb + 1e-30), na, nb)
    return rows


def _stats_error(got, want):
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp(min=1e-12))
               for k, w in want.items())


def _errors(got, want):
    """(loss relative, ||g - g_want|| / ||g_want|| over the whole gradient,
    1 - the worst per-leaf cosine, statistics relative)."""
    loss = abs(got[0] - want[0]) / abs(want[0])
    num = sum(float((got[1][k] - w).double().square().sum()) for k, w in want[1].items())
    den = sum(float(w.double().square().sum()) for w in want[1].values())
    cos = min(c for c, _, _ in _leaf_rows(got[1], want[1]).values())
    return loss, (num / den) ** 0.5, 1.0 - cos, _stats_error(got[2], want[2])


# (ii)'s bounds: loss, whole gradient, 1 - per-leaf cosine, statistics
TIGHT = (1e-5, 1e-3, 1e-4, 2e-5)


def _jax_sharded_step(batch):
    """The JAX f32 step's (loss, gradients, updated statistics) on `batch`
    sharded over a 2-device mesh, parameters replicated."""
    import jax
    import jax.numpy as jnp

    from patchmatchnet_torch.compat import tensors_from_jax_params
    from patchmatchnet_tpu.compat import load_variables
    from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
    from patchmatchnet_tpu.models.net import patchmatchnet_loss as jax_loss
    from patchmatchnet_tpu.parallel import make_mesh, replicated_sharding
    from patchmatchnet_tpu.parallel import shard_batch as jax_shard_batch
    from patchmatchnet_tpu.train.loop import build_stage_pyramid as jax_pyramid

    model = JaxPatchmatchNet()
    mesh = make_mesh(2)
    variables = jax.device_put(load_variables(CKPT), replicated_sharding(mesh))

    def loss_fn(params, stats, arrays):
        (_, _, dp), updates = model.apply(
            {"params": params, "batch_stats": stats}, arrays["images"], arrays["intrinsics"],
            arrays["extrinsics"], arrays["depth_min"], arrays["depth_max"], train=True,
            init_noise=arrays["noise"], mutable=["batch_stats", "diagnostics"])
        gts, masks = jax_pyramid(arrays["depth_gt"], arrays["mask"])
        return jax_loss(dp, gts, masks), updates["batch_stats"]

    arrays = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], arrays)
    out = (float(loss), tensors_from_jax_params(jax.tree.map(np.array, grads)),
           state_dict_from_jax({"batch_stats": jax.tree.map(np.array, stats)}))
    jax.clear_caches()
    return out


def test_two_rank_step_matches_the_jax_sharded_step(two_ranks):
    """(i)"""
    want = _jax_sharded_step(_masked_batch())
    loss, grads, stats = two_ranks[0]["first"]
    assert abs(loss - want[0]) / abs(want[0]) < 1e-4, (loss, want[0])
    assert set(grads) == set(want[1])
    rows = _leaf_rows(grads, want[1])
    assert len(rows) >= 100, len(rows)
    for name, (cos, na, nb) in rows.items():
        assert cos > 0.999, (name, cos)
        assert abs(nb - na) / na < 1e-2, (name, na, nb)
    assert set(stats) == set(want[2])
    assert _stats_error(stats, want[2]) < 1e-4


def test_two_rank_step_matches_one_rank(two_ranks, one_rank):
    """(ii)"""
    errors = _errors(two_ranks[0]["first"], one_rank)
    assert all(e < b for e, b in zip(errors, TIGHT)), (errors, TIGHT)


def test_local_statistics_miss_the_bound(released, one_rank):
    """(ii)'s negative control: each sample stepped alone (its own batch
    statistics and mask count), the two results averaged, as DDP over ranks
    with local BatchNorm and local loss denominators would give."""
    batch = _masked_batch()
    parts = []
    for i in range(2):
        model = PatchmatchNet()
        model.load_state_dict(released)
        parts.append(_step(model, model, {k: v[i:i + 1] for k, v in batch.items()}))
    averaged = ((parts[0][0] + parts[1][0]) / 2,
                {k: (parts[0][1][k] + parts[1][1][k]) / 2 for k in parts[0][1]},
                {k: (parts[0][2][k] + parts[1][2][k]) / 2 for k in parts[0][2]})
    loss, grad, _, stats = _errors(averaged, one_rank)
    assert loss > 10 * TIGHT[0] and grad > 10 * TIGHT[1] and stats > 10 * TIGHT[3], \
        (loss, grad, stats)


def test_ranks_hold_the_same_state(two_ranks):
    """(iii) after 2 steps: parameters, running statistics, Adam state."""
    a, b = two_ranks
    assert a["first"][0] == b["first"][0]  # the global loss on both ranks
    for key in ("params", "buffers"):
        assert set(a[key]) == set(b[key])
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    for name, state in a["adam"].items():
        for k, v in state.items():
            assert torch.equal(v, b["adam"][name][k]), (name, k)
        assert int(state["step"]) == 2


def _dryrun_rank(group: Group, state_dict, batch):
    model = DryRunModel()
    model.load_state_dict(state_dict)
    optimizer = make_optimizer(model.parameters(), LR)
    loss, _, _ = _step(model, replicate(model, group), shard_batch(batch, group),
                       group.process_group, optimizer=optimizer)
    return loss, {k: p.detach().clone() for k, p in model.named_parameters()}


def test_dryrun_model_matches_the_jax_mesh_step():
    """(iv) the JAX stand-in's step on a 2-device mesh, at the tolerances of
    tests/test_train_step.py's data-parallel step: loss rtol 1e-5;
    parameters after Adam within 3e-3, and no more than 1e-3 of them off by
    more than 1e-5, since a near-zero gradient may flip sign and take a
    whole +-lr step. Here that gradient is conv0's bias, in front of the
    BatchNorm, which cancels any shift: its gradient is rounding noise
    (checked below 1e-5 of the largest leaf norm), and its 8 values are 2%
    of this model's 313, so it is held to 3e-3 alone and the rest to the
    1e-3 share."""
    import jax
    import jax.numpy as jnp

    from patchmatchnet_tpu.parallel import make_mesh, replicated_sharding
    from patchmatchnet_tpu.parallel import shard_batch as jax_shard_batch
    from patchmatchnet_tpu.parallel.dryrun import DryRunModel as JaxDryRunModel
    from patchmatchnet_tpu.train.loop import (
        create_train_state,
        make_train_step,
    )
    from patchmatchnet_tpu.train.loop import make_optimizer as jax_optimizer

    batch = _masked_batch()
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "noise"}
    jax_model = JaxDryRunModel()
    variables = jax_model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                               arrays["images"], arrays["intrinsics"], arrays["extrinsics"],
                               arrays["depth_min"], arrays["depth_max"], train=True)
    variables = jax.tree.map(np.array, dict(variables))
    state_dict = state_dict_from_jax(variables)
    tx = jax_optimizer(LR)
    mesh = make_mesh(2)
    state = jax.device_put(create_train_state(jax_model, variables, tx), replicated_sharding(mesh))
    state, metrics, _ = make_train_step(jax_model, tx, with_grads=True)(
        state, jax_shard_batch(arrays, mesh), jax.device_put(jax.random.PRNGKey(7),
                                                            replicated_sharding(mesh)))
    want_params = state_dict_from_jax({"params": jax.tree.map(np.array, state.params)})
    grads = state_dict_from_jax({"params": jax.tree.map(np.array, metrics["grads"])})
    want_loss = float(metrics["loss"])
    jax.clear_caches()
    top = max(float(g.norm()) for g in grads.values())
    assert float(grads["conv0.bias"].norm()) < 1e-5 * top

    results = launch(_dryrun_rank, 2, (state_dict, batch), device_type="cpu",
                     timeout=RANK_TIMEOUT)
    loss, params = results[0].value
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    total = off = 0
    for name, got in params.items():
        diff = (got - want_params[name]).abs()
        assert float(diff.max()) < 3e-3, name
        if name != "conv0.bias":
            off += int((diff > 1e-5).sum())
            total += diff.numel()
    assert off / total < 1e-3, (off, total)


def _train_config(scene, out, epochs, resume=False):
    cfg = Config()
    cfg.data.input_folder = scene
    cfg.data.num_views = 2
    cfg.data.image_extension = ".png"
    cfg.data.batch_size = 2
    cfg.model.train_precision = "f32"
    cfg.train.output_folder = out
    cfg.train.epochs = epochs
    cfg.train.summary_freq = 1
    cfg.train.device = "cpu"
    # Adam's first moves are +-lr whatever a gradient's size, so at 1e-3 a
    # rounding-level difference of a near-zero gradient becomes a whole
    # step (the 4th loss then moves by 5e-3 relative); at 1e-6 rounding
    # stays rounding while the steps still move every parameter
    cfg.train.learning_rate = 1e-6
    cfg.train.resume = resume
    cfg.train.checkpoint_path = "" if resume else CKPT
    return cfg


def test_run_training_on_two_ranks(tmp_path):
    """(v) the 1-rank run's logged losses within (ii)'s loss bound, its
    checkpoint set and a module that loads strictly; then a 2-rank run
    resumed from the first epoch's checkpoint continues them."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=4, height=64, width=80, texture_scale=6.0)
    one = run_training(_train_config(scene, str(tmp_path / "one"), 2))
    launches = []
    two = run_training(_train_config(scene, str(tmp_path / "two"), 1), num_devices=2,
                       launches=launches)
    assert launches == [{}, {}]  # each rank's hand kernels: none on the CPU
    resumed = run_training(_train_config(scene, str(tmp_path / "two"), 2, resume=True),
                           num_devices=2)
    assert [r["step"] for r in two + resumed] == [r["step"] for r in one] == [0, 1, 2, 3]
    got, want = [r["loss"] for r in two + resumed], [r["loss"] for r in one]
    for g, w in zip(got, want):
        assert abs(g - w) / w < TIGHT[0], (got, want)
    files = sorted(f for f in os.listdir(tmp_path / "one") if not f.startswith("events."))
    assert files == sorted(f for f in os.listdir(tmp_path / "two")
                           if not f.startswith("events."))
    for epoch in (0, 1):
        a = torch.load(tmp_path / "one" / f"module_{epoch:06d}.pt", weights_only=True)
        b = torch.load(tmp_path / "two" / f"module_{epoch:06d}.pt", weights_only=True)
        assert list(a) == list(b)
        PatchmatchNet().load_state_dict(b, strict=True)
        ckpt = str(tmp_path / "two" / f"params_{epoch:06d}.ckpt.pt")
        assert list(load_any_checkpoint(ckpt)) == list(a)


def test_eval_on_two_ranks_writes_the_one_rank_maps(tmp_path):
    """(vi) 5 references at a global batch of 2: the last batch is short,
    and rank 1 has no row of it (the JAX estimator refuses such a batch:
    its sharding needs the device count to divide it)."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=5, height=64, width=80, texture_scale=6.0)
    for n in ("1", "2"):
        cli.main(["eval", "--input_folder", scene, "--output_folder", str(tmp_path / n),
                  "--checkpoint_path", CKPT, "--num_views", "2", "--batch_size", "2",
                  "--num_devices", n, "--device", "cpu", "--image_extension", ".png",
                  "--geo_mask_thres", "1", "--seed", "3"])
    for view in range(5):
        for folder in ("depth_est", "confidence"):
            name = os.path.join(folder, f"{view:08d}.pfm")
            a, b = read_map(str(tmp_path / "1" / name)), read_map(str(tmp_path / "2" / name))
            assert np.array_equal(a, b), name
    with open(tmp_path / "1" / "fused.ply", "rb") as a, open(tmp_path / "2" / "fused.ply", "rb") as b:
        assert a.read() == b.read()


def test_sharded_loader_loads_only_its_rows(tmp_path):
    """The ranks' rows of each global batch, in rank order, are the 1-rank
    loader's batch (order and robust-train views included), and a rank
    decodes only its own samples; a short last batch splits ceil-first."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=7, height=16, width=24)

    class Counting(MVSDataset):
        loaded: list

        def __getitem__(self, idx):
            self.loaded.append(idx)
            return super().__getitem__(idx)

    def loader(shard):
        ds = Counting(scene, 3, ".png", robust_train=True, seed=4)
        ds.loaded = []
        ld = BatchLoader(ds, 3, shuffle=True, seed=4, shard=shard, num_threads=1)
        ld.set_epoch(2)
        return ds, ld

    _, whole = loader(None)
    want = list(whole)
    got, loaded = [], []
    for rank in range(2):
        ds, ld = loader((rank, 2))
        got.append(list(ld))
        loaded.append(sorted(ds.loaded))
        assert len(got[-1]) == len(ld) == (3 if rank == 0 else 2)
        assert len(ds.loaded) == sum(len(b["filename"]) for b in got[-1])
    assert sorted(loaded[0] + loaded[1]) == list(range(7))  # each sample decoded once
    for i, batch in enumerate(want):
        parts = [g[i] for g in got if i < len(g)]
        assert [p["rows"] for p in parts] == [(0, len(batch["filename"])), (2, 3)][:len(parts)]
        for key in ("images", "intrinsics", "filename"):
            joined = sum((list(p[key]) for p in parts), [])
            assert len(joined) == len(batch[key])
            assert all(np.array_equal(x, y) for x, y in zip(joined, list(batch[key]))), key
    assert [rank_rows(1, r, 2) for r in (0, 1)] == [slice(0, 1), slice(1, 1)]


def _failing_rank(group: Group):
    if group.rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()  # would wait for rank 1 for ever


def test_launch_raises_and_stops_the_other_ranks():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        launch(_failing_rank, 2, device_type="cpu", timeout=RANK_TIMEOUT)


def _unequal_rows_rank(group: Group):
    bn = BatchNorm(2)
    bn.group = group.process_group
    bn(torch.ones(1 + group.rank, 2, 3, 3))


def test_sync_batch_norm_refuses_unequal_shares():
    """Sync-BN averages the ranks' means, so every rank must hold as many
    elements; a rank with another share raises rather than skewing them."""
    with pytest.raises(RuntimeError, match="sync-BN needs the same number of elements"):
        launch(_unequal_rows_rank, 2, device_type="cpu", timeout=RANK_TIMEOUT)


def test_refusals(tmp_path):
    """(vii) a batch the ranks do not divide, NCCL with a card repeated,
    more CUDA ranks than cards (before any rank starts or any file is
    written), and a batch shard_batch cannot split."""
    cfg = _train_config(str(tmp_path), str(tmp_path / "out"), 1)
    cfg.data.batch_size = 3
    with pytest.raises(ValueError, match="must be divisible by 2 devices"):
        run_training(cfg, num_devices=2)
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="NCCL takes one rank per GPU"):
        resolve_devices(2, devices=["cuda:0", "cuda:0"], backend="nccl")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"device_count\\(\\) is {cards}"):
        launch(_failing_rank, cards + 1, device_type="cuda")
    group = Group(0, 2, CPU, None)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        shard_batch({"images": np.zeros((3, 1))}, group)


def _batch_norm_before(bn, x):
    """BatchNorm.forward as the port had it before sync-BN."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if bn.training:
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(0.9).add_(0.1 * mean)
            bn.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + 1e-5) * bn.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
        return y.to(x.dtype)
    scale = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
    bias = bn.bias - bn.running_mean * scale
    return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_without_a_group_is_unchanged(dtype, train):
    """(viii) output, input and parameter gradients and running statistics
    equal to the bit."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(2, 6, 5, 7, 3, generator=gen) * 3 + 1).to(dtype)
    outs = []
    for forward in (lambda bn, x: bn(x), _batch_norm_before):
        bn = BatchNorm(6)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(6, generator=torch.Generator().manual_seed(1)))
            bn.running_var.fill_(2.0)
        bn.train(train)
        xi = x.clone().requires_grad_(True)
        y = forward(bn, xi)
        y.float().square().sum().backward()
        outs.append((y, xi.grad, bn.weight.grad, bn.running_mean, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
