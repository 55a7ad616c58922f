"""The port's gathers (D1-D5 of tools/dev/bench_gather.py) against the JAX
tool's Pallas kernels, run in interpret mode, and against
`jnp.take_along_axis`, on the same numpy inputs. On the CPU the wrappers run
their plain versions. A gather is exact, so every comparison is to the bit
(max abs error 0).

D1 is a defect of the JAX tool, not of the port: `_pallas_lane_kernel`
writes only `out_ref[0]`, so with 8 blocks per grid step (D1) it writes the
first block of each 8 and leaves the other 7 unwritten (the tool's note at
:109-110 says so, and the tool times D2 instead). The port computes the full
take_along_axis; the D1 test compares only the blocks the JAX kernel writes.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from patchmatchnet_torch.dev import bench_gather
from patchmatchnet_torch.ops import (
    gather_lanes,
    gather_lanes_reference,
    gather_rows,
    gather_rows_reference,
    gather_sublanes,
    gather_sublanes_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """tools/dev/bench_gather.py, loaded from its file (it is no package)."""
    path = os.path.join(REPO, "tools", "dev", "bench_gather.py")
    spec = importlib.util.spec_from_file_location("jax_bench_gather", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spec(block):
    rest = (0,) * (len(block) - 1)
    return pl.BlockSpec(block, lambda i: (i, *rest), memory_space=pltpu.VMEM)


def _pallas(kernel, blocks_per_step, out_shape, *args):
    """The tool's pallas_call pattern in interpret mode: a grid over the
    leading axis, `blocks_per_step` blocks of every operand per step."""
    n = out_shape[0]
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        grid=(n // blocks_per_step,),
        in_specs=[_spec((blocks_per_step, *a.shape[1:])) for a in args],
        out_specs=_spec((blocks_per_step, *out_shape[1:])),
        interpret=True,
    )(*args)
    return np.asarray(out)


def _block_inputs(shape, index_size, seed):
    rng = np.random.default_rng(seed)
    win = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, index_size, shape).astype(np.int32)
    return win, idx


@pytest.mark.parametrize("case,shape", [("D2", (16, 32, 128)), ("D3", (4, 256, 128))])
def test_lane_gather_equals_pallas_lane_kernel(jax_tool, case, shape):
    """D2 ([32,128] blocks) and D3 ([256,128]), one block per grid step,
    through the tool's own `_pallas_lane_kernel`."""
    win, idx = _block_inputs(shape, shape[2], seed=1)
    want = _pallas(jax_tool._pallas_lane_kernel, 1, shape, win, idx)
    got = gather_lanes(torch.from_numpy(win), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jnp.take_along_axis(win, idx, axis=2)))


def test_d1_lane_gather_equals_pallas_on_the_blocks_it_writes(jax_tool):
    """D1: 8 blocks per grid step. The JAX kernel writes block 0 of each 8
    (here blocks 0 and 8 of 16); only those are compared. The port's result
    is the full take_along_axis on every block."""
    shape = (16, 32, 128)
    win, idx = _block_inputs(shape, shape[2], seed=2)
    want = _pallas(jax_tool._pallas_lane_kernel, 8, shape, win, idx)
    got = gather_lanes(torch.from_numpy(win), torch.from_numpy(idx)).numpy()
    written = [n for n in range(shape[0]) if n % 8 == 0]
    not_compared = [n for n in range(shape[0]) if n not in written]
    assert written == [0, 8] and len(not_compared) == 14
    np.testing.assert_array_equal(got[written], want[written])
    np.testing.assert_array_equal(got, np.take_along_axis(win, idx, axis=2))


def _sublane_kernel(win_ref, idx_ref, out_ref):
    """The tool's D4 kernel (a closure in `bench_pallas_sublane_gather`)."""
    out_ref[0] = jnp.take_along_axis(win_ref[0], idx_ref[0], axis=0)


def test_d4_sublane_gather_equals_pallas_and_take_along_axis():
    shape = (16, 8, 128)
    win, idx = _block_inputs(shape, shape[1], seed=3)
    want = _pallas(_sublane_kernel, 1, shape, win, idx)
    got = gather_sublanes(torch.from_numpy(win), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jnp.take_along_axis(win, idx, axis=1)))


def _onehot_kernel(p, kw):
    """The tool's D5 kernel (a closure in `bench_onehot_matmul`): the row
    gather as a one-hot [P, KW] x [KW, C4] product."""

    def kernel(win_ref, idx_ref, out_ref):
        iota = jax.lax.broadcasted_iota(jnp.int32, (p, kw), 1)
        oh = (iota == idx_ref[0]).astype(jnp.float32)
        out_ref[0] = jnp.dot(oh, win_ref[0], preferred_element_type=jnp.float32)

    return kernel


def test_d5_row_gather_equals_onehot_pallas_and_take_along_axis():
    n, p, kw, c4 = 4, 16, 128, 64
    rng = np.random.default_rng(4)
    win = rng.standard_normal((n, kw, c4)).astype(np.float32)
    idx = rng.integers(0, kw, (n, p, 1)).astype(np.int32)  # the tool's [N, P, 1]
    want = _pallas(_onehot_kernel(p, kw), 1, (n, p, c4), win, idx)
    got = gather_rows(torch.from_numpy(win), torch.from_numpy(idx[..., 0].copy())).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jnp.take_along_axis(win, idx, axis=1)))


@pytest.mark.parametrize("payload", ["f32", "bf16"])
def test_xla_row_gather_equals_take_along_axis(payload):
    """The tool's `xla` section: a [1, rows, C] table read at indices
    jittered by +-300 rows around each point's own row, as
    `jnp.take_along_axis(..., axis=1)` computes it."""
    hw, c4, npts = 700, 16, 2048
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.random((1, hw, c4), dtype=np.float32))
    jnp_dtype = jnp.float32
    if payload == "bf16":
        table, jnp_dtype = table.to(torch.bfloat16), jnp.bfloat16
    jit = rng.integers(-300, 300, npts)
    idx = np.clip(np.arange(npts) % hw + jit, 0, hw - 1).astype(np.int32)[None]
    got = gather_rows(table, torch.from_numpy(idx))
    assert got.dtype == table.dtype and got.shape == (1, npts, c4)
    want = jnp.take_along_axis(jnp.asarray(table.float().numpy(), jnp_dtype), idx[..., None],
                               axis=1, mode="promise_in_bounds")
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


SMALL = {
    "xla": {"cases": (("tiny", 700, 16, 2048),)},
    "lane": {"n": 4},
    "biglane": {"n": 2},
    "sublane": {"n": 4},
    "onehot": {"n": 2, "p": 16, "cases": ((128, 64),)},
}


@pytest.mark.parametrize("section", list(bench_gather.SECTIONS))
def test_bench_section_runs_on_cpu(section, capsys):
    """Each section of the port's tool finishes on the CPU at a small shape,
    prints its section and returns its cases, each equal to its plain version
    and torch.gather."""
    cases = bench_gather.SECTIONS[section](device="cpu", **SMALL[section])
    out = capsys.readouterr().out
    assert out.startswith(f"== {section}") and "torch.gather" in out
    assert cases and all(c["max_abs_err"] == 0.0 for c in cases)
    for c in cases:
        assert c["bytes"] > 0
        assert min(c["ms"], c["plain_ms"], c["library_ms"]) > 0
        assert "device_ms" not in c  # a device time is taken on the card only
    if section == "onehot":
        assert "one-hot bmm" in out and cases[0]["bmm_ms"] > 0


def test_bench_cli_refuses_unknown_sections_and_the_cpu():
    assert bench_gather.main(["wide"]) == 2
    assert bench_gather.main(["lane", "xla"]) == 2
    if not torch.cuda.is_available():
        assert bench_gather.main(["lane"]) == 1


@pytest.mark.parametrize("bad", [-1, "size"])
@pytest.mark.parametrize("kind", ["lanes", "sublanes", "rows"])
def test_plain_versions_raise_on_an_index_out_of_range(kind, bad):
    win = torch.zeros((2, 8, 12))
    idx = torch.zeros((2, 8) if kind == "rows" else (2, 8, 12), dtype=torch.int32)
    size = {"lanes": 12, "sublanes": 8, "rows": 8}[kind]
    idx[1, 3] = size if bad == "size" else bad
    fn = {"lanes": gather_lanes_reference, "sublanes": gather_sublanes_reference,
          "rows": gather_rows_reference}[kind]
    with pytest.raises(IndexError, match="out of range"):
        fn(win, idx)


def test_plain_versions_refuse_other_index_types_and_shapes():
    win = torch.zeros((2, 8, 12))
    with pytest.raises(TypeError, match="int32"):
        gather_lanes_reference(win, torch.zeros((2, 8, 12), dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        gather_sublanes_reference(win, torch.zeros((2, 8, 11), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[N, P\]"):
        gather_rows_reference(win, torch.zeros((2, 8, 1), dtype=torch.int32))
