"""The port stands alone: it imports no JAX, builds its own host library,
its wrappers take the plain versions only for CPU tensors, and asking for
CUDA without CUDA raises."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from patchmatchnet_torch.infer import DepthEstimator
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.ops import (
    coord_group_corr,
    eval_grid_score,
    gather_lanes,
    gather_rows,
    gather_sublanes,
    neighbor_group_corr,
    warp_group_corr,
    warp_group_corr_views,
)
from patchmatchnet_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


SCRIPTS = ["chip_smoke.py", os.path.join("tools", "dev", "profile_torch_main.py")]
# every module of the port, the command line (cli.py, __main__.py) included
PACKAGE_FILES = sorted(
    os.path.relpath(os.path.join(root, name), REPO)
    for root, _, names in os.walk(os.path.join(REPO, "patchmatchnet_torch"))
    for name in names if name.endswith(".py"))
# `bench` and `tools` are the JAX side's root bench.py and tools/dev/ scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "patchmatchnet_tpu", "scene_utils", "tests", "bench",
             "tools")


def _script_imports(path):
    """Every absolute module a script imports, at any depth of its code."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    """Neither the port (its bench and measurement tools, the trainer
    comparison, roofline, gather tool, fusion, DTU protocol, command line, converter,
    raw DTU dataset and profiling too) nor the scripts that drive
    it (chip_smoke.py and the profiling tool, including imports inside their
    functions) name or load a module of JAX, flax or the JAX package."""
    assert "patchmatchnet_torch/cli.py" in PACKAGE_FILES
    assert "patchmatchnet_torch/__main__.py" in PACKAGE_FILES
    assert "patchmatchnet_torch/bench.py" in PACKAGE_FILES
    assert "patchmatchnet_torch/dev/bf16_train_compare.py" in PACKAGE_FILES
    assert "patchmatchnet_torch/dev/roofline.py" in PACKAGE_FILES
    assert "patchmatchnet_torch/native.py" in PACKAGE_FILES
    named = set().union(*(_script_imports(p) for p in SCRIPTS + PACKAGE_FILES))
    assert not sorted(m for m in named if m.split(".")[0] in FORBIDDEN)
    modules = sorted(m for m in named if m.split(".")[0] == "patchmatchnet_torch")
    proc = _run(
        "import importlib, sys\n"
        "import patchmatchnet_torch, patchmatchnet_torch.compat, patchmatchnet_torch.ops\n"
        "import patchmatchnet_torch.models, patchmatchnet_torch.infer, patchmatchnet_torch.data\n"
        "import patchmatchnet_torch.train, patchmatchnet_torch.utils, patchmatchnet_torch.config\n"
        "import patchmatchnet_torch.dev.bench_gather, patchmatchnet_torch.bench\n"
        "import patchmatchnet_torch.dev.bench_dataset_configs\n"
        "import patchmatchnet_torch.dev.bf16_accuracy, patchmatchnet_torch.dev.bf16_scene_check\n"
        "import patchmatchnet_torch.dev.bf16_train_compare, patchmatchnet_torch.dev.roofline\n"
        "import patchmatchnet_torch.geometry, patchmatchnet_torch.eval_protocols\n"
        "import patchmatchnet_torch.infer.fusion, patchmatchnet_torch.cli\n"
        "import patchmatchnet_torch.__main__, patchmatchnet_torch.compat.torch_convert\n"
        "import patchmatchnet_torch.data.dtu_legacy, patchmatchnet_torch.utils.profiling\n"
        "import patchmatchnet_torch.native\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_wrappers_return_plain_version_on_cpu():
    """On CPU tensors each wrapper is its plain version, exactly, and no
    launch is counted."""
    from patchmatchnet_torch.ops import (
        coord_group_corr_reference,
        eval_grid_score_reference,
        gather_lanes_reference,
        gather_rows_reference,
        gather_sublanes_reference,
        neighbor_group_corr_reference,
        warp_group_corr_reference,
        warp_group_corr_views_reference,
    )
    from patchmatchnet_torch.ops.warp import warp_coords, warp_proj_coeffs

    gen = torch.Generator().manual_seed(0)
    h, w, c, g, d = 8, 12, 16, 4, 3
    src, ref = torch.randn((2, 1, h, w, c), generator=gen)
    proj = torch.eye(4).repeat(2, 1, 1)
    proj[:, :3, :3] *= 10.0
    proj[1, 0, 3] = 2.0
    mat12 = warp_proj_coeffs(proj[1:], proj[:1])
    depth = 4.0 + torch.rand((1, d, h, w), generator=gen)
    grid = tuple(torch.rand((1, 9, h, w), generator=gen) * 2 - 1 for _ in range(2))
    x_norm = torch.rand((1, h, w, d), generator=gen)
    cost = torch.randn((1, h, w, d), generator=gen)
    fw = torch.rand((1, 9, h, w), generator=gen)
    stack = torch.stack([src, ref], 1)
    mats = torch.stack([mat12, mat12], 1)
    vw = torch.rand((1, 2, h, w), generator=gen)
    ix, iy = warp_coords(mat12, depth, h, w)
    before = cuda_build.launch_counts()
    assert torch.equal(warp_group_corr(src, mat12, depth, ref, g),
                       warp_group_corr_reference(src, mat12, depth, ref, g))
    assert torch.equal(neighbor_group_corr(ref, grid, g),
                       neighbor_group_corr_reference(ref, grid, g))
    assert torch.equal(eval_grid_score(x_norm, cost, grid, fw, 0.0125),
                       eval_grid_score_reference(x_norm, cost, grid, fw, 0.0125))
    assert torch.equal(warp_group_corr_views(stack, mats, depth, ref, vw, g),
                       warp_group_corr_views_reference(stack, mats, depth, ref, vw, g))
    assert torch.equal(coord_group_corr(src, ix, iy, ref, g),
                       coord_group_corr_reference(src, ix, iy, ref, g))
    win = torch.randn((3, 8, 12), generator=gen)
    lanes = torch.randint(0, 12, (3, 8, 12), generator=gen, dtype=torch.int32)
    sublanes = torch.randint(0, 8, (3, 8, 12), generator=gen, dtype=torch.int32)
    rows = torch.randint(0, 8, (3, 5), generator=gen, dtype=torch.int32)
    assert torch.equal(gather_lanes(win, lanes), gather_lanes_reference(win, lanes))
    assert torch.equal(gather_sublanes(win, sublanes), gather_sublanes_reference(win, sublanes))
    assert torch.equal(gather_rows(win, rows), gather_rows_reference(win, rows))
    assert cuda_build.launch_counts() == before


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA; this machine has CUDA")


def test_cuda_request_without_cuda_raises():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_build.kernel_library()
    with pytest.raises(RuntimeError, match="CUDA"):
        DepthEstimator(PatchmatchNet(), device="cuda")


def test_fusion_cuda_request_without_cuda_raises(tmp_path):
    """filter_and_fuse runs on CUDA unless asked for the CPU, and raises
    without CUDA before it reads anything."""
    _no_cuda()
    from patchmatchnet_torch.infer import filter_and_fuse

    with pytest.raises(RuntimeError, match="CUDA"):
        filter_and_fuse(str(tmp_path), str(tmp_path), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        filter_and_fuse(str(tmp_path), str(tmp_path), verbose=False, device="cuda:0")


@pytest.mark.parametrize("kernel", ["warp", "neighbor", "eval", "views", "coord", "lanes",
                                    "sublanes", "rows"])
def test_wrappers_refuse_non_cpu_non_cuda_tensors(kernel):
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches a plain version: the wrapper raises before any launch."""
    meta = {"device": "meta"}
    f = torch.empty((1, 8, 12, 16), **meta)
    grid = (torch.empty((1, 9, 8, 12), **meta), torch.empty((1, 9, 8, 12), **meta))
    before = cuda_build.launch_counts()
    with pytest.raises(ValueError, match="CPU .* or on a CUDA"):
        if kernel == "warp":
            warp_group_corr(f, torch.empty((1, 12), **meta),
                            torch.empty((1, 4, 8, 12), **meta), f, 4)
        elif kernel == "neighbor":
            neighbor_group_corr(f, grid, 4)
        elif kernel == "views":
            warp_group_corr_views(f[:, None], torch.empty((1, 1, 12), **meta),
                                  torch.empty((1, 4, 8, 12), **meta), f,
                                  torch.empty((1, 1, 8, 12), **meta), 4)
        elif kernel == "coord":
            coord_group_corr(f, grid[0], grid[1], f, 4)
        elif kernel in ("lanes", "sublanes"):
            gather = gather_lanes if kernel == "lanes" else gather_sublanes
            gather(torch.empty((2, 8, 12), **meta),
                   torch.empty((2, 8, 12), dtype=torch.int32, **meta))
        elif kernel == "rows":
            gather_rows(torch.empty((2, 8, 12), **meta),
                        torch.empty((2, 5), dtype=torch.int32, **meta))
        else:
            eval_grid_score(torch.empty((1, 8, 12, 4), **meta),
                            torch.empty((1, 8, 12, 4), **meta), grid,
                            torch.empty((1, 9, 8, 12), **meta), 0.025)
    assert cuda_build.launch_counts() == before


def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and when it is alone in a directory."""
    _no_cuda()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_f32_forward_turns_tf32_off_and_restores_it():
    """The f32 model runs with TF32 off (cuDNN convs and CUDA matmuls) and
    leaves the global flags as it found them."""
    from patchmatchnet_torch.models.net import full_f32

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def test_host_library_is_the_ports_own(tmp_path, monkeypatch):
    """No file of the port (its C++ and CUDA sources too) nor chip_smoke.py
    names the JAX package's `native/` directory, and only
    `patchmatchnet_torch/native.py` names `libhostops.so`, which it builds
    under `build/hostops/` from `patchmatchnet_torch/csrc/hostops.cpp`, the
    one file its build reads (shown in a copy of the module and its source,
    in a tree without the repo's `native/`)."""
    import importlib.util
    import re

    from patchmatchnet_torch import native

    sources = [os.path.relpath(p, REPO) for p in sorted((native.SOURCE.parent).iterdir())
               if p.suffix in (".cpp", ".cu", ".cuh")]
    assert "patchmatchnet_torch/csrc/hostops.cpp" in sources
    for path in SCRIPTS + PACKAGE_FILES + sources:
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        assert not re.search(r"(?<![\w.])native[/\\]", text), path
        if path != "patchmatchnet_torch/native.py":
            assert "libhostops" not in text, path
    assert native.SOURCE == pathlib.Path(REPO, "patchmatchnet_torch", "csrc", "hostops.cpp")
    assert native.library_path().is_relative_to(pathlib.Path(REPO, "build", "hostops"))

    pkg = tmp_path / "patchmatchnet_torch"
    (pkg / "csrc").mkdir(parents=True)
    shutil.copy(native.__file__, pkg / "native.py")
    shutil.copy(native.SOURCE, pkg / "csrc" / "hostops.cpp")
    spec = importlib.util.spec_from_file_location("hostops_copy", pkg / "native.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    commands = []
    run = subprocess.run

    def recording_run(argv, *args, **kwargs):
        commands.append(list(argv))
        return run(argv, *args, **kwargs)

    monkeypatch.setattr(subprocess, "run", recording_run)
    assert copy.get_lib().hostops_version() == 1
    assert len(commands) == 1
    argv = commands[0]
    inputs = [a for i, a in enumerate(argv[1:], 1)
              if not a.startswith("-") and argv[i - 1] != "-o"]
    assert inputs == [str(pkg / "csrc" / "hostops.cpp")]
    assert copy.library_path().is_relative_to(tmp_path / "build" / "hostops")
