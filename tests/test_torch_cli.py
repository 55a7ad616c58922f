"""The port's command line (`python -m patchmatchnet_torch`) on the CPU.

- Each ported subcommand's parser has the JAX command line's flags: the
  same names (and aliases), destinations, defaults, choices, types, nargs,
  required flags and actions; only `--device` is extra.
- `eval --device cpu` on a 64x80 4-view synthetic scene writes the maps
  that `DepthEstimator` + `save_depth_maps` write with the same seed, and
  the `fused.ply` and masks that `filter_and_fuse` writes, byte for byte;
  `fuse --device cpu` over those maps writes the same `fused.ply`.
- `eval --device cpu` at the default `--num_views 20` on a 21-view scene
  (view 0 the reference, every other view its source, so K6's plain
  version takes V = 20, two of the kernel's view chunks on the card)
  writes the maps of
  `DepthEstimator` + `save_depth_maps`, byte for byte; the port's f32
  forward at V = 20 meets the JAX model's (its default per-view path) at
  the golden bounds, with the same weights and noise.
- `train --device cpu` for one epoch writes the checkpoint set, a config
  that loads back, a finite loss and a trace; `--dataset dtu_legacy` builds
  its loaders on the raw DTU layout.
- `convert` writes the port's state dict of a reference `.ckpt`.
- `scripts/eval_torch.sh` has `scripts/eval.sh`'s four presets, each with
  its flags letter for letter; `run_eth3d` with `--device cpu` over a
  5-view 64x80 scan writes the maps of `DepthEstimator` +
  `save_depth_maps` byte for byte, and a fused.ply with points.
- A batch size that `--num_devices` does not divide is refused before any
  work, with the JAX messages; so is `--device cuda` without CUDA
  (tests/test_torch_parallel.py runs `--num_devices 2`).
- Each host tool's subcommand runs its tool (tests/test_torch_tools.py
  holds their files against the JAX tools'; tests/test_torch_export.py
  runs `export` and `eval --input_type module`).
"""

import argparse
import filecmp
import json
import math
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu import cli as jax_cli
from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.config import Config as JaxConfig
from patchmatchnet_torch import cli
from patchmatchnet_torch.compat import convert_torch_state_dict
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import (
    BatchLoader,
    MVSDataset,
    make_synthetic_scene,
    read_ply,
    save_pair_file,
    save_ply,
)
from patchmatchnet_torch.infer import DepthEstimator, FusionConfig, filter_and_fuse, save_depth_maps
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train.driver import load_any_checkpoint
from tests.test_dtu_legacy import raw_dtu  # noqa: F401  (the fixture)
from tests.test_tools import _write_synthetic_colmap
from tests.test_torch_convert import reference_state_dict
from tests.test_torch_model import _check_against
from tests.test_torch_tools import _eth3d, _raw_dtu, _scene_with_maps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")
SCENE_ARGS = ["--num_views", "3", "--image_extension", ".png"]
FUSION_ARGS = ["--geo_mask_thres", "2", "--photo_thres", "0.3"]


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _jax_parser(command, monkeypatch):
    """The parser the JAX command line builds for `command`, caught at its
    parse_args."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as caught:
        jax_cli.COMMANDS[command]([])
    monkeypatch.undo()
    return caught.value.parser


def _flags(parser):
    return {a.option_strings[0]: (tuple(a.option_strings), a.dest, a.default, a.choices, a.type,
                                  a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("command", ["train", "eval", "fuse", "convert", "export"])
def test_parser_matches_jax(command, monkeypatch):
    ours, ref = _flags(cli.build_parser(command)), _flags(_jax_parser(command, monkeypatch))
    extra = set(ours) - set(ref)
    assert extra == ({"--device"} if command != "convert" else set())
    assert {k: ours[k] for k in ref} == ref


def test_help_lists_ported_and_missing_commands(capsys):
    cli.main(["--help"])
    out = capsys.readouterr().out
    assert "commands: train, eval, fuse, convert" in out
    for name in cli.NOT_PORTED:
        assert name in out


def test_config_json_loads_from_either_package(tmp_path):
    ref = JaxConfig()
    ref.model.evaluate_neighbors = (17, 9, 17)
    ref.data.dataset = "dtu_legacy"
    ref.fuse.geo_mask_thres = 3
    path = str(tmp_path / "config.json")
    ref.save(path)
    cfg = Config.load(path)
    assert cfg.model.evaluate_neighbors == (17, 9, 17) and cfg.data.dataset == "dtu_legacy"
    assert cfg.fuse.geo_mask_thres == 3 and cfg.train.device == "cuda"
    for section in ("model", "data", "fuse"):
        assert vars(getattr(cfg, section)) == vars(getattr(ref, section))
    assert Config.from_json(cfg.to_json()) == cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_scene"))
    make_synthetic_scene(root, num_views=4, height=64, width=80, texture_scale=6.0)
    return root


def _same_files(a, b, names):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_eval_and_fuse_match_the_library(scene, tmp_path):
    out = str(tmp_path / "cli")
    cli.main(["eval", "--input_folder", scene, "--output_folder", out, "--checkpoint_path", CKPT,
              "--device", "cpu", "--seed", "3", *SCENE_ARGS, *FUSION_ARGS])

    ref = str(tmp_path / "library")
    model = PatchmatchNet(compute_dtype=torch.bfloat16)  # the default --precision bf16
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    written = save_depth_maps(DepthEstimator(model, "cpu"),
                              BatchLoader(MVSDataset(scene, 3, ".png"), 1), ref, seed=3)
    assert written == 4
    filter_and_fuse(scene, ref, "", FusionConfig(geo_mask_thres=2, photo_thres=0.3,
                                                 image_extension=".png"), device="cpu")
    maps = [os.path.join(folder, f"{v:08d}.pfm") for folder in ("depth_est", "confidence")
            for v in range(4)]
    masks = [os.path.join("mask", f"{v:08d}_{kind}.png") for v in range(4)
             for kind in ("photo", "geo", "final")]
    _same_files(out, ref, maps + masks + ["fused.ply"])
    assert read_ply(os.path.join(out, "fused.ply"))[0].shape[0] > 100  # as test_cli_e2e.py

    # fuse alone, over a copy of the maps
    fused = str(tmp_path / "fuse")
    for folder in ("depth_est", "confidence"):
        shutil.copytree(os.path.join(ref, folder), os.path.join(fused, folder))
    cli.main(["fuse", "--input_folder", scene, "--output_folder", fused, "--device", "cpu",
              "--image_extension", ".png", *FUSION_ARGS])
    _same_files(fused, ref, masks + ["fused.ply"])


@pytest.fixture(scope="module")
def scene21(tmp_path_factory):
    """21 views; pair.txt lists view 0 as the one reference, with the 20
    others as its sources (one map a run keeps the case short)."""
    root = str(tmp_path_factory.mktemp("cli_scene21"))
    make_synthetic_scene(root, num_views=21, height=64, width=80, texture_scale=6.0)
    save_pair_file(os.path.join(root, "pair.txt"), [(0, [(s, 10.0 - s) for s in range(1, 21)])])
    return root


def test_eval_at_the_default_20_sources_matches_the_library(scene21, tmp_path):
    out = str(tmp_path / "cli")
    cli.main(["eval", "--input_folder", scene21, "--output_folder", out, "--checkpoint_path",
              CKPT, "--device", "cpu", "--seed", "3", "--image_extension", ".png",
              "--output_type", "depth"])
    assert cli.build_parser("eval").get_default("num_views") == 20

    ref = str(tmp_path / "library")
    model = PatchmatchNet(compute_dtype=torch.bfloat16)  # the default --precision bf16
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    dataset = MVSDataset(scene21, 20, ".png")
    assert dataset[0]["images"].shape[0] == 21
    written = save_depth_maps(DepthEstimator(model, "cpu"), BatchLoader(dataset, 1), ref, seed=3)
    assert written == 1
    _same_files(out, ref, [os.path.join(folder, "00000000.pfm")
                           for folder in ("depth_est", "confidence")])


def test_forward_at_20_sources_matches_jax(scene21):
    sample = MVSDataset(scene21, 20, ".png")[0]
    arrays = [np.asarray(sample[k], np.float32)[None] for k in
              ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    noise = np.random.default_rng(0).random((1, 48, 8, 10), np.float32)
    model = PatchmatchNet()  # f32
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    with torch.inference_mode():
        depth, conf, dp = model(*[torch.from_numpy(a) for a in arrays],
                                init_noise=torch.from_numpy(noise))
    ours = (depth.numpy(), conf.numpy(), {s: [d.numpy() for d in v] for s, v in dp.items()})
    jmodel = JaxPatchmatchNet()
    fwd = jax.jit(lambda v, *a, noise: jmodel.apply(v, *a, train=False, init_noise=noise))
    jd, jc, jdp = fwd(load_variables(CKPT), *[jnp.asarray(a) for a in arrays],
                      noise=jnp.asarray(noise))
    ref = (np.asarray(jd), np.asarray(jc), jax.tree.map(np.asarray, jdp))
    jax.clear_caches()
    _check_against(ours, ref, float(sample["depth_max"] - sample["depth_min"]))


def test_train_one_epoch(scene, tmp_path):
    out = str(tmp_path / "train")
    cli.main(["train", "--input_folder", scene, "--output_folder", out, "--device", "cpu",
              "--train_list", "__missing__", "--test_list", "__missing__",
              "--checkpoint_path", CKPT, "--epochs", "1", "--batch_size", "2",
              "--summary_freq", "1", "--profile_dir", str(tmp_path / "trace"), *SCENE_ARGS])
    for name in ("params_000000.ckpt.pt", "module_000000.pt", "config.json", "metrics.jsonl"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    assert len(train) == 2 and all(math.isfinite(r["loss"]) for r in train)
    # one timing per logged step, from the driver's PhaseTimer
    assert all(r["step_ms"] > 0 and r["data_ms"] >= 0 for r in train)
    assert not any(k.startswith("time-") for r in train for k in r)
    assert any(r["mode"] == "full_test" for r in records)
    cfg = Config.load(os.path.join(out, "config.json"))
    assert cfg.train.device == "cpu" and cfg.data.num_views == 3 and cfg.train.epochs == 1
    assert os.path.isfile(str(tmp_path / "trace" / "trace.json"))
    # the module and the training checkpoint load as inference weights
    module, ckpt = (load_any_checkpoint(os.path.join(out, n))
                    for n in ("module_000000.pt", "params_000000.ckpt.pt"))
    assert all(torch.equal(module[k], ckpt[k]) for k in module)
    PatchmatchNet().load_state_dict(module, strict=True)


def test_train_on_the_raw_dtu_layout(raw_dtu, tmp_path):  # noqa: F811
    """`--dataset dtu_legacy` reads the raw layout (no epochs run: 640x512
    steps are too slow for the CPU tier)."""
    root, list_file = raw_dtu
    out = str(tmp_path / "legacy")
    cli.main(["train", "--input_folder", root, "--output_folder", out, "--device", "cpu",
              "--dataset", "dtu_legacy", "--train_list", list_file, "--test_list", list_file,
              "--num_views", "3", "--batch_size", "4", "--epochs", "0"])
    cfg = Config.load(os.path.join(out, "config.json"))
    assert cfg.data.dataset == "dtu_legacy" and cfg.data.num_views == 3


def test_convert_writes_the_port_state_dict(tmp_path):
    sd = reference_state_dict(seed=2)
    src, dst = str(tmp_path / "params_000007.ckpt"), str(tmp_path / "params_000007.pt")
    torch.save({"model": sd}, src)
    cli.main(["convert", "--checkpoint_path", src, "--output", dst])
    got, want = torch.load(dst, weights_only=True), convert_torch_state_dict(sd)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    for path in (src, dst):  # either file as eval's --checkpoint_path
        loaded = load_any_checkpoint(path)
        assert all(torch.equal(loaded[k], want[k]) for k in want)


@pytest.mark.parametrize("argv,message", [
    (["eval", "--batch_size", "3", "--num_devices", "2"],
     "batch_size 3 must be a multiple of --num_devices 2"),
    (["train", "--batch_size", "3", "--num_devices", "2"],
     "batch_size 3 must be divisible by 2 devices"),
])
def test_refused_options_raise(argv, message, tmp_path):
    """A global batch the ranks do not divide, with the JAX command line's
    messages (its eval's and its training driver's)."""
    required = {"eval": ["--input_folder", str(tmp_path), "--checkpoint_path", CKPT],
                "train": ["--input_folder", str(tmp_path), "--train_list", "x",
                          "--test_list", "x"]}
    with pytest.raises(ValueError, match=message):
        cli.main(argv + required.get(argv[0], []) + ["--device", "cpu"] * (argv[0] in required))
    assert not os.listdir(tmp_path)  # refused before any work


@pytest.mark.parametrize("command", ["colmap-import", "colmap-export", "convert-dtu",
                                     "convert-eth3d", "visualize"])
def test_tool_subcommands_run(command, tmp_path, capsys):
    src, out = str(tmp_path / "in"), str(tmp_path / "out")
    scans = os.path.join(src, "scans.txt")
    if command == "colmap-import":
        _write_synthetic_colmap(src)
        argv = ["--input_folder", src, "--output_folder", out, "--model_ext", ".txt"]
        want = os.path.join(out, "pair.txt")
    elif command == "colmap-export":
        _scene_with_maps(src)
        argv = ["--input_folder", src, "--output_folder", out]
        want = os.path.join(out, "stereo", "fusion.cfg")
    elif command == "convert-dtu":
        _raw_dtu(src, views=1)
        argv = ["--input_folder", src, "--output_folder", out, "--scan_list", scans]
        want = os.path.join(out, "scan1", "depth_gt", "00000000.pfm")
    elif command == "convert-eth3d":
        _eth3d(src)
        argv = ["--input_folder", src, "--output_folder", out, "--scan_list", scans]
        want = os.path.join(out, "courtyard", "masks", "00000002.png")
    else:
        os.makedirs(src)
        want = os.path.join(src, "fused.ply")
        save_ply(want, np.zeros((3, 3), np.float32), np.zeros((3, 3), np.uint8))
        argv = ["--ply", want, "--headless"]
    cli.main([command, *argv])
    assert os.path.isfile(want)
    if command == "visualize":
        assert "0.00 M points" in capsys.readouterr().out


def test_orbax_backend_raises(tmp_path):
    """orbax stays out: the training driver refuses it before any work."""
    with pytest.raises(ValueError, match="orbax"):
        cli.main(["train", "--input_folder", str(tmp_path), "--train_list", "x",
                  "--test_list", "x", "--ckpt_backend", "orbax", "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_cuda_without_cuda_raises(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA; this machine has CUDA")
    for argv in (["eval", "--input_folder", scene, "--checkpoint_path", CKPT,
                  "--output_folder", str(tmp_path)],
                 ["fuse", "--input_folder", scene, "--output_folder", str(tmp_path)],
                 ["train", "--input_folder", scene, "--output_folder", str(tmp_path),
                  "--train_list", "x", "--test_list", "x"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert not os.listdir(tmp_path)


def _presets(script):
    """{function: its command's words after the module name} of an eval
    presets script (scripts/eval.sh or scripts/eval_torch.sh)."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        text = f.read().replace("\\\n", " ")
    return {name: body.split()[1:] for name, body in
            re.findall(r"^(run_\w+)\(\) \{\n\s*python -m (.*?)\n\}", text, re.M | re.S)}


@pytest.mark.parametrize("preset", ["run_dtu", "run_eth3d", "run_tanks", "run_custom"])
def test_eval_torch_presets_have_the_eval_sh_flags(preset):
    jax_presets, presets = _presets("eval.sh"), _presets("eval_torch.sh")
    assert sorted(presets) == sorted(jax_presets)
    assert presets[preset][:1] == ["eval"] and presets[preset] == jax_presets[preset]
    with open(os.path.join(REPO, "scripts", "eval_torch.sh")) as f:
        assert f.read().count("python -m patchmatchnet_torch eval ") == 4


def test_run_eth3d_on_cpu_writes_the_library_maps_and_a_cloud(tmp_path):
    root, scan = str(tmp_path / "eth3d"), "scan1"
    make_synthetic_scene(os.path.join(root, scan), num_views=5, height=64, width=80,
                         texture_scale=6.0)
    scan_list = str(tmp_path / "scans.txt")
    with open(scan_list, "w") as f:
        f.write(scan + "\n")
    out = str(tmp_path / "cli")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    proc = subprocess.run(["bash", "scripts/eval_torch.sh", "run_eth3d", root, out, scan_list,
                           "--device", "cpu", "--image_extension", ".png"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Wrote 5 depth/confidence map pairs" in proc.stdout

    ref = str(tmp_path / "library")
    model = PatchmatchNet(compute_dtype=torch.bfloat16)  # the default --precision bf16
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    dataset = MVSDataset(root, 7, ".png", max_dim=2688, scan_list=scan_list)
    assert dataset[0]["images"].shape[0] == 5  # 4 sources, all the scan has
    written = save_depth_maps(DepthEstimator(model, "cpu"), BatchLoader(dataset, 1), ref, seed=0)
    assert written == 5
    _same_files(out, ref, [os.path.join(scan, folder, f"{v:08d}.pfm")
                           for folder in ("depth_est", "confidence") for v in range(5)])
    assert read_ply(os.path.join(out, scan, "fused.ply"))[0].shape[0] > 0
