"""The port's command line (`python -m patchmatchnet_torch`) on the CPU.

- Each ported subcommand's parser has the JAX command line's flags: the
  same names (and aliases), destinations, defaults, choices, types, nargs,
  required flags and actions; only `--device` is extra.
- `eval --device cpu` on a 64x80 4-view synthetic scene writes the maps
  that `DepthEstimator` + `save_depth_maps` write with the same seed, and
  the `fused.ply` and masks that `filter_and_fuse` writes, byte for byte;
  `fuse --device cpu` over those maps writes the same `fused.ply`.
- `train --device cpu` for one epoch writes the checkpoint set, a config
  that loads back, a finite loss and a trace; `--dataset dtu_legacy` builds
  its loaders on the raw DTU layout.
- `convert` writes the port's state dict of a reference `.ckpt`.
- Options the port refuses raise, naming the ROADMAP item to come; so does
  `--device cuda` without CUDA.
"""

import argparse
import filecmp
import json
import math
import os
import shutil

import pytest
import torch

from patchmatchnet_tpu import cli as jax_cli
from patchmatchnet_tpu.config import Config as JaxConfig
from patchmatchnet_torch import cli
from patchmatchnet_torch.compat import convert_torch_state_dict
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene, read_ply
from patchmatchnet_torch.infer import DepthEstimator, FusionConfig, filter_and_fuse, save_depth_maps
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train.driver import load_any_checkpoint
from tests.test_dtu_legacy import raw_dtu  # noqa: F401  (the fixture)
from tests.test_torch_convert import reference_state_dict

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


@pytest.mark.parametrize("command", ["train", "eval", "fuse", "convert"])
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


@pytest.mark.parametrize("argv,item", [
    (["eval", "--input_type", "module"], "item 11"),
    (["eval", "--num_devices", "2"], "item 10"),
    (["train", "--num_devices", "2"], "item 10"),
    (["export"], "item 11"),
    (["colmap-import"], "item 12"),
    (["visualize"], "item 12"),
])
def test_refused_options_raise(argv, item, tmp_path):
    required = {"eval": ["--input_folder", str(tmp_path), "--checkpoint_path", CKPT],
                "train": ["--input_folder", str(tmp_path), "--train_list", "x",
                          "--test_list", "x"]}
    with pytest.raises(SystemExit, match=item):
        cli.main(argv + required.get(argv[0], []) + ["--device", "cpu"] * (argv[0] in required))
    assert not os.listdir(tmp_path)  # refused before any work


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
