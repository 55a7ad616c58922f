"""The port's host tools (`patchmatchnet_torch.tools`) against the JAX
package's (`patchmatchnet_tpu.tools`) on the CPU, on synthetic inputs built
in tmp_path: every file either writes is compared byte for byte.

- tests/test_tools.py's four cases through both packages: the quaternion
  round trip, the COLMAP text model read, `colmap_to_mvs` and
  `mvs_to_colmap`;
- `convert_dtu` on a raw DTU scan at DTU's 1200x1600, whose depth maps and
  masks shrink through `read_map(..., 800)` and `read_image(..., 800)`;
- `convert_eth3d`, through `read_image_dictionary`;
- `visualize --headless` prints the same statistics;
- each tool's subcommand of the port's command line runs it, with the JAX
  tool's parser.
"""

import argparse
import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from patchmatchnet_tpu.dataio import save_map as jax_save_map
from patchmatchnet_tpu.tools import colmap_export as jax_colmap_export
from patchmatchnet_tpu.tools import colmap_import as jax_colmap_import
from patchmatchnet_tpu.tools import colmap_model as jax_colmap_model
from patchmatchnet_tpu.tools import convert_dtu as jax_convert_dtu
from patchmatchnet_tpu.tools import convert_eth3d as jax_convert_eth3d
from patchmatchnet_tpu.tools import visualize as jax_visualize
from patchmatchnet_torch import cli
from patchmatchnet_torch.data import PLANE_Z, read_cam_file, save_ply
from patchmatchnet_torch.tools import (
    colmap_export,
    colmap_import,
    colmap_model,
    convert_dtu,
    convert_eth3d,
    visualize,
)
from tests.scene_utils import make_synthetic_scene
from tests.test_tools import _write_synthetic_colmap


def _tree(root):
    """Relative paths of every file under `root`, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_trees(port, ref):
    """The two output trees hold the same files, equal byte for byte."""
    files = _tree(ref)
    assert files and _tree(port) == files
    for name in files:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name),
                           shallow=False), name


def test_quaternion_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        rot = colmap_model.quaternion_to_rotation(q)
        np.testing.assert_array_equal(rot, jax_colmap_model.quaternion_to_rotation(q))
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
        q2 = colmap_model.rotation_to_quaternion(rot)
        np.testing.assert_array_equal(q2, jax_colmap_model.rotation_to_quaternion(rot))
        np.testing.assert_allclose(q2, q, atol=1e-9)


def test_colmap_model_text_read_matches_jax(tmp_path):
    _write_synthetic_colmap(str(tmp_path))
    sparse = str(tmp_path / "sparse")
    cameras, images, points = colmap_model.read_model(sparse, ".txt")
    ref_cameras, ref_images, ref_points = jax_colmap_model.read_model(sparse, ".txt")
    assert vars(cameras[1]) == vars(ref_cameras[1]) and cameras[1].model == "PINHOLE"
    assert len(images) == len(ref_images) == 4
    for img, ref in zip(images, ref_images):
        assert (img.id, img.camera_id, img.name) == (ref.id, ref.camera_id, ref.name)
        for key in ("qvec", "tvec", "point3d_ids"):
            np.testing.assert_array_equal(getattr(img, key), getattr(ref, key))
        np.testing.assert_array_equal(img.extrinsics(), ref.extrinsics())
    for key in ("ids", "xyz", "rgb", "error"):
        np.testing.assert_array_equal(getattr(points, key), getattr(ref_points, key))
    assert (points.xyz[:, 2] > 3.5).all()


def test_colmap_import_matches_jax(tmp_path):
    root = str(tmp_path / "colmap")
    _write_synthetic_colmap(root)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert colmap_import.colmap_to_mvs(root, port, model_ext=".txt") == 4
    assert jax_colmap_import.colmap_to_mvs(root, ref, model_ext=".txt") == 4
    _same_trees(port, ref)
    intr, _, depth_params = read_cam_file(os.path.join(port, "cams", "00000000_cam.txt"))
    assert intr[0, 0] == pytest.approx(70.0)
    assert 3.5 < depth_params[0] < depth_params[1] < 9.0


def _scene_with_maps(root, ext=".pfm"):
    make_synthetic_scene(root, num_views=3, height=48, width=64, image_extension=".jpg")
    for v in range(3):
        for folder, value in (("depth_est", PLANE_Z), ("confidence", 0.9)):
            os.makedirs(os.path.join(root, folder), exist_ok=True)
            jax_save_map(os.path.join(root, folder, f"{v:08d}{ext}"),
                         np.full((48, 64), value, np.float32))


@pytest.mark.parametrize("ext", [".pfm", ".bin"])
def test_colmap_export_matches_jax(tmp_path, ext):
    """Both map formats: .pfm maps are rewritten as .bin, .bin maps copied."""
    root = str(tmp_path / "mvs")
    _scene_with_maps(root, ext)
    port, ref = str(tmp_path / "port_ws"), str(tmp_path / "ref_ws")
    colmap_export.mvs_to_colmap(root, root, port)
    jax_colmap_export.mvs_to_colmap(root, root, ref)
    _same_trees(port, ref)
    assert os.path.isfile(os.path.join(port, "stereo", "depth_maps",
                                       "00000000.jpg.geometric.bin"))
    cameras, images, _ = colmap_model.read_model(os.path.join(port, "sparse"), ".txt")
    assert len(images) == 3
    np.testing.assert_allclose(images[0].extrinsics()[:3, :3], np.eye(3), atol=1e-9)


def _raw_dtu(root, views=2, lights=7):
    """A raw DTU scan `scan1` as convert_dtu reads it: Cameras_1 (pair.txt,
    train/ cams at a quarter of the image size), Depths_raw at 1200x1600
    (depth PFMs and 8-bit grey depth_visual PNGs) and 7 lights of small
    Rectified PNGs."""
    rng = np.random.default_rng(5)
    os.makedirs(os.path.join(root, "Cameras_1", "train"))
    os.makedirs(os.path.join(root, "Depths_raw", "scan1"))
    os.makedirs(os.path.join(root, "Rectified", "scan1_train"))
    with open(os.path.join(root, "Cameras_1", "pair.txt"), "w") as f:
        f.write(f"{views}\n" + "".join(f"{v}\n1 {1 - v} 100.5\n" for v in range(views)))
    for v in range(views):
        extr = np.eye(4)
        extr[:3, 3] = rng.uniform(-200, 200, 3)
        intr = [[rng.uniform(700, 800), 0, rng.uniform(150, 170)],
                [0, rng.uniform(700, 800), rng.uniform(110, 130)], [0, 0, 1]]
        lines = (["extrinsic"] + [" ".join(f"{x:.6f}" for x in row) for row in extr]
                 + ["", "intrinsic"] + [" ".join(f"{x:.6f}" for x in row) for row in intr]
                 + ["", "425.0 2.5"])
        with open(os.path.join(root, "Cameras_1", "train", f"{v:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        depth = rng.uniform(425.0, 935.0, (1200, 1600)).astype(np.float32)
        jax_save_map(os.path.join(root, "Depths_raw", "scan1", f"depth_map_{v:04d}.pfm"), depth)
        Image.fromarray(rng.integers(0, 256, (1200, 1600), dtype=np.uint8)).save(
            os.path.join(root, "Depths_raw", "scan1", f"depth_visual_{v:04d}.png"))
        for light in range(lights):
            Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
                os.path.join(root, "Rectified", "scan1_train",
                             f"rect_{v + 1:03d}_{light}_r5000.png"))
    with open(os.path.join(root, "scans.txt"), "w") as f:
        f.write("scan1\n")


def test_convert_dtu_matches_jax(tmp_path):
    raw = str(tmp_path / "raw")
    _raw_dtu(raw)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    scans = os.path.join(raw, "scans.txt")
    convert_dtu.main(["--input_folder", raw, "--output_folder", port, "--scan_list", scans])
    jax_convert_dtu.main(["--input_folder", raw, "--output_folder", ref, "--scan_list", scans])
    _same_trees(port, ref)
    mask = np.asarray(Image.open(os.path.join(port, "scan1", "masks", "00000000.png")))
    assert mask.shape == (512, 640) and 0 < (mask > 0).mean() < 1


def _eth3d(root):
    """An ETH3D scan `courtyard`: cams/ with index2prefix.txt and pair.txt,
    images/ named by the index, depths/ as PFMs without `_undistorted`."""
    rng = np.random.default_rng(6)
    cams = os.path.join(root, "courtyard", "cams")
    os.makedirs(cams)
    os.makedirs(os.path.join(root, "courtyard", "images", "dslr_images_undistorted"))
    os.makedirs(os.path.join(root, "courtyard", "depths", "dslr_images"))
    names = [f"dslr_images_undistorted/DSC_{v:04d}.JPG" for v in range(3)]
    with open(os.path.join(cams, "index2prefix.txt"), "w") as f:
        f.write("3\n" + "".join(f"{v} {n}\n" for v, n in enumerate(names)))
    with open(os.path.join(cams, "pair.txt"), "w") as f:
        f.write("3\n" + "".join(f"{v}\n2 {(v + 1) % 3} 3.0 {(v + 2) % 3} 1.0\n"
                                for v in range(3)))
    for v, name in enumerate(names):
        with open(os.path.join(cams, f"{v:08d}_cam.txt"), "w") as f:
            f.write(f"extrinsic\n1 0 0 {v}\n0 1 0 0\n0 0 1 0\n0 0 0 1\n\n"
                    "intrinsic\n500 0 40\n0 500 30\n0 0 1\n\n0.5 20.0\n")
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(
            os.path.join(root, "courtyard", "images", name), format="PNG")
        depth = rng.uniform(-1.0, 10.0, (60, 80)).astype(np.float32)
        jax_save_map(os.path.join(root, "courtyard", "depths", "dslr_images",
                                  f"DSC_{v:04d}.pfm"), depth)
    with open(os.path.join(root, "scans.txt"), "w") as f:
        f.write("courtyard\n")


def test_convert_eth3d_matches_jax(tmp_path):
    raw = str(tmp_path / "eth3d")
    _eth3d(raw)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    scans = os.path.join(raw, "scans.txt")
    convert_eth3d.main(["--input_folder", raw, "--output_folder", port, "--scan_list", scans])
    jax_convert_eth3d.main(["--input_folder", raw, "--output_folder", ref, "--scan_list", scans])
    _same_trees(port, ref)
    assert len(_tree(os.path.join(port, "courtyard", "masks"))) == 3


def test_visualize_headless_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "fused.ply")
    save_ply(path, rng.standard_normal((500, 3)) * 10,
             rng.integers(0, 256, (500, 3), dtype=np.uint8))
    visualize.main(["--ply", path, "--headless"])
    ours = capsys.readouterr().out
    jax_visualize.main(["--ply", path, "--headless"])
    assert ours == capsys.readouterr().out and "0.00 M points" in ours
    with pytest.raises(FileNotFoundError):
        visualize.main(["--ply", str(tmp_path / "missing.ply"), "--headless"])


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser_of(main, monkeypatch):
    """The parser a tool's main builds, caught at its parse_args."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as caught:
        main([])
    monkeypatch.undo()
    return caught.value.parser


@pytest.mark.parametrize("command,port_main,jax_main", [
    ("colmap-import", colmap_import.main, jax_colmap_import.main),
    ("colmap-export", colmap_export.main, jax_colmap_export.main),
    ("convert-dtu", convert_dtu.main, jax_convert_dtu.main),
    ("convert-eth3d", convert_eth3d.main, jax_convert_eth3d.main),
    ("visualize", visualize.main, jax_visualize.main),
])
def test_tool_parsers_match_jax(command, port_main, jax_main, monkeypatch):
    def flags(parser):
        return {a.option_strings[0]: (tuple(a.option_strings), a.dest, a.default, a.choices,
                                      a.type, a.nargs, a.required, type(a).__name__)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    assert cli.COMMANDS[command] is port_main
    assert flags(_parser_of(port_main, monkeypatch)) == flags(_parser_of(jax_main, monkeypatch))
