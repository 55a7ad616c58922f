"""The photometric confidence of the DTU preset on the synthetic scan of
`chip_smoke.py`'s phase 12 (a), through the JAX CLI and the port's CLI on
the CPU: a witness that the flat confidence at the smooth texture comes
from the scene, not from the port.

The scan is rendered at 400x300 in place of 1600x1200, with its texture
scale divided by 4, so that the texture's period in pixels is the same
(the camera's focal length is 1.1 x the image width, so one pixel spans 4x
the world at a quarter of the width): scale 2 stands for the smooth
texture of scale 8, scale 32 for the fine one of scale 128. Both CLIs run
`eval --output_type depth` with the preset's flags (1 + 5 views) and the
released weights; the photometric mask is confidence > 0.8, as the
preset's fusion takes it.

Run as a script for the table: `python tests/test_torch_cli_texture.py`
(JAX on the CPU; about a minute).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
VIEWS, H, W, SOURCES, PHOTO_THRES = 7, 300, 400, 5, 0.8
# the smooth texture of the other chip phases (8) and the one phase 12 (a)
# renders (128) at 1600x1200, as scales at 400x300
TEXTURES = {8.0: 2.0, 128.0: 32.0}
PRESET = ["--num_views", str(SOURCES), "--image_max_dim", str(W), "--geo_mask_thres", "3",
          "--photo_thres", str(PHOTO_THRES), "--output_type", "depth"]


def make_scan(root: str, texture_scale: float) -> str:
    """The 7-view scan under root/scan1 with each reference's sources best
    first (as DTU's pair.txt lists them); returns the scan list's path."""
    from patchmatchnet_torch.data import make_synthetic_scene, read_pair_file, save_pair_file

    scan = os.path.join(root, "scan1")
    make_synthetic_scene(scan, num_views=VIEWS, height=H, width=W, texture_scale=texture_scale)
    pairs = os.path.join(scan, "pair.txt")
    save_pair_file(pairs, [(v, [(s, 10.0 - abs(s - v))
                                for s in sorted(srcs, key=lambda s: abs(s - v))])
                           for v, srcs in read_pair_file(pairs)])
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("scan1\n")
    return os.path.join(root, "test.txt")


def confidence_stats(root: str, texture_scale: float) -> dict:
    """{"jax"|"torch": (median confidence, share > PHOTO_THRES, median
    |depth - plane|) over every pixel of the 7 maps} of both CLIs."""
    from patchmatchnet_torch import cli as torch_cli
    from patchmatchnet_torch.data import PLANE_Z, read_pfm
    from patchmatchnet_tpu import cli as jax_cli

    scan_list = make_scan(os.path.join(root, "data"), texture_scale)
    stats = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        out = os.path.join(root, name)
        main(["eval", "--input_folder", os.path.join(root, "data"), "--output_folder", out,
              "--checkpoint_path", CKPT, "--scan_list", scan_list, "--image_extension", ".png",
              *PRESET, *extra])
        conf = np.stack([read_pfm(os.path.join(out, "scan1", "confidence", f"{v:08d}.pfm"))
                         for v in range(VIEWS)])
        depth = np.stack([read_pfm(os.path.join(out, "scan1", "depth_est", f"{v:08d}.pfm"))
                          for v in range(VIEWS)])
        stats[name] = (float(np.median(conf)), float((conf > PHOTO_THRES).mean()),
                       float(np.median(np.abs(depth - PLANE_Z))))
    return stats


@pytest.mark.slow
@pytest.mark.parametrize("texture", sorted(TEXTURES))
def test_port_confidence_matches_jax(texture, tmp_path):
    stats = confidence_stats(str(tmp_path), TEXTURES[texture])
    (jax_median, jax_share, _), (port_median, port_share, _) = stats["jax"], stats["torch"]
    # the port's confidence distribution is the JAX package's: both run the
    # same weights on the same images, apart from the stage-3 noise's draw
    assert abs(port_median - jax_median) <= 0.02
    assert abs(port_share - jax_share) <= 0.02
    if texture == 8.0:  # the JAX reference itself passes almost no pixel
        assert jax_share <= 0.01


def main() -> None:
    import tempfile

    print(f"DTU preset at {W}x{H}, {VIEWS} views, 1 + {SOURCES} per map, photo_thres "
          f"{PHOTO_THRES}; over all pixels of the {VIEWS} maps:")
    for texture, scale in TEXTURES.items():
        with tempfile.TemporaryDirectory() as root:
            stats = confidence_stats(root, scale)
        for name, (median, share, err) in stats.items():
            print(f"texture {texture:g} at 1600x1200 (scale {scale:g} here), {name}: median "
                  f"confidence {median:.4f}, share > {PHOTO_THRES} {share:.4f}, median "
                  f"|depth - plane| {err:.4f}", flush=True)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, REPO)
    main()
