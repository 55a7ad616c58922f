"""Point-cloud visualization (Open3D if available; stats-only fallback):
the port of `patchmatchnet_tpu/tools/visualize.py`.

Counterpart of the reference viewer (reference: visualize_ply.py) with a
headless mode for hosts without a display.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from patchmatchnet_torch.data.codecs import read_ply


def describe(path: str) -> None:
    xyz, rgb = read_ply(path)
    print(f"{path}: {xyz.shape[0] / 1e6:.2f} M points")
    for axis, name in enumerate("xyz"):
        print(
            f"  {name}: min {xyz[:, axis].min():.3f} max {xyz[:, axis].max():.3f} "
            f"mean {xyz[:, axis].mean():.3f}"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize a fused point cloud")
    parser.add_argument("--ply", type=str, required=True, help="path to .ply file")
    parser.add_argument("--headless", action="store_true", default=False,
                        help="print statistics only (no window)")
    parser.add_argument("--point_size", type=float, default=1.0)
    parser.add_argument("--use_viewpoint", type=str, default="",
                        help="load a saved Open3D viewpoint json")
    parser.add_argument("--save_viewpoint", type=str, default="",
                        help="save the viewpoint json on close")
    args = parser.parse_args(argv)

    if not os.path.isfile(args.ply):
        raise FileNotFoundError(args.ply)

    describe(args.ply)
    if args.headless:
        return

    try:
        import open3d as o3d
    except ImportError:
        print("open3d not installed; rerun with --headless for statistics")
        return

    pcd = o3d.io.read_point_cloud(args.ply)
    vis = o3d.visualization.Visualizer()
    vis.create_window()
    ctr = vis.get_view_control()
    opt = vis.get_render_option()
    opt.point_size = args.point_size
    opt.background_color = np.array([1.0, 1.0, 1.0])
    vis.add_geometry(pcd)
    if args.use_viewpoint:
        param = o3d.io.read_pinhole_camera_parameters(args.use_viewpoint)
        ctr.convert_from_pinhole_camera_parameters(param)
    vis.run()
    if args.save_viewpoint:
        param = ctr.convert_to_pinhole_camera_parameters()
        o3d.io.write_pinhole_camera_parameters(args.save_viewpoint, param)
    vis.destroy_window()


if __name__ == "__main__":
    main()
