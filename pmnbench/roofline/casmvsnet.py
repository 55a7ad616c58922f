"""The least time an H100 could take for one CasMVSNet inference forward of
a `maps` cell: the benchmark's own count, from the configuration file and
the traffic's shapes alone.

The rules are `count.py`'s: each component reads every input once and
writes every output once at its dtype (the configuration's payload
precision for features, volumes and 3D activations; f32 for hypotheses,
probabilities and maps); a convolution takes the rate of the unit its
precision runs on (bf16 tensor cores, or f32 CUDA cores), a transposed one
the work of its input positions; every other component's operations are
f32 on the CUDA cores. Rows belong to three groups:
- "convolutions": FeatureNet's 2D and the CostRegNets' 3D convolutions;
- "K8": the variance cost volume of each stage, the same work whatever
  computes it: the volume [B, D, h, w, C] written once, the N views'
  features and the hypotheses read once; per value and source view the
  bilinear tap and the two sums (11 operations), per sample and source view
  its warp (20), per value the reference's square and the variance (5);
- "glue": BatchNorm with ReLU, the FPN's upsample and add, the U-Nets'
  skips, the hypotheses, softmax, regression, confidence and the resize of
  the maps to the request's size.
The whole bound is the sum of the rows' bounds.
"""

from __future__ import annotations

from typing import Any, Dict, List

from pmnbench.roofline.count import BF16_TENSOR_OPS_PER_S, F32, F32_OPS_PER_S, Row

GROUPS = ("convolutions", "K8", "glue")
STAGE_SCALE = (4, 2, 1)  # image pixels a feature pixel, by stage
FEATURE_CHANNELS = (32, 16, 8)  # FPN outputs, by stage


class _Count:
    def __init__(self, precision: str):
        self.size = 2 if precision == "bf16" else F32
        self.conv_rate = F32_OPS_PER_S if precision == "f32" else BF16_TENSOR_OPS_PER_S
        self.rows: List[Row] = []

    def add(self, component: str, group: str, work_bytes: float, flops: float = 0.0,
            rate: float = F32_OPS_PER_S) -> None:
        self.rows.append(Row(component, group, float(work_bytes), float(flops), rate))

    def conv(self, component: str, n: int, cin: int, cout: int, k: int, inputs: int,
             outputs: int, transposed: bool = False) -> None:
        """A convolution of `n` maps, `inputs` and `outputs` positions a map,
        a k^d kernel's taps `k` (9, 25 or 27)."""
        weights = cin * cout * k
        flops = 2 * n * weights * (inputs if transposed else outputs)
        work = (n * cin * inputs + weights + n * cout * outputs) * self.size
        self.add(component, "convolutions", work, flops, self.conv_rate)

    def act(self, component: str, values: int, reads: int = 1) -> None:
        """An elementwise pass over `values` payload values of `reads` inputs."""
        self.add(component, "glue", values * (reads + 1) * self.size)


def _feature_net(k: _Count, n: int, h: int, w: int) -> None:
    full, half, quarter = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    for name, cin, cout, taps, ins, outs in (
            ("conv0.0", 3, 8, 9, full, full), ("conv0.1", 8, 8, 9, full, full),
            ("conv1.0", 8, 16, 25, full, half), ("conv1.1", 16, 16, 9, half, half),
            ("conv1.2", 16, 16, 9, half, half), ("conv2.0", 16, 32, 25, half, quarter),
            ("conv2.1", 32, 32, 9, quarter, quarter), ("conv2.2", 32, 32, 9, quarter, quarter)):
        k.conv(f"FeatureNet {name}", n, cin, cout, taps, ins, outs)
        k.act(f"FeatureNet {name} BN+ReLU", n * cout * outs)
    k.conv("FeatureNet out1", n, 32, 32, 1, quarter, quarter)
    for inner, out, cin, cout, low, high in (("inner1", "out2", 16, 16, quarter, half),
                                             ("inner2", "out3", 8, 8, half, full)):
        k.conv(f"FeatureNet {inner}", n, cin, 32, 1, high, high)
        k.add(f"FeatureNet upsample + {inner}", "glue", n * 32 * (low + 2 * high) * k.size)
        k.conv(f"FeatureNet {out}", n, 32, cout, 9, high, high)


def _cost_regularization(k: _Count, stage: int, b: int, c: int, d: int, h: int, w: int
                         ) -> None:
    sizes = [(d, h, w)]
    for _ in range(3):
        dd, hh, ww = sizes[-1]
        sizes.append(((dd + 1) // 2, (hh + 1) // 2, (ww + 1) // 2))
    voxels = [x * y * z for x, y, z in sizes]
    label = f"stage {stage} CostRegNet"
    for name, cin, cout, level_in, level_out in (
            ("conv0", c, 8, 0, 0), ("conv1", 8, 16, 0, 1), ("conv2", 16, 16, 1, 1),
            ("conv3", 16, 32, 1, 2), ("conv4", 32, 32, 2, 2), ("conv5", 32, 64, 2, 3),
            ("conv6", 64, 64, 3, 3)):
        k.conv(f"{label} {name}", b, cin, cout, 27, voxels[level_in], voxels[level_out])
        k.act(f"{label} {name} BN+ReLU", b * cout * voxels[level_out])
    for name, cin, cout, level in (("conv7", 64, 32, 3), ("conv9", 32, 16, 2),
                                   ("conv11", 16, 8, 1)):
        k.conv(f"{label} {name}", b, cin, cout, 27, voxels[level], voxels[level - 1],
               transposed=True)
        k.act(f"{label} {name} BN+ReLU + skip", b * cout * voxels[level - 1], reads=2)
    k.conv(f"{label} prob", b, 8, 1, 27, voxels[0], voxels[0])


def count(precision: str, config: Dict[str, Any], traffic: Dict[str, Any]) -> List[Row]:
    """The rows of one request of the traffic's shapes at `precision`."""
    k = _Count(precision)
    b, n, h, w = traffic["batch"], traffic["views"], traffic["height"], traffic["width"]
    _feature_net(k, b * n, h, w)
    for i, (d, c) in enumerate(zip(config["ndepths"], FEATURE_CHANNELS)):
        stage, s = i + 1, STAGE_SCALE[i]
        hs, ws = h // s, w // s
        plane = b * hs * ws
        voxels = plane * d
        if i == 0:
            k.add("stage 1 hypotheses", "glue", voxels * F32)
        else:
            k.add(f"stage {stage} depth upsample", "glue",
                  (b * (h // STAGE_SCALE[i - 1]) * (w // STAGE_SCALE[i - 1]) + b * h * w) * F32)
            if s != 1:
                k.add(f"stage {stage} depth resize", "glue", (b * h * w + plane) * F32)
            k.add(f"stage {stage} hypotheses", "glue", (plane + voxels) * F32)
        k.add(f"stage {stage} variance volume", "K8",
              voxels * c * k.size + n * plane * c * k.size + voxels * F32,
              voxels * ((n - 1) * (20 + 11 * c) + 5 * c))
        _cost_regularization(k, stage, b, c, d, hs, ws)
        k.add(f"stage {stage} softmax", "glue", voxels * (k.size + F32), 5 * voxels)
        k.add(f"stage {stage} regression", "glue", voxels * 2 * F32 + plane * F32, 2 * voxels)
    k.add("stage 3 confidence", "glue", voxels * F32 + plane * F32, 6 * voxels)
    k.add("resize of depth and confidence", "glue", 2 * 2 * b * h * w * F32)
    return k.rows


def summary(rows: List[Row]) -> dict:
    """{"bytes", "flops", "bound_ms", "groups": {group: bound ms}}."""
    groups = {g: 0.0 for g in GROUPS}
    for row in rows:
        groups[row.group] += row.bound[0]
    return {"bytes": sum(r.bytes for r in rows), "flops": sum(r.flops for r in rows),
            "bound_ms": sum(groups.values()), "groups": groups}


def cell_bound(config: Dict[str, Any], traffic: Dict[str, Any]) -> dict:
    """`summary` of one request of a maps cell at the configuration's precision."""
    return summary(count(config["precision"], config, traffic))

