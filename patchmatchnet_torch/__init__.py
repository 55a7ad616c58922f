"""patchmatchnet_torch — PatchmatchNet inference and training in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `patchmatchnet_tpu` is the reference this package is held
against. This package imports `torch` and never `jax`, `flax` or the JAX
package.

Layout:
- `cli` (`python -m patchmatchnet_torch train|eval|fuse|convert`): the
  command line, with the JAX command line's flags plus `--device`.
- `config`: the typed configuration (per-stage model options, data,
  training, fusion), read from and written to `config.json`.
- `compat.weights`: flax msgpack checkpoint reader + state-dict conversion,
  including gradient/Adam trees and JAX training checkpoints.
- `compat.torch_convert`: the original PyTorch `params_*.ckpt` to the
  port's state dict.
- `models`: FeatureNet, the PatchMatch stages (any supported per-stage
  configuration), Refinement, the cascade (eval and train modes) and the
  loss.
- `ops`: plain tensor ops and the kernel wrappers (`warp_similarity` K1
  with its backward K4, `neighbor_similarity` K3 with its backward K5,
  `eval_tail` K2, `gather` the gathers D1-D5), each with a plain PyTorch
  twin used for CPU tensors; `cuda_build` builds `csrc/` with nvcc.
- `dev.bench_gather`: the gather microbenchmarks on the card.
- `infer.depth`: `DepthEstimator` and `save_depth_maps` (.pfm or .bin).
- `infer.fusion`: `filter_and_fuse`, depth maps to a fused, coloured PLY
  on the card, over `geometry.fusion_math` (consistency batched over a
  reference's source views).
- `eval_protocols.dtu`: the DTU evaluation protocol (numpy/scipy).
- `train`: train/eval steps, Adam + MultiStep, checkpoints, the epoch
  driver `run_training` (configured by `config.Config`), `build_model` and
  `load_any_checkpoint`.
- `data`: file codecs (images, cams, pairs, PFM and COLMAP .bin maps, PLY),
  the MVS scene dataset and batch loader, `data.dtu_legacy` (the raw DTU
  training layout), and a synthetic scene with known depth.
- `utils`: depth metrics, the JSONL/TensorBoard metrics logger,
  `utils.profiling` (`torch_trace`, `PhaseTimer`) and device-trace helpers.
"""

__version__ = "0.1.0"
