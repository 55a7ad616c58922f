"""patchmatchnet_torch — PatchmatchNet inference in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `patchmatchnet_tpu` is the reference this package is held
against. This package imports `torch` and never `jax`, `flax` or the JAX
package.

Layout:
- `compat.weights`: flax msgpack checkpoint reader + state-dict conversion.
- `models`: FeatureNet, the PatchMatch stages, Refinement and the cascade.
- `ops`: plain tensor ops and the three kernel wrappers
  (`warp_similarity`, `neighbor_similarity`, `eval_tail`), each with a plain
  PyTorch twin used for CPU tensors; `cuda_build` builds `csrc/` with nvcc.
- `infer.depth`: `DepthEstimator` and `save_depth_maps`.
- `data`: file codecs, the MVS scene dataset and batch loader, and a
  synthetic scene with known depth.
"""

__version__ = "0.1.0"
