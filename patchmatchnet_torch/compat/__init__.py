"""Checkpoint interop with the JAX reference package."""

from patchmatchnet_torch.compat.weights import read_flax_msgpack, state_dict_from_jax

__all__ = ["read_flax_msgpack", "state_dict_from_jax"]
