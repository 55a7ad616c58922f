"""Checkpoint interop with the JAX reference package."""

from patchmatchnet_torch.compat.weights import (
    TrainState,
    read_flax_msgpack,
    state_dict_from_jax,
    tensors_from_jax_params,
    train_state_from_jax,
)

__all__ = [
    "TrainState",
    "read_flax_msgpack",
    "state_dict_from_jax",
    "tensors_from_jax_params",
    "train_state_from_jax",
]
