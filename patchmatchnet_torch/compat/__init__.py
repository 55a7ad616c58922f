"""Checkpoint interop with the JAX reference package and the original
PyTorch checkpoints."""

from patchmatchnet_torch.compat.torch_convert import (
    convert_torch_checkpoint,
    convert_torch_state_dict,
)
from patchmatchnet_torch.compat.weights import (
    TrainState,
    read_flax_msgpack,
    state_dict_from_jax,
    tensors_from_jax_params,
    train_state_from_jax,
)

__all__ = [
    "TrainState",
    "convert_torch_checkpoint",
    "convert_torch_state_dict",
    "read_flax_msgpack",
    "state_dict_from_jax",
    "tensors_from_jax_params",
    "train_state_from_jax",
]
