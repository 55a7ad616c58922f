"""Checkpoint interop with the JAX reference package and the original
PyTorch checkpoints, and the export of the inference forward."""

from patchmatchnet_torch.compat.export import (
    ExportedForward,
    export_inference,
    kernel_nodes,
    load_exported,
)
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
    "ExportedForward",
    "TrainState",
    "convert_torch_checkpoint",
    "convert_torch_state_dict",
    "export_inference",
    "kernel_nodes",
    "load_exported",
    "read_flax_msgpack",
    "state_dict_from_jax",
    "tensors_from_jax_params",
    "train_state_from_jax",
]
