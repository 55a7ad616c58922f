"""Load the flax checkpoint (`checkpoints/params_000007.msgpack`) into the
PyTorch modules.

`read_flax_msgpack` is a small pure-Python reader for the subset of msgpack
that `flax.serialization.msgpack_serialize` writes: maps with str keys and
ndarray leaves as ext type 1, whose payload is itself a msgpack
`(shape, dtype name, raw bytes)` tuple. Neither flax nor the `msgpack`
package is needed.

`state_dict_from_jax` inverts `patchmatchnet_tpu/compat/torch_convert.py`:
- conv kernel HWIO [kH, kW, I, O] -> OIHW [O, I, kH, kW];
- dense kernel [I, O] -> 1x1 conv weight [O, I, 1, 1];
- the Refinement deconv kernel (forward-conv HWIO, spatially flipped) ->
  ConvTranspose2d weight [I, O, kH, kW] un-flipped;
- BatchNorm params scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.
The port's module tree mirrors the flax tree, so a leaf at
params/a/b/kernel becomes the key "a.b.weight".

`tensors_from_jax_params` applies the same rules to any params-shaped tree
(gradients, Adam moments), and `train_state_from_jax` maps a JAX training
checkpoint (`patchmatchnet_tpu/train/loop.py` `save_train_checkpoint`) to
the model state dict, per-parameter `torch.optim.Adam` state and the step
and epoch counters.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Minimal msgpack decoder over a bytes buffer."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def read(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._uint(1 << (t - 0xC7))
            return self._ext(self._int(1), n)
        if t == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= t <= 0xCF:  # uint 8/16/32/64
            return self._uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:  # int 8/16/32/64
            return self._int(1 << (t - 0xD0))
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            code = self._int(1)
            return self._ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self._take(self._uint(1 << (t - 0xD9))), "utf-8")
        if t in (0xDC, 0xDD):  # array 16/32
            return self._array(self._uint(2 if t == 0xDC else 4))
        if t in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if t == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"non-str map key {key!r}")
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, code: int, n: int) -> Any:
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(payload).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Read a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes in {path}")
    return tree


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _torch_weight(scope: Tuple[str, ...], kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 2:  # dense [I, O] -> 1x1 conv [O, I, 1, 1]
        return kernel.T[:, :, None, None]
    if kernel.ndim != 4:
        raise ValueError(f"unexpected kernel shape {kernel.shape} at {scope}")
    if scope[-1] == "deconv":  # flipped HWIO -> [I, O, kH, kW]
        return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW


def _map_collection(tree: Dict[str, Any], names: Dict[str, str], collection: str,
                    out: Dict[str, torch.Tensor]) -> None:
    for path, value in _leaves(tree):
        scope, leaf = path[:-1], path[-1]
        if leaf not in names:
            raise ValueError(f"unmapped leaf {collection}/{'/'.join(path)}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr = _torch_weight(scope, arr)
        key = ".".join(scope + (names[leaf],))
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))


def tensors_from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A params-shaped flax tree (the params themselves, their gradients or
    Adam moments) -> f32 tensors keyed and laid out like the port's
    parameters in its state dict."""
    out: Dict[str, torch.Tensor] = {}
    _map_collection(tree, _PARAM_NAMES, "params", out)
    return out


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree -> PyTorch state dict
    for `patchmatchnet_torch.models.PatchmatchNet` (f32 tensors)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    _map_collection(variables.get("params", {}), _PARAM_NAMES, "params", out)
    _map_collection(variables.get("batch_stats", {}), _STAT_NAMES, "batch_stats", out)
    return out


class TrainState(NamedTuple):
    """A training checkpoint in the port's terms."""

    state_dict: Dict[str, torch.Tensor]  # model parameters and running stats
    adam: Dict[str, Dict[str, torch.Tensor]]  # parameter name -> Adam state
    step: int  # optimizer steps taken
    epoch: int  # last finished epoch


def _find_adam_state(tree: Any) -> Dict[str, Any]:
    """The optax `ScaleByAdamState` ({count, mu, nu}) inside an opt_state
    tree, whether or not a weight-decay transform precedes it."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for value in tree.values():
            found = _find_adam_state(value)
            if found:
                return found
    return {}


def train_state_from_jax(payload: Dict[str, Any]) -> TrainState:
    """A JAX training checkpoint (`read_flax_msgpack` of a
    `params_*.ckpt.msgpack`: epoch, step, params, batch_stats, opt_state)
    -> `TrainState` with `torch.optim.Adam` state per parameter:
    exp_avg = mu, exp_avg_sq = nu, step = count."""
    adam_tree = _find_adam_state(payload["opt_state"])
    if not adam_tree:
        raise ValueError("no Adam state (count, mu, nu) in the checkpoint's opt_state")
    count = float(np.asarray(adam_tree["count"]))
    mu = tensors_from_jax_params(adam_tree["mu"])
    nu = tensors_from_jax_params(adam_tree["nu"])
    adam = {
        name: {"step": torch.tensor(count, dtype=torch.float32),
               "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for name in mu
    }
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    return TrainState(state_dict_from_jax(variables), adam, int(np.asarray(payload["step"])),
                      int(np.asarray(payload["epoch"])))
