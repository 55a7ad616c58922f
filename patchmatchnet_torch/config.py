"""Typed configuration of the command line and the training driver
(reference: `patchmatchnet_tpu/config.py`, same field names and defaults).

One dataclass per concern: the per-stage model options and precisions, the
data, training and fusion settings. Serialized as JSON next to checkpoints;
`Config.load` reads a `config.json` written by either package (fields the
port does not know are ignored)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class ModelConfig:
    # per-stage options, indexed (stage 1, stage 2, stage 3)
    patchmatch_interval_scale: Tuple[float, ...] = (0.005, 0.0125, 0.025)
    propagation_range: Tuple[int, ...] = (6, 4, 2)
    patchmatch_iteration: Tuple[int, ...] = (1, 2, 2)
    patchmatch_num_sample: Tuple[int, ...] = (8, 8, 16)
    propagate_neighbors: Tuple[int, ...] = (0, 8, 16)
    evaluate_neighbors: Tuple[int, ...] = (9, 9, 9)
    # inference: "bf16" payloads with f32 geometry, softmax and regression,
    # or full "f32"
    precision: str = "bf16"
    # "bf16": bf16 feature and correlation payloads with f32 parameters,
    # BatchNorm statistics, loss and optimizer state; "f32": full precision
    # with TF32 off (the reference-parity trainer)
    train_precision: str = "bf16"


@dataclass
class DataConfig:
    input_folder: str = ""
    dataset: str = "unified"  # "unified" (cams/pair layout) or "dtu_legacy" (raw DTU)
    num_views: int = 5  # source views per sample ("dtu_legacy": views in all)
    image_max_dim: int = -1
    scan_list: str = ""
    num_light_idx: int = -1
    image_extension: str = ".jpg"
    batch_size: int = 1


@dataclass
class TrainConfig:
    output_folder: str = ""
    checkpoint_path: str = ""  # resume from it with `resume`, else warm start
    resume: bool = False
    epochs: int = 16
    learning_rate: float = 1e-3
    lr_epochs: str = "10,12,14:2"
    weight_decay: float = 0.0
    summary_freq: int = 20
    save_freq: int = 1
    rand_seed: int = 1
    robust_train: bool = False
    train_list: str = ""
    test_list: str = ""
    # "msgpack" only: the name the JAX package gives its default; the port
    # checkpoints with torch.save (orbax is JAX's)
    ckpt_backend: str = "msgpack"
    device: str = "cuda"  # one device; "cpu" runs the plain kernel versions


@dataclass
class FuseConfig:
    geo_pixel_thres: float = 1.0
    geo_depth_thres: float = 0.01
    geo_mask_thres: int = 5
    photo_thres: float = 0.5
    file_format: str = ".pfm"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    fuse: FuseConfig = field(default_factory=FuseConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def make(cls, values):
            names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: v for k, v in values.items() if k in names}
            if cls is ModelConfig:
                kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
            return cls(**kwargs)

        return Config(model=make(ModelConfig, raw.get("model", {})),
                      data=make(DataConfig, raw.get("data", {})),
                      train=make(TrainConfig, raw.get("train", {})),
                      fuse=make(FuseConfig, raw.get("fuse", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_json(f.read())
