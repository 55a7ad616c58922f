"""Training configuration: the model, data and train fields that
`train.driver.run_training` reads (reference: `patchmatchnet_tpu/config.py`,
same field names and defaults). Serialized as JSON next to checkpoints."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    # "bf16": bf16 feature and correlation payloads with f32 parameters,
    # BatchNorm statistics, loss and optimizer state; "f32": full precision
    # with TF32 off (the reference-parity trainer)
    train_precision: str = "bf16"


@dataclass
class DataConfig:
    input_folder: str = ""
    num_views: int = 5  # source views per sample
    image_max_dim: int = -1
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
    device: str = "cuda"  # one device; "cpu" runs the plain kernel versions


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
