"""Scalar and image logging: JSONL always, TensorBoard when importable
(reference: `patchmatchnet_tpu/utils/logging.py`)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np


class MetricsLogger:
    """Appends one JSON record per `scalars` call to `<log_dir>/metrics.jsonl`
    and mirrors scalars and images to TensorBoard if it can be imported."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:  # tensorboard is optional
            self._tb = None
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, mode: str, scalar_dict: Dict[str, Any], step: int) -> None:
        record = {"mode": mode, "step": step, "time": time.time()}
        for key, value in scalar_dict.items():
            record[key] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(f"{mode}/{key}", record[key], step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def image(self, mode: str, name: str, image: np.ndarray, step: int) -> None:
        """image: [H, W] or [H, W, C] float, normalized per image."""
        if self._tb is None:
            return
        img = np.asarray(image, dtype=np.float32)
        lo, hi = float(img.min()), float(img.max())
        if hi > lo:
            img = (img - lo) / (hi - lo)
        img = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        self._tb.add_image(f"{mode}/{name}", img, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
