"""Trainer of the ExposureDecision pretrain (port of
``ebfi_tpu/train/exposure_trainer.py``): the full Trainer's control
surface with one iteration per loaded real-data window position (no
per-timestamp loop)."""
from __future__ import annotations

from .trainer import Trainer


class ExposureTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("model_name", "ExposureDecision")
        super().__init__(*args, **kwargs)

    def _batches_from_window(self, window):
        blurry = window["blurry"]      # (B, L, NumP, H, W, 3)
        events = window["events"]      # (B, L, H, W, 2TB)
        exposure = window["exposure"]  # (B, L, NumP, 1)
        if blurry.shape[2] != 1:
            raise ValueError("exposure pretrain consumes NumPeriodPerLoad == 1 windows")
        for idx_l in range(blurry.shape[1]):
            yield {
                "frame": blurry[:, idx_l, 0],
                "event": events[:, idx_l],
                "gt_ex": exposure[:, idx_l, 0],
            }
