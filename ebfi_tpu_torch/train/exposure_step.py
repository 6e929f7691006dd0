"""ExposureDecision pretrain steps (port of
``ebfi_tpu/train/exposure_step.py``): the blurriness map of the real
blurry frame (DarkCh, Lap, RGB, RGBDark or RGBLap), the exposure duty
regressed from (events, map), MSE against the duty the clip records."""
from __future__ import annotations

import torch

from ..losses import mse_loss
from ..ops import dark_channel, laplacian_response
from .train_step import TrainState


def blurry_level_map(frame: torch.Tensor, fashion: str) -> torch.Tensor:
    lap = lambda f: laplacian_response(f).to(f.dtype)  # noqa: E731
    if fashion == "DarkCh":
        return dark_channel(frame)
    if fashion == "Lap":
        return lap(frame)
    if fashion == "RGB":
        return frame
    if fashion == "RGBDark":
        return torch.cat([frame, dark_channel(frame)], dim=-1)
    if fashion == "RGBLap":
        return torch.cat([frame, lap(frame)], dim=-1)
    raise ValueError(f"Wrong blurry conversion fashion {fashion!r}")


def make_exposure_train_step(blurry_fashion: str):
    def step_fn(state: TrainState, batch):
        ex = state.model(batch["event"], blurry_level_map(batch["frame"], blurry_fashion))
        loss = mse_loss(ex, batch["gt_ex"])
        loss.backward()
        state.updater.step()
        state.step += 1
        return state, {"train_loss": loss.detach()}

    return step_fn


def make_exposure_eval_step(blurry_fashion: str):
    @torch.no_grad()
    def eval_fn(model, batch):
        ex = model(batch["event"], blurry_level_map(batch["frame"], blurry_fashion))
        return {"valid_loss": mse_loss(ex, batch["gt_ex"])}

    return eval_fn
