"""Train and eval steps (port of ``ebfi_tpu/train/train_step.py``).

Loss: Laplacian + census on both heads with phase-switched weights, (pre
1.0, final 0.1) before ``phase_switch_iter`` micro-steps and swapped after;
a detail-free model uses the single term on its final head.  Mixed
precision (``compute_dtype=torch.bfloat16``, config ``trainer.precision:
bf16``) runs the model on a bf16 copy of every parameter and of the batch,
as the JAX step casts its whole parameter tree, through
``torch.func.functional_call``: the casts are differentiable, so the
gradients land on the f32 parameters, and the loss reduces in f32 against
the f32 target.  (``torch.autocast`` keeps some ops in f32 and would not
compute the same function.)  Gradient accumulation lives in the
:class:`~ebfi_tpu_torch.train.optim.Updater`.

Not ported yet, and raising ``NotImplementedError``: the adversarial and
perceptual loss terms (``trainer.loss``; ROADMAP.md A3 and A5) and
H-sharded spatial parallelism (A5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from ..losses import census_loss, charbonnier_loss, laplacian_loss
from .optim import Updater


@dataclass
class TrainState:
    """The model (f32 parameters, trained in place), its updater, and the
    count of micro-steps taken (``TrainState.step`` of the JAX package)."""

    model: nn.Module
    updater: Updater
    step: int = 0


def _pair_loss(pred, target):
    return laplacian_loss(pred, target) + census_loss(pred, target)


def _cast(x, dtype):
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _apply_model(model: nn.Module, inputs: Tuple, compute_dtype=None):
    """model(*inputs), or in ``compute_dtype``: the model on a cast copy of
    its parameters and floating inputs; gradients reach the originals."""
    if compute_dtype is None:
        return model(*inputs)
    params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    return functional_call(model, params, tuple(_cast(x, compute_dtype) for x in inputs))


def make_loss_fn(detail_enabled: bool, phase_switch_iter: int = 10_000, compute_dtype=None):
    def loss_fn(model, batch, step: int):
        target = batch["target"]
        sharp, final = _apply_model(
            model, (batch["frame"], batch["event"], batch["t"], batch.get("gt_ex")), compute_dtype
        )
        sharp, final = sharp.float(), final.float()
        if detail_enabled:
            early = step < phase_switch_iter
            w_final, w_pre = (0.1, 1.0) if early else (1.0, 0.1)
            loss = w_final * _pair_loss(final, target) + w_pre * _pair_loss(sharp, target)
        else:
            loss = _pair_loss(final, target)
        return loss

    return loss_fn


def check_loss_cfg(loss_cfg: Optional[dict]) -> None:
    for term, item in (("adversarial", "A5"), ("perceptual", "A3")):
        if ((loss_cfg or {}).get(term) or {}).get("enabled", False):
            raise NotImplementedError(
                f"trainer.loss.{term} is not ported to ebfi_tpu_torch yet (ROADMAP.md, queue A, "
                f"{item}); train it with python -m ebfi_tpu.train"
            )


def make_train_step(
    detail_enabled: bool = True,
    phase_switch_iter: int = 10_000,
    compute_dtype=None,
    spatial: bool = False,
    loss_cfg: Optional[dict] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch) -> (state, {"train_loss": device scalar}).

    batch: frame (B, H, W, 3), event (B, H, W, 2TB), t (B, 1), gt_ex (B, 1)
    or absent, target (B, H, W, 3), on the model's device.  The state (its
    model's parameters, updater and step count) is updated in place and
    returned."""
    if spatial:
        raise NotImplementedError(
            "spatial (H-sharded) training is not ported to ebfi_tpu_torch yet (ROADMAP.md, "
            "queue A, A5)"
        )
    check_loss_cfg(loss_cfg)
    loss_fn = make_loss_fn(detail_enabled, phase_switch_iter, compute_dtype)

    def step_fn(state: TrainState, batch):
        loss = loss_fn(state.model, batch, state.step)
        loss.backward()
        state.updater.step()
        state.step += 1
        return state, {"train_loss": loss.detach()}

    return step_fn


def make_eval_step():
    """eval(model, batch) -> {"valid_loss"}: Charbonnier on the final
    head, f32."""

    @torch.no_grad()
    def eval_fn(model, batch):
        _, final = model(batch["frame"], batch["event"], batch["t"], batch.get("gt_ex"))
        return {"valid_loss": charbonnier_loss(final, batch["target"])}

    return eval_fn
