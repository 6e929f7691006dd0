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
compute the same function.)  Gradient accumulation, and the gradients'
average over data-parallel ranks, live in the
:class:`~ebfi_tpu_torch.train.optim.Updater`.

``trainer.loss.perceptual.enabled`` adds ``weight * mean(LPIPS(clip(final,
0, 1), target))`` (weight 0.1 by default), in f32 in both precisions; the
LPIPS backbone is frozen and not among the model's parameters.

Data parallelism (``world`` ranks, each with its share of the global
batch): the JAX step computes its loss over the global batch, and its
terms are of two kinds, sums over the batch (Laplacian; the eval step's
Charbonnier) and means (census, LPIPS).  Each rank here scales its sums
by ``world``, so that the mean over the ranks of their losses, and of
their gradients (the Updater's all-reduce), is the global batch's.

Not ported yet, and raising ``NotImplementedError``: the adversarial loss
term (``trainer.loss``; ROADMAP.md A5) and H-sharded spatial parallelism
(A5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from ..losses import LPIPS, census_loss, charbonnier_loss, laplacian_loss, load_lpips_params
from .optim import Updater


@dataclass
class TrainState:
    """The model (f32 parameters, trained in place), its updater, and the
    count of micro-steps taken (``TrainState.step`` of the JAX package)."""

    model: nn.Module
    updater: Updater
    step: int = 0


def _pair_loss(pred, target, world=1):
    return world * laplacian_loss(pred, target) + census_loss(pred, target)


def _cast(x, dtype):
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _apply_model(model: nn.Module, inputs: Tuple, compute_dtype=None):
    """model(*inputs), or in ``compute_dtype``: the model on a cast copy of
    its parameters and floating inputs; gradients reach the originals."""
    if compute_dtype is None:
        return model(*inputs)
    params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    return functional_call(model, params, tuple(_cast(x, compute_dtype) for x in inputs))


def make_loss_fn(detail_enabled: bool, phase_switch_iter: int = 10_000, compute_dtype=None,
                 world: int = 1):
    """loss_fn(model, batch, step) -> (loss, final): the loss of this rank's
    batch (its sum terms scaled by ``world``) and the final head in f32."""
    def loss_fn(model, batch, step: int):
        target = batch["target"]
        sharp, final = _apply_model(
            model, (batch["frame"], batch["event"], batch["t"], batch.get("gt_ex")), compute_dtype
        )
        sharp, final = sharp.float(), final.float()
        if detail_enabled:
            early = step < phase_switch_iter
            w_final, w_pre = (0.1, 1.0) if early else (1.0, 0.1)
            loss = (w_final * _pair_loss(final, target, world)
                    + w_pre * _pair_loss(sharp, target, world))
        else:
            loss = _pair_loss(final, target, world)
        return loss, final

    return loss_fn


def check_loss_cfg(loss_cfg: Optional[dict]) -> None:
    if ((loss_cfg or {}).get("adversarial") or {}).get("enabled", False):
        raise NotImplementedError(
            "trainer.loss.adversarial is not ported to ebfi_tpu_torch yet (ROADMAP.md, queue A, "
            "A5); train it with python -m ebfi_tpu.train"
        )


def build_lpips_term(loss_cfg: Optional[dict]):
    """(LPIPS module, weight) of ``trainer.loss.perceptual``, or (None, 0)
    when it is off (``_build_lpips_term`` of the JAX package)."""
    pcfg = (loss_cfg or {}).get("perceptual") or {}
    if not pcfg.get("enabled", False):
        return None, 0.0
    lpips = LPIPS(load_lpips_params(pcfg.get("lpips_weights"), pcfg.get("alexnet_weights")))
    return lpips, float(pcfg.get("weight", 0.1))


def make_train_step(
    detail_enabled: bool = True,
    phase_switch_iter: int = 10_000,
    compute_dtype=None,
    spatial: bool = False,
    loss_cfg: Optional[dict] = None,
    world: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch) -> (state, {"train_loss": device scalar,
    and "lpips_loss" with the perceptual term}).

    batch: frame (B, H, W, 3), event (B, H, W, 2TB), t (B, 1), gt_ex (B, 1)
    or absent, target (B, H, W, 3), on the model's device: under data
    parallelism this rank's share of the global batch, ``world`` ranks in
    all.  The state (its model's parameters, updater and step count) is
    updated in place and returned."""
    if spatial:
        raise NotImplementedError(
            "spatial (H-sharded) training is not ported to ebfi_tpu_torch yet (ROADMAP.md, "
            "queue A, A5)"
        )
    check_loss_cfg(loss_cfg)
    loss_fn = make_loss_fn(detail_enabled, phase_switch_iter, compute_dtype, world)
    lpips, w_lpips = build_lpips_term(loss_cfg)

    def step_fn(state: TrainState, batch):
        loss, final = loss_fn(state.model, batch, state.step)
        metrics = {}
        if lpips is not None:
            lp = lpips.to(final.device)(final.clamp(0.0, 1.0), batch["target"].float()).mean()
            loss = loss + w_lpips * lp
            metrics["lpips_loss"] = lp.detach()
        loss.backward()
        state.updater.step()
        state.step += 1
        return state, {"train_loss": loss.detach(), **metrics}

    return step_fn


def make_eval_step(world: int = 1):
    """eval(model, batch) -> {"valid_loss"}: Charbonnier on the final
    head, f32, times ``world`` (a sum over this rank's share of the
    batch)."""

    @torch.no_grad()
    def eval_fn(model, batch):
        _, final = model(batch["frame"], batch["event"], batch["t"], batch.get("gt_ex"))
        return {"valid_loss": world * charbonnier_loss(final, batch["target"])}

    return eval_fn
