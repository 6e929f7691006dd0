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

``trainer.loss.adversarial.enabled`` adds ``weight * g_loss`` (weight
0.01 by default) and steps a discriminator inside the train step, as the
JAX step does (:func:`build_adversarial`; its state, a discriminator with
its optimizer, lives in ``TrainState.adv_state``, from
:func:`init_adv_state`).  The discriminator sees the final head in f32
and keeps f32 parameters in both precisions; the GAN types conditioned on
a frame pair get the blurry input frame twice.  It takes one update per
micro-step, accumulation or not (the JAX step calls it every micro-step,
where ``optax.MultiSteps`` defers only the model's update); under data
parallelism its BN statistics and gradients are the global batch's
(:mod:`~ebfi_tpu_torch.losses.adversarial`).  Its losses are means: no
``world`` scaling.  The step returns ``g_loss`` and ``d_loss`` beside
``train_loss``; the adversarial work runs inside a ``record_function``
range ``ebfi::adversarial``.

Spatial parallelism, DP x SP (``spatial=``, the
:class:`~ebfi_tpu_torch.parallel.SpatialSpec` of
``spatial_shardings(model_parallel)``): the ranks form a D x S grid, the
model axis fastest.  Each rank is given its data shard's whole items, as
under data parallelism; the step cuts its own band of H / S rows out of
the frame and the events, runs the model on it inside a band scope (every
row-coupled op takes its halo rows, every image statistic sums over the
model axis; Modification runs unfused, as the JAX step falls back from
its Pallas kernel), and gathers the two heads over the model axis, so
every rank of a data shard computes the loss of its whole items.  The
gather's backward hands each rank its band's rows of the gradient: the
ranks' gradients sum over the model axis to the shard's, and the sum
terms scale by D (not by D x S) so that the mean over the data axis is
the global batch's.  The Updater, built with the same ``spatial``, sums
over the model axis and averages over the data axis.  The adversarial
and perceptual terms raise under ``spatial``: not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from ..losses import (LPIPS, AdversarialLoss, AdvState, census_loss, charbonnier_loss,
                      laplacian_loss, load_lpips_params)
from ..parallel import SpatialSpec, band_scope, gather_rows
from .optim import Updater

ADV_RANGE = "ebfi::adversarial"


@dataclass
class TrainState:
    """The model (f32 parameters, trained in place), its updater, the
    count of micro-steps taken (``TrainState.step`` of the JAX package),
    and the discriminator's state where the adversarial term is on."""

    model: nn.Module
    updater: Updater
    step: int = 0
    adv_state: Optional[AdvState] = None


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


def _apply_on_band(model, inputs, compute_dtype, spec: SpatialSpec):
    """(sharp, final) of the whole items, in f32: the model on this rank's
    band of the frame and the events, the heads gathered over the model
    axis."""
    frame, event, t, gt_ex = inputs
    r0, r1 = spec.band_rows(frame.shape[1])
    with band_scope(spec):
        sharp, final = _apply_model(model, (frame[:, r0:r1], event[:, r0:r1], t, gt_ex),
                                    compute_dtype)
    heads = gather_rows(torch.cat([sharp.float(), final.float()], dim=-1), spec)
    return heads[..., :3], heads[..., 3:]


def make_loss_fn(detail_enabled: bool, phase_switch_iter: int = 10_000, compute_dtype=None,
                 world: int = 1, spatial: Optional[SpatialSpec] = None):
    """loss_fn(model, batch, step) -> (loss, final): the loss of this rank's
    batch (its sum terms scaled by ``world``) and the final head in f32.
    With ``spatial``, the model runs on this rank's band and the loss is
    that of the whole items (see the module's docstring)."""
    def loss_fn(model, batch, step: int):
        target = batch["target"]
        inputs = (batch["frame"], batch["event"], batch["t"], batch.get("gt_ex"))
        if spatial is None:
            sharp, final = _apply_model(model, inputs, compute_dtype)
            sharp, final = sharp.float(), final.float()
        else:
            sharp, final = _apply_on_band(model, inputs, compute_dtype, spatial)
        if detail_enabled:
            early = step < phase_switch_iter
            w_final, w_pre = (0.1, 1.0) if early else (1.0, 0.1)
            loss = (w_final * _pair_loss(final, target, world)
                    + w_pre * _pair_loss(sharp, target, world))
        else:
            loss = _pair_loss(final, target, world)
        return loss, final

    return loss_fn


def build_adversarial(loss_cfg: Optional[dict], world: int = 1) -> Optional[AdversarialLoss]:
    """The AdversarialLoss of ``trainer.loss.adversarial`` (None when it is
    absent or off), STGAN by default as the reference constructs it;
    ``world``: the data-parallel ranks."""
    acfg = (loss_cfg or {}).get("adversarial") or {}
    if not acfg.get("enabled", False):
        return None
    return AdversarialLoss(patch_size=int(acfg.get("patch_size", 32)),
                           gan_type=acfg.get("gan_type", "STGAN"),
                           gan_k=int(acfg.get("gan_k", 1)), world=world)


def init_adv_state(adv: AdversarialLoss, seed, batch_like: Dict[str, Any]) -> AdvState:
    """The discriminator's state, its shapes and device from a sample
    batch's ``target`` and ``frame``, its weights from ``seed`` (an int or
    a ``torch.Generator``)."""
    fake = torch.zeros_like(batch_like["target"], dtype=torch.float32)
    frame = batch_like["frame"].float()
    return adv.init(seed, fake, fake, torch.stack([frame, frame], dim=1))


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
    spatial: Optional[SpatialSpec] = None,
    loss_cfg: Optional[dict] = None,
    world: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch) -> (state, {"train_loss": device scalar,
    "lpips_loss" with the perceptual term, "g_loss" and "d_loss" with the
    adversarial one}).

    batch: frame (B, H, W, 3), event (B, H, W, 2TB), t (B, 1), gt_ex (B, 1)
    or absent, target (B, H, W, 3), on the model's device: under data
    parallelism this rank's share of the global batch, ``world`` ranks in
    all.  The state (its model's parameters, updater and step count) is
    updated in place and returned.

    ``spatial``: None, or the spec of ``spatial_shardings(model_parallel)``
    for DP x SP: the batch is then this rank's data shard, whole (every
    rank of a model group is given the same items), H a multiple of 8 x
    the model axis; the sum terms scale by the spec's data axis (``world``
    must be 1 or that); the updater must be built with the same spec.  The
    train_loss is the data shard's, the same on every rank of a model
    group."""
    if spatial is not None:
        if not isinstance(spatial, SpatialSpec):
            raise TypeError("spatial takes the SpatialSpec of "
                            f"ebfi_tpu_torch.parallel.spatial_shardings(), got {spatial!r}")
        for term in ("adversarial", "perceptual"):
            if ((loss_cfg or {}).get(term) or {}).get("enabled", False):
                raise NotImplementedError(
                    f"the {term} term (trainer.loss.{term}) under spatial (H-sharded) "
                    "parallelism is not ported to ebfi_tpu_torch")
        if world not in (1, spatial.data):
            raise ValueError(f"world={world}, but the spatial spec's data axis is {spatial.data}")
        world = spatial.data
    loss_fn = make_loss_fn(detail_enabled, phase_switch_iter, compute_dtype, world, spatial)
    lpips, w_lpips = build_lpips_term(loss_cfg)
    adv = build_adversarial(loss_cfg, world)
    w_adv = float(((loss_cfg or {}).get("adversarial") or {}).get("weight", 0.01))

    def step_fn(state: TrainState, batch):
        if spatial is not None and state.updater.spatial is not spatial:
            raise ValueError("a spatial train step needs the updater of "
                             "build_optimizer(..., spatial=<the same spec>)")
        loss, final = loss_fn(state.model, batch, state.step)
        metrics = {}
        if lpips is not None:
            lp = lpips.to(final.device)(final.clamp(0.0, 1.0), batch["target"].float()).mean()
            loss = loss + w_lpips * lp
            metrics["lpips_loss"] = lp.detach()
        if adv is not None:
            if state.adv_state is None:
                raise ValueError("the adversarial loss is on but state.adv_state is None: set it "
                                 "to init_adv_state(...) first")
            frame = batch["frame"].float()
            with torch.autograd.profiler.record_function(ADV_RANGE):
                state.adv_state, g_loss, d_loss = adv.step(
                    state.adv_state, final, batch["target"].float(),
                    torch.stack([frame, frame], dim=1))
            loss = loss + w_adv * g_loss
            metrics["g_loss"], metrics["d_loss"] = g_loss.detach(), d_loss
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
