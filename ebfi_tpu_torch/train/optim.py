"""Optimizer and LR schedule (port of ``ebfi_tpu/train/optim.py``).

The schedule keeps the JAX package's iteration semantics: the optimizer
update with 0-based index ``step`` sees ``max(step - 1, 0) //
lr_change_rate`` completed scheduler steps, so the k-th StepLR decay first
applies at update k*step_size + 1; the lr_min gate steps while the lr is
at or above lr_min, so the lr freezes one decay below it.

The optimizers follow optax's update rules, which are the JAX package's:
Adam (AdamW when weight_decay is given: optax's ``adamw`` is decoupled,
so it is ``torch.optim.AdamW``, not Adam's L2 ``weight_decay``), AdamW,
Adamax, SGD (with momentum), and RMSprop as optax's (decay 0.9, eps inside
the square root), which ``torch.optim.RMSprop`` cannot express, so it has
an optimizer of its own here.  ``amsgrad`` is read and ignored, as there.

:class:`Updater` adds what ``optax.MultiSteps`` and ``multi_transform``
do there: the mean of ``accu_step`` micro-step gradients is applied every
``accu_step``-th call, the schedule counts applied updates, and a frozen
subtree (FrozenEX) is left out of the optimizer, so it gets no update and
no moments.  Under data parallelism it also averages the gradients over
the processes once per update, after accumulation (what XLA's all-reduce
does inside the JAX package's jitted step); under spatial parallelism
(D x S ranks) it sums them over the model axis, where each rank holds its
band's share, and averages them over the data axis: one all-reduce over
the world, divided by D.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch

from ..parallel import all_reduce_mean_


def _decays_until_below(base_lr: float, gamma: float, lr_min: float) -> int:
    """Smallest k with base*gamma^k < lr_min (the frozen decay count); a
    huge sentinel when the gate never engages."""
    if lr_min <= 0 or not (0 < gamma < 1):
        return 10**9
    k = 0
    lr = base_lr
    while lr >= lr_min and k < 200:
        lr *= gamma
        k += 1
    return k


def build_lr_factor(name: str, base_lr: float, args: dict, lr_min: float = 0.0,
                    lr_change_rate: int = 1) -> Callable[[int], float]:
    """factor(step) with lr = base_lr * factor(step), ``step`` the 0-based
    index of the optimizer update."""

    def sched_count(step):  # scheduler steps completed before update `step`
        return max(step - 1, 0) // lr_change_rate

    if name == "StepLR":
        size, gamma = int(args["step_size"]), float(args["gamma"])
        k_max = _decays_until_below(base_lr, gamma, lr_min)
        return lambda step: gamma ** min(sched_count(step) // size, k_max)
    if name == "ExponentialLR":
        gamma = float(args["gamma"])
        n_max = _decays_until_below(base_lr, gamma, lr_min)
        return lambda step: gamma ** min(sched_count(step), n_max)
    raise ValueError(f"Unknown lr_scheduler {name}")


def build_lr_schedule(name: str, base_lr: float, args: dict, lr_min: float = 0.0,
                      lr_change_rate: int = 1) -> Callable[[int], float]:
    """schedule(step) -> lr, ``step`` the 0-based optimizer update index."""
    factor = build_lr_factor(name, base_lr, args, lr_min, lr_change_rate)
    return lambda step: base_lr * factor(step)


class OptaxRMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` defaults: nu = decay*nu + (1 - decay)*g^2, then
    p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float = 1e-2, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt_(), value=-group["lr"])
        return loss


def trainable_params(model: torch.nn.Module, frozen_key: Optional[str]) -> List:
    """The parameters outside every submodule named ``frozen_key``, at any
    depth (the JAX package's ``subtree_freeze_labels``)."""
    return [p for name, p in model.named_parameters()
            if not (frozen_key and frozen_key in name.split(".")[:-1])]


def _torch_optimizer(name: str, params: Iterable, base_lr: float, args: dict):
    betas = tuple(args.get("betas", (0.9, 0.999)))
    wd = float(args.get("weight_decay", 0.0))
    if name == "Adam":
        if wd:
            return torch.optim.AdamW(params, base_lr, betas=betas, eps=1e-8, weight_decay=wd)
        return torch.optim.Adam(params, base_lr, betas=betas, eps=1e-8)
    if name == "AdamW":
        return torch.optim.AdamW(params, base_lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "Adamax":
        return torch.optim.Adamax(params, base_lr, betas=betas, eps=1e-8)
    if name == "SGD":
        return torch.optim.SGD(params, base_lr, momentum=float(args.get("momentum", 0.0)))
    if name == "RMSprop":
        return OptaxRMSprop(params, base_lr)
    raise ValueError(f"Unknown optimizer {name}")


class Updater:
    """The optimizer, its schedule and gradient accumulation.

    Call :meth:`step` after each micro-step's ``backward``: it applies an
    update (and advances the schedule) every ``accumulate_steps``-th call
    with the running mean of the micro-steps' gradients, as
    ``optax.MultiSteps`` does, and clears the gradients.  With
    ``data_parallel``, the gradients of every parameter it updates (zeros
    for one that got none, so that every rank reduces the same list) are
    averaged over the processes right before the update.  With ``spatial``
    (a :class:`~ebfi_tpu_torch.parallel.SpatialSpec`), they are summed over
    the model axis and averaged over the data axis instead."""

    def __init__(self, optimizer: torch.optim.Optimizer, factor: Callable[[int], float],
                 accumulate_steps: int = 1, data_parallel: bool = False, spatial=None):
        self.optimizer = optimizer
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
        self.accumulate_steps = accumulate_steps
        self.data_parallel = data_parallel or spatial is not None
        self.spatial = spatial
        self.mini_step = 0
        self._acc: List[Optional[torch.Tensor]] = []

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self) -> bool:
        """Returns whether an update was applied."""
        params = self.params
        if self.accumulate_steps > 1:
            if not self._acc:
                self._acc = [torch.zeros_like(p) for p in params]
            for p, acc in zip(params, self._acc):  # acc + (g - acc) / (n + 1)
                g = p.grad if p.grad is not None else torch.zeros_like(acc)
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate_steps:
                self.optimizer.zero_grad(set_to_none=True)
                return False
            for p, acc in zip(params, self._acc):
                p.grad = acc.clone()
                acc.zero_()
            self.mini_step = 0
        if self.data_parallel:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean_([p.grad for p in params],
                             divisor=None if self.spatial is None else self.spatial.data)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        return {
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "mini_step": self.mini_step,
            "acc_grads": [a.detach().cpu() for a in self._acc],
        }

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = int(state["mini_step"])
        self._acc = [a.to(p.device) for a, p in zip(state["acc_grads"], self.params)]


def build_optimizer(
    model: torch.nn.Module,
    optimizer_cfg: dict,
    scheduler_cfg: Optional[dict] = None,
    lr_min: float = 0.0,
    lr_change_rate: int = 1,
    accumulate_steps: int = 1,
    freeze_subtree: Optional[str] = None,
    data_parallel: bool = False,
    spatial=None,
) -> Tuple[Updater, Callable[[int], float]]:
    """(updater, schedule) over ``model``'s parameters.  Supported names:
    Adam, AdamW, SGD, Adamax, RMSprop.  ``freeze_subtree``: the name of a
    submodule whose parameters receive no update (FrozenEX).
    ``data_parallel``: average the gradients over the process group at
    every update.  ``spatial``: the :class:`~ebfi_tpu_torch.parallel.SpatialSpec`
    of a spatial train step (``make_train_step(spatial=...)``): sum the
    gradients over its model axis and average them over its data axis."""
    args = optimizer_cfg.get("args") or {}
    base_lr = float(args.get("lr", 1e-4))
    if scheduler_cfg is not None:
        factor = build_lr_factor(scheduler_cfg["name"], base_lr, scheduler_cfg.get("args", {}),
                                 lr_min=lr_min, lr_change_rate=lr_change_rate)
    else:
        factor = lambda step: 1.0  # noqa: E731
    opt = _torch_optimizer(optimizer_cfg["name"], trainable_params(model, freeze_subtree),
                           base_lr, args)
    return (Updater(opt, factor, accumulate_steps, data_parallel, spatial),
            (lambda step: base_lr * factor(step)))
