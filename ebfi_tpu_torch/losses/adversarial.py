"""Adversarial loss with a discriminator of its own (port of
``ebfi_tpu/losses/adversarial.py``).

    adv = AdversarialLoss(patch_size, gan_type)
    state = adv.init(seed, fake, real, frames)
    state, g_loss, d_loss = adv.step(state, fake, real, frames)

``step`` first takes ``gan_k`` discriminator updates on ``fake.detach()``
(each on the mean of its losses; the WGAN weights clamped to [-1, 1]
after each), then returns the generator loss of the UPDATED
discriminator, differentiable in ``fake`` and with no gradient for the
discriminator's parameters, and the mean of the discriminator's losses.
The state (:class:`AdvState`) holds the discriminator, its optimizer and
the generator of the WGAN-GP interpolation weights; ``step`` updates it in
place and returns it.

GAN types: GAN, WGAN, WGAN_GP, T_WGAN_GP, FI_GAN, FI_Cond_GAN, STGAN.
Optimizer: Adamax(1e-3) (optax's rule: ``u = max(b2 * u, |g| + eps)``,
which ``torch.optim.Adamax`` computes), Adam(1e-5, betas (0, 0.9)) for
WGAN_GP and T_WGAN_GP.  The gradient penalty is a double backward; its
weights are drawn per element over ``fake``'s shape from a generator
seeded 0 (the JAX state's ``key(0)``), on ``fake``'s device, or given to
``step`` as ``eps``.

Data parallelism (``world`` shards of the batch, this rank's shard
``rank``, their ranks ``group``): BN statistics are the global batch's
(summed over ``group``), the discriminator's gradients are averaged over
every rank before each of its updates, in a ``record_function`` range
``ebfi::disc_grad_allreduce``, and each rank takes its shard's slice of a
draw over the global batch's shape, so the ranks step as one process on
the whole batch.  Without spatial parallelism these are the world size,
the process's rank and None (the world); under DP x SP the data axis:
``spec.data``, ``spec.data_index`` and ``spec.data_group``.  The ranks of
a model group hold the same items, so the mean over every rank is the
mean over the data shards.  Its losses are means, so they need no
scaling.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.func import functional_call

from ..parallel import DISC_GRAD_RANGE, all_reduce_mean_, local_shard_info
from .discriminator import build_discriminator, init_discriminator

CONDITIONED = ("T_WGAN_GP", "FI_Cond_GAN", "STGAN")  # D(prev, x, next)
GP_TYPES = ("WGAN_GP", "T_WGAN_GP")


class AdvState(NamedTuple):
    disc: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator  # the gradient penalty's weights


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits, in the stable form."""
    return torch.mean(logits.clamp(min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


class AdversarialLoss:
    def __init__(self, patch_size: int, gan_type: str = "GAN", gan_k: int = 1, world: int = 1,
                 rank: Optional[int] = None, group=None):
        self.patch_size = patch_size  # unused, as in the JAX package: shapes come from init
        self.gan_type = gan_type
        self.gan_k = gan_k
        self.world = world  # the data shards
        self.rank = rank  # this rank's shard; the process's rank for None
        self.group = group  # the shards' ranks; the world for None

    # -------------------------------------------------------------- #

    def init(self, seed: Union[int, torch.Generator], fake, real, frames=None) -> AdvState:
        """A discriminator for ``fake``'s (H, W) on its device, f32,
        initialised from ``seed``; its optimizer; the penalty's generator."""
        g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        disc = build_discriminator(self.gan_type, fake.shape[1:3], sync=self.world > 1,
                                   group=self.group)
        disc = init_discriminator(disc, g).to(fake.device)
        if self.gan_type in GP_TYPES:
            opt = torch.optim.Adam(disc.parameters(), 1e-5, betas=(0.0, 0.9), eps=1e-8)
        else:
            opt = torch.optim.Adamax(disc.parameters(), 1e-3, betas=(0.9, 0.999), eps=1e-8)
        return AdvState(disc, opt, torch.Generator(fake.device).manual_seed(0))

    # -------------------------------------------------------------- #

    def _apply(self, disc, fake, real, frames):
        """(D(fake), D(real)), or FI_GAN's (D(prev, fake), D(fake, next))."""
        if self.gan_type in CONDITIONED:
            return disc(frames[:, 0], fake, frames[:, 1]), disc(frames[:, 0], real, frames[:, 1])
        if self.gan_type == "FI_GAN":
            return disc(frames[:, 0], fake), disc(fake, frames[:, 1])
        return disc(fake), disc(real)

    def d_loss(self, disc: nn.Module, fake_d, real, frames, eps: Optional[torch.Tensor] = None):
        """The discriminator's loss on a detached ``fake_d``; ``eps`` the
        gradient penalty's interpolation weights (WGAN_GP, T_WGAN_GP)."""
        gt = self.gan_type
        a, b = self._apply(disc, fake_d, real, frames)
        if gt not in ("WGAN", *GP_TYPES):  # GAN, FI_GAN, FI_Cond_GAN, STGAN
            return bce_logits(a, torch.zeros_like(a)) + bce_logits(b, torch.ones_like(b))
        loss = torch.mean(a - b)
        if gt in GP_TYPES:
            hat = (fake_d * (1 - eps) + real * eps).detach().requires_grad_(True)
            out = disc(frames[:, 0], hat, frames[:, 1]) if gt == "T_WGAN_GP" else disc(hat)
            (g,) = torch.autograd.grad(out.sum(), hat, create_graph=True)
            gnorm = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) + 1e-12)
            loss = loss + 10.0 * torch.mean((gnorm - 1.0) ** 2)
        return loss

    def g_loss(self, disc: nn.Module, fake, frames):
        """The generator's loss; ``disc`` is called as it is (``step``
        passes it with detached parameters)."""
        gt = self.gan_type
        if gt == "GAN":
            d = disc(fake)
            return bce_logits(d, torch.ones_like(d))
        if gt == "FI_GAN":
            d01 = torch.sigmoid(disc(frames[:, 0], fake))
            d12 = torch.sigmoid(disc(fake, frames[:, 1]))
            return torch.mean(d01 * torch.log(d01 + 1e-12) + d12 * torch.log(d12 + 1e-12))
        if gt in ("FI_Cond_GAN", "STGAN"):
            d = disc(frames[:, 0], fake, frames[:, 1])
            return bce_logits(d, torch.ones_like(d))
        d = disc(frames[:, 0], fake, frames[:, 1]) if gt == "T_WGAN_GP" else disc(fake)
        return -torch.mean(d)

    def draw_eps(self, state: AdvState, fake: torch.Tensor) -> torch.Tensor:
        """The penalty's weights for this rank: its slice of one draw over
        the global batch's shape."""
        B = fake.shape[0]
        eps = torch.rand((B * self.world, *fake.shape[1:]), generator=state.generator,
                         dtype=fake.dtype, device=fake.device)
        if self.world == 1:
            return eps
        rank = local_shard_info()[0] if self.rank is None else self.rank
        return eps[rank * B:(rank + 1) * B]

    def step(self, state: AdvState, fake, real, frames=None,
             eps: Optional[Sequence[torch.Tensor]] = None):
        """Update the discriminator in place; returns (state, g_loss,
        d_loss).  ``eps``: one tensor of penalty weights per discriminator
        update, instead of drawing them."""
        if frames is None:
            frames = torch.zeros((fake.shape[0], 2, *fake.shape[1:]), dtype=fake.dtype,
                                 device=fake.device)
        if state.disc.sync != (self.world > 1) or (self.world > 1
                                                    and state.disc.group is not self.group):
            raise ValueError(
                f"the discriminator's BN statistics run over (sync={state.disc.sync}, group="
                f"{state.disc.group}) but this loss's data axis is (world={self.world}, group="
                f"{self.group}): init the state with an AdversarialLoss of the same axis")
        fake_d = fake.detach()
        params = list(state.disc.parameters())
        d_total = 0.0
        for k in range(self.gan_k):
            e = None
            if self.gan_type in GP_TYPES:
                e = eps[k] if eps is not None else self.draw_eps(state, fake_d)
            state.opt.zero_grad(set_to_none=True)
            d_loss = self.d_loss(state.disc, fake_d, real, frames, e)
            d_loss.backward()
            if torch.distributed.is_initialized():
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                # the mean over every rank, not over the data group: under
                # DP x SP the replicas of a model group compute the same
                # gradients only up to the card's nondeterministic kernels
                # (cuDNN's weight gradients add with atomics), and a mean
                # over the world keeps them bitwise equal
                all_reduce_mean_([p.grad for p in params], range_name=DISC_GRAD_RANGE)
            state.opt.step()
            if self.gan_type == "WGAN":
                with torch.no_grad():
                    for p in params:
                        p.clamp_(-1.0, 1.0)
            d_total = d_total + d_loss.detach()
        state.opt.zero_grad(set_to_none=True)
        frozen = {n: p.detach() for n, p in state.disc.named_parameters()}
        g_loss = self.g_loss(lambda *x: functional_call(state.disc, frozen, x), fake, frames)
        return state, g_loss, d_total / self.gan_k
