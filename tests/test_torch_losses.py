"""The port's losses against ``ebfi_tpu.losses`` on the CPU: values and
gradients with respect to the prediction, on the same numpy inputs.
Tolerance: 1e-5 relative to the reference's largest magnitude, f32 sums
reassociating between XLA and PyTorch (the Laplacian loss sums ~6000
absolute differences per level)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu import losses as jl
from ebfi_tpu_torch import losses as tl
import torch_threads  # noqa: F401  (one intra-op thread per test process)

NAMES = ["laplacian_loss", "census_loss", "charbonnier_loss", "mse_loss", "l1_loss"]
TOL = 1e-5


def _inputs(seed, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, shape).astype(np.float32), rng.uniform(0, 1, shape).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(np.asarray(want)).max()), 1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_loss_value_and_gradient_match_jax(name):
    pred, target = _inputs(NAMES.index(name))
    jval, jgrad = jax.value_and_grad(getattr(jl, name))(jnp.asarray(pred), jnp.asarray(target))
    tp = torch.tensor(pred, requires_grad=True)
    tval = getattr(tl, name)(tp, torch.tensor(target))
    (tgrad,) = torch.autograd.grad(tval, tp)
    assert abs(tval.item() - float(jval)) <= TOL * abs(float(jval))
    assert _rel(tgrad.numpy(), jgrad) <= TOL


def test_census_loss_target_branch_is_detached():
    pred, target = _inputs(7)
    tp, tt = torch.tensor(pred, requires_grad=True), torch.tensor(target, requires_grad=True)
    tl.census_loss(tp, tt).backward()
    assert tt.grad is None and tp.grad is not None


def test_laplacian_pyramid_levels_match_jax():
    from ebfi_tpu.losses.restore import laplacian_pyramid as jpyr
    from ebfi_tpu_torch.losses.restore import laplacian_pyramid as tpyr

    x, _ = _inputs(8, (1, 48, 64, 3))
    for a, b in zip(tpyr(torch.tensor(x)), jpyr(jnp.asarray(x))):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= TOL
