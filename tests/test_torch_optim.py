"""The port's optimizers and LR schedule against ``ebfi_tpu.train.optim``
(optax) on the CPU.

The schedule is compared at every tested update index in f32, where the
JAX schedule computes: StepLR (powers of 0.5) exactly; ExponentialLR to
1e-4 relative, since the JAX schedule raises gamma rounded to f32 to the
power k in f32 (0.9 is 0.89999998 in f32, so its k-th power drifts by
about k x 3e-8 relative, 1.5e-5 at k = 500) where the port computes in
f64.  The optimizers get the same gradients, drawn
from numpy, for 5 updates; parameters are compared after each, to 1e-6
absolute (f32 rounding of updates of size ~lr = 1e-2 on parameters of
size ~1).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from ebfi_tpu.train.optim import build_lr_schedule as jax_schedule
from ebfi_tpu.train.optim import build_optimizer as jax_build
from ebfi_tpu_torch.train.optim import build_lr_schedule, build_optimizer
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ATOL = 1e-6


class Toy(nn.Module):
    """Parameters under two subtrees, as a flax tree {'params': {...}}."""

    def __init__(self):
        super().__init__()
        self.exposure_decision = nn.Module()
        self.exposure_decision.w = nn.Parameter(torch.zeros(3, 4))
        self.other = nn.Module()
        self.other.w = nn.Parameter(torch.zeros(5))
        self.other.b = nn.Parameter(torch.zeros(2, 2))


def _toy(seed):
    rng = np.random.default_rng(seed)
    m = Toy()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.tensor(rng.standard_normal(p.shape).astype(np.float32)))
    # copies: jnp.asarray may alias a numpy buffer, here the torch parameter's
    val = lambda p: jnp.asarray(p.detach().numpy().copy())  # noqa: E731
    tree = {"params": {
        "exposure_decision": {"w": val(m.exposure_decision.w)},
        "other": {"w": val(m.other.w), "b": val(m.other.b)},
    }}
    return m, tree


def _grads(seed, n):
    rng = np.random.default_rng(seed)
    return [{"exposure_decision.w": rng.standard_normal((3, 4)).astype(np.float32),
             "other.w": rng.standard_normal(5).astype(np.float32),
             "other.b": rng.standard_normal((2, 2)).astype(np.float32)} for _ in range(n)]


def _jtree(g):
    return {"params": {"exposure_decision": {"w": jnp.asarray(g["exposure_decision.w"])},
                       "other": {"w": jnp.asarray(g["other.w"]), "b": jnp.asarray(g["other.b"])}}}


def _flat(tree):
    p = tree["params"]
    return {"exposure_decision.w": np.asarray(p["exposure_decision"]["w"]),
            "other.w": np.asarray(p["other"]["w"]), "other.b": np.asarray(p["other"]["b"])}


def _run_both(opt_cfg, sched_cfg=None, steps=5, accumulate=1, freeze=None, lr_min=0.0):
    m, tree = _toy(0)
    updater, _ = build_optimizer(m, opt_cfg, sched_cfg, lr_min=lr_min,
                                 accumulate_steps=accumulate, freeze_subtree=freeze)
    tx, _ = jax_build(opt_cfg, sched_cfg, lr_min=lr_min, accumulate_steps=accumulate,
                      freeze_subtree=freeze)
    state = tx.init(tree)
    before = {n: p.detach().clone().numpy() for n, p in m.named_parameters()}
    for g in _grads(1, steps):
        for n, p in m.named_parameters():
            p.grad = torch.tensor(g[n])
        updater.step()
        updates, state = tx.update(_jtree(g), state, tree)
        tree = optax.apply_updates(tree, updates)
        want = _flat(tree)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], atol=ATOL, rtol=0, err_msg=n)
    return m, before, updater


OPTIMIZERS = {
    "Adam": {"name": "Adam", "args": {"lr": 1e-2, "betas": [0.9, 0.999], "amsgrad": False}},
    "Adam_weight_decay": {"name": "Adam", "args": {"lr": 1e-2, "weight_decay": 0.1}},
    "AdamW": {"name": "AdamW", "args": {"lr": 1e-2, "weight_decay": 0.05}},
    "Adamax": {"name": "Adamax", "args": {"lr": 1e-2, "betas": [0.8, 0.99]}},
    "SGD": {"name": "SGD", "args": {"lr": 1e-2}},
    "SGD_momentum": {"name": "SGD", "args": {"lr": 1e-2, "momentum": 0.9}},
    "RMSprop": {"name": "RMSprop", "args": {"lr": 1e-2}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax_over_five_steps(name):
    _run_both(OPTIMIZERS[name])


def test_optimizer_follows_the_schedule():
    """StepLR with step_size 2 decays inside the 5 updates: the k-th decay
    first applies at update 2k + 1."""
    _run_both(OPTIMIZERS["Adam"], {"name": "StepLR", "args": {"step_size": 2, "gamma": 0.5}})


def test_frozen_subtree_gets_no_update_and_no_state():
    m, before, updater = _run_both(OPTIMIZERS["Adam"], freeze="exposure_decision")
    np.testing.assert_array_equal(m.exposure_decision.w.detach().numpy(),
                                  before["exposure_decision.w"])
    assert all(p is not m.exposure_decision.w for p in updater.params)
    assert m.exposure_decision.w not in updater.optimizer.state
    assert not np.array_equal(m.other.w.detach().numpy(), before["other.w"])


def test_gradient_accumulation_matches_multisteps():
    """accu_step = 2: updates land on every second micro-step with the mean
    gradient; the schedule counts applied updates."""
    _run_both(OPTIMIZERS["Adam"], {"name": "StepLR", "args": {"step_size": 2, "gamma": 0.5}},
              steps=8, accumulate=2)


SCHEDULES = [
    ("StepLR", {"step_size": 10, "gamma": 0.5}, 1e-5, 1),
    ("StepLR", {"step_size": 10, "gamma": 0.5}, 0.0, 3),
    ("StepLR", {"step_size": "2e5", "gamma": 0.5}, 1e-6, 1),
    ("ExponentialLR", {"gamma": 0.9}, 5e-5, 1),
    ("ExponentialLR", {"gamma": 0.9}, 0.0, 2),
]


@pytest.mark.parametrize("name,args,lr_min,rate", SCHEDULES)
def test_lr_schedule_equals_jax(name, args, lr_min, rate):
    args = {k: float(v) if isinstance(v, str) else v for k, v in args.items()}
    steps = sorted({0, 1, 2, 3, 9, 10, 11, 12, 19, 20, 21, 22, 29, 30, 31, 60, 61, 100, 1000,
                    200_000, 200_001, 400_000, 400_001, 2_000_000, 10**7})
    port = build_lr_schedule(name, 1e-4, args, lr_min=lr_min, lr_change_rate=rate)
    ref = jax_schedule(name, 1e-4, args, lr_min=lr_min, lr_change_rate=rate)
    for s in steps:
        want = np.float32(ref(jnp.asarray(s, jnp.int32)))
        got = np.float32(port(s))
        np.testing.assert_allclose(got, want, rtol=0 if name == "StepLR" else 1e-4,
                                   err_msg=f"step {s}")


def test_steplr_boundaries_and_lr_min_freeze():
    sched = build_lr_schedule("StepLR", 1e-4, {"step_size": 10, "gamma": 0.5}, lr_min=1e-5)
    assert sched(10) == pytest.approx(1e-4)
    assert sched(11) == pytest.approx(5e-5)
    assert sched(21) == pytest.approx(2.5e-5)
    # the gate steps while lr >= lr_min, so the lr freezes one decay below it
    assert sched(10**6) == pytest.approx(6.25e-6)


def test_updater_lr_follows_schedule_per_update():
    """The lr the optimizer applies at update k is schedule(k)."""
    m, _ = _toy(0)
    cfg = {"name": "StepLR", "args": {"step_size": 3, "gamma": 0.5}}
    updater, sched = build_optimizer(m, OPTIMIZERS["SGD"], cfg)
    for k in range(10):
        assert updater.lr == pytest.approx(sched(k), rel=1e-12)
        for p in m.parameters():
            p.grad = torch.zeros_like(p)
        updater.step()
