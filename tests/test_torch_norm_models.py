"""EVFIAutoEx with a norm (``dual_path=False``) against the JAX package's,
on the CPU.

The weights are the flax tree randomised with numpy (BN's running
variance kept positive), carried across by ``params_from_jax`` with its
``batch_stats``.  The detail branch, which has no norm, is left out.
Tolerance as in ``test_torch_models.py``: f32, rtol 1e-4 and atol 2e-5 on
the outputs.  The parameter gradients: rtol 1e-3 and an atol of 1e-4 of
the tensor's largest magnitude plus 1e-6 of the model's largest, since a
norm's backward subtracts sums of nearly equal terms (a conv bias before
an instance norm has a gradient of 0 in exact arithmetic, and of
rounding's size in f32 on both sides).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu import models as jm
from ebfi_tpu_torch import models as tm
from test_torch_models import CHANNELS, TB, J, T, close, make_inputs, random_params
import torch_threads  # noqa: F401  (one intra-op thread per test process)

C = 8
ARGS = dict(frame_basech=C, event_basech=C, inter_ch=C, tb=TB, blurry_fashion="RGBLap",
            bl_in=4, step=2, dual_path=False, residual=True, detail_enabled=False,
            channels=CHANNELS)


def norm_pair(norm, seed=0):
    """(port model, JAX model, JAX variables) with shared random weights and
    non-trivial BN statistics."""
    rng = np.random.default_rng(seed)
    jmodel = jm.EVFIAutoEx(norm=norm, **ARGS)
    frame, event, t, _ = make_inputs(rng, B=1, H=16, W=16)
    variables = dict(random_params(jmodel, rng, *J(frame, event, t)))
    if "batch_stats" in variables:
        stats = variables["batch_stats"]
        flat = jax.tree_util.tree_flatten_with_path(stats)[0]
        leaves = [np.abs(v) + 0.5 if "var" in jax.tree_util.keystr(p) else v for p, v in flat]
        variables["batch_stats"] = jax.tree.unflatten(jax.tree.structure(stats), leaves)
    tmodel = tm.EVFIAutoEx(norm=norm, **ARGS)
    tmodel.load_state_dict(tm.params_from_jax(variables), strict=True)
    return tmodel.eval(), jmodel, jax.tree.map(jnp.asarray, variables)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_norm_model_forward_and_gradients_match_jax(norm):
    tmodel, jmodel, jvars = norm_pair(norm)
    rng = np.random.default_rng(1)
    frame, event, t, _ = make_inputs(rng, B=2, H=16, W=16)
    r = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)

    def jloss(params):
        s, f = jmodel.apply(dict(jvars, params=params), *J(frame, event, t))
        return jnp.sum((s + f) * r), (s, f)

    (_, (js, jf)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jvars["params"])
    s, f = tmodel(*T(frame, event, t))
    close(s, js)
    close(f, jf)
    ((s + f) * torch.from_numpy(r)).sum().backward()
    want = tm.params_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # unused: zero in JAX
        np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max())
                                   + 1e-6 * scale, err_msg=name)
    if norm == "BN":  # running statistics, not the batch's
        assert float(tmodel.frame_feat.norm.running_var.min()) >= 0.5


def test_fast_mod_with_a_norm_takes_the_unfused_path(monkeypatch):
    """fast_mod with a norm computes the unfused bank act(norm(conv(.))),
    as the JAX model gates its fused kernel on norm is None."""
    monkeypatch.setenv("EBFI_FORCE_FUSED_MOD", "1")
    tmodel, jmodel, jvars = norm_pair("BN", seed=2)
    fused = copy.deepcopy(tmodel)
    fused.modification.fused = True
    calls = []
    from ebfi_tpu_torch.ops.cuda import mod_fac as mod_fac_mod

    monkeypatch.setattr(mod_fac_mod, "_run_fused", lambda *a: calls.append(a))
    frame, event, t, _ = make_inputs(np.random.default_rng(3), B=1, H=16, W=16)
    with torch.no_grad():
        s, f = fused(*T(frame, event, t))
    js, jf = jmodel.clone(fast_mod=True).apply(jvars, *J(frame, event, t))
    assert not calls and not fused.modification.use_fused(torch.zeros(1, 4, 4, C))
    close(s, js)
    close(f, jf)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_dual_path_with_a_norm_raises_as_jax_does(norm):
    frame, event, t, _ = make_inputs(np.random.default_rng(4), B=1, H=16, W=16)
    args = dict(ARGS, dual_path=True)
    with pytest.raises(NotImplementedError, match="norm=None"):
        jm.EVFIAutoEx(norm=norm, **args).init(jax.random.key(0), *J(frame, event, t))
    with pytest.raises(NotImplementedError, match="norm=None"):
        tm.EVFIAutoEx(norm=norm, **args)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_build_model_passes_the_norm_through_and_inits(norm):
    cfg = {"name": "EVFIAutoEx", "args": {"FrameBasech": 8, "EventBasech": 8, "InterCH": 8,
                                          "TB": 4, "step": 2, "DualPath": False, "norm": norm,
                                          "channels": [4, 6, 8, 12]}}
    model = tm.build_model(cfg)
    for layer in (model.frame_feat, model.recon_out, model.exposure_decision.head2,
                  model.modification.kernel_conv):
        assert layer.norm_kind == norm and (layer.conv.bias is None) == (norm == "BN")
    for scheme in ("random", "train"):  # the train CLI's init, with BN's bias-free convs
        tm.init_weights(model, 0, scheme=scheme)
        assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
