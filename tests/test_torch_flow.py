"""The port's flow losses, brightness constancy and warping ops against
``ebfi_tpu`` on the CPU, on the same numpy inputs (B = 2, 10x14 images,
150 events of integer pixel coordinates).  Tolerances:

- gathers, roundings and the averaged image of warped events: exact;
- scatter-added images and loss values: 1e-5 relative (f32 sums in
  another order);
- gradients: relative L2 1e-4 (a weight's ``|x|`` or ``max(0, x)`` at
  its kink takes the same convention in both, see ``ops/warp.py``).

``BrightnessConstancy.generative_model`` takes the flow's values to the
host in the JAX package (``np.asarray``), so JAX cannot differentiate it
in the flow; its JAX flow gradient is taken with the host call replaced
by its value at the same flow, the constant it is there.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.losses import flow as jflow
from ebfi_tpu.losses import reconstruction as jrec
from ebfi_tpu.ops import warp as jwarp
from ebfi_tpu_torch.losses import BrightnessConstancy, EventWarping, averaged_iwe, deblur_events
from ebfi_tpu_torch.losses import flow as tflow
from ebfi_tpu_torch.ops import grid_sample, sobel_gradients
import torch_threads  # noqa: F401  (one intra-op thread per test process)

B, H, W, N = 2, 10, 14, 150
RES = (H, W)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _events(seed=0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 1, (B, N)), axis=1)
    ev = np.stack([ts, rng.integers(0, H, (B, N)), rng.integers(0, W, (B, N)),
                   rng.choice([-1.0, 1.0], (B, N))], axis=-1).astype(np.float32)
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], axis=-1).astype(np.float32)
    return ev, pol


def _flow(seed=1, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, 2)) * scale / max(RES)).astype(np.float32)


# ------------------------------------------------------------------ warp ops


def test_grid_sample_matches_jax_value_and_gradients():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (B, 7, 9, 2)).astype(np.float32)  # some samples outside
    want, vjp = jax.vjp(jwarp.grid_sample, jnp.asarray(img), jnp.asarray(grid))
    r = rng.standard_normal(want.shape).astype(np.float32)
    wi, wg = vjp(jnp.asarray(r))
    ti, tg = _t(img).requires_grad_(), _t(grid).requires_grad_()
    got = grid_sample(ti, tg)
    got.backward(_t(r))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert _rel_l2(ti.grad, wi) <= 1e-5 and _rel_l2(tg.grad, wg) <= 1e-5
    # what F.grid_sample computes, corners outside the image included
    ref = torch.nn.functional.grid_sample(ti.detach().permute(0, 3, 1, 2), tg.detach(),
                                          align_corners=True, padding_mode="zeros")
    np.testing.assert_allclose(got.detach().numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sobel_matches_jax():
    img = np.random.default_rng(3).standard_normal((B, H, W, 1)).astype(np.float32)
    for got, want in zip(sobel_gradients(_t(img)), jwarp.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- flow losses


@pytest.mark.parametrize("round_idx", [False, True])
def test_get_interpolation_and_iwe_match_jax(round_idx):
    ev, pol = _events()
    flow = _flow(scale=4.0)  # some events warp out of the image
    ev_flow = np.asarray(jflow._event_flow_lookup(jnp.asarray(flow), jnp.asarray(ev), RES))
    np.testing.assert_array_equal(tflow._event_flow_lookup(_t(flow), _t(ev), RES).numpy(), ev_flow)
    for tref in (1.0, 0.0):
        jidx, jw = jflow.get_interpolation(jnp.asarray(ev), jnp.asarray(ev_flow), tref, RES,
                                           max(RES), round_idx)
        tidx, tw = tflow.get_interpolation(_t(ev), _t(ev_flow), tref, RES, max(RES), round_idx)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
        pm = np.concatenate([pol[:, :, :1]] * (1 if round_idx else 4), axis=1)
        want = jflow.interpolate_iwe(jidx, jw, RES, jnp.asarray(pm))
        got = tflow.interpolate_iwe(tidx, tw, RES, _t(pm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert 0 < float(np.asarray(jw).sum()) < jw.shape[1] * B  # some weight was purged


def test_event_warping_matches_jax_value_and_flow_gradient():
    ev, pol = _events(4)
    flows = [_flow(5), _flow(6, scale=1.0)]
    loss = EventWarping(flow_regul_weight=0.5)
    jl, jg = jax.value_and_grad(
        lambda fl: jflow.EventWarping(flow_regul_weight=0.5)(fl, jnp.asarray(ev), jnp.asarray(pol),
                                                             RES))([jnp.asarray(f) for f in flows])
    tf = [_t(f).requires_grad_() for f in flows]
    tl = loss(tf, _t(ev), _t(pol), RES)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for t, g in zip(tf, jg):
        assert _rel_l2(t.grad, g) <= 1e-4


@pytest.mark.parametrize("round_idx", [True, False])
def test_deblur_events_matches_jax(round_idx):
    ev, pol = _events(7)
    flow = _flow(8)
    want = jflow.deblur_events(jnp.asarray(flow), jnp.asarray(ev), RES, max(RES), round_idx,
                               jnp.asarray(pol[:, :, :1]))
    got = deblur_events(_t(flow), _t(ev), RES, max(RES), round_idx, _t(pol[:, :, :1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_averaged_iwe_is_exact():
    ev, pol = _events(9)
    ev[:, :40, 1:3] = ev[:, 40:80, 1:3]  # sources shared by several events
    flow = _flow(10, scale=1.5)
    want = jflow.averaged_iwe(flow, ev, pol, RES)
    tf = _t(flow).requires_grad_()
    got = averaged_iwe(tf, _t(ev), _t(pol), RES)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want % 1 != 0).any()  # some pixel averages over several sources


# --------------------------------------------------------- brightness constancy


def _bc_inputs(seed=11):
    rng = np.random.default_rng(seed)
    ev, pol = _events(seed)
    cnt = rng.integers(0, 2, (B, H, W, 2)).astype(np.float32)
    img = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    prev = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    return _flow(seed + 1, 1.5), img, prev, cnt, ev, pol


def test_brightness_constancy_generative_model_matches_jax(monkeypatch):
    flow, img, _, cnt, ev, pol = _bc_inputs()
    jbc, tbc = jrec.BrightnessConstancy(RES), BrightnessConstancy(RES)
    args = [jnp.asarray(a) for a in (cnt, ev, pol)]
    want = jbc.generative_model(jnp.asarray(flow), jnp.asarray(img), *args)
    g_img = jax.grad(lambda i: jbc.generative_model(jnp.asarray(flow), i, *args))(jnp.asarray(img))
    # the flow gradient: the host call is the constant it is in the JAX package
    avg = jflow.averaged_iwe(flow * (cnt.sum(-1, keepdims=True) > 0), ev, pol, RES)
    monkeypatch.setattr(jrec, "np", types.SimpleNamespace(asarray=lambda x: x))
    monkeypatch.setattr(jrec, "averaged_iwe", lambda *a: avg)
    g_flow = jax.grad(lambda f: jbc.generative_model(f, jnp.asarray(img), *args))(jnp.asarray(flow))

    tf, ti = _t(flow).requires_grad_(), _t(img).requires_grad_()
    got = tbc.generative_model(tf, ti, _t(cnt), _t(ev), _t(pol))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert _rel_l2(ti.grad, g_img) <= 1e-4 and _rel_l2(tf.grad, g_flow) <= 1e-4


def test_brightness_constancy_consistency_and_regularization_match_jax():
    flow, img, prev, *_ = _bc_inputs(13)
    jbc, tbc = jrec.BrightnessConstancy(RES, (0.3, 2.0)), BrightnessConstancy(RES, (0.3, 2.0))
    jv, jg = jax.value_and_grad(lambda f, p, i: jbc.temporal_consistency(f, p, i),
                                argnums=(0, 1, 2))(*map(jnp.asarray, (flow, prev, img)))
    tin = [_t(a).requires_grad_() for a in (flow, prev, img)]
    tv = tbc.temporal_consistency(*tin)
    tv.backward()
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    for t, g in zip(tin, jg):
        assert _rel_l2(t.grad, g) <= 1e-4
    jv, jg = jax.value_and_grad(jbc.regularization)(jnp.asarray(img))
    ti = _t(img).requires_grad_()
    tv = tbc.regularization(ti)
    tv.backward()
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    np.testing.assert_array_equal(ti.grad.numpy(), np.asarray(jg))
