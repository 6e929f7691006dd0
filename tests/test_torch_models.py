"""The port's modules against the JAX package's, on the CPU.

Both packages get the same weights (the flax tree, randomised with numpy,
carried across by ``params_from_jax`` and loaded with strict=True) and the
same numpy inputs.  Tolerance f32: rtol=1e-4, atol=2e-5 -- the two
frameworks sum convolutions in different orders (and the port runs
ResidualControl's fuse conv as one conv over concat(u, v) where JAX adds
two half convs), which moves results by f32 rounding of partial sums.
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ebfi_tpu import models as jm
from ebfi_tpu_torch import models as tm

RTOL, ATOL = 1e-4, 2e-5
C, TB, STEP = 8, 4, 2
CHANNELS = (4, 6, 8, 12)
MODEL_ARGS = dict(
    frame_basech=C, event_basech=C, inter_ch=C, tb=TB, blurry_fashion="RGBLap",
    bl_in=4, step=STEP, dual_path=True, residual=True, detail_enabled=True,
    channels=CHANNELS,
)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol
    )


def random_params(jax_module, rng, *init_args, scale=0.1, **init_kw):
    """Init the flax module for its tree shapes, then replace every leaf by
    seeded normal noise (biases and norms included, so nothing is zero)."""
    params = jax_module.init(jax.random.key(0), *init_args, **init_kw)
    return jax.tree.map(
        lambda v: (scale * rng.standard_normal(v.shape)).astype(np.float32), params
    )


def port(torch_module, params):
    """Load the numpy flax tree into the port's module (strict) and return
    it with the JAX-side params as jnp arrays."""
    torch_module.load_state_dict(tm.params_from_jax(params), strict=True)
    return torch_module.eval(), jax.tree.map(jnp.asarray, params)


def make_inputs(rng, B=2, H=32, W=32, tb=TB):
    frame = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    event = rng.standard_normal((B, H, W, 2 * tb)).astype(np.float32)
    t = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    ex = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    return frame, event, t, ex


def T(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def J(*arrays):
    return [jnp.asarray(a) for a in arrays]


def evfi_pair(seed=0, **kw):
    """(torch model, jax model, jax params) with shared random weights."""
    args = dict(MODEL_ARGS, **kw)
    rng = np.random.default_rng(seed)
    jmodel = jm.EVFIAutoEx(**args)
    frame, event, t, _ = make_inputs(rng, B=1, H=16, W=16)
    params = random_params(jmodel, rng, *J(frame, event, t))
    tmodel, jparams = port(tm.EVFIAutoEx(**args), params)
    return tmodel, jmodel, jparams


@pytest.fixture(scope="module")
def evfi():
    return evfi_pair()


# ------------------------------------------------------------------ layers


def test_exposure_decision_matches_jax(rng):
    event = rng.standard_normal((2, 16, 20, 2 * TB)).astype(np.float32)
    bl = rng.standard_normal((2, 16, 20, 4)).astype(np.float32)
    jmod = jm.ExposureDecision(event_in=2 * TB, bl_in=4, inter_ch=C)
    params = random_params(jmod, rng, *J(event, bl))
    # GroupNorm scale near one, as trained, keeps the head in range
    params["params"]["group_norm"]["scale"] += 1.0
    tmod, jp = port(tm.ExposureDecision(2 * TB, 4, C), params)
    got = tmod(*T(event, bl))
    assert got.shape == (2, 1)
    close(got, jmod.apply(jp, *J(event, bl)))


@pytest.mark.parametrize("mode", ["full", "hoist_tail"])
def test_residual_control_matches_jax(rng, mode):
    N = 3
    data = rng.standard_normal((1, 10, 12, C)).astype(np.float32)
    ex = rng.uniform(0, 1, (1, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    jmod = jm.ResidualControl(basech=C, step=3)
    params = random_params(jmod, rng, *J(data, ex, t[:1]))
    tmod, jp = port(tm.ResidualControl(C, 3), params)
    if mode == "full":
        d = np.repeat(data, N, 0)
        e = np.repeat(ex, N, 0)
        close(tmod(*T(d, e, t)), jmod.apply(jp, *J(d, e, t)))
        return
    jh = jmod.apply(jp, *J(data, ex), None, mode="hoist")
    th = tmod(*T(data, ex), None, mode="hoist")
    for k in ("tx0", "hu0", "ex_scales"):
        close(th[k], jh[k])
    got = tmod(None, None, *T(t), mode="tail", hoisted=th)
    close(got, jmod.apply(jp, None, None, jnp.asarray(t), mode="tail", hoisted=jh))
    # hoist + tail == the full stack on the repeated frame
    full = tmod(*T(np.repeat(data, N, 0), np.repeat(ex, N, 0), t))
    close(got, full.detach().numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["full", "hoist_tail"])
def test_modification_matches_jax(rng, monkeypatch, fused, mode):
    """Unfused: cuDNN-style bank conv + plain FAC; fused: the plain
    versions of B3 (full) and B2 (tail).  The JAX side runs its fused
    Pallas kernels in interpret mode; H is odd so its tail takes the
    unpacked shared kernel that B2 ports."""
    monkeypatch.setenv("EBFI_FORCE_FUSED_MOD", "1")
    N, H, W = 3, 7, 10
    ff = rng.standard_normal((1, H, W, C)).astype(np.float32)
    ev = rng.standard_normal((N, H, W, C)).astype(np.float32)
    jmod = jm.Modification(frame_basech=C, fused=fused)
    params = random_params(jmod, rng, *J(ff, ev[:1]))
    tmod, jp = port(tm.Modification(C, C, fused=fused), params)
    if mode == "full":
        f = np.repeat(ff, N, 0)
        close(tmod(*T(f, ev)), jmod.apply(jp, *J(f, ev)))
        return
    jh = jmod.apply(jp, jnp.asarray(ff), None, mode="hoist")
    th = tmod(*T(ff), None, mode="hoist")
    assert set(th) == set(jh) == (set() if fused else {"bank_ff"})
    got = tmod(*T(ff, ev), mode="tail", hoisted=th)
    close(got, jmod.apply(jp, *J(ff, ev), mode="tail", hoisted=jh))


def test_unet3d18_matches_jax(rng):
    img0 = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    img1 = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    jmod = jm.UNet3d18(channels=CHANNELS)
    # the flax init is nonzero everywhere here (torch-default conv biases)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), *J(img0, img1)))
    tmod, jp = port(tm.UNet3d18(CHANNELS), params)
    got = tmod(*T(img0, img1))
    assert got.shape == (2, 16, 24, 3)
    close(got, jmod.apply(jp, *J(img0, img1)))


# ------------------------------------------------------------------ EVFIAutoEx


@pytest.mark.parametrize("hw", [(32, 32), (28, 36)])
def test_evfi_forward_matches_jax(rng, evfi, hw):
    """Full forward; (28, 36) exercises the pad-to-/8 and crop."""
    tmodel, jmodel, jp = evfi
    frame, event, t, _ = make_inputs(rng, B=2, H=hw[0], W=hw[1])
    s, f = tmodel(*T(frame, event, t))
    js, jf = jmodel.apply(jp, *J(frame, event, t))
    assert s.shape == f.shape == (2, *hw, 3)
    close(s, js)
    close(f, jf)


def test_evfi_trunk_hoist_and_shared_tail_match_jax(rng, evfi, monkeypatch):
    """features -> hoist -> from_timestamp_shared, fused Modification
    (plain B2 on the CPU) against JAX with its Pallas kernels."""
    monkeypatch.setenv("EBFI_FORCE_FUSED_MOD", "1")
    tmodel, jmodel, jp = evfi
    tmodel = copy.deepcopy(tmodel)
    tmodel.modification.fused = True
    jmodel = jmodel.clone(fast_mod=True)
    frame, event, _, _ = make_inputs(rng, B=1, H=24, W=40)
    t = rng.uniform(0, 1, (3, 1)).astype(np.float32)
    ttrunk = tmodel.features(*T(frame, event))
    jtrunk = jmodel.apply(jp, *J(frame, event), method=jm.EVFIAutoEx.features)
    for a, b in zip(ttrunk, jtrunk):
        close(a, b)
    th = tmodel.hoist(ttrunk)
    jh = jmodel.apply(jp, jtrunk, method=jm.EVFIAutoEx.hoist)
    ts, tf = tmodel.from_timestamp_shared(ttrunk, th, *T(t))
    js, jf = jmodel.apply(
        jp, jtrunk, jh, jnp.asarray(t), method=jm.EVFIAutoEx.from_timestamp_shared
    )
    close(ts, js)
    close(tf, jf)


@pytest.mark.parametrize("fashion", ["DarkCh", "Lap", "RGB", "RGBDark", "RGBLap"])
def test_blurry_level_matches_jax(rng, fashion):
    frame = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    tmodel = tm.EVFIAutoEx(**dict(MODEL_ARGS, blurry_fashion=fashion))
    jmodel = jm.EVFIAutoEx(**dict(MODEL_ARGS, blurry_fashion=fashion))
    got = tmodel.blurry_level(*T(frame))
    want = jmodel.apply({}, jnp.asarray(frame), method=jm.EVFIAutoEx.blurry_level)
    close(got, want, 0, 0)


# ------------------------------------------------------------------ construction


def test_params_from_jax_loads_strict_and_maps_layouts(evfi):
    _, _, jp = evfi
    params = jax.tree.map(np.asarray, jp)
    sd = tm.params_from_jax(params)
    model = tm.EVFIAutoEx(**MODEL_ARGS)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    p = params["params"]
    w = p["modification"]["kernel_conv"]["Conv_0"]["kernel"]  # HWIO
    assert torch.equal(model.modification.kernel_conv.conv.weight, torch.tensor(w.transpose(3, 2, 0, 1)))
    up = p["detail"]["dec1"]["upconv"]["kernel"]  # (kd, kh, kw, O, I)
    assert tuple(model.detail.dec1.upconv.weight.shape) == (up.shape[4], up.shape[3], 3, 4, 4)
    rc = p["residual_control"]["conv5"]  # (S, 3, 3, 2C, C)
    assert torch.equal(model.residual_control.conv5[1], torch.tensor(rc[1].transpose(3, 2, 0, 1)))


def test_build_model_reference_keys_and_seeded_init():
    cfg = {
        "name": "EVFIAutoEx",
        "args": {
            "FrameBasech": 16, "EventBasech": 16, "InterCH": 16, "TB": 4,
            "BlurryFashion": "RGBLap", "BLInch": 4, "step": 2, "DualPath": True,
            "residual": True, "DetailEnabled": True, "channels": [4, 6, 8, 12],
            "LoadPretrainEX": False, "norm": None, "activation": "LeakyReLU",
        },
    }
    a = tm.init_weights(tm.build_model(cfg), seed=3)
    b = tm.init_weights(tm.build_model(cfg), seed=3)
    c = tm.init_weights(tm.build_model(cfg), seed=4)
    assert a.residual_control.step == 2 and a.frame_feat.conv.out_channels == 16
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["frame_feat.conv.weight"], sc["frame_feat.conv.weight"])
    assert torch.count_nonzero(sa["residual_control.conv3a_b"]) == 0
    e = tm.build_model({"name": "ExposureDecision", "args": {"EventInch": 8, "BLInch": 4, "InterCH": 8}})
    assert isinstance(e, tm.ExposureDecision)
    with pytest.raises(ValueError):
        tm.build_model({"name": "Nope"})
