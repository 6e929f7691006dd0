"""The port's op and block library against the JAX package on the CPU:
DCNv2 (``ops/dcn_v2.py``, ``ops/dcn_modules.py``), deformable PSROI
pooling, every block of ``models/library.py`` and ConvLayer's BN and IN.

The same numpy inputs from a seed go through the JAX function and the
port's; flax weights cross over through ``params_from_jax``.  Tolerances:

- forwards, f32: 1e-5 relative to the output's largest magnitude (plus
  1e-6 absolute): the same ops, with sums (convolutions, the DCN
  contraction over Cin*K*K, the norms' statistics) in another order;
- DCN gradients, f32: 1e-4 relative to each gradient's largest magnitude:
  the backward sums scatter-adds over the taps' gathers, whose order
  differs between XLA and PyTorch;
- BN running statistics after a train step: 1e-6 absolute (a mean and a
  biased variance over 128 values, moved by 0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.models import library as jlib
from ebfi_tpu.models.layers import ConvLayer as JaxConvLayer
from ebfi_tpu.ops import dcn_v2_conv as jax_dcn_v2_conv
from ebfi_tpu.ops import dcn_modules as jdcn
from ebfi_tpu_torch.models import library as tlib
from ebfi_tpu_torch.models import params_from_jax
from ebfi_tpu_torch.models.layers import ConvLayer
from ebfi_tpu_torch.ops import dcn_modules as tdcn
from ebfi_tpu_torch.ops.dcn_v2 import dcn_v2_conv
import torch_threads  # noqa: F401  (one intra-op thread per test process)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max() + atol,
                               err_msg=what)


def _load(module, variables):
    tree = jax.tree.map(np.asarray, variables)
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- DCNv2


def _dcn_inputs(seed, B=2, C=4, H=7, W=6, Cout=3, K=3, dg=2, stride=1, pad=1, dil=1):
    rng = np.random.default_rng(seed)
    Ho = (H + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B, H, W, C), offset=2.0 * f(B, Ho, Wo, dg * 2 * K * K),
                mask=rng.uniform(0, 1, (B, Ho, Wo, dg * K * K)).astype(np.float32),
                weight=f(Cout, C, K, K), bias=f(Cout))


DCN_CASES = {  # (stride, padding, dilation, deformable groups, K)
    "s1_p1_dg2": (1, 1, 1, 2, 3),
    "s2_p0_dg1": (2, 0, 1, 1, 3),
    "dil2_dg4": (1, 2, 2, 4, 3),
    "k1": (1, 0, 1, 1, 1),
}


@pytest.mark.parametrize("case", list(DCN_CASES))
def test_dcn_v2_conv_matches_jax_forward_and_gradients(case):
    stride, pad, dil, dg, K = DCN_CASES[case]
    a = _dcn_inputs(3, K=K, dg=dg, stride=stride, pad=pad, dil=dil)
    names = ("x", "offset", "mask", "weight", "bias")
    r = np.random.default_rng(4)

    def jax_loss(*args):
        out = jax_dcn_v2_conv(*args, stride, pad, dil, dg)
        return (out * jnp.asarray(cot)).sum(), out

    jout = jax_dcn_v2_conv(*(jnp.asarray(a[n]) for n in names), stride, pad, dil, dg)
    cot = r.standard_normal(jout.shape).astype(np.float32)
    (_, _), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(a[n]) for n in names))

    ts = [_t(a[n]).requires_grad_() for n in names]
    out = dcn_v2_conv(*ts, stride, pad, dil, dg)
    _close(out, jout, what="forward")
    (out * _t(cot)).sum().backward()
    for n, t, g in zip(names, ts, jgrads):
        _close(t.grad, g, rtol=1e-4, what=f"d/d{n}")


def test_dcn_v2_conv_bf16_samples_in_f32():
    """bf16 values with f32 sampling positions and an f32 contraction, as
    the JAX op: 1e-2 relative (bf16 rounds each gathered product)."""
    a = _dcn_inputs(5)
    jout = jax_dcn_v2_conv(jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["offset"]),
                           jnp.asarray(a["mask"], jnp.bfloat16),
                           jnp.asarray(a["weight"], jnp.bfloat16),
                           jnp.asarray(a["bias"], jnp.bfloat16), 1, 1, 1, 2)
    out = dcn_v2_conv(_t(a["x"]).bfloat16(), _t(a["offset"]), _t(a["mask"]).bfloat16(),
                      _t(a["weight"]).bfloat16(), _t(a["bias"]).bfloat16(), 1, 1, 1, 2)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(jout, np.float32), rtol=1e-2)


def test_dcn_modules_match_jax():
    """DCN and DCNSep with every weight random (the offset conv too, so
    the offsets are not zero): the o1/o2/mask wiring against the JAX
    modules'."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 9, 4)).astype(np.float32)
    fea = rng.standard_normal((2, 8, 9, 5)).astype(np.float32)

    def randomize(variables, seed):
        leaves, tree = jax.tree.flatten(variables)
        r = np.random.default_rng(seed)
        return jax.tree.unflatten(tree, [0.3 * r.standard_normal(l.shape).astype(np.float32)
                                         for l in leaves])

    jm = jdcn.DCN(6)
    v = randomize(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    tm = _load(tdcn.DCN(4, 6), v)
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)), what="DCN")

    js = jdcn.DCNSep(6, deformable_groups=2)
    v = randomize(js.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(fea)), 2)
    ts = _load(tdcn.DCNSep(4, 5, 6, deformable_groups=2), v)
    _close(ts(_t(x), _t(fea)), js.apply(v, jnp.asarray(x), jnp.asarray(fea)), what="DCNSep")


def test_dcn_module_init_is_the_reference_init():
    """Zero offset conv (offsets 0, mask sigmoid(0) = 0.5), weight within
    +-1/sqrt(Cin*K*K), zero bias: at init DCN is half the dense conv."""
    m = tdcn.DCN(4, 6).requires_grad_(False)
    assert not m.conv_offset_mask.conv.weight.any() and not m.dcn.bias.any()
    assert float(m.dcn.weight.abs().max()) <= 1 / np.sqrt(36)
    x = _t(_x((1, 8, 8, 4)))
    ref = 0.5 * torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), m.dcn.weight, padding=1)
    _close(m(x), ref.permute(0, 2, 3, 1).numpy())


PSROI_CASES = {  # (group_size, pooled, part, sample_per_part, with trans, spatial_scale)
    "no_trans": (1, 3, None, 4, False, 1.0),
    "groups_trans": (2, 4, 2, 2, True, 0.5),
    "trans_part3": (1, 3, 3, 3, True, 1.0),
}


@pytest.mark.parametrize("case", list(PSROI_CASES))
def test_psroi_pooling_matches_jax(case):
    G, P, part, spp, with_trans, scale = PSROI_CASES[case]
    rng = np.random.default_rng(7)
    D, B, H, W = 3, 2, 12, 14
    x = rng.standard_normal((B, H, W, D * G * G)).astype(np.float32)
    # rois partly outside the map, one degenerate
    rois = np.array([[0, 1, 2, 9, 10], [1, -3, 4, 16, 13], [1, 5, 5, 5, 5]], np.float32)
    ncls = 1
    trans = (rng.standard_normal((3, 2 * ncls, part or P, part or P)).astype(np.float32)
             if with_trans else None)
    kw = dict(spatial_scale=scale, pooled_size=P, output_dim=D, group_size=G,
              part_size=part, sample_per_part=spp, trans_std=0.1)
    want = jdcn.dcn_v2_psroi_pooling(jnp.asarray(x), jnp.asarray(rois),
                                     None if trans is None else jnp.asarray(trans), **kw)
    got = tdcn.dcn_v2_psroi_pooling(_t(x), _t(rois), None if trans is None else _t(trans), **kw)
    _close(got, want)


# ---------------------------------------------------------------- the block library


def _x(shape, seed=8):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


BLOCKS = {
    # name: (JAX module, port module, input shape)
    "residual": (lambda: jlib.ResidualBlock(8), lambda: tlib.ResidualBlock(8), (2, 6, 7, 8)),
    "residual_bn": (lambda: jlib.ResidualBlock(8, "LeakyReLU", "BN"),
                    lambda: tlib.ResidualBlock(8, "LeakyReLU", "BN"), (2, 6, 7, 8)),
    "residual_in": (lambda: jlib.ResidualBlock(8, norm="IN"),
                    lambda: tlib.ResidualBlock(8, norm="IN"), (2, 6, 7, 8)),
    "transposed": (lambda: jlib.TransposedConvLayer(5), lambda: tlib.TransposedConvLayer(4, 5),
                   (2, 5, 6, 4)),
    "transposed_k3": (lambda: jlib.TransposedConvLayer(5, kernel_size=3, activation=None),
                      lambda: tlib.TransposedConvLayer(4, 5, 3, None), (1, 5, 6, 4)),
    "upsample": (lambda: jlib.UpsampleConvLayer(5), lambda: tlib.UpsampleConvLayer(4, 5),
                 (2, 5, 6, 4)),
    "attention": (lambda: jlib.SelfAttention(16), lambda: tlib.SelfAttention(16), (2, 10, 16)),
    "mlp": (lambda: jlib.MLP(12, 4, 3), lambda: tlib.MLP(16, 12, 4, 3), (2, 10, 16)),
    "conv1d": (lambda: jlib.ConvLayer1D(6, 3, 1, 1), lambda: tlib.ConvLayer1D(5, 6, 3, 1, 1),
               (2, 11, 5)),
    "conv1d_bn": (lambda: jlib.ConvLayer1D(6, 3, 2, 1, "Tanh", "BN"),
                  lambda: tlib.ConvLayer1D(5, 6, 3, 2, 1, "Tanh", "BN"), (3, 11, 5)),
    "unet_sum_transpose": (lambda: jlib.UNet(8, 2, 1, 2),
                           lambda: tlib.UNet(5, 8, 2, 1, 2), (1, 16, 16, 5)),
    "unet_concat_upsample": (lambda: jlib.UNet(8, 2, 2, 1, "concat", "upsample",
                                               final_activation=None),
                             lambda: tlib.UNet(5, 8, 2, 2, 1, "concat", "upsample",
                                               final_activation=None), (2, 16, 16, 5)),
}


def _random_stats(variables, seed):
    """Running statistics away from their init (mean 0, var 1), so that a
    block in eval mode shows whether it reads them."""
    if "batch_stats" not in variables:
        return variables
    r = np.random.default_rng(seed)
    stats = jax.tree.map(lambda s: r.uniform(0.5, 1.5, s.shape).astype(np.float32),
                         variables["batch_stats"])
    return {**variables, "batch_stats": stats}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_library_block_matches_jax(name):
    jfac, tfac, shape = BLOCKS[name]
    x = _x(shape)
    jm = jfac()
    v = _random_stats(jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.asarray(x))), 2)
    tm = _load(tfac(), v)
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)), what=name)


@pytest.mark.parametrize("cell", ["convlstm", "convgru"])
def test_recurrent_cells_match_jax_over_a_sequence(cell):
    """Four steps of the cell, then RecurrentConvLayer's downsampling conv
    and one step of its cell; the carries must agree at every step."""
    B, H, W, C = 2, 8, 8, 6
    seq = _x((4, B, H, W, 3), 9)
    jcell = jlib.ConvLSTMCell(C) if cell == "convlstm" else jlib.ConvGRUCell(C)
    tcell = tlib.ConvLSTMCell(3, C) if cell == "convlstm" else tlib.ConvGRUCell(3, C)
    jcarry = type(jcell).init_carry(B, H, W, C)
    tcarry = type(tcell).init_carry(B, H, W, C, device="cpu")
    v = jcell.init(jax.random.key(0), jcarry, jnp.asarray(seq[0]))
    _load(tcell, v)
    for s in range(4):
        jcarry, jy = jcell.apply(v, jcarry, jnp.asarray(seq[s]))
        tcarry, ty = tcell(tcarry, _t(seq[s]))
        _close(ty, jy, what=f"step {s}")

    jrec = jlib.RecurrentConvLayer(C, stride=2, recurrent_block_type=cell)
    trec = tlib.RecurrentConvLayer(3, C, stride=2, recurrent_block_type=cell)
    j0 = type(jcell).init_carry(B, H // 2, W // 2, C)
    v = jrec.init(jax.random.key(1), j0, jnp.asarray(seq[0]))
    _load(trec, v)
    (jc, jy) = jrec.apply(v, j0, jnp.asarray(seq[0]))
    (tc, ty) = trec(type(tcell).init_carry(B, H // 2, W // 2, C, device="cpu"), _t(seq[0]))
    _close(ty, jy, what="RecurrentConvLayer")


# ---------------------------------------------------------------- ConvLayer's norms


@pytest.mark.parametrize("norm", ["BN", "IN"])
@pytest.mark.parametrize("train", [False, True])
def test_conv_layer_norm_matches_jax(norm, train):
    """ConvLayer with BN (a conv without bias; batch statistics when
    ``train``, the running ones otherwise; the running ones moved by 0.1
    toward the batch's biased statistics) or IN (learnable scale and bias
    per channel), against the JAX ConvLayer with random scale, bias and
    running statistics."""
    x = _x((4, 6, 7, 5), 10)
    jm = JaxConvLayer(8, 3, 1, 1, "LeakyReLU", norm)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(2), jnp.asarray(x)))
    r = np.random.default_rng(11)
    v = jax.tree.map(lambda a: a + 0.5 * r.uniform(0, 1, a.shape).astype(np.float32), v)
    tm = _load(ConvLayer(5, 8, 3, 1, 1, "LeakyReLU", norm), v)
    assert (tm.conv.bias is None) == (norm == "BN")
    if train and norm == "BN":
        jy, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        ty = tm(_t(x), train=True)
        for k in ("mean", "var"):
            got = getattr(tm.norm, f"running_{k}")
            np.testing.assert_allclose(got.numpy(), np.asarray(upd["batch_stats"]["BatchNorm_0"][k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    else:
        jy = jm.apply(v, jnp.asarray(x), train=train)
        before = {k: b.clone() for k, b in tm.named_buffers()}
        ty = tm(_t(x), train=train)
        for k, b in tm.named_buffers():
            assert torch.equal(b, before[k]), f"{k} moved outside train"
    _close(ty, jy)


def test_conv_layer_norm_gradients_match_jax():
    """BN in train mode: gradients through the batch statistics, to the
    input, the conv and the norm's scale and bias (1e-4 relative)."""
    x = _x((4, 6, 7, 5), 12)
    jm = JaxConvLayer(8, 3, 1, 1, "ReLU", "BN")
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(3), jnp.asarray(x)))
    cot = _x((4, 6, 7, 8), 13)

    def loss(params, xx):
        y, _ = jm.apply({**v, "params": params}, xx, train=True, mutable=["batch_stats"])
        return (y * cot).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    tm = _load(ConvLayer(5, 8, 3, 1, 1, "ReLU", "BN"), v)
    xt = _t(x).requires_grad_()
    (tm(xt, train=True) * _t(cot)).sum().backward()
    _close(xt.grad, gx, rtol=1e-4, what="dx")
    want = params_from_jax({"params": jax.tree.map(np.asarray, gp)})
    for k, p in tm.named_parameters():
        _close(p.grad, want[k].numpy(), rtol=1e-4, what=k)


def test_conv_layer_rejects_unknown_norm_and_evfi_keeps_norm_none():
    from ebfi_tpu_torch.models import EVFIAutoEx

    with pytest.raises(ValueError, match="norm"):
        ConvLayer(3, 4, norm="LN")
    with pytest.raises(NotImplementedError, match="norm=None"):
        EVFIAutoEx(norm="BN")
