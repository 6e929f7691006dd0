"""The port's adversarial pack (``ebfi_tpu_torch.losses.adversarial`` and
``discriminator``) against ``ebfi_tpu.losses`` on the CPU, the flax
parameters carried over by ``discriminator_params_from_jax``.

Tolerances:
- a discriminator's output, f32: 1e-5 relative to the largest output
  (convolutions and matmuls sum in another order);
- one ``step`` of each GAN type (B = 2, 32x32), both frameworks in f64
  (the JAX step jitted under ``jax.enable_x64``): ``d_loss`` and
  ``g_loss`` 1e-9 relative, ``dg_loss / dfake`` relative L2 1e-7; the
  discriminator's parameters after its updates: Adamax's (and WGAN-GP's
  Adam's) first updates are about lr * sign(g), so a gradient that is ~0
  in both may take either sign: at most 2 * lr per update apart, and at
  most 1e-4 of them more than 1e-6 * lr apart.  In f32 the same
  comparison is not tight: the jitted JAX discriminator's early-layer
  gradients of a BN ladder are far from an f64 evaluation (XLA fuses the
  batch variance), and the sign flips follow (see
  ``test_f32_discriminator_gradients``, which computes both frameworks'
  distance from f64);
- the f32 gradients: relative L2 against f64, as that test says.
The gradient penalty's weights are JAX's own draw (``split(key(0))``),
given to the port's ``step`` as ``eps``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.losses import AdversarialLoss as JaxAdversarial
from ebfi_tpu.losses.discriminator import build_discriminator as jax_build
from ebfi_tpu_torch.losses import AdversarialLoss
from ebfi_tpu_torch.losses.discriminator import build_discriminator, init_discriminator
from ebfi_tpu_torch.models import discriminator_params_from_jax

B, S = 2, 32
GAN_TYPES = ["GAN", "WGAN", "WGAN_GP", "T_WGAN_GP", "FI_GAN", "FI_Cond_GAN", "STGAN"]
N_INPUTS = {"T_WGAN_GP": 3, "FI_GAN": 2, "FI_Cond_GAN": 3, "STGAN": 3}
LR = {"WGAN_GP": 1e-5, "T_WGAN_GP": 1e-5}  # else Adamax 1e-3


def _inputs(seed, hw=(S, S)):
    rng = np.random.default_rng(seed)
    fake, real = (rng.uniform(0, 1, (B, *hw, 3)).astype(np.float32) for _ in range(2))
    frames = rng.uniform(0, 1, (B, 2, *hw, 3)).astype(np.float32)
    return fake, real, frames


def _port_params(tree):
    return {k: v.numpy() for k, v in discriminator_params_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _jax_state(adv, fake, real, frames):
    return adv.init(jax.random.key(3), *(jnp.asarray(a) for a in (fake, real, frames)))


def _port_state(gan_type, jstate, fake, gan_k=1):
    adv = AdversarialLoss(S, gan_type, gan_k)
    state = adv.init(0, torch.from_numpy(fake), None)
    state.disc.load_state_dict(discriminator_params_from_jax(
        jax.tree.map(np.asarray, jstate.params)), strict=True)
    return adv, state


@pytest.mark.parametrize("gan_type,hw", [
    *[(g, (S, S)) for g in ("GAN", "WGAN_GP", "T_WGAN_GP", "FI_GAN", "FI_Cond_GAN", "STGAN")],
    ("GAN", (24, 40)), ("STGAN", (24, 40))])
def test_discriminator_matches_flax(gan_type, hw):
    """Each of the five discriminators (GAN's with BN, WGAN_GP's without),
    and the flatten order and the in-features at an odd-sized ladder
    output (24x40 -> 2x3)."""
    rng = np.random.default_rng(1)
    xs = [rng.uniform(0, 1, (B, *hw, 3)).astype(np.float32)
          for _ in range(N_INPUTS.get(gan_type, 1))]
    jd = jax_build(gan_type, S)
    params = jax.jit(jd.init)(jax.random.key(0), *map(jnp.asarray, xs))
    want = np.asarray(jax.jit(jd.apply)(params, *map(jnp.asarray, xs)))
    td = build_discriminator(gan_type, hw)
    td.load_state_dict(discriminator_params_from_jax(jax.tree.map(np.asarray, params)),
                       strict=True)
    got = td(*map(torch.from_numpy, xs)).detach().numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_init_follows_the_jax_distributions():
    """Same shapes as flax's init, the JAX package's U(+-1/sqrt(fan_in)) for
    weights and biases, BN scale 1 and shift 0; one seed, one result."""
    fake, real, frames = _inputs(0)
    jparams = _port_params(jax.jit(jax_build("STGAN", S).init)(
        jax.random.key(0), *(jnp.asarray(a) for a in (frames[:, 0], fake, frames[:, 1]))))
    a = init_discriminator(build_discriminator("STGAN", (S, S)), torch.Generator().manual_seed(7))
    b = init_discriminator(build_discriminator("STGAN", (S, S)), torch.Generator().manual_seed(7))
    sd = a.state_dict()
    assert {k: v.shape for k, v in jparams.items()} == {k: tuple(v.shape) for k, v in sd.items()}
    for k, v in sd.items():
        assert torch.equal(v, b.state_dict()[k])
        if k.endswith("scale"):
            assert torch.equal(v, torch.ones_like(v))
        elif k.endswith("bias") and ".block" in k:
            assert torch.equal(v, torch.zeros_like(v))
        else:
            fan_in = np.prod(sd[k.rsplit(".", 1)[0] + ".weight"].shape[1:])
            assert v.abs().max() <= 1 / np.sqrt(fan_in)
            assert v.numel() < 64 or v.std() > 0.5 / np.sqrt(fan_in)  # U(-b, b): std b / sqrt(3)


def _jax_eps(gan_k, shape, dtype=jnp.float32):
    """The penalty weights of JAX's step: ``split`` of ``key(0)`` per update."""
    key, out = jax.random.key(0), []
    for _ in range(gan_k):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sub, shape, dtype))))
    return out


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("gan_k", [1, 2])
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_step_matches_jax(gan_type, gan_k):
    """``gan_k`` updates and the generator loss, both frameworks in f64 (the
    JAX step jitted under ``enable_x64``), from the same parameters and,
    for the penalty, the same weights."""
    fake, real, frames = _inputs(2)
    jadv = JaxAdversarial(S, gan_type, gan_k)
    jstate = _jax_state(jadv, fake, real, frames)
    with jax.enable_x64(True):
        jstate = jstate._replace(params=_f64(jstate.params), opt_state=jadv.tx.init(
            _f64(jstate.params)))
        eps = [e.double() for e in _jax_eps(gan_k, fake.shape, jnp.float64)]
        j_in = [jnp.asarray(a, jnp.float64) for a in (fake, real, frames)]

        def g_of_fake(f):
            s, g, d = jadv.step(jstate, f, *j_in[1:])
            return g, (s, d)

        (jg, (js, jd)), jgrad = jax.value_and_grad(g_of_fake, has_aux=True)(j_in[0])
        want = {k: v.numpy() for k, v in discriminator_params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float64), js.params), np.float64).items()}
    adv, state = _port_state(gan_type, jstate, fake, gan_k)
    init = {k: v.clone() for k, v in state.disc.state_dict().items()}
    state.disc.double()
    tf = torch.from_numpy(fake).double().requires_grad_()
    state, tg, td = adv.step(state, tf, *(torch.from_numpy(a).double() for a in (real, frames)),
                             eps=eps if "GP" in gan_type else None)
    tg.backward()
    for got, ref in ((td, jd), (tg, jg)):
        assert abs(float(got) - float(ref)) <= 1e-9 * abs(float(ref)), (float(got), float(ref))
    assert all(p.grad is None for p in state.disc.parameters())  # g_loss spares the disc

    got = {k: v.detach().numpy() for k, v in state.disc.state_dict().items()}
    lr = LR.get(gan_type, 1e-3)
    moved = max(float(np.abs(want[k] - init[k].numpy()).max()) for k in want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert moved > 0.5 * lr and diffs.max() <= 2 * lr * gan_k
    assert (diffs > 1e-6 * lr).mean() <= 1e-4
    g = tf.grad.numpy()
    assert np.linalg.norm(g - np.asarray(jgrad)) <= 1e-7 * np.linalg.norm(np.asarray(jgrad))


def test_f32_discriminator_gradients(gan_type="STGAN"):
    """In f32, the working dtype: the port's discriminator loss within 1e-5
    of the JAX loss's, and its gradients (all tensors as one vector) within
    relative L2 1e-3 of the f64 JAX gradients, or no further from them
    than the jitted f32 JAX gradients are.  A leaky ReLU whose input lies
    within f32 noise of its kink takes the other slope in f32 (ROADMAP.md,
    "Not faults"), which moves the gradients of the layers below it; and
    where BN makes a gradient a cancelling sum, XLA's jitted batch
    variance loses digits (on GAN's base-64 ladder more than on STGAN's).
    The assertion message gives both distances."""
    fake, real, frames = _inputs(6)
    jadv = JaxAdversarial(S, gan_type)
    jstate = _jax_state(jadv, fake, real, frames)
    grad_fn = jax.jit(jax.value_and_grad(jadv._d_loss))
    jl, jg32 = grad_fn(jstate.params, *(jnp.asarray(a) for a in (fake, real, frames)), None)
    with jax.enable_x64(True):
        _, jg = grad_fn(_f64(jstate.params), *(jnp.asarray(a, jnp.float64)
                                               for a in (fake, real, frames)), None)
        truth = {k: v.numpy() for k, v in discriminator_params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float64), jg), np.float64).items()}
    ref32 = _port_params(jg32)
    adv, state = _port_state(gan_type, jstate, fake)
    tl = adv.d_loss(state.disc, *(torch.from_numpy(a) for a in (fake, real, frames)))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    names = [n for n, _ in state.disc.named_parameters()]
    flat = lambda g: np.concatenate([np.ravel(g[n]) for n in names])  # noqa: E731
    want = flat(truth)
    got = flat({n: p.grad.numpy() for n, p in state.disc.named_parameters()})
    port_err = np.linalg.norm(got - want) / np.linalg.norm(want)
    jax_err = np.linalg.norm(flat(ref32) - want) / np.linalg.norm(want)
    assert port_err <= max(1e-3, jax_err), (port_err, jax_err)


def test_wgan_clamps_the_weights():
    """WGAN clamps every parameter to [-1, 1] after each update: weights set
    to +-2 come back at +-1 in both frameworks."""
    fake, real, frames = _inputs(4)
    jadv = JaxAdversarial(S, "WGAN")
    jstate = _jax_state(jadv, fake, real, frames)
    params = jax.tree.map(np.asarray, jstate.params)
    w = params["params"]["features"]["block3"]["Conv_0"]["kernel"]
    params["params"]["features"]["block3"]["Conv_0"]["kernel"] = np.where(w > 0, 2.0, -2.0)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    adv, state = _port_state("WGAN", jstate, fake)
    js, _, _ = jadv.step(jstate, *(jnp.asarray(a) for a in (fake, real, frames)))
    state, _, _ = adv.step(state, *(torch.from_numpy(a) for a in (fake, real, frames)))
    got = state.disc.features.block3.conv.weight.detach().numpy()
    assert set(np.unique(np.abs(got))) == {1.0}
    np.testing.assert_array_equal(got, _port_params(js.params)["features.block3.conv.weight"])
    assert max(float(p.abs().max()) for p in state.disc.parameters()) <= 1.0


def test_penalty_weights_draw_per_element_from_seed_zero():
    """Without ``eps`` the penalty's weights come from the state's generator
    (seeded 0), one per element of ``fake``; the same state, the same step."""
    fake, real, frames = _inputs(5)
    results = []
    for _ in range(2):
        adv = AdversarialLoss(S, "WGAN_GP")
        state = adv.init(1, torch.from_numpy(fake), None)
        e = adv.draw_eps(state, torch.from_numpy(fake))
        assert e.shape == fake.shape and 0 <= float(e.min()) and float(e.max()) < 1
        assert e.unique().numel() > 0.99 * e.numel()
        state = adv.init(1, torch.from_numpy(fake), None)
        _, g, d = adv.step(state, *(torch.from_numpy(a) for a in (fake, real, frames)))
        results.append((float(g), float(d)))
    assert results[0] == results[1]
