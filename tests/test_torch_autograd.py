"""Gradients through the port's kernel wrappers, on the CPU.

B1, B3, B2 and B2p sit behind ``torch.autograd.Function``s whose backward
recomputes through the plain versions, as the JAX package's
``custom_vjp``s recompute through their XLA twins.  Here the values and
the input and weight gradients of each wrapper are held against
``jax.vjp`` of the JAX function (its Pallas forward in interpret mode) on
the same numpy inputs and cotangent.  Tolerances, relative to the largest
magnitude of the reference: f32 1e-4 (sums reassociate between XLA and
PyTorch); bf16 5e-2 (the two frameworks round to bf16 at other places:
the Pallas kernels accumulate in f32, the plain versions in bf16).

A second group replaces the forward of each wrapper (the CUDA launch on a
card) by the plain computation run without autograd, as a ``ctypes``
launch is, and shows that the output still carries a ``grad_fn``, that
the gradients arrive and equal autograd through the plain version, and
that nothing is recorded under ``no_grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.ops.pallas import kernel_conv2d_pallas
from ebfi_tpu.ops.pallas.mod_fac import (
    modification_fac_fused as jax_mod_fac,
    modification_fac_fused_shared as jax_mod_fac_shared,
    modification_fac_fused_shared_packed as jax_mod_fac_shared_packed,
)
from ebfi_tpu_torch.ops.cuda import fac as fac_mod
from ebfi_tpu_torch.ops.cuda import mod_fac as mod_fac_mod
from ebfi_tpu_torch.ops.cuda import (
    fac_plain,
    kernel_conv2d_cuda,
    mod_fac_plain,
    mod_fac_shared_plain,
    modification_fac_fused,
    modification_fac_fused_shared,
)
import torch_threads  # noqa: F401  (one intra-op thread per test process)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
K = 3


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(s).astype(np.float32) for s, scale in shapes]


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[dtype], f"{what}: rel err {err:.2e} > {TOL[dtype]}"


def _compare(jax_fn, port_fn, arrays, n_diff, dtype, seed):
    """Values and vjp of jax_fn against the port's wrapper; the first
    n_diff arrays get gradients (the last, a bias, stays f32 as the
    callers keep it)."""
    jin = [jnp.asarray(a, JDT[dtype] if i < 3 else jnp.float32) for i, a in enumerate(arrays)]
    jout, vjp = jax.vjp(jax_fn, *jin)
    cot = np.random.default_rng(seed + 1).standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot, jout.dtype))
    tin = [torch.tensor(a, dtype=TDT[dtype] if i < 3 else torch.float32, requires_grad=i < n_diff)
           for i, a in enumerate(arrays)]
    tout = port_fn(*tin)
    assert tout.grad_fn is not None
    tgrads = torch.autograd.grad(tout, tin[:n_diff], torch.tensor(cot, dtype=tout.dtype))
    _close(tout.float().detach().numpy(), np.asarray(jout, np.float32), dtype, "values")
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        _close(tg.float().numpy(), np.asarray(jg, np.float32), dtype, f"gradient of input {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fac_function_matches_jax_custom_vjp(dtype):
    B, H, W, C = 2, 8, 8, 4
    arrays = _arrays([((B, H, W, C), 1.0), ((B, H, W, K * K * C), 1.0)], 0)
    _compare(lambda x, k: kernel_conv2d_pallas(x, k, K),
             lambda x, k: kernel_conv2d_cuda(x.contiguous(), k, K), arrays, 2, dtype, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mod_fac_function_matches_jax_custom_vjp(dtype):
    B, H, W, C = 2, 6, 10, 4
    arrays = _arrays([((B, H, W, C), 1.0), ((B, H, W, C), 1.0),
                      ((3, 3, 2 * C, K * K * C), 0.1), ((K * K * C,), 0.1)], 1)
    _compare(lambda e, f, w, b: jax_mod_fac(e, f, w, b, K),
             lambda e, f, w, b: modification_fac_fused(e, f, w, b, K), arrays, 4, dtype, 1)


@pytest.mark.parametrize("packed", [False, True], ids=["B2", "B2p"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mod_fac_shared_function_matches_jax_custom_vjp(dtype, packed):
    B, N, H, W, C = 2, 3, 6, 10, 4
    arrays = _arrays([((B * N, H, W, C), 1.0), ((B, H, W, C), 1.0),
                      ((3, 3, 2 * C, K * K * C), 0.1), ((K * K * C,), 0.1)], 2)
    jfn = jax_mod_fac_shared_packed if packed else jax_mod_fac_shared
    _compare(lambda e, f, w, b: jfn(e, f, w, b, K),
             lambda e, f, w, b: modification_fac_fused_shared(e, f, w, b, K, packed_rows2=packed),
             arrays, 4, dtype, 2)


# ---------------------------------------------------------------- stubbed launch

def _graphless(plain, counter):
    """A stand-in for the kernel launch: the plain computation without
    autograd (a ctypes launch fills a buffer and records nothing)."""

    def run(*args):
        counter.append(1)
        with torch.no_grad():
            return plain(*args)

    return run


CASES = {
    "B1": (fac_mod, "_run", lambda *a: fac_plain(*a[:2], K), kernel_conv2d_cuda,
           [((2, 6, 7, 4), 1.0), ((2, 6, 7, K * K * 4), 1.0)], ()),
    "B3": (mod_fac_mod, "_run_fused", lambda *a: mod_fac_plain(*a[:4], K), modification_fac_fused,
           [((2, 6, 7, 4), 1.0), ((2, 6, 7, 4), 1.0), ((3, 3, 8, K * K * 4), 0.1),
            ((K * K * 4,), 0.1)], ()),
    "B2": (mod_fac_mod, "_run_shared", lambda *a: mod_fac_shared_plain(*a[:4], K),
           modification_fac_fused_shared,
           [((4, 6, 7, 4), 1.0), ((2, 6, 7, 4), 1.0), ((3, 3, 8, K * K * 4), 0.1),
            ((K * K * 4,), 0.1)], (False,)),
    "B2p": (mod_fac_mod, "_run_shared", lambda *a: mod_fac_shared_plain(*a[:4], K, True),
            modification_fac_fused_shared,
            [((4, 6, 7, 4), 1.0), ((2, 6, 7, 4), 1.0), ((3, 3, 8, K * K * 4), 0.1),
             ((K * K * 4,), 0.1)], (True,)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stubbed_launch_output_carries_gradients(monkeypatch, name):
    module, attr, plain, wrapper, shapes, extra = CASES[name]
    calls = []
    monkeypatch.setattr(module, attr, _graphless(lambda *a: plain(*a), calls))
    arrays = _arrays(shapes, 3)
    inputs = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = wrapper(*inputs, K, *extra)
    assert len(calls) == 1
    assert out.grad_fn is not None, "the wrapper's output carries no gradient"
    r = torch.tensor(np.random.default_rng(4).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, inputs, r)
    want = torch.autograd.grad(plain(*inputs), inputs, r)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # under no_grad the forward runs alone and nothing is saved for backward
    with torch.no_grad():
        out = wrapper(*inputs, K, *extra)
    assert out.grad_fn is None and len(calls) == 2


def test_modification_bank_weight_gradient_reaches_the_conv_weight():
    """The fused Modification's bank weight is a permuted view of
    kernel_conv.conv.weight; its gradient must reach that parameter, the
    same as through the unfused module (cuDNN-style conv + FAC)."""
    from ebfi_tpu_torch.models import Modification

    torch.manual_seed(0)
    fused = Modification(4, 6, 3, fused=True)
    unfused = Modification(4, 6, 3, fused=False)
    unfused.load_state_dict(fused.state_dict())
    ff, ev = (torch.tensor(a) for a in _arrays([((2, 6, 7, 4), 1.0), ((2, 6, 7, 6), 1.0)], 5))
    grads = []
    for m in (fused, unfused):
        m(ff, ev).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert grads[0]["kernel_conv.conv.weight"] is not None
    assert float(grads[0]["kernel_conv.conv.weight"].abs().max()) > 0
    for n in grads[1]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=1e-4, atol=1e-5)
