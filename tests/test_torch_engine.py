"""The port's InferenceEngine against the JAX package's, on the CPU.

Same weights (carried across by ``params_from_jax``) and numpy inputs.
All four interpolation modes: hoisted at one frame, hoisted over several
frames, 'scan', and unhoisted 'batched'; plus ``forward`` and bf16.
Tolerance f32: rtol=1e-4, atol=2e-5, as in test_engine.py -- float
reassociation only.  The hoisted JAX engine runs its fast variants (s2d
reconstruction, packed detail and control), which are the same math up to
reassociation; the port's hoisted engine runs the plain versions of the
fused kernels on the CPU.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ebfi_tpu.infer import InferenceEngine as JaxEngine
from ebfi_tpu_torch.infer import InferenceEngine
from test_torch_models import MODEL_ARGS, evfi_pair, make_inputs

RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def pair():
    return evfi_pair(seed=7)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def engines(pair, **kw):
    tmodel, jmodel, jp = pair
    return InferenceEngine(tmodel, device="cpu", **kw), JaxEngine(jmodel, jp, **kw)


@pytest.mark.parametrize(
    "B,mode,fast_math",
    [
        (1, "batched", True),   # hoisted, one frame
        (2, "batched", True),   # hoisted, frames looped
        (2, "scan", False),
        (2, "batched", False),  # unhoisted, timestamps folded into the batch
    ],
)
def test_interpolate_matches_jax_engine(rng, pair, B, mode, fast_math):
    frame, event, _, _ = make_inputs(rng, B=B, H=24, W=32)
    ts = rng.uniform(0, 1, (B, 5)).astype(np.float32)  # chunk 3 -> edge-padded
    ours, theirs = engines(pair, precision="f32", multi_chunk=3, fast_math=fast_math)
    assert ours._hoist == theirs._hoist == fast_math
    s, f = ours.interpolate(frame, event, ts, mode=mode)
    js, jf = theirs.interpolate(*map(jnp.asarray, (frame, event, ts)), mode=mode)
    assert s.shape == f.shape == (5, B, 24, 32, 3) and f.dtype == torch.float32
    close(s, js)
    close(f, jf)


def test_hoisted_standard_path_and_outputs_final(rng, pair):
    """Hoisted tail on the unfused Modification (the bank's ff half
    precomputed, as test_engine.py:78-107 forces on the JAX side) and
    outputs='final'."""
    tmodel, jmodel, jp = pair
    frame, event, _, _ = make_inputs(rng, B=1, H=30, W=36)
    ts = rng.uniform(0, 1, (1, 3)).astype(np.float32)
    ours = InferenceEngine(tmodel, precision="f32", multi_chunk=4, fast_math=True, device="cpu")
    ours.compute_model.modification.fused = False
    theirs = JaxEngine(jmodel, jp, precision="f32", multi_chunk=4, fast_math=True)
    theirs.model = jmodel
    s, f = ours.interpolate(frame, event, ts, outputs="final")
    _, jf = theirs.interpolate(*map(jnp.asarray, (frame, event, ts)), outputs="final")
    assert s is None and f.shape == (3, 1, 30, 36, 3)
    close(f, jf)


def test_forward_matches_jax_engine(rng, pair):
    frame, event, t, _ = make_inputs(rng, B=2, H=16, W=24)
    for fast_math in (False, True):
        ours, theirs = engines(pair, precision="f32", fast_math=fast_math)
        s, f = ours.forward(frame, event, t)
        js, jf = theirs.forward(*map(jnp.asarray, (frame, event, t)), jnp.zeros((2, 1)))
        close(s, js)
        close(f, jf)


def test_bf16_engine_is_close_to_f32(rng, pair):
    """The serving configuration: bf16, hoisted, fused.  Compared at bf16
    level against the f32 JAX engine (bf16 keeps ~3 decimal digits; the
    detail residual is O(1)), as test_engine.py's bf16 smoke test does."""
    frame, event, _, _ = make_inputs(rng, B=1, H=24, W=32)
    ts = rng.uniform(0, 1, (1, 4)).astype(np.float32)
    ours, _ = engines(pair, precision="bf16", multi_chunk=4)
    _, theirs = engines(pair, precision="f32", multi_chunk=4, fast_math=True)
    assert ours._hoist and ours.compute_model.modification.fused
    assert ours.compute_model.frame_feat.conv.weight.dtype == torch.bfloat16
    assert ours.model.frame_feat.conv.weight.dtype == torch.float32
    _, f = ours.interpolate(frame, event, ts, outputs="final")
    _, jf = theirs.interpolate(*map(jnp.asarray, (frame, event, ts)), outputs="final")
    got, ref = f.numpy(), np.asarray(jf)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=0.15)
    assert np.mean(np.abs(got - ref)) < 0.02


def test_engine_rejects_bad_arguments(pair):
    tmodel = pair[0]
    with pytest.raises(ValueError):
        InferenceEngine(tmodel, precision="f16", device="cpu")
    eng = InferenceEngine(tmodel, device="cpu")
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError):
        eng.interpolate(x, np.zeros((1, 8, 8, 8), np.float32), np.zeros((1, 2), np.float32), mode="nope")
