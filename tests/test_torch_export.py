"""The kernels as custom ops, and the exported serving program, on the CPU.

``torch.library.opcheck`` holds each ``ebfi::`` op's schema, fake
implementation, autograd registration and AOT dispatch.  The program
written by ``python -m ebfi_tpu_torch.tools.export --device cpu`` and
loaded in a fresh process (after ``import ebfi_tpu_torch.ops``) must equal
``InferenceEngine.interpolate`` exactly (the same ops on the same CPU), and
the JAX tool's artifact (``tools/export_stablehlo.py``) on the same
weights within f32 tolerance: rtol 1e-4, atol 1e-4 (two frameworks' conv
sums in different orders, through a sigmoid and the detail branch).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ebfi_tpu_torch.infer import InferenceEngine
from ebfi_tpu_torch.models import build_model, init_weights
from ebfi_tpu_torch.ops.cuda import fac, mod_fac  # noqa: F401 (registers the ops)
from ebfi_tpu_torch.tools.export import export_engine, export_model
from ebfi_tpu_torch.utils.checkpoint import save_checkpoint
from test_infer_cli import MODEL_CFG
from test_torch_checkpoint import orbax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_stablehlo import export_model as jax_export_model  # noqa: E402
from jax_ckpt_to_torch import convert  # noqa: E402

K, C = 3, 4


def _r(g, *shape, scale=1.0):
    return (scale * torch.randn(*shape, generator=g)).requires_grad_()


OPS = {
    "fac": lambda g: (torch.ops.ebfi.fac.default,
                      (_r(g, 1, 5, 6, C), _r(g, 1, 5, 6, K * K * C), K)),
    "mod_fac": lambda g: (torch.ops.ebfi.mod_fac.default,
                          (_r(g, 1, 5, 6, C), _r(g, 1, 5, 6, C),
                           _r(g, 3, 3, 2 * C, K * K * C, scale=0.1), _r(g, K * K * C, scale=0.1),
                           K)),
    "mod_fac_shared_packed": lambda g: (
        torch.ops.ebfi.mod_fac_shared.default,
        (_r(g, 2, 4, 6, C), _r(g, 1, 4, 6, C), _r(g, 3, 3, 2 * C, K * K * C, scale=0.1),
         _r(g, K * K * C, scale=0.1), K, True)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_custom_op_passes_opcheck(name):
    op, args = OPS[name](torch.Generator().manual_seed(0))
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_a_call_of_the_ops_imports_no_compiler():
    """The ops are defined through ``torch.library.Library``: a call,
    forward and backward, does not import ``torch._dynamo``
    (``torch.library.custom_op``'s first call does, seconds of host time
    at the start of every process)."""
    code = (
        "import sys, torch\n"
        "from ebfi_tpu_torch.ops import cuda as kern\n"
        "x = torch.ones(1, 3, 3, 2, requires_grad=True)\n"
        "kern.kernel_conv2d_cuda(x, torch.ones(1, 3, 3, 18), 3).sum().backward()\n"
        "w, b = torch.ones(3, 3, 4, 2), torch.ones(2)\n"
        "kern.modification_fac_fused(x, x, w, b, 1)\n"
        "kern.modification_fac_fused_shared(x, x, w, b, 1, False)\n"
        "assert 'torch._dynamo' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr


def _inputs(tb, n, hw=32, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32),
            rng.standard_normal((1, hw, hw, 2 * tb)).astype(np.float32),
            rng.uniform(0, 1, (1, n)).astype(np.float32),
            np.full((1, 1), 0.4, np.float32))


LOAD = """
import sys
import numpy as np
import torch
import ebfi_tpu_torch.ops  # registers the ebfi:: ops the program calls
program = torch.export.load(sys.argv[1]).module()
inputs = [torch.from_numpy(a) for a in np.load(sys.argv[2]).values()]
with torch.no_grad():
    sharps, finals = program(*inputs)
np.savez(sys.argv[3], sharps=sharps.numpy(), finals=finals.numpy())
"""


def test_cli_export_loads_in_a_fresh_process_and_matches_engine_and_jax(tmp_path):
    jax_ckpt, _ = orbax_checkpoint(tmp_path / "jax", MODEL_CFG)
    ckpt = str(tmp_path / "model.pt")
    convert(jax_ckpt, ckpt)
    pt2 = str(tmp_path / "model.pt2")
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = lambda *argv: subprocess.run(  # noqa: E731
        [sys.executable, *argv], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    proc = run("-m", "ebfi_tpu_torch.tools.export", "--checkpoint", ckpt, "--output", pt2,
               "--height", "32", "--width", "32", "--num_t", "3", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "wrote" in proc.stdout and os.path.getsize(pt2) > 1000

    inputs = _inputs(4, 3)
    np.savez(tmp_path / "in.npz", *inputs)
    proc = run("-c", LOAD, pt2, str(tmp_path / "in.npz"), str(tmp_path / "out.npz"))
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp_path / "out.npz")
    assert got["finals"].shape == (3, 1, 32, 32, 3)

    from ebfi_tpu_torch.utils.checkpoint import load_checkpoint

    engine = InferenceEngine(load_checkpoint(ckpt)[0], device="cpu")
    want = [o.numpy() for o in engine.interpolate(*inputs)]
    np.testing.assert_array_equal(got["sharps"], want[0])
    np.testing.assert_array_equal(got["finals"], want[1])

    jax_out = jax_export_model(jax_ckpt, 32, 32, 3).call(*inputs)
    for key, j in zip(("sharps", "finals"), jax_out):
        np.testing.assert_allclose(got[key], np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("precision, num_t, op", [
    ("bf16", 3, "mod_fac_shared"), ("bf16", 1, "mod_fac"), ("f32", 1, "fac")])
def test_exported_program_calls_the_op_and_matches_the_engine(precision, num_t, op):
    """bf16 batched: hoisted, B2's op; num_t = 1: the single forward, B3's
    op in bf16 (fast_math fuses Modification) and B1's in f32."""
    cfg = {"name": "EVFIAutoEx", "args": dict(MODEL_CFG["args"], UseGTEx=False)}
    engine = InferenceEngine(init_weights(build_model(cfg), 2), precision, device="cpu")
    program = export_engine(engine, 32, 32, num_t)
    assert any(str(n.target) == f"ebfi.{op}.default" for n in program.graph.nodes)
    inputs = [torch.from_numpy(a) for a in _inputs(4, num_t, seed=3)]
    with torch.no_grad():
        got = program.module()(*inputs)
    want = engine.interpolate(*inputs) if num_t > 1 else engine.forward(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_export_on_the_card_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, init_weights(build_model(MODEL_CFG), 0), {"model": MODEL_CFG})
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model(ckpt, 32, 32, 3)
