"""The port's ops and the plain versions of its CUDA kernels against the
JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
Pallas kernels run in interpret mode on the CPU, as in test_pallas_fac.py.
Tolerance f32: rtol=1e-4, atol=2e-5 -- XLA and PyTorch sum convolutions
and FAC taps in different orders, which moves results by a few f32 ulps
of the partial sums; nothing else differs.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ebfi_tpu import ops as jops
from ebfi_tpu.ops.pallas import kernel_conv2d_pallas
from ebfi_tpu.ops.pallas import mod_fac as jmod_fac
from ebfi_tpu_torch import ops
from ebfi_tpu_torch.ops import cuda as kern
from ebfi_tpu_torch.ops.cuda import _common, build

RTOL, ATOL = 1e-4, 2e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def both(a):
    return torch.from_numpy(a), jnp.asarray(a)


# ------------------------------------------------------------------ image ops


@pytest.mark.parametrize("size", [35, 4])
def test_dark_channel_matches_jax(rng, size):
    f = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    t, j = both(f)
    close(ops.dark_channel(t, size), jops.dark_channel(j, size), 0, 0)


def test_laplacian_response_is_integer_exact(rng):
    f = rng.uniform(0, 1, (2, 17, 23, 3)).astype(np.float32)
    t, j = both(f)
    got = ops.laplacian_response(t)
    assert got.dtype == torch.float32 and got.shape == (2, 17, 23, 1)
    close(got, jops.laplacian_response(j), 0, 0)


def test_pixel_shuffle_matches_jax_and_torch(rng):
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    t, j = both(x)
    got = ops.pixel_shuffle(t, 2)
    close(got, jops.pixel_shuffle(j, 2), 0, 0)
    ref = torch.pixel_shuffle(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("hw", [(32, 32), (28, 36), (259, 346), (1, 9)])
def test_pad_amounts_match_jax(hw):
    assert ops.pad_amounts_to_multiple(*hw, 8, 8) == jops.pad_amounts_to_multiple(*hw, 8, 8)


# ------------------------------------------------------------------ plain FAC


@pytest.mark.parametrize("layout", ["c_major", "tap_major"])
@pytest.mark.parametrize("K", [3, 5])
def test_kernel_conv2d_matches_jax(rng, layout, K):
    B, H, W, C = 2, 9, 11, 4
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    bank = rng.standard_normal((B, H, W, C * K * K)).astype(np.float32)
    (xt, xj), (bt, bj) = both(x), both(bank)
    close(ops.kernel_conv2d(xt, bt, K, layout), jops.kernel_conv2d(xj, bj, K, layout))
    p = (K - 1) // 2
    xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="edge")
    close(
        ops.kernel_conv2d_raw(torch.from_numpy(xp), bt, K, layout),
        jops.kernel_conv2d_raw(jnp.asarray(xp), bj, K, layout),
    )


def test_kernel_conv2d_rejects_bad_args(rng):
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        ops.kernel_conv2d(x, torch.zeros(1, 4, 4, 18), 4)
    with pytest.raises(ValueError):
        ops.kernel_conv2d(x, torch.zeros(1, 4, 4, 17), 3)
    with pytest.raises(ValueError):
        ops.kernel_conv2d(x, torch.zeros(1, 4, 4, 18), 3, layout="bogus")


# ------------------------------------------------------------------ kernels' plain versions


def test_b1_plain_matches_pallas_and_xla(rng):
    B, H, W, C, K = 2, 12, 16, 8, 5
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    bank = rng.standard_normal((B, H, W, C * K * K)).astype(np.float32)
    (xt, xj), (bt, bj) = both(x), both(bank)
    kern.reset_launch_counts()
    got = kern.kernel_conv2d_cuda(xt, bt, K)  # CPU tensor -> plain version
    assert kern.launch_counts()["fac"] == 0
    close(got, kernel_conv2d_pallas(xj, bj, K))
    close(got, jops.kernel_conv2d(xj, bj, K, layout="tap_major"))
    assert torch.equal(got, kern.fac_plain(xt, bt, K))
    assert ops.kernel_conv2d_auto is kern.kernel_conv2d_cuda


def _mod_inputs(rng, B, N, H, W, C, K):
    ev = rng.standard_normal((B * N, H, W, C)).astype(np.float32)
    ff = rng.standard_normal((B, H, W, C)).astype(np.float32)
    wk = (0.1 * rng.standard_normal((3, 3, 2 * C, K * K * C))).astype(np.float32)
    bk = (0.1 * rng.standard_normal((K * K * C,))).astype(np.float32)
    return [both(a) for a in (ev, ff, wk, bk)]


def test_b3_plain_matches_pallas_and_xla_twin(rng):
    K = 5
    (et, ej), (ft, fj), (wt, wj), (bt, bj) = _mod_inputs(rng, 2, 1, 6, 12, 8, K)
    kern.reset_launch_counts()
    got = kern.modification_fac_fused(et, ft, wt, bt, K)
    assert kern.launch_counts()["mod_fac"] == 0
    close(got, jmod_fac._xla_twin(ej, fj, wj, bj, K))
    close(got, jmod_fac.modification_fac_fused(ej, fj, wj, bj, K))
    assert torch.equal(got, kern.mod_fac_plain(et, ft, wt, bt, K))


def test_b2_plain_matches_pallas_and_xla_twin(rng):
    B, N, K = 2, 3, 5
    (et, ej), (ft, fj), (wt, wj), (bt, bj) = _mod_inputs(rng, B, N, 6, 12, 8, K)
    kern.reset_launch_counts()
    got = kern.modification_fac_fused_shared(et, ft, wt, bt, K)
    assert kern.launch_counts()["mod_fac_shared"] == 0
    assert got.shape == (B * N, 6, 12, 8)
    close(got, jmod_fac._xla_twin_shared(ej, fj, wj, bj, K))
    # f32 inputs keep an f32 ff scratch in the Pallas kernel: f32 tolerance
    close(got, jmod_fac.modification_fac_fused_shared(ej, fj, wj, bj, K))
    # the shared form equals the unshared one on repeated frame features
    rep = ft.repeat_interleave(N, dim=0)
    close(got, kern.mod_fac_plain(et, rep, wt, bt, K).numpy())


def test_plain_versions_run_in_bf16(rng):
    """The CPU path takes bf16 like the kernels do; results stay at bf16
    rounding distance from f32."""
    K = 5
    (et, _), (ft, _), (wt, _), (bt, _) = _mod_inputs(rng, 1, 2, 6, 8, 8, K)
    ref = kern.mod_fac_shared_plain(et, ft, wt, bt, K)
    got = kern.modification_fac_fused_shared(et.bfloat16(), ft.bfloat16(), wt, bt, K)
    assert got.dtype == torch.bfloat16
    scale = ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() < 0.05 * scale


# ------------------------------------------------------------------ wrapper checks


def test_check_inputs_rejects_cpu_and_wrong_dtype():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        _common.check_inputs("k", {"x": x}, torch.float32)
    with pytest.raises(TypeError):
        _common.check_inputs("k", {"x": x}, torch.float16)


def test_kernel_channel_constraint_is_checked():
    from ebfi_tpu_torch.ops.cuda.mod_fac import _check_weights

    C, K = 64, 5
    _check_weights("k", C, K, torch.zeros(3, 3, 2 * C, K * K * C), torch.zeros(K * K * C))
    with pytest.raises(ValueError, match="C=64"):
        _check_weights("k", 16, K, torch.zeros(3, 3, 32, 400), torch.zeros(400))
    with pytest.raises(ValueError):
        _check_weights("k", C, K, torch.zeros(3, 3, C, K * K * C), torch.zeros(K * K * C))


def test_library_name_hashes_the_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libebfi_kernels_")
    assert path == build.library_path()
    names = {p.name for p in build.CSRC_DIR.glob("*.cu")}
    assert names == {"fac.cu", "mod_fac.cu", "mod_fac_wgmma.cu"}
    assert set(build.SIGNATURES) == {
        "ebfi_fac_forward", "ebfi_mod_fac_fused", "ebfi_mod_fac_shared",
        "ebfi_mod_fac_fused_wgmma", "ebfi_mod_fac_shared_wgmma",
    }


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's parameters, as declared in csrc/, match the
    ctypes argtypes: pointers (and the stream) as c_void_p, ints as c_int."""
    import ctypes
    import re

    src = "".join(p.read_text() for p in build.CSRC_DIR.glob("*.cu"))
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(decls) == set(build.SIGNATURES)
    for name, params in decls.items():
        kinds = [
            ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in (q.strip() for q in params.split(","))
        ]
        assert kinds == build.SIGNATURES[name], name
