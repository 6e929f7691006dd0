"""The port's spatial parallelism (DP x SP) on the CPU: ranks are processes
joined over gloo, as in ``test_torch_distributed.py``; each launch runs
every check of its grid once, and the tests read its results.

- One launch of 2 ranks (1 x 2): every row-coupled op of the path on its
  band against the op on the whole image, on the same seeded numpy inputs,
  forward and gradient.  The band's output and its inputs' gradients must
  equal the whole image's rows, its parameters' gradients summed over the
  bands the whole image's: within 1e-5 of the largest magnitude in f32
  (sums reassociate); the forwards of the dark channel's min-pool and the
  Laplacian's integer stencil exactly.
- The same launch and one of 4 ranks (2 x 2): STEPS Adam steps of the
  flagship-graph model of ``tests/test_train.py``
  (``test_spatial_train_step_matches_dp_flagship_graph``: DarkCh,
  ``use_gt_ex=False``, detail on, 128 x 32, 2 shards of 64 rows) from the
  JAX package's initial weights, carried by ``params_from_jax``:
  - against the JAX package's ``make_train_step(model, mesh,
    spatial=True)`` on its virtual CPU mesh (2 x 2: DP x SP is DP is one
    process there, so one JAX run serves both grids): the loss within
    1e-5 relative at every step, the parameters within the Adam tolerance
    of ``test_torch_train.py`` (at most 2 * lr per step apart, at most
    0.1 % of them more than 1e-3 * lr apart);
  - against the port's unsharded step on the same batches: f32 as above;
    bf16 with FastVariants (which falls back to the unfused Modification
    on a band): the loss within 1e-2 relative, the parameters within
    2 * lr per step (as ``test_torch_distributed.py`` holds bf16 DP);
  - the ranks' parameters bitwise equal, and the grid's groups as
    ``make_mesh`` lays them out (model axis fastest).
The ranks import no JAX; the JAX step runs once, in the test process.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu_torch.models import EVFIAutoEx, params_from_jax
from ebfi_tpu_torch.parallel import spatial_shardings
from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step
from test_torch_distributed import launch
import torch_threads  # noqa: F401  (one intra-op thread per test process)

LAUNCH_TIMEOUT_S = 150
MODEL = dict(frame_basech=8, event_basech=8, inter_ch=8, tb=4, use_gt_ex=False,
             blurry_fashion="DarkCh", bl_in=1, step=2, dual_path=True, residual=True,
             detail_enabled=True, channels=(4, 6, 8, 12))
B, H, W, STEPS, LR = 2, 128, 32, 2, 1e-3
OP_TOL = 1e-5  # relative to the largest magnitude of the whole image's result
EXACT_OPS = ("dark_channel", "laplacian_response")  # their forwards: min-pool, integer stencil
NO_GRAD_OPS = ("laplacian_response",)  # an integer map

# one rank: with "ops_out", the op checks (1 x 2 grid), then the steps
WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist, torch.nn as nn
from ebfi_tpu_torch.losses import census_loss, laplacian_loss
from ebfi_tpu_torch.models import EVFIAutoEx, ExposureDecision, Modification, UNet3d18
from ebfi_tpu_torch.models.layers import (ConvLayer, SEGating, conv3d, conv_transpose3d,
                                          group_norm_nhwc, reflect_conv2d)
from ebfi_tpu_torch.ops import dark_channel, kernel_conv2d_auto, laplacian_response
from ebfi_tpu_torch.ops.cuda.fac import fac_band_cuda
from ebfi_tpu_torch.parallel import (band_scope, current_band, gather_rows, halo_rows,
                                     maybe_init_distributed, model_sum, spatial_shardings)
from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step

spec_in = json.loads(sys.argv[1])
assert maybe_init_distributed()
spec = spatial_shardings(spec_in["model_parallel"])
rank = dist.get_rank()
S, m = spec.model, spec.band_index
torch.manual_seed(0)
rng = np.random.default_rng(5)
arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def band(x, dim):
    n = x.shape[dim] // S
    return x.narrow(dim, m * n, n)


def rel(a, b, scale=None):
    return (a - b).abs().max().item() / max(b.abs().max().item() if scale is None else scale,
                                            1e-30)


def check(fn, inputs, dims, out_dim, module=None, share=1.0):
    # fn on the whole image and on this band: the band's output and its
    # inputs' gradients against the whole image's rows, each error over
    # the largest magnitude of what it is compared with; the parameters'
    # gradients, summed over the bands, against the whole image's, over
    # the largest magnitude of them all (IN zeroes a conv bias's).  An
    # output that every band holds whole (out_dim None) weighs each
    # band's backward by `share`: 1 / S where the bands reduced it
    # (every rank backpropagates its share of the loss), 1 where the
    # bands gathered it (the gather's backward hands each its rows)
    whole = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
    out = fn(*whole)
    r = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    grads = {}
    if out.requires_grad:
        (out * r).sum().backward()
        grads = {n: p.grad.clone() for n, p in (module.named_parameters() if module else [])}
        if module:
            module.zero_grad()
    parts = [band(x, d) if d is not None else x for x, d in zip(inputs, dims)]
    parts = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in parts]
    with band_scope(spec):
        got = fn(*parts)
    want = out if out_dim is None else band(out, out_dim)
    errs = [rel(got, want)]
    if out.requires_grad:
        (got * (share * r if out_dim is None else band(r, out_dim))).sum().backward()
        for x, p, d in zip(whole, parts, dims):
            if x.grad is not None:
                errs.append(rel(p.grad, x.grad if d is None else band(x.grad, d)))
        scale = max([g.abs().max().item() for g in grads.values()], default=None)
        for n, p in (module.named_parameters() if module else []):
            errs.append(rel(model_sum(p.grad, spec), grads[n], scale))
    return {"errs": errs, "n_grads": len(errs) - 1}


def fac(x, bank):
    if current_band() is None:
        return kernel_conv2d_auto(x, bank, 5)
    return fac_band_cuda(halo_rows(x, 1, 2, 2, "replicate"), bank, 5)


def op_checks():
    res = {}
    conv = ConvLayer(6, 8, 3, 1, 1, "LeakyReLU")
    res["conv3x3"] = check(conv, [arr(2, 64, 12, 6)], [1], 1, conv)
    conv2 = ConvLayer(6, 8, 3, 2, 1, "LeakyReLU")
    res["conv3x3_stride2"] = check(conv2, [arr(2, 64, 12, 6)], [1], 1, conv2)
    stem = nn.Conv3d(3, 4, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False)
    res["conv3d_stem"] = check(lambda x: conv3d(stem, x), [arr(2, 3, 2, 64, 12)], [3], 3, stem)
    up = nn.ConvTranspose3d(6, 4, (3, 4, 4), (1, 2, 2), (1, 1, 1))
    res["conv_transpose3d"] = check(lambda x: conv_transpose3d(up, x), [arr(2, 6, 2, 16, 6)],
                                    [3], 3, up)
    out7 = nn.Conv2d(4, 3, 7)
    res["outconv_reflect7x7"] = check(lambda x: reflect_conv2d(out7, x), [arr(2, 4, 64, 12)],
                                      [2], 2, out7)
    frame = torch.from_numpy(rng.uniform(0, 1, (2, 64, 12, 3)).astype(np.float32))
    res["dark_channel"] = check(dark_channel, [frame], [1], 1)
    res["laplacian_response"] = check(laplacian_response, [frame], [1], 1)
    res["fac_band"] = check(fac, [arr(2, 64, 12, 4), arr(2, 64, 12, 100)], [1, 1], 1)
    gn = nn.GroupNorm(4, 8)
    nn.init.normal_(gn.weight); nn.init.normal_(gn.bias)
    res["group_norm_shared"] = check(lambda x: group_norm_nhwc(gn, x), [3 + arr(2, 64, 12, 8)],
                                     [1], 1, gn)
    inorm = ConvLayer(6, 8, 3, 1, 1, "LeakyReLU", "IN")
    res["instance_norm"] = check(inorm, [arr(2, 64, 12, 6)], [1], 1, inorm)
    se = SEGating(6)
    res["se_mean"] = check(se, [arr(2, 6, 2, 16, 12)], [3], 3, se)
    target = torch.from_numpy(rng.uniform(0, 1, (2, 64, 32, 3)).astype(np.float32))
    pred = torch.from_numpy(rng.uniform(0, 1, (2, 64, 32, 3)).astype(np.float32))
    gathered = lambda loss: lambda p: loss(p if current_band() is None else gather_rows(p, spec),
                                           target)
    res["laplacian_loss"] = check(gathered(laplacian_loss), [pred], [1], None)
    res["census_loss"] = check(gathered(census_loss), [pred], [1], None)
    # modules of the path as a whole
    ed = ExposureDecision(8, 4, 8)
    res["exposure_decision"] = check(ed, [arr(2, 64, 12, 8).abs(), arr(2, 64, 12, 4)], [1, 1],
                                     None, ed, share=1 / S)
    with band_scope(spec), torch.no_grad():
        ex = ed(band(arr(2, 64, 12, 8), 1), band(arr(2, 64, 12, 4), 1))
    res["exposure_decision"]["ex_bits"] = ex.numpy().view(np.int32).tolist()
    mod = Modification(8, 8, 5, fused=True)  # falls back to the unfused path on a band
    res["modification"] = check(mod, [arr(2, 32, 12, 8), arr(2, 32, 12, 8)], [1, 1], 1, mod)
    unet = UNet3d18((4, 6, 8, 12))
    img = torch.from_numpy(rng.uniform(0, 1, (2, 64, 16, 3)).astype(np.float32))
    res["unet3d_detail"] = check(unet, [img, img.flip(1).contiguous()], [1, 1], 1, unet)
    return res


if spec_in.get("ops_out"):
    json.dump(op_checks(), open(spec_in["ops_out"] % rank, "w"))

data = np.load(spec_in["batches"])
weights = torch.load(spec_in["weights"], weights_only=True)
out = {"groups": [dist.get_process_group_ranks(spec.model_group),
                  dist.get_process_group_ranks(spec.data_group)],
       "index": [spec.data_index, spec.band_index]}
for label, bf16 in (("f32", False), ("bf16", True)):
    model = EVFIAutoEx(**spec_in["model"], fast_mod=bf16)
    model.load_state_dict(weights)
    updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": spec_in["lr"]}},
                                 spatial=spec)
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, spatial=spec)
    state, losses = TrainState(model, updater), []
    n = data["frame"].shape[1] // spec.data
    for i in range(data["frame"].shape[0]):
        b = {k: torch.from_numpy(data[k][i, spec.data_index * n:(spec.data_index + 1) * n])
             for k in ("frame", "event", "t", "target")}
        state, metrics = step(state, b)
        losses.append(float(metrics["train_loss"]))
    out[label] = losses
    np.savez(spec_in["out"] % rank + "." + label + ".npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
json.dump(out, open(spec_in["out"] % rank, "w"))
dist.destroy_process_group()
"""


def _batches(seed=3):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 1, (STEPS, B, H, W, 3)).astype(np.float32)
    return {"frame": frame,
            "event": np.abs(rng.standard_normal((STEPS, B, H, W, 8))).astype(np.float32),
            "t": rng.uniform(0, 1, (STEPS, B, 1)).astype(np.float32),
            "target": rng.uniform(0, 1, (STEPS, B, H, W, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's spatial step on a 2 x 2 CPU mesh, the port's
    unsharded f32 and bf16 steps, and the weights and batches they start
    from (written for the ranks)."""
    from ebfi_tpu.models import EVFIAutoEx as JaxEVFI
    from ebfi_tpu.parallel.mesh import dp_shardings, make_mesh
    from ebfi_tpu.train import build_optimizer as jax_build_optimizer
    from ebfi_tpu.train import create_train_state
    from ebfi_tpu.train import make_train_step as jax_train_step

    d = tmp_path_factory.mktemp("spatial")
    batches = _batches()
    np.savez(d / "batches.npz", **batches)
    jm = JaxEVFI(**MODEL)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 8)),
                              jnp.zeros((1, 1)))
    weights = params_from_jax(jax.tree.map(np.asarray, params))
    torch.save(weights, d / "weights.pt")

    tx, _ = jax_build_optimizer({"name": "Adam", "args": {"lr": LR}})
    mesh = make_mesh(num_devices=4, model_parallel=2)
    batch_sh, repl = dp_shardings(mesh)
    state = jax.device_put(create_train_state(jm, params, tx), repl)
    step = jax_train_step(jm, mesh=mesh, spatial=True, donate=False)
    jax_losses = []
    for i in range(STEPS):
        state, m = step(state, {k: jax.device_put(v[i], batch_sh) for k, v in batches.items()})
        jax_losses.append(float(m["train_loss"]))
    out = {"dir": d, "jax": (jax_losses, {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state.params)).items()})}

    for label, bf16 in (("f32", False), ("bf16", True)):
        model = EVFIAutoEx(**MODEL, fast_mod=bf16)
        model.load_state_dict(weights)
        updater, _ = build_optimizer(model, {"name": "Adam", "args": {"lr": LR}})
        tstep = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None)
        tstate, losses = TrainState(model, updater), []
        for i in range(STEPS):
            tstate, m = tstep(tstate, {k: torch.from_numpy(v[i]) for k, v in batches.items()})
            losses.append(float(m["train_loss"]))
        out[label] = (losses, {k: v.numpy() for k, v in model.state_dict().items()})
    return out


def _launch(reference, ranks):
    """One launch of ``ranks`` ranks (1 x 2: the op checks first); every
    rank's results."""
    d = reference["dir"]
    spec = {"model_parallel": 2, "model": {**MODEL, "channels": list(MODEL["channels"])},
            "lr": LR, "batches": str(d / "batches.npz"), "weights": str(d / "weights.pt"),
            "out": str(d / f"step{ranks}.rank%d.json"),
            "ops_out": str(d / "ops.rank%d.json") if ranks == 2 else None}
    for rc, out, err in launch(ranks, ["-c", WORKER, json.dumps(spec)], timeout=LAUNCH_TIMEOUT_S):
        assert rc == 0, err[-3000:]
    results = []
    for r in range(ranks):
        with open(spec["out"] % r) as f:
            res = json.load(f)
        for label in ("f32", "bf16"):
            res[label + "_params"] = dict(np.load(spec["out"] % r + f".{label}.npz"))
        if spec["ops_out"]:
            with open(spec["ops_out"] % r) as f:
                res["ops"] = json.load(f)
        results.append(res)
    return results


@pytest.fixture(scope="module")
def two_ranks(reference):
    return _launch(reference, 2)


@pytest.fixture(scope="module")
def four_ranks(reference):
    return _launch(reference, 4)


OPS = ["conv3x3", "conv3x3_stride2", "conv3d_stem", "conv_transpose3d", "outconv_reflect7x7",
       "dark_channel", "laplacian_response", "fac_band", "group_norm_shared", "instance_norm",
       "se_mean", "laplacian_loss", "census_loss", "exposure_decision", "modification",
       "unet3d_detail"]


@pytest.mark.parametrize("op", OPS)
def test_band_op_matches_the_whole_image(two_ranks, op):
    ops = [res["ops"] for res in two_ranks]
    for rank, res in enumerate(ops):
        errs = res[op]["errs"]
        assert errs[0] <= (0.0 if op in EXACT_OPS else OP_TOL), f"rank {rank}: {op} {errs}"
        assert max(errs) <= OP_TOL, f"rank {rank}: {op} forward/gradient errors {errs}"
        assert (res[op]["n_grads"] > 0) == (op not in NO_GRAD_OPS)
    if op == "exposure_decision":  # ex bit for bit on every rank of the model group
        assert ops[0][op]["ex_bits"] == ops[1][op]["ex_bits"]


def _assert_adam_close(got, want, bf16):
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * LR * STEPS
    if not bf16:
        assert (diffs > 1e-3 * LR).mean() <= 1e-3


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("against", ["jax_f32", "port_f32", "port_bf16"])
def test_spatial_step_matches(reference, two_ranks, four_ranks, ranks, against):
    results = two_ranks if ranks == 2 else four_ranks
    label = "bf16" if against.endswith("bf16") else "f32"
    want_losses, want_params = reference["jax" if against.startswith("jax") else label]
    for r in range(1, ranks):  # bitwise equal replicas
        for k in want_params:
            np.testing.assert_array_equal(results[r][label + "_params"][k],
                                          results[0][label + "_params"][k], err_msg=k)
    # every rank's loss is its data shard's; their mean is the global batch's
    got = np.mean([res[label] for res in results], axis=0)
    np.testing.assert_allclose(got, want_losses, rtol=1e-2 if label == "bf16" else 1e-5)
    _assert_adam_close(results[0][label + "_params"], want_params, label == "bf16")


@pytest.mark.parametrize("ranks", [2, 4])
def test_spatial_shardings_builds_the_grid(two_ranks, four_ranks, ranks):
    results = two_ranks if ranks == 2 else four_ranks
    S = 2
    for r, res in enumerate(results):
        d, m = divmod(r, S)
        assert res["index"] == [d, m]
        assert res["groups"][0] == [d * S + i for i in range(S)]
        assert res["groups"][1] == [i * S + m for i in range(ranks // S)]


def test_spatial_spec_without_a_group():
    spec = spatial_shardings(1)
    assert (spec.data, spec.model, spec.data_index, spec.band_index) == (1, 1, 0, 0)
    assert spec.band_rows(128) == (0, 128)
    with pytest.raises(ValueError, match="band alignment 8 x the model axis 1"):
        spec.band_rows(100)
    with pytest.raises(ValueError, match="needs a process group"):
        spatial_shardings(2)
