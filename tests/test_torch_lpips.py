"""The port's LPIPS against ``ebfi_tpu.losses.LPIPS`` on the CPU, and the
perceptual term of the train step against ``ebfi_tpu.train``'s.

Inputs are numpy, seeded, 96x96 (AlexNet's stride-4 first stage and two
pools leave 5x5 taps).  Tolerance: 1e-5 relative on the distances (f32
convolutions of up to 11x11x3 and 3x3x384 terms, summed in another order
by XLA and PyTorch).  The weights are the same numbers in both: the JAX
package's random backbone converted with ``lpips_params_from_jax``, or a
torchvision-layout backbone file and an ``alex.pth``-layout heads file
read by both loaders.
"""
import os

import jax.numpy as jnp
import numpy as np
import torch

from ebfi_tpu.losses import LPIPS as JaxLPIPS
from ebfi_tpu.losses import load_lpips_params as jax_load
from ebfi_tpu_torch.losses import LPIPS, load_lpips_params
from ebfi_tpu_torch.losses.lpips import ALEX_CONVS, ALEX_LAYER_IDS
from ebfi_tpu_torch.models import lpips_params_from_jax
from test_torch_cli import FLAGS, inputs  # noqa: F401  (inputs: the CLI tests' clips, checkpoints)
from test_torch_train import _assert_params_close, _batches, _models, _port_params
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ROOT = os.path.join(os.path.dirname(__file__), "..")
HW = 96
RTOL = 1e-5


def _images(seed, b=2):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.2, pred.shape), 0, 1).astype(np.float32)
    return pred, target


def write_backbone(path, seed=0):
    """A random AlexNet ``features`` state dict in torchvision's layout."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for lid, (cout, k, _, _) in zip(ALEX_LAYER_IDS, ALEX_CONVS):
        std = (2.0 / (k * k * cin)) ** 0.5
        sd[f"features.{lid}.weight"] = torch.randn(cout, cin, k, k, generator=g) * std
        sd[f"features.{lid}.bias"] = torch.randn(cout, generator=g) * 0.1
        cin = cout
    torch.save(sd, path)
    return str(path)


def _write_heads(path, seed=1):
    """Linear heads in the reference's ``alex.pth`` layout, some negative."""
    g = torch.Generator().manual_seed(seed)
    torch.save({f"lin{i}.model.1.weight": torch.randn(1, c, 1, 1, generator=g)
                for i, (c, *_) in enumerate(ALEX_CONVS)}, path)
    return str(path)


def _distances(jax_params, port_params, seed):
    pred, target = _images(seed)
    want = np.asarray(JaxLPIPS(jax_params)._distance(jnp.asarray(pred), jnp.asarray(target)))
    got = LPIPS(port_params)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    return got, want


def test_random_backbone_matches_jax():
    jp = jax_load()
    got, want = _distances(jp, lpips_params_from_jax(jp), 3)
    assert want.shape == got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_own_random_backbone_equals_the_jax_draw():
    """Without a backbone file both loaders draw the same numbers."""
    mine, theirs = load_lpips_params(seed=4), lpips_params_from_jax(jax_load(seed=4))
    assert sorted(mine) == sorted(theirs) and mine["_real_backbone"] is False
    for k, v in theirs.items():
        if k != "_real_backbone":
            torch.testing.assert_close(mine[k], v, rtol=0, atol=0, msg=k)
    assert not LPIPS(mine).comparable


def test_backbone_file_matches_jax(tmp_path):
    path = write_backbone(tmp_path / "alexnet.pth")
    mine = load_lpips_params(backbone_path=path)
    got, want = _distances(jax_load(backbone_path=path), mine, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert LPIPS(mine).comparable and JaxLPIPS(jax_load(backbone_path=path)).comparable


def test_heads_file_matches_jax(tmp_path):
    heads = _write_heads(tmp_path / "alex.pth")
    mine = load_lpips_params(linear_path=heads)
    assert all((mine[f"lin{i}_w"] >= 0).all() for i in range(5))
    got, want = _distances(jax_load(linear_path=heads), mine, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_default_heads_are_the_package_copy():
    """The port's heads file holds the JAX package's numbers; the port
    reads its own copy."""
    ours = os.path.join(ROOT, "ebfi_tpu_torch", "losses", "lpips_alex_linear.npz")
    theirs = os.path.join(ROOT, "ebfi_tpu", "losses", "lpips_alex_linear.npz")
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    from ebfi_tpu_torch.losses import lpips as mod

    assert os.path.realpath(mod.HEADS_FILE) == os.path.realpath(ours)


def test_identical_images_are_at_distance_zero_and_gradients_flow():
    lp = LPIPS(load_lpips_params(seed=0))
    pred, target = (torch.from_numpy(a) for a in _images(7))
    assert float(lp(target, target).abs().max()) < 1e-6
    pred.requires_grad_()
    lp(pred, target).mean().backward()
    assert pred.grad is not None and bool(torch.isfinite(pred.grad).all())
    assert not any(b.requires_grad for b in lp.buffers())


# ------------------------------------------------------ the perceptual term


def test_perceptual_train_step_matches_jax(tmp_path):
    """Three SGD steps with ``trainer.loss.perceptual`` on, both packages
    reading the same backbone file and their default heads: the loss and
    the LPIPS term within 1e-4 relative at every step, the weights within
    ``test_torch_train.py``'s SGD bound."""
    import jax
    from ebfi_tpu.train import build_optimizer as jax_build_optimizer
    from ebfi_tpu.train import create_train_state
    from ebfi_tpu.train import make_train_step as jax_train_step
    from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step

    loss_cfg = {"perceptual": {"enabled": True, "weight": 0.5,
                               "alexnet_weights": write_backbone(tmp_path / "alexnet.pth")}}
    jm, params, tm = _models()
    init = _port_params(params)
    opt_cfg = {"name": "SGD", "args": {"lr": 1e-2}}
    tx, _ = jax_build_optimizer(opt_cfg)
    jstate = create_train_state(jm, params, tx)
    jstep = jax_train_step(jm, loss_cfg=loss_cfg)
    updater, _ = build_optimizer(tm, opt_cfg)
    tstate = TrainState(tm, updater)
    tstep = make_train_step(loss_cfg=loss_cfg)
    for i, b in enumerate(_batches(8)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("train_loss", "lpips_loss"):
            want, got = float(jm_[key]), float(tm_[key])
            assert abs(got - want) <= 1e-4 * abs(want), f"step {i} {key}: {got} vs {want}"
    assert float(tm_["lpips_loss"]) > 0
    _assert_params_close(tm, jax.tree.map(np.asarray, jstate.params), init)


def test_lpips_term_runs_in_f32_under_bf16_compute():
    from ebfi_tpu_torch.train import TrainState, build_optimizer, make_train_step

    _, _, tm = _models()
    updater, _ = build_optimizer(tm, {"name": "Adam", "args": {"lr": 1e-4}})
    step = make_train_step(compute_dtype=torch.bfloat16,
                           loss_cfg={"perceptual": {"enabled": True}})
    b = {k: torch.from_numpy(v) for k, v in _batches(9, n=1)[0].items()}
    _, m = step(TrainState(tm, updater), b)
    assert m["lpips_loss"].dtype == torch.float32 and float(m["lpips_loss"]) > 0
    assert all(p.dtype == torch.float32 for p in tm.parameters())


# ------------------------------------------------------------- the infer CLI


def test_infer_cli_lpips_column_matches_jax_cli(inputs, tmp_path, monkeypatch):
    """``--alexnet_weights`` on both CLIs (f32, the same clip and weights):
    an ``lpips`` column in the per-clip and mean results, within 1e-4
    absolute; with ``--lpips_weights`` alone (random backbone) both warn and
    leave it out."""
    import functools

    import yaml
    from ebfi_tpu.infer import cli as jax_cli
    from ebfi_tpu_torch.infer.cli import main as port_main

    monkeypatch.setattr(jax_cli, "EBFIDataLoader",
                        functools.partial(jax_cli.EBFIDataLoader, num_threads=1))
    ckpt, port_ckpt, clips = inputs
    h5, npz = clips["synthetic"]
    backbone = write_backbone(tmp_path / "alexnet.pth")
    heads = _write_heads(tmp_path / "alex.pth")
    for extra, has_lpips in ((["--alexnet_weights", backbone], True),
                             (["--lpips_weights", heads], False)):
        means = {}
        for side, model, clip, run, dev in (("jax", ckpt, h5, jax_cli.main, []),
                                            ("port", port_ckpt, npz, port_main,
                                             ["--device", "cpu"])):
            out = tmp_path / f"{side}_{has_lpips}"
            datalist = tmp_path / f"{side}.txt"
            datalist.write_text(clip + "\n")
            run(["--model_path", model, "--data_list", str(datalist), "--output_path", str(out)]
                + FLAGS + extra + dev)
            results = yaml.safe_load(open(out / "inference_all.yml"))
            means[side] = results["mean results for the whole data"]
            per_clip = results["breakdown results for each data"]
            assert ("lpips" in per_clip) == has_lpips
        assert list(means["port"]) == list(means["jax"])
        assert ("lpips" in means["port"]) == has_lpips
        if has_lpips:
            assert means["jax"]["lpips"] > 0
            assert abs(means["port"]["lpips"] - means["jax"]["lpips"]) <= 1e-4

