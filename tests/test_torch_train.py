"""The port's training against ``ebfi_tpu.train`` on the CPU.

A narrow EVFIAutoEx (widths 8, tb 4, 2 control stages) gets the JAX
package's initial weights through ``params_from_jax``; both train steps
then take the same numpy batches.  Tolerances:

- loss, f32: 1e-4 relative at every step (sums of ~6000 terms
  reassociate between XLA and PyTorch);
- parameters, f32, SGD: within 1e-3 of the largest change the JAX steps
  made to any parameter;
- parameters, f32, Adam: Adam's first updates are lr * g / (|g| + eps),
  about +-lr wherever |g| >> eps, so a gradient that is ~0 in both
  frameworks may take either sign: at most 2 * lr * steps apart, and at
  most 0.1 % of the parameters more than 1e-3 * lr apart;
- bf16 compute (f32 master weights): loss 2e-2 relative (bf16 rounds at
  other places in the two frameworks).
"""
import copy
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.models import EVFIAutoEx as JaxEVFI
from ebfi_tpu.models import ExposureDecision as JaxExposure
from ebfi_tpu.train import build_optimizer as jax_build_optimizer
from ebfi_tpu.train import create_train_state, make_eval_step as jax_eval_step
from ebfi_tpu.train import make_train_step as jax_train_step
from ebfi_tpu.train.exposure_step import make_exposure_eval_step as jax_ex_eval
from ebfi_tpu.train.exposure_step import make_exposure_train_step as jax_ex_train
from ebfi_tpu_torch.models import EVFIAutoEx, ExposureDecision, params_from_jax
from ebfi_tpu_torch.parallel import spatial_shardings
from ebfi_tpu_torch.train import TrainState, build_optimizer, make_eval_step, make_train_step
from ebfi_tpu_torch.train.exposure_step import make_exposure_eval_step, make_exposure_train_step
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ARGS = dict(frame_basech=8, event_basech=8, inter_ch=8, tb=4, step=2, channels=(4, 6, 8, 12),
            blurry_fashion="RGBLap", bl_in=4)
B, H, W = 2, 32, 32
STEPS = 3


def _batches(seed, n=STEPS, gt_ex=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"frame": rng.uniform(0, 1, (B, H, W, 3)), "event": rng.uniform(0, 3, (B, H, W, 8)),
             "t": rng.uniform(0, 1, (B, 1)), "target": rng.uniform(0, 1, (B, H, W, 3))}
        if gt_ex:
            b["gt_ex"] = rng.uniform(0.2, 0.9, (B, 1))
        out.append({k: v.astype(np.float32) for k, v in b.items()})
    return out


def _models(seed=0, **kw):
    args = {**ARGS, **kw}
    jm = JaxEVFI(**args)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 8)),
                     jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    fast = args.pop("fast_recon", False)
    for k in ("fast_detail", "fast_control"):
        args.pop(k, None)
    tm = EVFIAutoEx(**{**args, "fast_mod": args.pop("fast_mod", False) or fast})
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _port_params(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _assert_params_close(tm, jax_params, init):
    """SGD: the port's parameters within 1e-3 of the largest change the
    JAX steps made to any parameter (gradients agree to ~1e-5 relative;
    the loss is a sum over pixels, so lr * gradient moves parameters by
    up to ~1e-1 here)."""
    want = _port_params(jax_params)
    moved = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    assert moved > 0
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], atol=1e-3 * moved, rtol=0,
                                   err_msg=k)


CASES = {
    # name: (optimizer, model kwargs, step kwargs)
    "f32_adam": ({"name": "Adam", "args": {"lr": 1e-3}}, {}, {}),
    "f32_sgd": ({"name": "SGD", "args": {"lr": 1e-2}}, {}, {}),
    "phase_switch": ({"name": "SGD", "args": {"lr": 1e-2}}, {}, {"phase_switch_iter": 2}),
    "no_detail": ({"name": "SGD", "args": {"lr": 1e-2}}, {"detail_enabled": False},
                  {"detail_enabled": False}),
    "fast_variants": ({"name": "SGD", "args": {"lr": 1e-2}},
                      {"fast_recon": True, "fast_detail": True, "fast_control": True,
                       "fast_mod": True}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    opt_cfg, model_kw, step_kw = CASES[case]
    jm, params, tm = _models(**model_kw)
    init = _port_params(params)  # the JAX step donates its state
    tx, _ = jax_build_optimizer(opt_cfg)
    jstate = create_train_state(jm, params, tx)
    jstep = jax_train_step(jm, **step_kw)
    updater, _ = build_optimizer(tm, opt_cfg)
    tstate = TrainState(tm, updater)
    tstep = make_train_step(**step_kw)
    for i, b in enumerate(_batches(1)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl, tl = float(jm_["train_loss"]), float(tm_["train_loss"])
        assert abs(tl - jl) <= 1e-4 * abs(jl), f"step {i}: loss {tl} vs {jl}"
    assert tstate.step == int(jstate.step) == STEPS
    if opt_cfg["name"] == "SGD":
        _assert_params_close(tm, jstate.params, init)
    else:
        want = _port_params(jstate.params)
        got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
        lr = opt_cfg["args"]["lr"]
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= 2 * lr * STEPS
        assert (diffs > 1e-3 * lr).mean() <= 1e-3


def test_bf16_train_step_matches_jax_at_bf16_tolerance():
    jm, params, tm = _models()
    opt_cfg = {"name": "SGD", "args": {"lr": 1e-2}}
    tx, _ = jax_build_optimizer(opt_cfg)
    jstate = create_train_state(jm, params, tx)
    jstep = jax_train_step(jm, compute_dtype=jnp.bfloat16)
    updater, _ = build_optimizer(tm, opt_cfg)
    tstate = TrainState(tm, updater)
    tstep = make_train_step(compute_dtype=torch.bfloat16)
    for b in _batches(2, n=2):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl, tl = float(jm_["train_loss"]), float(tm_["train_loss"])
        assert abs(tl - jl) <= 2e-2 * abs(jl), (tl, jl)
    # the master weights stay f32
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_eval_step_matches_jax():
    jm, params, tm = _models()
    b = _batches(3, n=1)[0]
    want = float(jax_eval_step(jm)(params, {k: jnp.asarray(v) for k, v in b.items()})["valid_loss"])
    got = float(make_eval_step()(tm, {k: torch.from_numpy(v) for k, v in b.items()})["valid_loss"])
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("fashion", ["RGBLap", "DarkCh"])
def test_exposure_step_matches_jax(fashion):
    bl_in = 4 if fashion == "RGBLap" else 1
    jm = JaxExposure(event_in=8, bl_in=bl_in, inter_ch=8)
    params = jm.init(jax.random.key(0), jnp.zeros((1, H, W, 8)), jnp.zeros((1, H, W, bl_in)))
    tm = ExposureDecision(8, bl_in, 8)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    opt_cfg = {"name": "Adam", "args": {"lr": 1e-3}}
    tx, _ = jax_build_optimizer(opt_cfg)
    jstate = create_train_state(jm, params, tx)
    jstep, jeval = jax_ex_train(jm, fashion), jax_ex_eval(jm, fashion)
    updater, _ = build_optimizer(tm, opt_cfg)
    tstate = TrainState(tm, updater)
    tstep, teval = make_exposure_train_step(fashion), make_exposure_eval_step(fashion)
    for b in _batches(4, n=2, gt_ex=True):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        jstate, jm_ = jstep(jstate, jb)
        tstate, tm_ = tstep(tstate, tb)
        assert abs(float(tm_["train_loss"]) - float(jm_["train_loss"])) <= 1e-4 * abs(
            float(jm_["train_loss"]))
    jv = float(jeval(jstate.params, jb)["valid_loss"])
    tv = float(teval(tm, tb)["valid_loss"])
    assert abs(tv - jv) <= 1e-3 * abs(jv)


def test_unported_options_raise():
    # spatial parallelism is ported (test_torch_spatial.py); the adversarial
    # and perceptual terms under it are not, and raise naming the feature
    spec = spatial_shardings(1)
    for term in ("adversarial", "perceptual"):
        with pytest.raises(NotImplementedError, match=f"the {term} term .* spatial"):
            make_train_step(spatial=spec, loss_cfg={term: {"enabled": True}})
    with pytest.raises(TypeError, match="SpatialSpec"):
        make_train_step(spatial=True)
    # the adversarial and perceptual terms are ported (test_torch_adversarial.py and
    # test_torch_lpips.py hold them against JAX); the adversarial one needs its state
    step = make_train_step(loss_cfg={"adversarial": {"enabled": True}})
    tm = EVFIAutoEx(**ARGS)
    updater, _ = build_optimizer(tm, {"name": "SGD", "args": {"lr": 1e-3}})
    b = {k: torch.from_numpy(v) for k, v in _batches(0, n=1)[0].items()}
    with pytest.raises(ValueError, match="adv_state"):
        step(TrainState(tm, updater), b)
    make_train_step(loss_cfg={"perceptual": {"enabled": True}})


ADV_CFG = {"adversarial": {"enabled": True, "gan_type": "STGAN", "weight": 0.05}}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_adversarial_train_steps_match_jax(precision):
    """Three Adam steps of the tiny model with the STGAN term against the
    JAX step on the same batches, from the same model and discriminator
    weights: train_loss, g_loss and d_loss at every step (f32 1e-4
    relative; bf16: train_loss 2e-2, as the plain bf16 step, g_loss and
    d_loss 5e-2: the discriminator's Adamax update amplifies one-ulp bf16
    differences of the final head it sees, while given the same head the
    two adversarial steps agree as in f32); the generator's
    parameters within 2 * lr per Adam step (in f32 also at most 0.1 % of
    them more than 1e-3 * lr apart); the discriminator's, updated by
    Adamax (lr 1e-3, first updates about lr * sign(g)), within 2 * lr per
    update in both precisions (it sees the f32 final head of generators
    that drift apart by those bounds)."""
    from ebfi_tpu.train.train_step import build_adversarial as jax_build_adversarial
    from ebfi_tpu.train.train_step import init_adv_state as jax_init_adv_state
    from ebfi_tpu_torch.models import discriminator_params_from_jax
    from ebfi_tpu_torch.train import build_adversarial, init_adv_state

    bf16 = precision == "bf16"
    jm, params, tm = _models()
    opt_cfg = {"name": "Adam", "args": {"lr": 1e-3}}
    tx, _ = jax_build_optimizer(opt_cfg)
    sample = {"target": jnp.zeros((1, H, W, 3)), "frame": jnp.zeros((1, H, W, 3))}
    jadv = jax_init_adv_state(jax_build_adversarial(ADV_CFG), jax.random.key(9), sample)
    jstate = create_train_state(jm, params, tx).replace(adv_state=jadv)
    jstep = jax_train_step(jm, compute_dtype=jnp.bfloat16 if bf16 else None, loss_cfg=ADV_CFG)

    updater, _ = build_optimizer(tm, opt_cfg)
    tsample = torch.zeros((1, H, W, 3))
    adv_state = init_adv_state(build_adversarial(ADV_CFG), 0, {"target": tsample,
                                                                 "frame": tsample})
    adv_state.disc.load_state_dict(discriminator_params_from_jax(
        jax.tree.map(np.asarray, jadv.params)), strict=True)
    tstate = TrainState(tm, updater, adv_state=adv_state)
    tstep = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, loss_cfg=ADV_CFG)
    rtol = {"train_loss": 2e-2, "g_loss": 5e-2, "d_loss": 5e-2} if bf16 else {
        "train_loss": 1e-4, "g_loss": 1e-4, "d_loss": 1e-4}
    for i, b in enumerate(_batches(5)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for k, tol in rtol.items():
            want, got = float(jm_[k]), float(tm_[k])
            assert abs(got - want) <= tol * abs(want), f"step {i}: {k} {got} vs {want}"
    lr = opt_cfg["args"]["lr"]
    want = _port_params(jstate.params)
    got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * lr * STEPS
    if not bf16:
        assert (diffs > 1e-3 * lr).mean() <= 1e-3
    want = {k: v.numpy() for k, v in discriminator_params_from_jax(
        jax.tree.map(np.asarray, jstate.adv_state.params)).items()}
    got = {k: v.detach().numpy() for k, v in tstate.adv_state.disc.state_dict().items()}
    assert all(v.dtype == np.float32 for v in got.values())
    d_diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d_diffs.max() <= 2 * 1e-3 * STEPS


@pytest.mark.parametrize("gan_type", ["GAN", "WGAN", "WGAN_GP", "T_WGAN_GP", "FI_GAN",
                                      "FI_Cond_GAN", "STGAN"])
def test_adversarial_train_step_runs_for_every_gan_type(gan_type):
    """``make_train_step`` with each GAN type and two accumulated
    micro-steps: the discriminator updates at every micro-step
    (its state moves at the first one), the model only at the second, and
    the metrics are finite (each type's step is held against JAX in
    test_torch_adversarial.py)."""
    from ebfi_tpu_torch.train import build_adversarial, init_adv_state

    cfg = {"adversarial": {"enabled": True, "gan_type": gan_type}}
    torch.manual_seed(0)
    tm = EVFIAutoEx(**ARGS)
    updater, _ = build_optimizer(tm, {"name": "Adam", "args": {"lr": 1e-3}}, accumulate_steps=2)
    sample = torch.zeros((1, H, W, 3))
    state = TrainState(tm, updater, adv_state=init_adv_state(build_adversarial(cfg), 1, {
        "target": sample, "frame": sample}))
    step = make_train_step(loss_cfg=cfg)
    model0 = {k: v.clone() for k, v in tm.state_dict().items()}
    disc0 = {k: v.clone() for k, v in state.adv_state.disc.state_dict().items()}
    b1, b2 = ({k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(6, n=2))
    state, m = step(state, b1)
    assert all(torch.equal(v, model0[k]) for k, v in tm.state_dict().items())
    assert not all(torch.equal(v, disc0[k]) for k, v in state.adv_state.disc.state_dict().items())
    state, m = step(state, b2)
    assert not all(torch.equal(v, model0[k]) for k, v in tm.state_dict().items())
    assert set(m) == {"train_loss", "g_loss", "d_loss"}
    assert all(np.isfinite(float(v)) for v in m.values())


# ---------------------------------------------------------------- the trainers

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def _trainer_cfg(out, name):
    return {
        "experiment": "smoke",
        "model": {"name": "EVFIAutoEx"},
        "optimizer": {"name": "SGD", "args": {"lr": 1e-3}},
        "lr_scheduler": {"name": "StepLR", "args": {"step_size": 2, "gamma": 0.5}},
        "trainer": {
            "output_path": str(out / name),
            "iteration_based_train": {
                "enabled": True, "iterations": 5, "save_period": 1000, "train_log_step": 1,
                "valid_step": 4, "lr_change_rate": 1,
            },
            "epoch_based_train": {"enabled": False},
            "monitor": "min valid_loss", "early_stop": 10, "accu_step": 1,
            "do_validation": True, "lr_min": 1e-6,
        },
    }


def test_trainer_matches_jax_trainer(tmp_path):
    """Both Trainers for 5 iterations on one clip (H5 for the JAX loader,
    its .npz repack for the port's), shuffled with one seed and flipped
    per item: the same batches, losses and validation, the weights within
    the SGD bound above.

    The validation loaders flip nothing, as the shipped config validates
    (``configs/train_evfi.yml``: flips off, a fixed centre crop).  With
    flips there, each validation item's
    flip came from a seed drawn from python's global ``random``, which the
    JAX loader's item threads reseed (``random.seed`` per item, in whatever
    order the threads run) and the port's loader leaves alone: the two
    validations flipped different items, and the best ``valid_loss`` moved
    by up to ~1.5e-4 relative between runs (flips alone move this clip's
    loss by ~1e-4).  The JAX loaders run one item thread, so its training
    flips cannot race between threads either.  Two checks then hold what
    remains: the eval steps on equal weights (the JAX-trained ones) within
    1e-5 relative (measured ~1e-7: sums over 2048 pixels), and the best
    ``valid_loss`` of the two runs within 1e-4 (measured ~5e-7: the
    weights' gap, 1.2e-4 of the largest change, moves the loss that
    little)."""
    from ebfi_tpu.data.dataloader import EBFIDataLoader as JaxLoader
    from ebfi_tpu.data.synth import write_clip_h5
    from ebfi_tpu.train.config import ConfigParser as JaxConfig
    from ebfi_tpu.train.trainer import Trainer as JaxTrainer
    from ebfi_tpu_torch.data.dataloader import EBFIDataLoader
    from ebfi_tpu_torch.train.config import ConfigParser
    from ebfi_tpu_torch.train.trainer import Trainer
    from h5_to_npz import h5_to_npz
    from test_data import dataset_cfg

    h5 = str(tmp_path / "clip.h5")
    write_clip_h5(h5, num_frames=33, H=H, W=W, seed=11)
    npz = h5_to_npz(h5, str(tmp_path / "npz"))
    dcfg = dataset_cfg(time_bins=4, NumPeriodPerSeq=1, SlidingWindowSeq=1)
    dcfg["data_augment"].update(enabled=True, flip=dict(enabled=True, horizontal_prob=0.5,
                                                        vertical_prob=0.5))
    vcfg = copy.deepcopy(dcfg)
    vcfg["data_augment"]["flip"]["enabled"] = False
    jm, params, tm = _models(use_gt_ex=True)
    init = _port_params(params)
    opt = _trainer_cfg(tmp_path, "x")
    loaders = dict(batch_size=2, shuffle=True, drop_last=True, seed=5)

    tx, _ = jax_build_optimizer(opt["optimizer"], opt["lr_scheduler"], lr_min=1e-6)
    random.seed(0)
    jt = JaxTrainer(JaxConfig(_trainer_cfg(tmp_path, "jax"), run_id="j"), jm,
                    create_train_state(jm, params, tx), jax_train_step(jm), jax_eval_step(jm),
                    JaxLoader([h5, h5], dcfg, num_threads=1, **loaders),
                    JaxLoader([h5], vcfg, batch_size=2, num_threads=1))
    jt.train()

    updater, _ = build_optimizer(tm, opt["optimizer"], opt["lr_scheduler"], lr_min=1e-6)
    random.seed(0)
    pt = Trainer(ConfigParser(_trainer_cfg(tmp_path, "port"), run_id="p"), tm,
                 TrainState(tm, updater), make_train_step(), make_eval_step(),
                 EBFIDataLoader([npz, npz], dcfg, **loaders),
                 EBFIDataLoader([npz], vcfg, batch_size=2))
    pt.train()

    assert pt.state.step == int(jt.state.step) == 5
    jl, tl = jt.train_metrics._totals["train_loss"], pt.train_metrics._totals["train_loss"]
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    _assert_params_close(tm, jt.state.params, init)
    # the eval steps on equal weights: the port's on the JAX-trained ones
    jax_valid = jt._valid()["valid_loss"]
    equal = copy.deepcopy(tm)
    equal.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jt.state.params)))
    pt.state.model = equal
    assert abs(pt._valid()["valid_loss"] - jax_valid) <= 1e-5 * abs(jax_valid)
    assert abs(pt.mnt_best - jt.mnt_best) <= 1e-4 * abs(jt.mnt_best)
