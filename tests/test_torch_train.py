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
from ebfi_tpu_torch.train import TrainState, build_optimizer, make_eval_step, make_train_step
from ebfi_tpu_torch.train.exposure_step import make_exposure_eval_step, make_exposure_train_step

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
    with pytest.raises(NotImplementedError, match="A5"):
        make_train_step(spatial=True)
    with pytest.raises(NotImplementedError, match="A5"):
        make_train_step(loss_cfg={"adversarial": {"enabled": True}})
    # the perceptual term is ported (test_torch_lpips.py holds it against JAX)
    make_train_step(loss_cfg={"perceptual": {"enabled": True}})


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
    the SGD bound above."""
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
    jm, params, tm = _models(use_gt_ex=True)
    init = _port_params(params)
    opt = _trainer_cfg(tmp_path, "x")
    loaders = dict(batch_size=2, shuffle=True, drop_last=True, seed=5)

    tx, _ = jax_build_optimizer(opt["optimizer"], opt["lr_scheduler"], lr_min=1e-6)
    random.seed(0)
    jt = JaxTrainer(JaxConfig(_trainer_cfg(tmp_path, "jax"), run_id="j"), jm,
                    create_train_state(jm, params, tx), jax_train_step(jm), jax_eval_step(jm),
                    JaxLoader([h5, h5], dcfg, **loaders), JaxLoader([h5], dcfg, batch_size=2))
    jt.train()

    updater, _ = build_optimizer(tm, opt["optimizer"], opt["lr_scheduler"], lr_min=1e-6)
    random.seed(0)
    pt = Trainer(ConfigParser(_trainer_cfg(tmp_path, "port"), run_id="p"), tm,
                 TrainState(tm, updater), make_train_step(), make_eval_step(),
                 EBFIDataLoader([npz, npz], dcfg, **loaders),
                 EBFIDataLoader([npz], dcfg, batch_size=2))
    pt.train()

    assert pt.state.step == int(jt.state.step) == 5
    jl, tl = jt.train_metrics._totals["train_loss"], pt.train_metrics._totals["train_loss"]
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert abs(pt.mnt_best - jt.mnt_best) <= 1e-4 * abs(jt.mnt_best)
    _assert_params_close(tm, jt.state.params, init)
