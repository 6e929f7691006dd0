"""Checkpoints the port serves from, on the CPU: its own format, the
Orbax -> port conversion tool, and reference-format ``.pth`` files.

Tolerance of the reference route: f32 outputs within 1e-4 abs of the JAX
model's on the same converted weights (the two frameworks sum
convolutions in different orders; values are O(1))."""
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ebfi_tpu.models import EVFIAutoEx as JaxEVFI
from ebfi_tpu.models.factory import build_model as jax_build_model
from ebfi_tpu.train import build_optimizer, create_train_state
from ebfi_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from ebfi_tpu_torch.models import build_model, init_weights, params_from_jax
from ebfi_tpu_torch.utils.checkpoint import FORMAT, load_checkpoint, save_checkpoint
from test_infer_cli import MODEL_CFG
from test_torch_parity import CHANNELS, STEP, TB, C, make_state_dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_checkpoint import convert_evfi_state_dict  # noqa: E402
from jax_ckpt_to_torch import convert  # noqa: E402
import torch_threads  # noqa: F401  (one intra-op thread per test process)


def orbax_checkpoint(directory, model_cfg, seed=0):
    """An Orbax checkpoint of the JAX model, as test_infer_cli.py makes it;
    returns (path, its flax params as numpy)."""
    model = jax_build_model(model_cfg)
    params = model.init(
        jax.random.key(seed), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 8)),
        jnp.zeros((1, 1)), jnp.zeros((1, 1)),
    )
    tx, _ = build_optimizer({"name": "Adam", "args": {"lr": 1e-4}})
    state = create_train_state(model, params, tx)
    path = jax_save_checkpoint(
        str(directory), "checkpoint-iteration10", state.params, state.opt_state, 10,
        {"model": model_cfg}, {"iteration": 10},
    )
    return path, jax.tree.map(np.asarray, params)


def test_port_checkpoint_round_trips(tmp_path):
    model = init_weights(build_model(MODEL_CFG), seed=3)
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, model, {"model": MODEL_CFG, "note": [1, 2.5, None]})
    raw = torch.load(path, weights_only=True)
    assert raw["format"] == FORMAT and set(raw) == {"format", "config", "model_states"}
    loaded, config = load_checkpoint(path)
    assert config == {"model": MODEL_CFG, "note": [1, 2.5, None]}
    want = model.state_dict()
    got = loaded.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not loaded.training


def test_port_checkpoint_loads_strict(tmp_path):
    model = build_model(MODEL_CFG)
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, model, {"model": MODEL_CFG})
    raw = torch.load(path, weights_only=True)
    raw["model_states"].pop(next(iter(raw["model_states"])))
    torch.save(raw, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_checkpoint(path)
    with pytest.raises(ValueError, match="model"):
        save_checkpoint(path, model, {"no_model": 1})


def test_orbax_conversion_tool_equals_params_from_jax(tmp_path):
    ckpt, params = orbax_checkpoint(tmp_path / "ckpt", MODEL_CFG)
    out = str(tmp_path / "converted.pt")
    convert(ckpt, out)
    model, config = load_checkpoint(out)
    assert config["model"] == MODEL_CFG
    want = params_from_jax(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reference_pth_serves_the_jax_model_output(rng, tmp_path):
    """A reference-format .pth: the JAX route (tools/convert_torch_checkpoint
    -> EVFIAutoEx) and the port's (load_checkpoint -> params_from_reference)
    give the same outputs."""
    sd = make_state_dict(rng)
    jparams = convert_evfi_state_dict(sd, step=STEP)
    model_cfg = {"name": "EVFIAutoEx", "args": {
        "FrameBasech": C, "EventBasech": C, "InterCH": C, "TB": TB, "BlurryFashion": "RGBLap",
        "BLInch": 4, "step": STEP, "channels": list(CHANNELS)}}
    path = str(tmp_path / "reference.pth")
    torch.save({"model": {"states": {k: torch.from_numpy(v) for k, v in sd.items()}},
                "config": {"model": model_cfg}}, path)
    model, _ = load_checkpoint(path)

    frame = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    event = np.abs(rng.standard_normal((2, 32, 32, 2 * TB))).astype(np.float32)
    ts = rng.uniform(0, 1, (2, 1)).astype(np.float32)
    jmodel = JaxEVFI(frame_basech=C, event_basech=C, inter_ch=C, tb=TB,
                     blurry_fashion="RGBLap", bl_in=4, step=STEP, channels=CHANNELS)
    js, jf = jmodel.apply(jparams, *map(jnp.asarray, (frame, event, ts)))
    with torch.no_grad():
        s, f = model(*map(torch.from_numpy, (frame, event, ts)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-4)


def test_reference_pth_without_a_model_config_raises(rng, tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in make_state_dict(rng).items()}
    path = str(tmp_path / "bare.pth")
    torch.save({"model": {"states": sd}}, path)
    with pytest.raises(ValueError, match="config"):
        load_checkpoint(path)
