"""The port's training CLI (``ebfi_tpu_torch.train.cli.main`` with
``--device cpu``) on tiny synthetic clips: checkpoint names and contents,
resume, ``--reset`` and the name guard, the ExposureDecision pretrain, the
two-stage handoff (LoadPretrainEX + FrozenEX), a trained checkpoint served
by the infer CLI, and the YAML reader against ``yaml.safe_load``."""
import os

import numpy as np
import pytest
import torch
import yaml

from ebfi_tpu_torch.data.synth import write_clip_npz
from ebfi_tpu_torch.train.checkpoint import restore_checkpoint
from ebfi_tpu_torch.train.cli import main as train_main
from ebfi_tpu_torch.utils.logger import dump_yaml
from ebfi_tpu_torch.utils.yaml_lite import YamlLiteError, safe_load

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL_MODEL = {"FrameBasech": 8, "EventBasech": 8, "InterCH": 8, "TB": 4, "step": 2,
               "channels": [4, 6, 8, 12], "BlurryFashion": "RGBLap", "BLInch": 4}


def _config(name, updates):
    with open(os.path.join(ROOT, "configs", name)) as f:
        cfg = yaml.safe_load(f)
    for path, v in updates.items():
        d = cfg
        keys = path.split(";")
        for k in keys[:-1]:
            d = d[k]
        d[keys[-1]] = v
    return cfg


def _write(path, cfg):
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return str(path)


def _loader_overrides(datalist, real=False):
    out = {}
    for dl in ("train_dataloader", "valid_dataloader"):
        out[f"{dl};path_to_datalist_txt"] = datalist
        out[f"{dl};batch_size"] = 2
        out[f"{dl};num_workers"] = 1
        ds = {"scale": 1, "ori_scale": "ori", "time_bins": 4}
        if real:
            ds["interp_num"] = 4
        else:
            ds.update(NumFramePerPeriod=8, NumFramePerBlurry=8, NumPeriodPerSeq=1,
                      SlidingWindowSeq=1, ExposureTime=[3, 5])
        for k, v in ds.items():
            out[f"{dl};dataset;{k}"] = v
        for aug in ("random_crop", "center_crop", "flip"):
            out[f"{dl};dataset;data_augment;{aug};enabled"] = False
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    clip = str(d / "clip.npz")
    write_clip_npz(clip, num_frames=25, H=32, W=32, seed=2)
    real = str(d / "real.npz")
    write_clip_npz(real, num_frames=12, H=32, W=32, seed=6, real_exposure=(0.5, 0.1))
    (d / "train.txt").write_text(clip + "\n")
    (d / "real.txt").write_text(real + "\n")
    return d


def _full_cfg(data, out, iterations=4, **extra):
    upd = {"trainer;output_path": str(out),
           "trainer;iteration_based_train;iterations": iterations,
           "trainer;iteration_based_train;save_period": 2,
           "trainer;iteration_based_train;valid_step": 2,
           "trainer;iteration_based_train;train_log_step": 1,
           "trainer;tensorboard": False}
    upd.update({f"model;args;{k}": v for k, v in SMALL_MODEL.items()})
    upd.update(_loader_overrides(str(data / "train.txt")))
    upd.update(extra)
    return _config("train_evfi.yml", upd)


def _exposure_cfg(data, out, iterations=2):
    upd = {"trainer;output_path": str(out),
           "trainer;iteration_based_train;iterations": iterations,
           "trainer;iteration_based_train;save_period": iterations,
           "trainer;iteration_based_train;valid_step": 1000,
           "trainer;tensorboard": False,
           "model;args;EventInch": 8, "model;args;InterCH": 8, "model;args;BLInch": 4}
    upd.update(_loader_overrides(str(data / "real.txt"), real=True))
    return _config("train_exposure.yml", upd)


def test_full_model_cli_checkpoints_and_resume(data, tmp_path):
    cfg = _write(tmp_path / "cfg.yml", _full_cfg(data, tmp_path / "out"))
    trainer = train_main(["-c", cfg, "-id", "run", "--device", "cpu"])
    assert trainer.state.step == 4
    save_dir = tmp_path / "out" / "models" / "EVFIAutoEx" / "run"
    names = sorted(os.listdir(save_dir))
    assert {"checkpoint-iteration2.pt", "checkpoint-iteration4.pt"} <= set(names)
    assert all(n.startswith(("checkpoint-iteration", "model_best_until_iteration")) for n in names)
    snapshot = tmp_path / "out" / "logs" / "EVFIAutoEx" / "run" / "config.yml"
    assert safe_load(snapshot.read_text()) == yaml.safe_load(open(cfg))

    ckpt = restore_checkpoint(str(save_dir / "checkpoint-iteration2.pt"))
    assert ckpt["step"] == 2 and ckpt["meta"]["model"]["name"] == "EVFIAutoEx"
    assert ckpt["meta"]["optimizer"]["name"] == "Adam"
    assert ckpt["meta"]["trainer"]["iteration"] == 2
    assert ckpt["opt_states"]["scheduler"]["last_epoch"] == 2

    # resume continues from step 2 with the optimizer's state
    resumed = train_main(["-c", cfg, "-id", "res", "--device", "cpu",
                          "-r", str(save_dir / "checkpoint-iteration2.pt")])
    assert resumed.state.step == 4
    assert resumed.state.updater.scheduler.last_epoch == 4
    # --reset keeps the weights, drops the optimizer state and the step
    reset = train_main(["-c", cfg, "-id", "reset", "--device", "cpu", "--reset",
                        "-r", str(save_dir / "checkpoint-iteration2.pt")])
    assert reset.state.step == 4 and reset.state.updater.scheduler.last_epoch == 4
    first = restore_checkpoint(
        str(tmp_path / "out" / "models" / "EVFIAutoEx" / "reset" / "checkpoint-iteration2.pt"))
    assert first["step"] == 2  # two steps taken after the reset to step 0


def test_adversarial_term_trains_and_logs_its_losses(data, tmp_path):
    """An STGAN section in the config: the discriminator takes the random
    crop's shape (32x32 of a 48x40 clip: a 2x2x64 ladder output per
    stream), trains beside the model, and every logged iteration carries
    g_loss and d_loss; a resume starts the discriminator afresh (it is not
    checkpointed)."""
    import re

    from ebfi_tpu_torch.losses.discriminator import build_discriminator, init_discriminator

    write_clip_npz(str(tmp_path / "clip48x40.npz"), num_frames=25, H=48, W=40, seed=3)
    (tmp_path / "train.txt").write_text(str(tmp_path / "clip48x40.npz") + "\n")
    cfg = _full_cfg(data, tmp_path / "out", iterations=2, **{
        "trainer;loss": {"adversarial": {"enabled": True, "gan_type": "STGAN", "weight": 0.01}},
        "train_dataloader;path_to_datalist_txt": str(tmp_path / "train.txt"),
        "train_dataloader;dataset;data_augment;enabled": True,
        "train_dataloader;dataset;data_augment;random_crop;enabled": True,
        "train_dataloader;dataset;data_augment;random_crop;size": [32, 32],
        "trainer;do_validation": False,
    })
    path = _write(tmp_path / "cfg.yml", cfg)
    trainer = train_main(["-c", path, "-id", "adv", "--device", "cpu"])
    assert trainer.state.step == 2
    disc = trainer.state.adv_state.disc
    assert disc.classifier.dense0.in_features == 2 * 2 * 2 * 64
    init = init_discriminator(build_discriminator("STGAN", (32, 32)),
                              torch.Generator().manual_seed(cfg["seed"] + 1)).state_dict()
    assert all(not torch.equal(v, init[k]) for k, v in disc.state_dict().items()
               if not k.endswith(("scale", "bias")))
    log = (tmp_path / "out" / "logs" / "EVFIAutoEx" / "adv" / "info.txt").read_text()
    lines = re.findall(r"Iteration: (\d+)/2 train_loss: \S+ g_loss: (\S+) d_loss: (\S+)", log)
    assert [it for it, _, _ in lines] == ["1", "2"]
    assert all(np.isfinite(float(g)) and np.isfinite(float(d)) for _, g, d in lines)
    assert "Adversarial loss enabled: STGAN on 32x32" in log
    ckpt = str(tmp_path / "out" / "models" / "EVFIAutoEx" / "adv" / "checkpoint-iteration2.pt")
    assert "adv_state" not in str(restore_checkpoint(ckpt).keys())
    cfg["trainer"]["iteration_based_train"]["iterations"] = 3
    resumed = train_main(["-c", _write(tmp_path / "cfg3.yml", cfg), "-id", "adv_r",
                          "--device", "cpu", "-r", ckpt])
    assert resumed.state.step == 3
    assert "starts afresh" in (tmp_path / "out" / "logs" / "EVFIAutoEx" / "adv_r"
                               / "info.txt").read_text()


def test_epoch_based_training(data, tmp_path):
    cfg = _full_cfg(data, tmp_path / "out", **{
        "trainer;iteration_based_train;enabled": False,
        "trainer;epoch_based_train;enabled": True,
        "trainer;epoch_based_train;epochs": 2,
        "trainer;epoch_based_train;train_log_step": 1,
    })
    trainer = train_main(["-c", _write(tmp_path / "cfg.yml", cfg), "-id", "ep", "--device", "cpu"])
    # per epoch: one batch of 2 of the clip's 3 sequences (drop_last), 8 timestamps each
    save_dir = tmp_path / "out" / "models" / "EVFIAutoEx" / "ep"
    assert sorted(os.listdir(save_dir)) == ["checkpoint-epoch1.pt", "checkpoint-epoch2.pt"]
    assert restore_checkpoint(str(save_dir / "checkpoint-epoch2.pt"))["step"] == trainer.state.step
    assert trainer.state.step == 2 * len(trainer.train_loader) * 8


def test_resume_name_guards(data, tmp_path):
    cfg = _full_cfg(data, tmp_path / "out", iterations=2)
    path = _write(tmp_path / "cfg.yml", cfg)
    train_main(["-c", path, "-id", "a", "--device", "cpu"])
    ckpt = str(tmp_path / "out" / "models" / "EVFIAutoEx" / "a" / "checkpoint-iteration2.pt")
    sgd = _write(tmp_path / "sgd.yml", {**cfg, "optimizer": {"name": "SGD", "args": {"lr": 1e-3}}})
    with pytest.raises(ValueError, match="optimizer"):
        train_main(["-c", sgd, "-id", "b", "--device", "cpu", "-r", ckpt])
    # --reset skips the optimizer guard, not the model's
    train_main(["-c", sgd, "-id", "c", "--device", "cpu", "-r", ckpt, "--reset"])
    ex = _write(tmp_path / "ex.yml", _exposure_cfg(data, tmp_path / "out"))
    with pytest.raises(ValueError, match="model"):
        train_main(["-c", ex, "-id", "d", "--device", "cpu", "-r", ckpt, "--reset"])


def test_exposure_pretrain_and_two_stage_handoff(data, tmp_path):
    ex_cfg = _write(tmp_path / "ex.yml", _exposure_cfg(data, tmp_path / "out"))
    stage1 = train_main(["-c", ex_cfg, "-id", "stage1", "--device", "cpu"])
    assert stage1.state.step == 2
    ckpt = str(tmp_path / "out" / "models" / "TrainExposureDecision" / "stage1"
               / "checkpoint-iteration2.pt")
    ex_states = restore_checkpoint(ckpt)["model_states"]

    cfg = _full_cfg(data, tmp_path / "out2", iterations=3, **{
        "model;args;UseGTEx": False, "model;args;LoadPretrainEX": True,
        "model;args;PretrainedEXPath": ckpt, "model;args;FrozenEX": True,
        "trainer;iteration_based_train;save_period": 100,
        "trainer;iteration_based_train;valid_step": 100,
    })
    from ebfi_tpu_torch.models import build_model, init_weights

    init = init_weights(build_model(cfg["model"]), cfg["seed"], scheme="train").state_dict()
    stage2 = train_main(["-c", _write(tmp_path / "s2.yml", cfg), "-id", "s2", "--device", "cpu"])
    assert stage2.state.step == 3
    got = stage2.state.model.state_dict()
    for k, v in ex_states.items():  # bit for bit after 3 FrozenEX steps
        torch.testing.assert_close(got[f"exposure_decision.{k}"], v, rtol=0, atol=0)
    changed = [k for k in got if not k.startswith("exposure_decision.")
               and not torch.equal(got[k], init[k])]
    assert changed, "no parameter outside the exposure subtree was updated"


def test_infer_cli_serves_a_training_checkpoint(data, tmp_path):
    from ebfi_tpu_torch.infer.cli import load_model, main as infer_main

    cfg = _write(tmp_path / "cfg.yml", _full_cfg(data, tmp_path / "out", iterations=2))
    trainer = train_main(["-c", cfg, "-id", "run", "--device", "cpu"])
    ckpt = str(tmp_path / "out" / "models" / "EVFIAutoEx" / "run" / "checkpoint-iteration2.pt")
    model, engine = load_model(ckpt, device="cpu")
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v)
    out = infer_main(["--model_path", ckpt, "--data_list", str(data / "train.txt"),
                      "--output_path", str(tmp_path / "infer"), "--device", "cpu",
                      "--scale", "1", "--ori_scale", "ori", "--time_bins", "4",
                      "--num_frame_per_period", "8", "--num_frame_per_blurry", "5",
                      "--num_period_per_seq", "1", "--sliding_window_seq", "1",
                      "--exposure_method", "Fixed"])
    assert np.isfinite(out["means"]["psnr"])


@pytest.mark.parametrize("name", ["train_evfi.yml", "train_exposure.yml"])
def test_yaml_reader_equals_safe_load_on_the_configs(name):
    text = open(os.path.join(ROOT, "configs", name)).read()
    want = yaml.safe_load(text)
    assert safe_load(text) == want
    # the snapshot writer's output reads back the same, in both readers
    assert safe_load(dump_yaml(want)) == want == yaml.safe_load(dump_yaml(want))


SNIPPETS = [
    "a: 2e5\nb: !!float 2e5\nc: 1.0e+5\nd: 1_000\ne: 010\nf: 0x1F\ng: .inf\nh: -.Inf",
    "a: [1, 'x', \"y\\tz\", [2, 3], {b: 4}, []]\nc: {}",
    "a:\n- 1\n- two\nb:\n  - [3]\n  - null",
    "x: &X [9, 10]\ny: *X\nz: &Z hello\nw: *Z",
    "on: yes\nOff: NO\n'quoted key': ~\n\"dq\": 'it''s'",
    "# comment\na: b # trailing\nc: '#not a comment'\n\nd:\n  e: f",
    "a: !!str 12\nb: !!int '7'\nc: True\nd: FALSE",
]


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_yaml_reader_equals_safe_load_on_the_subset(i):
    assert safe_load(SNIPPETS[i]) == yaml.safe_load(SNIPPETS[i])


@pytest.mark.parametrize("text", ["a: |\n  block", "a: 2001-12-14", "a:\n  - b: 1",
                                  "<<: {a: 1}", "a: !!binary aGk=", "a: [1,\n  2]", "---\na: 1"])
def test_yaml_reader_raises_outside_the_subset(text):
    with pytest.raises(YamlLiteError):
        safe_load(text)
