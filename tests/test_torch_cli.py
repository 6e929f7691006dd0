"""The port's inference CLI against the JAX package's, the slice as a
whole, on the CPU.

Fixtures are test_infer_cli.py's: its model config (FrameBasech 8), an
Orbax checkpoint of it, and a 32x32 synthetic H5 clip.  The checkpoint goes
through ``tools/jax_ckpt_to_torch.py`` and the clip through
``tools/h5_to_npz.py``; ``python -m ebfi_tpu.infer`` runs on the H5 and
``ebfi_tpu_torch.infer.cli.main(..., "--device", "cpu")`` on the ``.npz``
with the same flags.  Tolerances:

- blurry, GT and event PNGs: identical pixels (the same numpy arithmetic);
- restored PNGs, f32: within 1 uint8 level (float reassociation between
  XLA and PyTorch moves a value across a rounding boundary at most);
  bf16: at most 2 % of the pixels off by more than 1 level (bf16 rounds at
  other places in the two frameworks);
- metrics: the same keys; PSNR within 0.01 dB and SSIM within 1e-4 in f32,
  0.1 dB and 1e-3 in bf16.
"""
import functools
import os
import sys

import cv2
import numpy as np
import pytest
import yaml

from ebfi_tpu.data.synth import write_clip_h5
from ebfi_tpu.infer import cli as jax_cli
from ebfi_tpu.infer.cli import main as jax_main
from ebfi_tpu_torch.infer.cli import main as port_main
from ebfi_tpu_torch.utils.vis import read_png
from test_infer_cli import MODEL_CFG
from test_torch_checkpoint import orbax_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from h5_to_npz import h5_to_npz  # noqa: E402
from jax_ckpt_to_torch import convert  # noqa: E402
import torch_threads  # noqa: F401  (one intra-op thread per test process)

FLAGS = [
    "--scale", "1", "--ori_scale", "ori", "--time_bins", "4",
    "--num_frame_per_period", "8", "--num_frame_per_blurry", "5",
    "--num_period_per_seq", "1", "--sliding_window_seq", "1",
    "--num_period_per_load", "1", "--sliding_window_load", "1",
    "--exposure_method", "Fixed",
]
REAL_FLAGS = [
    "--scale", "1", "--ori_scale", "ori", "--time_bins", "4", "--interp_num", "6",
    "--num_period_per_seq", "1", "--sliding_window_seq", "1",
    "--num_period_per_load", "1", "--sliding_window_load", "1", "--real_blur",
]
CASES = {
    "f32": FLAGS,
    "bf16": FLAGS + ["--precision", "bf16"],
    "real_blur": REAL_FLAGS,
    "noise_torch": FLAGS + ["--noise_rng", "torch"],
}
TOL = {"f32": (0.01, 1e-4), "bf16": (0.1, 1e-3)}  # PSNR dB, SSIM


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ckpt, _ = orbax_checkpoint(d / "ckpt", MODEL_CFG)
    port_ckpt = str(d / "model.pt")
    convert(ckpt, port_ckpt)
    clips = {}
    for kind, extra in (("synthetic", {}), ("real", {"real_exposure": (0.5, 0.05)})):
        h5 = str(d / f"{kind}.h5")
        write_clip_h5(h5, num_frames=32, H=32, W=32, seed=9, **extra)
        clips[kind] = (h5, h5_to_npz(h5, str(d / "npz")))
    return ckpt, port_ckpt, clips


def _tree(root):
    """Files under root, relative, with the clip directory's name dropped."""
    out = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root).split(os.sep)
            out.add("/".join(["<clip>"] + rel[1:] if len(rel) > 1 else rel))
    return out


def _clip_dir(root):
    (name,) = [n for n in os.listdir(root) if os.path.isdir(os.path.join(root, n))]
    return os.path.join(root, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_matches_jax_cli(inputs, tmp_path, monkeypatch, case):
    ckpt, port_ckpt, clips = inputs
    # the JAX loader's item threads share torch's global generator, which
    # its torch-noise mode reseeds per item: one thread keeps it in order
    monkeypatch.setattr(jax_cli, "EBFIDataLoader",
                        functools.partial(jax_cli.EBFIDataLoader, num_threads=1))
    flags = CASES[case]
    h5, npz = clips["real" if case == "real_blur" else "synthetic"]
    outs = {}
    for side, model, clip, run, extra in (
        ("jax", ckpt, h5, jax_main, []),
        ("port", port_ckpt, npz, port_main, ["--device", "cpu"]),
    ):
        datalist = tmp_path / f"{side}.txt"
        datalist.write_text(clip + "\n")
        outs[side] = str(tmp_path / side)
        run(["--model_path", model, "--data_list", str(datalist),
             "--output_path", outs[side]] + flags + extra)

    files = _tree(outs["jax"])
    assert _tree(outs["port"]) == files
    restored = sorted(f for f in files if "/restored_frame/" in f)
    assert restored and (case == "real_blur") == (not any("/gt_frame/" in f for f in files))
    jdir, pdir = _clip_dir(outs["jax"]), _clip_dir(outs["port"])
    for f in sorted(f for f in files if f.endswith(".png")):
        rel = f.split("/", 1)[1]
        want = cv2.imread(os.path.join(jdir, rel), cv2.IMREAD_UNCHANGED)
        got_cv2 = cv2.imread(os.path.join(pdir, rel), cv2.IMREAD_UNCHANGED)
        got = read_png(os.path.join(pdir, rel))
        np.testing.assert_array_equal(got_cv2, got[..., ::-1])  # cv2 decodes to BGR
        if "/restored_frame/" not in f:
            np.testing.assert_array_equal(got_cv2, want, err_msg=f)
            continue
        diff = np.abs(got_cv2.astype(int) - want.astype(int))
        if case == "bf16":
            assert (diff > 1).mean() <= 0.02, f
        else:
            assert diff.max() <= 1, f

    dpsnr, dssim = TOL["bf16" if case == "bf16" else "f32"]
    for name in ("inference_all.yml", "inference_all_step.yml"):
        want = yaml.safe_load(open(os.path.join(outs["jax"], name)))
        got = yaml.safe_load(open(os.path.join(outs["port"], name)))
        assert list(got) == list(want)
        for section in want:
            if section == "info":
                continue
            assert set(got[section]) == set(want[section]), section
            for metric in want[section]:
                w, g = want[section][metric], got[section][metric]
                if isinstance(w, dict):  # per clip: one clip, named after its file
                    (w,), (g,) = w.values(), g.values()
                w, g = np.asarray(w, float), np.asarray(g, float)
                assert g.shape == w.shape, (section, metric)
                tol = {"psnr": dpsnr, "ssim": dssim}.get(metric, 1e-4)
                np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{section} {metric}")
    clip_yml = yaml.safe_load(open(os.path.join(pdir, "inference.yml")))
    assert list(clip_yml) == ["info", "eval_datasetloader_config", "evaluation results",
                              "evaluation step results"]
    want_cfg = yaml.safe_load(open(os.path.join(jdir, "inference.yml")))["eval_datasetloader_config"]
    assert clip_yml["eval_datasetloader_config"] == want_cfg


def test_lpips_flags_raise_naming_the_roadmap_item(inputs, tmp_path):
    """LPIPS is ported: the flags no longer raise NotImplementedError; the
    CLI reads the file they name, as the JAX CLI does (its column is held
    against the JAX CLI's in test_torch_lpips.py)."""
    _, port_ckpt, clips = inputs
    with pytest.raises(FileNotFoundError, match="x.pth"):
        port_main(["--model_path", port_ckpt, "--data_list", str(tmp_path / "none.txt"),
                   "--output_path", str(tmp_path / "out"), "--device", "cpu",
                   "--lpips_weights", "x.pth"])


# ------------------------------------------------------------------ writers


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 31)])
def test_png_writer_pixels_equal_the_jax_writer(rng, tmp_path, shape):
    """The port's zlib PNGs decode (cv2) to the pixels of the JAX writer's
    cv2 PNGs: tolerance 0."""
    from ebfi_tpu.utils.vis import save_frame as jax_save_frame
    from ebfi_tpu_torch.utils.vis import save_frame

    frame = rng.integers(0, 256, shape, dtype=np.uint8)
    save_frame(frame, str(tmp_path / "port.png"))
    jax_save_frame(frame, str(tmp_path / "jax.png"))
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), frame)


def test_yaml_writer_loads_like_the_jax_logger(tmp_path):
    """yaml.safe_load reads the port's YAML files as the same structure as
    the JAX logger's (PyYAML) files, small floats and NaN included."""
    from ebfi_tpu.utils.logger import YamlResultLogger as JaxLogger
    from ebfi_tpu_torch.utils.logger import YamlResultLogger

    data = {
        "cfg": {"size": [128, 128], "std": 1.0, "frac": 1e-05, "tiny": 3.5e-12, "big": 1e16,
                "none": None, "flag": True, "name": "Fixed", "list": ["a: b", "[c]"]},
        "result": {"psnr": float("nan"), "ssim": np.float32(0.25), "n": np.int64(3),
                   "inf": float("inf")},
        "steps": {"psnr": [1.5, 2e-05, -0.0]},
        "empty": {},
    }
    outs = {}
    for name, cls in (("jax", JaxLogger), ("port", YamlResultLogger)):
        with cls(str(tmp_path / f"{name}.yml")) as log:
            log.log_info("inference [model] \n on ['a.h5', \"b\"]")
            for k, v in data.items():
                log.log_dict(v, k)
        outs[name] = yaml.safe_load(open(tmp_path / f"{name}.yml"))
    got, want = outs["port"], outs["jax"]
    assert np.isnan(got["result"].pop("psnr")) and np.isnan(want["result"].pop("psnr"))
    assert got == want
    assert isinstance(got["cfg"]["frac"], float) and got["cfg"]["frac"] == 1e-05
