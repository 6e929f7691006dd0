"""Schema H5 clips through the port's fetch plane, on the CPU.

The same synthetic recording is written as H5 four ways: by the JAX
package's ``write_clip_h5`` (contiguous) and ``H5Packager`` (gzip), and by
the port's ``write_clip_h5`` and ``H5Packager`` (its own HDF5 writer).  On
each, the port's ``H5ClipDataset``, ``H5ClipDatasetFast`` and
``H5ClipDatasetReal`` (its own HDF5 reader) must give items equal to the
JAX package's on the same file and seed, key by key, dtype and value
(tolerance 0), including a config whose GT resolution is half the stored
one (the resize route).  Then the loader on a datalist mixing H5 and npz
clips with spawned workers, and the infer CLI on an H5 clip against the
same clip as npz: the same PNGs, byte for byte, and the same metrics.
"""
import copy
import os
import random
import sys

import numpy as np
import pytest
import yaml

from ebfi_tpu.data import packager as jpackager
from ebfi_tpu.data import synth as jsynth
from ebfi_tpu.data.h5dataset import H5ClipDataset as JH5ClipDataset
from ebfi_tpu.data.h5dataset import H5ClipDatasetReal as JH5ClipDatasetReal
from ebfi_tpu.data.h5dataset_fast import H5ClipDatasetFast as JH5ClipDatasetFast
from ebfi_tpu.infer.cli import default_dataloader_config
from ebfi_tpu_torch.data import clip_dataset, datalist, hdf5, packager, synth
from ebfi_tpu_torch.data.clip_dataset import (H5ClipDataset, H5ClipDatasetFast,
                                              H5ClipDatasetReal, open_clip, open_h5_clip)
from ebfi_tpu_torch.data.dataloader import EBFIDataLoader

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from h5_to_npz import h5_to_npz  # noqa: E402
import torch_threads  # noqa: F401  (one intra-op thread per test process)

N_FRAMES, HW, FPS, SEED = 24, (32, 32), 240.0, 11
CLIP = dict(num_frames=N_FRAMES, H=HW[0], W=HW[1], fps=FPS, seed=SEED,
            real_exposure=(0.5, 0.05), down_scales=(2,))
FILES = ["jax_write_clip_h5", "jax_packager_gzip", "port_write_clip_h5", "port_packager_gzip"]


def _recording():
    """Frames (BGR), timestamps, events and exposures the packagers take."""
    frames = jsynth.render_frames(N_FRAMES, *HW, seed=SEED + 1)
    ts = np.arange(N_FRAMES, dtype=np.float64) / FPS
    events, _ = jsynth.simulate_events(frames, ts, seed=SEED + 1)
    duty = 0.3 + 0.4 * np.random.default_rng(SEED).random(N_FRAMES)
    exposures = [(t, t + d / FPS) for t, d in zip(ts, duty)]
    return frames[..., ::-1], ts, events, exposures


def _package(pk, frames, ts, events, exposures):
    """``package_sequence`` of the JAX package, through either packager."""
    pk.set_metadata(HW)
    for frame, t, e in zip(frames, ts, exposures):
        pk.package_image(frame, t, e)
    xs, ys, ets, ps = events
    pk.package_events(xs, ys, ets, ps, ("ori", "down2"))
    pk.h5.attrs["num_events"] = len(xs)
    pk.add_event_indices(("ori", "down2"))
    pk.close()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5clips")
    paths = {name: str(d / f"{name}.h5") for name in FILES}
    jsynth.write_clip_h5(paths["jax_write_clip_h5"], **CLIP)
    synth.write_clip_h5(paths["port_write_clip_h5"], **CLIP)
    rec = _recording()
    _package(jpackager.H5Packager(paths["jax_packager_gzip"]), *rec)
    _package(packager.H5Packager(paths["port_packager_gzip"]), *rec)
    return paths


def _config(**over):
    cfg = copy.deepcopy(default_dataloader_config()["dataset"])
    cfg.update(scale=1, ori_scale="ori", time_bins=4, NumFramePerPeriod=8, NumFramePerBlurry=5,
               NumPeriodPerSeq=1, SlidingWindowSeq=1, NumPeriodPerLoad=1, SlidingWindowLoad=1,
               interp_num=6)
    cfg["data_augment"]["noise"]["enabled"] = False
    cfg["data_augment"]["hot_pixel"]["enabled"] = False
    for k, v in over.pop("augment", {}).items():
        cfg["data_augment"][k].update(v)
    cfg.update(over)
    return cfg


CONFIGS = {
    "fixed": _config(),
    "rescaled": _config(ori_scale="down2"),  # GT at half the stored resolution: resized
    "load2_noise": _config(NumPeriodPerLoad=2, NumPeriodPerSeq=2, time_bins=3,
                           augment={"noise": {"enabled": True}}),
    "custom_flip_crop": _config(ExposureMethod="Custom", ExposureTime=[3, 8, 1], augment={
        "flip": {"enabled": True}, "random_crop": {"enabled": True, "size": [20, 24]}}),
}


def assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("file", FILES)
def test_h5_dataset_equals_jax(clips, file, config):
    cfg = CONFIGS[config]
    got_ds, want_ds = H5ClipDataset(clips[file], cfg), JH5ClipDataset(clips[file], cfg)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        assert_items_equal(got_ds.get(i, seed=100 + i), want_ds.get(i, seed=100 + i))


@pytest.mark.parametrize("file", FILES)
def test_h5_fast_dataset_equals_jax(clips, file):
    """Preloaded unaugmented, augmented at each fetch with its seed."""
    cfg = CONFIGS["custom_flip_crop"]
    got_ds, want_ds = H5ClipDatasetFast(clips[file], cfg), JH5ClipDatasetFast(clips[file], cfg)
    assert len(got_ds) == len(want_ds) > 0
    for seed in (0, 1, 7):
        for i in range(len(want_ds)):
            assert_items_equal(got_ds.get(i, seed=seed + i), want_ds.get(i, seed=seed + i))


@pytest.mark.parametrize("config", ["fixed", "rescaled", "load2_noise"])
@pytest.mark.parametrize("file", FILES)
def test_h5_real_dataset_equals_jax(clips, file, config):
    """The real-blur reader: frames as stored, duty from the images'
    exposure_begin_t / exposure_end_t attributes."""
    cfg = CONFIGS[config]
    got_ds, want_ds = H5ClipDatasetReal(clips[file], cfg), JH5ClipDatasetReal(clips[file], cfg)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        assert_items_equal(got_ds.get(i, seed=3 + i), want_ds.get(i, seed=3 + i))


@pytest.mark.parametrize("file", FILES)
def test_h5_clip_views_equal_the_repacked_container(clips, file, tmp_path):
    """open_h5_clip's lazy views hold what tools/h5_to_npz.py repacks."""
    got, want = open_h5_clip(clips[file]), open_clip(h5_to_npz(clips[file], str(tmp_path)))
    assert sorted(got) == sorted(k for k in want if k != "format")
    for k in got:
        view = got[k]
        if isinstance(view, (np.ndarray, hdf5.Dataset)):
            arr = np.asarray(view[()])
        else:  # frames and attribute columns: item by item
            arr = np.asarray([view[i] for i in range(len(view))])
        assert arr.dtype == want[k].dtype, k
        np.testing.assert_array_equal(arr, want[k], err_msg=k)


def test_blur_synthesis_takes_only_the_window(clips, tmp_path, monkeypatch):
    """On an H5 clip the native blur gets the window's frames, stacked,
    with local indices (never the whole clip); on an npz clip the memory
    map and the clip's indices, as before."""
    seen = []
    real = clip_dataset.native.blurry_mean
    monkeypatch.setattr(clip_dataset.native, "blurry_mean",
                        lambda images, idx: seen.append((len(images), list(idx)))
                        or real(images, idx))
    h5 = clips["port_packager_gzip"]
    npz = h5_to_npz(h5, str(tmp_path))
    items = {}
    for path in (h5, npz):
        seen.clear()
        items[path] = H5ClipDataset(path, CONFIGS["fixed"]).get(1, seed=0)
        assert len(seen) == 1
        frames, idx = seen[0]
        if path == h5:
            assert frames == 5 and idx == [0, 1, 2, 3, 4]
        else:
            assert frames == N_FRAMES and idx == [8, 9, 10, 11, 12]
    assert_items_equal(items[h5], items[npz])


@pytest.mark.parametrize("fast", [False, True])
def test_loader_mixes_h5_and_npz_clips_with_spawned_workers(clips, tmp_path, fast):
    h5 = clips["port_packager_gzip"]
    npz = h5_to_npz(clips["jax_write_clip_h5"], str(tmp_path))
    lst = tmp_path / "list.txt"
    lst.write_text(f"{h5}\n{npz}\n{clips['jax_packager_gzip']}\n")
    cfg = _config(augment={"noise": {"enabled": True}, "flip": {"enabled": True}})
    out = {}
    for workers in (0, 2):
        random.seed(5)
        out[workers] = list(EBFIDataLoader(str(lst), cfg, batch_size=2, num_workers=workers,
                                           fast=fast))
    assert len(out[0]) == len(out[2]) == 3
    for a, b in zip(out[0], out[2]):
        assert_items_equal(b, a)
    random.seed(5)
    seeds = [random.randint(0, 2**32) for _ in range(6)]
    want = [JH5ClipDataset(p, cfg).get(i, seed=seeds[2 * k + i])
            for k, p in enumerate([h5, clips["jax_write_clip_h5"], clips["jax_packager_gzip"]])
            for i in range(2)]
    got = [{k: v[j] for k, v in batch.items()} for batch in out[0] for j in range(2)]
    for g, w in zip(got, want):
        assert_items_equal(g, w)
    (single,) = list(EBFIDataLoader(h5, cfg, batch_size=2))  # one H5 path, no datalist
    assert single["blurry"].shape[0] == 2


def test_datalist_lists_h5_clips(tmp_path):
    for name in ("a.h5", "b.hdf5", "c.npz", "c.h5", "notes.txt"):
        (tmp_path / name).touch()
    train, valid = datalist.build_datalist(str(tmp_path), 0)
    assert [os.path.basename(p) for p in train] == ["a.h5", "b.hdf5", "c.npz"] and valid == []


# ------------------------------------------------------------------ the infer CLI

MODEL_CFG = {"name": "EVFIAutoEx", "args": {"FrameBasech": 8, "EventBasech": 8, "InterCH": 8,
                                            "TB": 4, "step": 1, "channels": [4, 4, 4, 4]}}
FLAGS = ["--scale", "1", "--ori_scale", "ori", "--time_bins", "4",
         "--num_frame_per_period", "8", "--num_frame_per_blurry", "5",
         "--num_period_per_seq", "1", "--sliding_window_seq", "1",
         "--num_period_per_load", "1", "--sliding_window_load", "1",
         "--exposure_method", "Fixed", "--noise_enabled", "--device", "cpu"]
REAL_FLAGS = ["--scale", "1", "--ori_scale", "ori", "--time_bins", "4", "--interp_num", "6",
              "--num_period_per_seq", "1", "--sliding_window_seq", "1",
              "--num_period_per_load", "1", "--sliding_window_load", "1", "--real_blur",
              "--device", "cpu"]


def _outputs(root, clip):
    """{relative path: bytes} of the PNGs, the clip directory's name dropped,
    and the result files' metric sections, the clip's name replaced."""
    pngs = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root).split(os.sep)
            if f.endswith(".png"):
                pngs["/".join(rel[1:])] = open(os.path.join(dirpath, f), "rb").read()
    results = {}
    for name in ("inference_all.yml", "inference_all_step.yml"):
        text = open(os.path.join(root, name)).read()
        doc = yaml.safe_load(text.replace(os.path.basename(clip), "<clip>"))
        results[name] = {k: v for k, v in doc.items() if k != "info"}
    return pngs, results


@pytest.mark.parametrize("case", ["synthetic", "real_blur"])
def test_infer_cli_on_h5_equals_npz(clips, tmp_path, case):
    from ebfi_tpu_torch.infer.cli import main
    from ebfi_tpu_torch.models import build_model, init_weights
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, init_weights(build_model(MODEL_CFG), 0), {"model": MODEL_CFG})
    h5 = clips["port_packager_gzip"]
    sources = {"h5": h5, "npz": h5_to_npz(h5, str(tmp_path / "npz"))}
    outs = {}
    for kind, clip in sources.items():
        lst = tmp_path / f"{kind}.txt"
        lst.write_text(clip + "\n")
        out = str(tmp_path / f"out_{kind}")
        main(["--model_path", ckpt, "--data_list", str(lst), "--output_path", out]
             + (REAL_FLAGS if case == "real_blur" else FLAGS))
        outs[kind] = _outputs(out, clip)
    (pngs, results), (want_pngs, want_results) = outs["h5"], outs["npz"]
    assert sorted(pngs) == sorted(want_pngs)
    assert any("/restored_frame/" in p for p in pngs)
    assert (case == "real_blur") == (not any("/gt_frame/" in p for p in pngs))
    for p in want_pngs:
        assert pngs[p] == want_pngs[p], p
    assert results == want_results
