"""The port's host fetch plane against the JAX package's, on the CPU.

The same synthetic clip is written as schema H5 (``ebfi_tpu.data.synth``)
and repacked by ``tools/h5_to_npz.py``; ``NpzClipDataset.get(i, seed)`` must
equal ``H5ClipDataset.get(i, seed)`` key by key, dtype and value, exactly
(tolerance 0: the fetch plane is the same numpy arithmetic in the same
order).  The event encoder is held to ``events_to_stack_np`` bit for bit.
"""
import copy
import os
import random
import sys

import numpy as np
import pytest

from ebfi_tpu.data import encodings as jenc
from ebfi_tpu.data.h5dataset import H5ClipDataset, H5ClipDatasetReal
from ebfi_tpu.data.synth import write_clip_h5
from ebfi_tpu.infer.cli import default_dataloader_config
from ebfi_tpu_torch.data import encodings as tenc
from ebfi_tpu_torch.data.clip_dataset import NpzClipDataset, NpzClipDatasetReal, open_clip
from ebfi_tpu_torch.data.dataloader import EBFIDataLoader
from ebfi_tpu_torch.data.synth import write_clip_npz

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from h5_to_npz import h5_to_npz  # noqa: E402
import torch_threads  # noqa: F401  (one intra-op thread per test process)

CLIP = dict(num_frames=32, H=32, W=32, seed=9, real_exposure=(0.5, 0.05), down_scales=(2,))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    h5 = str(d / "clip.h5")
    write_clip_h5(h5, **CLIP)
    return h5, h5_to_npz(h5, str(d / "npz"))


def assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ encoder


def _stream(rng, n, H, W):
    xs = rng.integers(-3, W + 3, n).astype(np.int16)  # some out of bounds
    ys = rng.integers(-3, H + 3, n).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.02, n))
    ps = rng.choice(np.array([-1, 1], np.int8), n)
    return xs, ys, ts, ps


def _on_edges(rng, B, H, W):
    """Events placed exactly on the f64 bin edges the encoder computes."""
    xs, ys, ts, ps = _stream(rng, 200, H, W)
    ts = jenc.normalize_event_ts(ts)
    delta = np.float64((np.float64(ts[-1] - ts[0]) + np.float64(1e-6)) / np.float64(B))
    edges = [np.float64(ts[0] + delta * np.float64(bi)) for bi in range(1, B)]
    edges += [np.float64(e + delta) for e in edges[:1]]  # a bin's tend, recomputed
    ts = np.sort(np.concatenate([ts, edges, edges]))
    n = len(ts)
    return (rng.integers(0, W, n), rng.integers(0, H, n), ts,
            rng.choice(np.array([-1.0, 1.0, 0.5, -2.0]), n))


@pytest.mark.parametrize("case", ["random", "shared_edges", "three_events", "zero_ts"])
def test_events_to_stack_is_bit_identical(rng, case):
    B, H, W = 5, 12, 17
    if case == "random":
        xs, ys, ts, ps = _stream(rng, 3000, H, W)
        ts = jenc.normalize_event_ts(ts)
    elif case == "shared_edges":
        xs, ys, ts, ps = _on_edges(rng, B, H, W)
    elif case == "three_events":
        xs, ys, ts, ps = _stream(rng, 3, H, W)
    else:
        xs, ys, _, ps = _stream(rng, 50, H, W)
        ts = np.zeros(50)
    want = jenc.events_to_stack_np(xs, ys, ts, ps.astype(np.float64), B, (H, W))
    got = tenc.events_to_stack(xs, ys, ts, ps.astype(np.float64), B, (H, W))
    assert got.dtype == want.dtype == np.float32 and got.shape == (2, B, H, W)
    np.testing.assert_array_equal(got, want)
    if case == "shared_edges":
        assert want.sum() > 0
    np.testing.assert_array_equal(tenc.normalize_event_ts(ts), jenc.normalize_event_ts(ts))


# ------------------------------------------------------------------ datasets


def _config(**over):
    cfg = copy.deepcopy(default_dataloader_config()["dataset"])
    cfg.update(scale=1, ori_scale="ori", time_bins=4, NumFramePerPeriod=8, NumFramePerBlurry=5,
               NumPeriodPerSeq=1, SlidingWindowSeq=1, NumPeriodPerLoad=1, SlidingWindowLoad=1)
    cfg["data_augment"]["noise"]["enabled"] = False
    cfg["data_augment"]["hot_pixel"]["enabled"] = False
    aug = over.pop("augment", {})
    cfg.update(over)
    for k, v in aug.items():
        cfg["data_augment"][k].update(v)
    return cfg


CONFIGS = {
    "fixed": _config(),
    "custom": _config(ExposureMethod="Custom", ExposureTime=[3, 8, 1]),
    "load2": _config(NumPeriodPerLoad=2, NumPeriodPerSeq=2, time_bins=3),
    "deblur_pretrain": _config(DeblurPretrain=True),
    "noise_numpy": _config(augment={"noise": {"enabled": True}, "hot_pixel": {"enabled": True}}),
    "noise_torch": _config(augment={"noise": {"enabled": True, "rng": "torch"},
                                    "hot_pixel": {"enabled": True}}),
    "center_crop": _config(augment={"center_crop": {"enabled": True, "size": [16, 24]}}),
    "scale2_down2": _config(scale=2, ori_scale="down2"),  # scripts/infer.sh: no rescale
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_npz_dataset_equals_h5_dataset(clip, name):
    h5, npz = clip
    cfg = CONFIGS[name]
    want_ds, got_ds = H5ClipDataset(h5, cfg), NpzClipDataset(npz, cfg)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        assert_items_equal(got_ds.get(i, seed=1000 + i), want_ds.get(i, seed=1000 + i))


def test_auto_exposure_windows_and_values(clip):
    """Auto draws its windows from an unseeded generator when the dataset
    is built: compare their structure, then the items given the same
    windows."""
    h5, npz = clip
    cfg = _config(ExposureMethod="Auto")
    want_ds, got_ds = H5ClipDataset(h5, cfg), NpzClipDataset(npz, cfg)
    assert got_ds.periods == want_ds.periods and got_ds.latent_idx == want_ds.latent_idx
    assert [b[0] for b in got_ds.blurry_idx] == [b[0] for b in want_ds.blurry_idx]
    assert all(1 <= len(b) < 8 for b in got_ds.blurry_idx)
    assert got_ds.duty == [len(b) / 8 for b in got_ds.blurry_idx]
    got_ds.blurry_idx, got_ds.duty = want_ds.blurry_idx, want_ds.duty
    for i in range(len(want_ds)):
        assert_items_equal(got_ds.get(i, seed=7), want_ds.get(i, seed=7))


@pytest.mark.parametrize("noise", ["off", "numpy"])
def test_real_blur_dataset_equals_h5(clip, noise):
    h5, npz = clip
    cfg = _config(interp_num=6, augment={"noise": {"enabled": noise != "off"}})
    want_ds, got_ds = H5ClipDatasetReal(h5, cfg), NpzClipDatasetReal(npz, cfg)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        assert_items_equal(got_ds.get(i, seed=3 + i), want_ds.get(i, seed=3 + i))


def test_rescaling_config_raises_naming_the_resolutions(clip):
    """A config whose GT resolution (16, 16) is not the stored one (32, 32)
    resizes the frames as the JAX dataset does with cv2 (it raised before
    the numpy bicubic was ported): the items are equal."""
    h5, npz = clip
    cfg = _config(scale=1, ori_scale="down2")
    got, want = NpzClipDataset(npz, cfg).get(0, seed=0), H5ClipDataset(h5, cfg).get(0, seed=0)
    assert got["latent"].shape[-3:] == (16, 16, 3)
    assert_items_equal(got, want)


@pytest.mark.parametrize("need", ["absent", False, True])
def test_need_neighbor_gt_raises_until_ported(clip, need):
    """NeedNeighborGT: True yields the 'neighbor' item as the JAX dataset
    does (it raised before it was ported); False or absent yields none.
    The items equal the JAX dataset's either way, and a 'fast' key in the
    dataset config changes nothing (the loader reads it)."""
    h5, npz = clip
    cfg = _config(fast=True)
    if need != "absent":
        cfg["NeedNeighborGT"] = need
    got_ds, want_ds = NpzClipDataset(npz, cfg), H5ClipDataset(h5, cfg)
    assert len(got_ds) == len(want_ds) > 0
    got = got_ds.get(0, seed=5)
    assert ("neighbor" in got) == (need is True)
    assert_items_equal(got, want_ds.get(0, seed=5))


def test_write_clip_npz_equals_repacked_h5(clip, tmp_path):
    _, npz = clip
    direct = str(tmp_path / "direct.npz")
    n_events = write_clip_npz(direct, **CLIP)
    got, want = open_clip(direct), open_clip(npz)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert n_events == len(want["ori_xs"]) > 0
    assert str(want["format"]) == "ebfi_clip_npz/1"


def test_loader_worker_processes_equal_threads(clip, tmp_path):
    """Spawned worker processes give the same batches as the in-process
    threads: seeds are drawn in the calling thread, in item order."""
    _, npz = clip
    datalist = tmp_path / "list.txt"
    datalist.write_text(f"{npz}\n{npz}\n")
    cfg = _config(augment={"noise": {"enabled": True}, "hot_pixel": {"enabled": True}})
    out = {}
    for workers in (0, 2):
        random.seed(123)
        out[workers] = list(EBFIDataLoader(str(datalist), cfg, num_workers=workers))
    assert len(out[0]) == len(out[2]) == 6
    for a, b in zip(out[0], out[2]):
        assert_items_equal(b, a)


@pytest.mark.parametrize("name", ["noise_torch", "flips_and_crop"])
def test_augmentation_is_thread_safe_and_seeded_like_the_reference(clip, name):
    """Flips, crops and torch noise draw from generators of their own:
    items fetched concurrently equal items fetched one by one, which equal
    the JAX dataset's."""
    import concurrent.futures as cf

    h5, npz = clip
    cfg = CONFIGS["noise_torch"] if name == "noise_torch" else _config(augment={
        "flip": {"enabled": True}, "random_crop": {"enabled": True, "size": [20, 24]}})
    want_ds, got_ds = H5ClipDataset(h5, cfg), NpzClipDataset(npz, cfg)
    seeds = list(range(40, 52))
    index = [s % len(got_ds) for s in seeds]
    want = [want_ds.get(i, seed=s) for i, s in zip(index, seeds)]
    with cf.ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda a: got_ds.get(*a), zip(index, seeds)))
    for g, w in zip(got, want):
        assert_items_equal(g, w)
