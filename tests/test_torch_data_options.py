"""The port's remaining dataset options against the JAX package's, on the
CPU: bicubic rescaling without cv2, the preloading ``fast`` dataset, the
``neighbor`` item with augmentation, and the datalist builder.

Items are compared as ``test_torch_data.py`` compares them: key by key,
dtype, shape and value, exactly.  ``resize_cubic`` is held to
``cv2.resize(..., INTER_CUBIC)`` bit for bit on fixed cases, and within
one level on at most 1e-4 of the values on random sizes.
"""
import os
import random

import cv2
import numpy as np
import pytest

from ebfi_tpu.data import datalist as jdatalist
from ebfi_tpu.data.h5dataset import H5ClipDataset, H5ClipDatasetReal
from ebfi_tpu.data.h5dataset_fast import H5ClipDatasetFast
from ebfi_tpu_torch.data import datalist as tdatalist
from ebfi_tpu_torch.data.clip_dataset import (NpzClipDataset, NpzClipDatasetFast,
                                              NpzClipDatasetReal)
from ebfi_tpu_torch.data.dataloader import EBFIDataLoader
from ebfi_tpu_torch.data.resize import resize_cubic
from test_torch_data import _config, assert_items_equal, clip  # noqa: F401 (fixture)
import torch_threads  # noqa: F401  (one intra-op thread per test process)

AUGMENT = {"random_crop": {"enabled": True, "size": [16, 24]},
           "flip": {"enabled": True, "horizontal_prob": 0.5, "vertical_prob": 0.5},
           "noise": {"enabled": True}}


@pytest.mark.parametrize("src, size", [
    ((37, 53, 3), (80, 64)),    # up, odd sizes
    ((37, 53, 3), (17, 20)),    # down
    ((45, 61), (23, 91)),       # one channel, down in W and up in H
    ((32, 32, 1), (64, 64)),    # one channel kept as an axis, x2
    ((180, 320, 3), (640, 360)),  # down2 -> ori of a 720p clip, scaled by 1/4
    ((7, 5, 3), (3, 11)),       # fewer pixels than taps
])
def test_resize_cubic_equals_cv2(rng, src, size):
    img = rng.integers(0, 256, src, dtype=np.uint8)
    img[:2] = 255  # saturation at the top, ringing below it
    got = resize_cubic(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC).reshape(got.shape)
    assert got.dtype == want.dtype and got.shape == (size[1], size[0]) + src[2:]
    np.testing.assert_array_equal(got, want)


def test_resize_cubic_on_random_sizes_is_within_one_level_of_cv2(rng):
    """Random sizes up and down, noise and ramps: a value whose exact
    result lies within float rounding of a half may round the other way
    than cv2's (its sums run in another order), so at most one level and
    at most 1e-4 of the values.  Sources have sides of at least 4 pixels,
    the taps' span: cv2 treats shorter ones otherwise (no frame is)."""
    off, total = 0, 0
    for i in range(24):
        h, w, W, H = (int(v) for v in rng.integers(4, 160, 4))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 3 == 0:
            img = (np.cumsum(img, axis=1) // 3).clip(0, 255).astype(np.uint8)
        got = resize_cubic(img, (W, H)).astype(int)
        diff = np.abs(got - cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC))
        assert diff.max() <= 1
        off, total = off + int((diff > 0).sum()), total + diff.size
    assert off <= 1e-4 * total, (off, total)


def test_rescaled_real_blur_items_equal_jax(clip):  # noqa: F811
    h5, npz = clip
    cfg = _config(scale=1, ori_scale="down2", NumPeriodPerSeq=2, SlidingWindowSeq=2)
    got_ds, want_ds = NpzClipDatasetReal(npz, cfg), H5ClipDatasetReal(h5, cfg)
    assert len(got_ds) == len(want_ds) > 0
    got = got_ds.get(0, seed=4)
    assert got["blurry"].shape[-3:] == (16, 16, 3)
    assert_items_equal(got, want_ds.get(0, seed=4))


@pytest.mark.parametrize("case", ["augmented", "rescaled_load2"])
def test_neighbor_items_equal_jax(clip, case):  # noqa: F811
    """The 'neighbor' item (L, NumP, NumF, 2, H, W, 3), cropped and flipped
    with the frames, or resized with them over a two-period load."""
    h5, npz = clip
    if case == "augmented":
        cfg = _config(NeedNeighborGT=True, augment=AUGMENT)
    else:
        cfg = _config(NeedNeighborGT=True, scale=1, ori_scale="down2", NumPeriodPerLoad=2,
                      NumPeriodPerSeq=2)
    got_ds, want_ds = NpzClipDataset(npz, cfg), H5ClipDataset(h5, cfg)
    for i in range(len(want_ds)):
        got = got_ds.get(i, seed=11 + i)
        L, P = got["blurry"].shape[:2]
        assert got["neighbor"].shape[:4] == (L, P, 8, 2)
        assert_items_equal(got, want_ds.get(i, seed=11 + i))


@pytest.mark.parametrize("case", ["augmented", "rescaled"])
def test_fast_items_equal_jax_and_the_unpreloaded_dataset(clip, case):  # noqa: F811
    h5, npz = clip
    over = {"augment": AUGMENT} if case == "augmented" else {"scale": 1, "ori_scale": "down2"}
    cfg = _config(NumPeriodPerSeq=1, **over)
    state = random.getstate()
    fast = NpzClipDatasetFast(npz, cfg)
    assert random.getstate() == state  # the preload draws no seed: fast changes speed only
    want_ds, plain = H5ClipDatasetFast(h5, cfg), NpzClipDataset(npz, cfg)
    assert len(fast) == len(want_ds) == len(plain) > 0
    for i in range(len(want_ds)):
        for seed in (3, 4):  # augmentation on each fetch, from its seed
            got = fast.get(i, seed=seed)
            assert_items_equal(got, want_ds.get(i, seed=seed))
            assert_items_equal(got, plain.get(i, seed=seed))


def test_fast_with_neighbor_gt_raises_as_jax_does(clip):  # noqa: F811
    h5, npz = clip
    cfg = _config(NeedNeighborGT=True)
    with pytest.raises(ValueError, match="NeighborGT"):
        H5ClipDatasetFast(h5, cfg)
    with pytest.raises(ValueError, match="NeedNeighborGT"):
        NpzClipDatasetFast(npz, cfg)


@pytest.mark.parametrize("real_data, num_workers, cls", [
    (False, 0, NpzClipDatasetFast), (False, 1, NpzClipDataset), (True, 0, NpzClipDatasetReal)])
def test_loader_preloads_where_the_jax_loader_does(clip, real_data, num_workers, cls):  # noqa: F811
    """``fast`` preloads in this process only where num_workers is 0 and
    the data is not real-blur (``dataloader.py:91-97`` of the JAX package),
    and the batches are the same as without it."""
    _, npz = clip
    cfg = _config()
    loader = EBFIDataLoader([npz], cfg, real_data=real_data, num_workers=num_workers, fast=True)
    assert all(type(ds) is cls for ds in loader.datasets)
    assert loader._worker_spec[-1] is True
    if num_workers == 0 and not real_data:
        plain = EBFIDataLoader([npz], cfg)
        for a, b in zip(loader, plain):
            assert_items_equal(a, b)


def test_train_cli_reads_fast_from_the_config(clip):  # noqa: F811
    from ebfi_tpu_torch.train.cli import _make_loader

    _, npz = clip
    cfg = {"path_to_datalist_txt": [npz], "dataset": _config(), "fast": True}
    loader = _make_loader(cfg, 0, 1, real_data=False, seed=0)
    assert type(loader.datasets[0]) is NpzClipDatasetFast


@pytest.mark.parametrize("mode, kw", [
    (0, {"num": 3}), (1, {"num": 3, "valid_num": 2}), (2, {"portion": 0.5}),
    (3, {"num": 2, "valid_num": 2})])
def test_build_datalist_draws_as_jax_does(tmp_path, mode, kw):
    """The same names from the same seed; the JAX builder lists ``.h5``
    clips, the port's ``.npz`` ones."""
    for d in ("train", "valid"):
        os.makedirs(tmp_path / d)
        for i in range(6):
            for ext in ("h5", "npz"):
                (tmp_path / d / f"clip{i}.{ext}").touch()
    valid = str(tmp_path / "valid") if mode == 3 else None
    stems = lambda paths: [os.path.splitext(p)[0] for p in paths]  # noqa: E731
    want = jdatalist.build_datalist(str(tmp_path / "train"), mode, valid_data_path=valid,
                                    seed=7, **kw)
    got = tdatalist.build_datalist(str(tmp_path / "train"), mode, valid_data_path=valid,
                                   seed=7, **kw)
    assert [stems(g) for g in got] == [stems(w) for w in want]
    assert all(p.endswith(".npz") for g in got for p in g)
    out = str(tmp_path / "lists" / "train.txt")
    tdatalist.write_txt(out, got[0])
    jdatalist.write_txt(out + ".jax", got[0])
    assert open(out).read() == open(out + ".jax").read()
    assert tdatalist.read_datalist(out) == got[0]
