"""The port's C++ host plane (``ebfi_tpu_torch.native``, built here with the
host's g++) against the numpy plane, on the CPU.  Every comparison is bit
for bit (tolerance 0):

- ``events_to_stack`` (the loader's item layout) against the port's
  numpy encoder and the JAX package's ``events_to_stack_np``, on seeded
  streams: unit polarities with out-of-range integer coordinates, events placed on
  the f64 bin edges, out-of-range and negative-fractional float
  coordinates, <= 3 events, all-zero timestamps, and non-unit weights
  piled onto a few pixels (where a sum in f32 comes out otherwise);
- ``blurry_mean`` and ``normalize_ts`` against numpy;
- items of ``NpzClipDataset`` and ``NpzClipDatasetReal`` against the same
  items with the dataset module's plane swapped for the numpy one;
- a source that does not compile fails the build with g++'s message.
"""
import threading
import types

import numpy as np
import pytest

from ebfi_tpu.data import encodings as jenc
from ebfi_tpu_torch import native
from ebfi_tpu_torch.data import clip_dataset
from ebfi_tpu_torch.data import encodings as tenc
from ebfi_tpu_torch.data.synth import write_clip_npz
from test_torch_data import _config, _on_edges, _stream, assert_items_equal
import torch_threads  # noqa: F401  (one intra-op thread per test process)

B, H, W = 5, 12, 17
NUMPY_PLANE = types.SimpleNamespace(events_to_stack=lambda *a: tenc.item_layout(
                                        tenc.events_to_stack(*a)),
                                    blurry_mean=tenc.blurry_mean,
                                    normalize_ts=tenc.normalize_event_ts)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _weights_on_few_pixels(rng):
    """20 000 uniform(-1, 1) weights onto 4 pixels."""
    n = 20_000
    return (rng.integers(0, 2, n), rng.integers(0, 2, n), np.sort(rng.uniform(0, 1, n)),
            rng.uniform(-1.0, 1.0, n))


def _stream_of(case, rng):
    if case == "random":
        xs, ys, ts, ps = _stream(rng, 3000, H, W)
        return xs, ys, tenc.normalize_event_ts(ts), ps
    if case == "shared_edges":
        return _on_edges(rng, B, H, W)
    if case == "fractional_out_of_range":
        n = 3000
        xs = rng.uniform(-2.5, W + 1.5, n)
        ys = rng.uniform(-2.5, H + 1.5, n)
        xs[:40] = rng.uniform(-0.999, 0.0, 40)  # truncate to 0: inside
        xs[40:80] = -1.0  # truncates to -1: dropped
        ys[80:120] = H - 1e-9  # inside; H itself is outside
        ys[120:160] = H
        return xs, ys, np.sort(rng.uniform(0, 1, n)), rng.choice([-1.0, 1.0], n)
    if case == "three_events":
        return _stream(rng, 3, H, W)
    if case == "zero_ts":
        xs, ys, _, ps = _stream(rng, 50, H, W)
        return xs, ys, np.zeros(50), ps
    if case == "nonunit_weights":
        return _weights_on_few_pixels(rng)
    raise ValueError(case)


CASES = ["random", "shared_edges", "fractional_out_of_range", "three_events", "zero_ts",
         "nonunit_weights"]


@pytest.mark.parametrize("case", CASES)
def test_events_to_stack_bit_for_bit(rng, case):
    xs, ys, ts, ps = _stream_of(case, rng)
    got = native.events_to_stack(xs, ys, ts, ps, B, (H, W))
    want = tenc.events_to_stack(xs, ys, ts, ps, B, (H, W))
    jax_want = jenc.events_to_stack_np(xs, ys, np.asarray(ts, np.float64),
                                       np.asarray(ps, np.float64), B, (H, W))
    assert got.dtype == np.float32 and got.shape == (H, W, 2 * B)
    np.testing.assert_array_equal(_bits(got), _bits(tenc.item_layout(want)))
    np.testing.assert_array_equal(_bits(got), _bits(tenc.item_layout(jax_want)))
    # bin-major, polarity-minor: channel 2 * b + q is polarity q of bin b
    np.testing.assert_array_equal(got.reshape(H, W, B, 2).transpose(3, 2, 0, 1), want)
    if case in ("three_events", "zero_ts"):
        assert not got.any()
    else:
        assert got.any()


def test_nonunit_weights_need_f64_sums(rng):
    """The stream of the non-unit case tells the two accumulators apart: the
    same weights summed in f32, as the JAX package's C++ twin sums them,
    differ from the f64 sum cast once, which the native plane equals."""
    xs, ys, ts, ps = _weights_on_few_pixels(rng)
    got = native.events_to_stack(xs, ys, ts, ps, 1, (H, W))
    f32 = np.zeros(H * W, np.float32)
    w = ps * np.where(ps < 0, 0.0, ps)
    for i in range(len(ts)):  # one bin holds every event
        f32[ys[i] * W + xs[i]] += np.float32(w[i])
    assert not np.array_equal(f32.reshape(H, W), got[..., 0])
    f64 = np.zeros(H * W)
    np.add.at(f64, ys * W + xs, w)
    np.testing.assert_array_equal(got[..., 0], f64.astype(np.float32).reshape(H, W))


def test_events_of_unequal_lengths_raise(rng):
    xs, ys, ts, ps = _stream(rng, 10, H, W)
    with pytest.raises(ValueError, match="unequal lengths"):
        native.events_to_stack(xs[:-1], ys, ts, ps, B, (H, W))


def test_blurry_mean_and_normalize_ts_bit_for_bit(rng, tmp_path):
    images = rng.integers(0, 256, (9, 14, 11, 3), dtype=np.uint8)
    np.save(tmp_path / "images.npy", images)
    mapped = np.load(tmp_path / "images.npy", mmap_mode="r")
    for idx in ([0], [2, 3, 4], [8, 1, 5, 5], list(range(9))):
        got = native.blurry_mean(mapped, idx)
        want = images[idx][..., ::-1].mean(0).astype(np.float32) / np.float32(255.0)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(tenc.blurry_mean(images, idx)))
    with pytest.raises(IndexError):
        native.blurry_mean(images, [9])
    ts = np.sort(rng.uniform(0, 1, 1000)) * 37.25 + 1.6e9
    for t in (ts, ts[:1], np.zeros(4)):
        np.testing.assert_array_equal(native.normalize_ts(t), tenc.normalize_event_ts(t))
        np.testing.assert_array_equal(native.normalize_ts(t), jenc.normalize_event_ts(t))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "clip.npz")
    write_clip_npz(path, num_frames=24, H=24, W=32, seed=3, real_exposure=(0.5, 0.05))
    return path


@pytest.mark.parametrize("kind", ["synthetic_blur", "real_blur"])
def test_dataset_items_equal_the_numpy_plane(clip, kind, monkeypatch):
    if kind == "synthetic_blur":
        cfg = _config(augment={"noise": {"enabled": True}})
        make = clip_dataset.NpzClipDataset
    else:
        cfg = _config(interp_num=6)
        make = clip_dataset.NpzClipDatasetReal
    got = make(clip, cfg).get(1, seed=11)
    monkeypatch.setattr(clip_dataset, "native", NUMPY_PLANE)
    want = make(clip, cfg).get(1, seed=11)
    assert_items_equal(got, want)
    assert got["events"].any()


def test_a_broken_source_fails_the_build_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void f() { undeclared_name(); }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(bad)
    assert not list((tmp_path / "build").iterdir())  # no library, no temporary left


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Builders racing for one library each write a temporary file and
    rename it into place; all get the same loadable library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not {"-march=native", "-ffast-math"} & set(native.CXX_FLAGS)
