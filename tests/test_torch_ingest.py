"""Real-recording ingest of the port against the JAX package's converters,
on the CPU.

Each route writes an ``ebfi_clip_npz/1`` clip; the JAX route writes a
schema H5 that ``tools/h5_to_npz.py`` repacks.  The two clips must hold the
same arrays, bit for bit, dtypes included: the packager with and without
exposures (``ebfi_tpu.data.packager.package_sequence``), ``events``
(``tools/convert_npz.py``), ``txt`` (``tools/h5_utils.py txt-to-h5``) and
``extract_bag`` on the duck-typed bag of ``tests/test_rosbag.py``
(``tools/rosbag_to_h5.py::extract_bag``).  The clip utilities
(``inspect``, ``to-memmap``, ``set-array``) run through the port's CLI.
"""
import importlib.util
import os
import sys
from types import SimpleNamespace

import cv2
import h5py
import numpy as np
import pytest

from ebfi_tpu.data import packager as jpackager
from ebfi_tpu_torch.data import ingest
from ebfi_tpu_torch.data import packager as tpackager
from ebfi_tpu_torch.data import rosbag as trosbag
from ebfi_tpu_torch.data.clip_dataset import NpzClipDatasetReal, open_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from h5_to_npz import h5_to_npz  # noqa: E402
from rosbag_to_h5 import extract_bag as jax_extract_bag  # noqa: E402
from test_rosbag import FakeBag  # noqa: E402
import torch_threads  # noqa: F401,E402  (one intra-op thread per test process)

H, W = 24, 32


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(ROOT, "tools",
                                                                              f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_clip(a, b):
    """Two npz clips with the same arrays: names, dtypes, shapes, bytes."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape,
                                                               y.shape)
            assert x.tobytes() == y.tobytes(), k


def jax_clip(tmp_path, name, write):
    """``write(h5_path)`` through the JAX package, then h5_to_npz."""
    h5 = str(tmp_path / f"{name}.h5")
    write(h5)
    return h5_to_npz(h5, str(tmp_path / "jax"))


def _events(rng, n, t0=0.0, t1=1.0):
    return (rng.integers(0, W, n).astype(np.float64), rng.integers(0, H, n).astype(np.float64),
            np.sort(rng.uniform(t0, t1, n)), rng.choice([-1.0, 1.0], n))


@pytest.mark.parametrize("with_exposures", [False, True])
def test_package_sequence_matches_jax(tmp_path, rng, with_exposures):
    frames = rng.integers(0, 256, (5, H, W, 3)).astype(np.uint8)
    img_ts = np.linspace(0.0, 1.0, 5)
    events = _events(rng, 2000)
    exposures = ([(t, t + 0.03 + 0.01 * i) for i, t in enumerate(img_ts)]
                 if with_exposures else None)
    want = jax_clip(tmp_path, "clip", lambda p: jpackager.package_sequence(
        p, frames, img_ts, events, (H, W), exposures=exposures))
    got = str(tmp_path / "clip.npz")
    tpackager.package_sequence(got, frames, img_ts, events, (H, W), exposures=exposures)
    assert_same_clip(got, want)
    assert ("exposure_begin_t" in np.load(got).files) == with_exposures


def test_package_sequence_refuses_a_short_exposure_list(tmp_path):
    frames = np.zeros((3, 4, 4, 3), np.uint8)
    ev = tuple(np.zeros(4) for _ in range(4))
    with pytest.raises(ValueError, match="2 exposures for 3 frames"):
        tpackager.package_sequence(str(tmp_path / "c.npz"), frames, [0, 1, 2], ev, (4, 4),
                                   exposures=[(0, 1), (1, 2)])


def _png_frames(d, rng, n):
    """Frames as PNGs through cv2 in the three kinds cv2.imread turns into
    BGR: grey, colour and colour with alpha."""
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        kind = i % 3
        shape = (H, W) if kind == 0 else (H, W, 3 + (kind == 2))
        cv2.imwrite(os.path.join(d, f"{i:04d}.png"), rng.integers(0, 256, shape).astype(np.uint8))
    return d


def test_imread_bgr_matches_cv2(tmp_path, rng):
    d = _png_frames(str(tmp_path / "frames"), rng, 3)
    for p in ingest.read_frames(d):
        want = cv2.imread(p)
        got = ingest.imread_bgr(p)
        assert got.dtype == want.dtype and np.array_equal(got, want), p


@pytest.mark.parametrize("with_exposures", [False, True])
def test_events_route_matches_convert_npz(tmp_path, rng, monkeypatch, with_exposures):
    n_frames, n = 6, 5000
    frames_dir = _png_frames(str(tmp_path / "frames"), rng, n_frames)
    ev = str(tmp_path / "events.npz")
    # unsorted times with ties, integer coordinates, polarities in {0, 1}
    t = np.round(rng.uniform(0, 1, n), 3)
    np.savez(ev, x=rng.integers(0, W, n), y=rng.integers(0, H, n), t=t, p=rng.integers(0, 2, n))
    ts_file = str(tmp_path / "ts.txt")
    np.savetxt(ts_file, np.linspace(0, 1, n_frames))
    exp_args = []
    if with_exposures:
        exp = str(tmp_path / "exp.txt")
        b = np.linspace(0, 1, n_frames)
        np.savetxt(exp, np.stack([b, b + 0.04], axis=1))
        exp_args = ["--exposures", exp]
    want_h5 = str(tmp_path / "want.h5")
    monkeypatch.setattr(sys, "argv", ["convert_npz.py", "--events", ev, "--frames_dir", frames_dir,
                                      "--timestamps", ts_file, "--output", want_h5, *exp_args])
    _tool("convert_npz").main()
    got = str(tmp_path / "got.npz")
    assert ingest.main(["events", "--events", ev, "--frames_dir", frames_dir, "--timestamps",
                        ts_file, "--output", got, *exp_args]) == 0
    assert_same_clip(got, h5_to_npz(want_h5, str(tmp_path / "jax")))


@pytest.mark.parametrize("with_frames", [False, True])
def test_txt_route_matches_h5_utils(tmp_path, rng, monkeypatch, with_frames):
    n = 3000
    txt = str(tmp_path / "events.txt")
    ts = np.round(rng.uniform(0, 2, n), 4)  # unsorted, with ties
    np.savetxt(txt, np.stack([ts, rng.integers(0, W, n), rng.integers(0, H, n),
                              rng.choice([0, 1], n)], axis=1))
    extra = []
    if with_frames:
        extra = ["--frames_dir", _png_frames(str(tmp_path / "frames"), rng, 4)]
    want_h5 = str(tmp_path / "want.h5")
    monkeypatch.setattr(sys, "argv", ["h5_utils.py", "txt-to-h5", "--txt", txt, "--output",
                                      want_h5, *extra])
    _tool("h5_utils").main()
    got = str(tmp_path / "got.npz")
    assert ingest.main(["txt", "--txt", txt, "--output", got, *extra]) == 0
    assert_same_clip(got, h5_to_npz(want_h5, str(tmp_path / "jax")))


# ---------------------------------------------------------------------- extract_bag


def colour_bag(bag, rng):
    """FakeBag with (H, W, 3) images in place of its grey ones."""
    msgs = []
    for topic, msg, t in bag.msgs:
        if topic == "/dvs/image_raw":
            h, w = msg.data.shape
            msg = SimpleNamespace(header=msg.header,
                                  data=rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        msgs.append((topic, msg, t))
    bag.msgs = msgs
    return bag


@pytest.mark.parametrize("images", ["mono", "colour", "none"])
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("zero", [False, True])
def test_extract_bag_matches_jax(tmp_path, images, window, zero):
    rng = np.random.default_rng(11)
    bag = FakeBag(rng, H=16, W=24, n_imgs=5, events_per_msg=300)
    if images == "colour":
        bag = colour_bag(bag, rng)
    # FakeBag's first message is an image at 10.0 s
    lo, hi = (0.07, 0.33) if zero else (10.07, 10.33)
    kw = dict(event_topic="/dvs/events",
              image_topic=None if images == "none" else "/dvs/image_raw",
              start_time=lo if window else None, end_time=hi if window else None,
              zero_timestamps=zero, imgmsg_to_array=lambda msg, color: msg.data)
    h5 = str(tmp_path / "bag.h5")
    want_stats = jax_extract_bag(bag, h5, **kw)
    got = str(tmp_path / "bag.npz")
    got_stats = trosbag.extract_bag(bag, got, **kw)
    assert got_stats == want_stats
    if images != "none":
        assert_same_clip(got, h5_to_npz(h5, str(tmp_path / "jax")))
        return
    # no image: tools/h5_to_npz.py needs ori_images, so hold the H5's arrays
    clip = np.load(got)
    assert clip["images"].shape == (0, *want_stats["sensor_size"], 3)
    with h5py.File(h5) as f:
        assert clip["sensor_resolution"].tobytes() == np.asarray(
            f.attrs["sensor_resolution"]).tobytes()
        for p in ("ori", "down2", "down4", "down8"):
            for a in ("xs", "ys", "ts", "ps"):
                want = f[f"{p}_events/{a}"][:]
                assert clip[f"{p}_{a}"].dtype == want.dtype
                assert clip[f"{p}_{a}"].tobytes() == want.tobytes(), (p, a)


def test_extract_bag_takes_a_given_size_only_without_images(tmp_path):
    rng = np.random.default_rng(3)
    bag = FakeBag(rng, H=16, W=24, n_imgs=3, events_per_msg=50)
    kw = dict(imgmsg_to_array=lambda msg, color: msg.data, sensor_size=(40, 50))
    with_images = trosbag.extract_bag(bag, str(tmp_path / "a.npz"), "/dvs/events",
                                      "/dvs/image_raw", **kw)
    without = trosbag.extract_bag(bag, str(tmp_path / "b.npz"), "/dvs/events", None, **kw)
    assert with_images["sensor_size"] == (16, 24) and without["sensor_size"] == (40, 50)


# ---------------------------------------------------------------------- the real-blur clip


def test_events_route_clip_serves_the_real_blur_reader(tmp_path, rng):
    """A clip from ``events`` with exposures is what ``--real_blur`` reads:
    its duty is (end - begin) / (next begin - begin)."""
    frames_dir = _png_frames(str(tmp_path / "frames"), rng, 5)
    n = 4000
    ev = str(tmp_path / "events.npz")
    np.savez(ev, x=rng.integers(0, W, n), y=rng.integers(0, H, n),
             t=np.sort(rng.uniform(0, 1, n)), p=rng.integers(0, 2, n))
    np.savetxt(tmp_path / "ts.txt", np.linspace(0, 1, 5))
    b = np.linspace(0, 1, 5)
    np.savetxt(tmp_path / "exp.txt", np.stack([b, b + 0.1], axis=1))
    clip = str(tmp_path / "clip.npz")
    ingest.main(["events", "--events", ev, "--frames_dir", frames_dir, "--timestamps",
                 str(tmp_path / "ts.txt"), "--exposures", str(tmp_path / "exp.txt"),
                 "--output", clip])
    cfg = {"scale": 1, "ori_scale": "ori", "time_bins": 2, "interp_num": 4,
           "NumPeriodPerSeq": 1, "SlidingWindowSeq": 1, "NumPeriodPerLoad": 1,
           "SlidingWindowLoad": 1, "data_augment": {"enabled": False}}
    ds = NpzClipDatasetReal(clip, cfg)
    item = ds.get(0, seed=0)
    assert len(ds) == 4 and item["blurry"].shape == (1, 1, H, W, 3)
    np.testing.assert_allclose(item["exposure"][0, 0, 0], 0.1 / 0.25, rtol=1e-6)


# ---------------------------------------------------------------------- clip utilities


def test_set_array_inspect_and_to_memmap(tmp_path, rng, capsys):
    clip = str(tmp_path / "clip.npz")
    frames = rng.integers(0, 256, (4, H, W, 3)).astype(np.uint8)
    events = _events(rng, 500)
    tpackager.package_sequence(clip, frames, np.linspace(0, 1, 4), events, (H, W))
    exp = str(tmp_path / "exp.txt")
    np.savetxt(exp, np.stack([np.arange(4.0), np.arange(4.0) + 0.5], axis=1))
    for name, col in (("exposure_begin_t", "0"), ("exposure_end_t", "1")):
        assert ingest.main(["set-array", "--clip", clip, "--name", name, "--values", exp,
                            "--column", col]) == 0
    ingest.main(["set-array", "--clip", clip, "--name", "source_id", "--value", "[3, 4]"])
    c = open_clip(clip)  # still a clip the datasets read
    np.testing.assert_array_equal(c["exposure_begin_t"], np.arange(4.0))
    np.testing.assert_array_equal(c["exposure_end_t"], np.arange(4.0) + 0.5)
    assert c["exposure_end_t"].dtype == np.float64
    np.testing.assert_array_equal(c["source_id"], [3, 4])
    np.testing.assert_array_equal(c["images"], frames)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".set_array_")]
    with pytest.raises(ValueError, match="one value per image"):
        ingest.main(["set-array", "--clip", clip, "--name", "exposure_begin_t", "--value",
                     "[1.0, 2.0]"])
    np.testing.assert_array_equal(open_clip(clip)["exposure_begin_t"], np.arange(4.0))

    capsys.readouterr()
    ingest.main(["inspect", "--clip", clip])
    out = capsys.readouterr().out
    assert "events ori: 500" in out and "exposures: yes" in out and "images: 4" in out

    mm = str(tmp_path / "mm")
    ingest.main(["to-memmap", "--clip", clip, "--output_dir", mm])
    for k in ("xs", "ys", "ts", "ps"):
        np.testing.assert_array_equal(np.load(os.path.join(mm, f"{k}.npy")), c[f"ori_{k}"])
