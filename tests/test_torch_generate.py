"""The port's dataset generation against the JAX package's on the CPU:
the PNG reader against ``cv2.imread``, the packager against
``package_sequence`` + ``tools/h5_to_npz.py``, and
``python -m ebfi_tpu_torch.data.generate`` against
``tools/generate_dataset.py`` + ``tools/h5_to_npz.py`` (run in process).

Tolerances: the PNG reader, the packager and the generator with
``--upsample_factor`` are exact (the same integer and f64 arithmetic).
With ``--slomo_ckpt`` the frames pass through SuperSloMo in two
frameworks: the frame counts and timestamps must be equal (the insertion
counts' maxima lie far from an integer here; the test checks that they
do), the uint8 frames within one level everywhere and equal at >= 99 % of
the values (``x * 255 + 0.5`` truncates, so a 1e-5 difference in [0, 1]
flips a level where the scaled value sits at a half).  Events are compared
as a count within 1 %: ESIM-lite turns a one-level pixel difference into
a different threshold crossing.
"""
import os
import struct
import sys
import zlib

import cv2
import jax
import numpy as np
import pytest

from ebfi_tpu.data.packager import package_sequence as jax_package_sequence
from ebfi_tpu.models import superslomo as jss
from ebfi_tpu_torch.data import generate
from ebfi_tpu_torch.data.clip_dataset import open_clip
from ebfi_tpu_torch.data.packager import package_sequence
from ebfi_tpu_torch.models import superslomo as tss
from ebfi_tpu_torch.models import superslomo_params_from_jax
from ebfi_tpu_torch.utils.vis import encode_png, filter_rows, read_png

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import generate_dataset as jax_generate  # noqa: E402
from h5_to_npz import h5_to_npz  # noqa: E402
import torch_threads  # noqa: F401  (one intra-op thread per test process)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b, skip=()):
    a, b = _npz(a), _npz(b)
    assert set(a) == set(b)
    for k in a:
        if k in skip:
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------- PNG reader


def _png(pixels, ctype, filters):
    """A PNG written by hand: (H, W, bpp) pixels, row filters given."""
    H, W, _ = pixels.shape
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filter_rows(pixels, filters).tobytes(), 6))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("ctype,bpp", [(0, 1), (2, 3), (6, 4)], ids=["grey", "rgb", "rgba"])
def test_read_png_decodes_each_filter_as_cv2_does(tmp_path, filt, ctype, bpp):
    """One hand-made file per filter type and colour type (and one mixing
    all five across its rows): the reader returns its pixels, and
    ``read_frame_bgr`` what ``cv2.imread`` returns for the same file."""
    rng = np.random.default_rng(bpp)
    px = rng.integers(0, 256, (13, 17, bpp), dtype=np.uint8)
    filters = np.arange(13) % 5 if filt == "mixed" else filt
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(px, ctype, filters))
    got = read_png(path)
    np.testing.assert_array_equal(got, px[:, :, 0] if bpp == 1 else px)
    np.testing.assert_array_equal(generate.read_frame_bgr(path), cv2.imread(path))


@pytest.mark.parametrize("shape", [(40, 56, 3), (33, 21, 3), (40, 56, 4), (40, 56)],
                         ids=["bgr", "odd", "bgra", "grey"])
def test_read_frame_bgr_matches_cv2_on_files_cv2_writes(tmp_path, shape):
    """cv2 chooses a filter per row: frames read as ``cv2.imread`` reads them."""
    rng = np.random.default_rng(len(shape))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (128 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.uint8)
    img = np.clip(smooth.reshape(shape[:2] + (1,) * (len(shape) - 2))
                  + rng.integers(0, 40, shape), 0, 255).astype(np.uint8)
    path = str(tmp_path / "c.png")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(generate.read_frame_bgr(path), cv2.imread(path))


def test_read_png_round_trips_its_writer_with_each_filter(tmp_path):
    px = np.random.default_rng(0).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    for f in range(5):
        path = str(tmp_path / f"{f}.png")
        with open(path, "wb") as fh:
            fh.write(encode_png(px, f))
        np.testing.assert_array_equal(read_png(path), px)
        np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], px)


def test_jpeg_frames_raise_naming_the_file(tmp_path):
    seq = tmp_path / "in" / "s"
    seq.mkdir(parents=True)
    cv2.imwrite(str(seq / "0.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match=r"0\.jpg.*JPEG"):
        generate.read_frames(str(seq))


# ---------------------------------------------------------------- packager


def test_packager_equals_the_jax_packager_and_repack(tmp_path):
    """Frames and events from the ESIM-lite simulator (with an event on an
    image timestamp, and coordinates that do not divide by 8)."""
    from ebfi_tpu_torch.data.synth import render_frames, simulate_events

    frames = render_frames(6, 36, 44, seed=3)[:, :, :, ::-1].copy()
    ts = np.arange(6) / 240.0
    (xs, ys, ets, ps), _ = simulate_events(frames[:, :, :, ::-1], ts, seed=3, cp=0.1, cn=0.15)
    assert len(xs) > 100
    ets = ets.copy()
    ets[len(ets) // 2] = ts[3]
    ets.sort()
    events = (xs, ys, ets, ps)
    h5 = str(tmp_path / "clip.h5")
    jax_package_sequence(h5, frames, ts, events, (36, 44))
    want = h5_to_npz(h5, str(tmp_path / "jax"))
    got = str(tmp_path / "clip.npz")
    package_sequence(got, frames, ts, events, (36, 44))
    _assert_same_npz(got, want)
    assert open_clip(got)["format"] == "ebfi_clip_npz/1"


def test_packager_with_no_events(tmp_path):
    frames = np.zeros((2, 8, 8, 3), np.uint8)
    empty = (np.zeros(0),) * 4
    h5 = str(tmp_path / "e.h5")
    jax_package_sequence(h5, frames, [0.0, 0.1], empty, (8, 8))
    got = str(tmp_path / "e.npz")
    package_sequence(got, frames, [0.0, 0.1], empty, (8, 8))
    _assert_same_npz(got, h5_to_npz(h5, str(tmp_path / "jax")))


# ---------------------------------------------------------------- the generator


def _sequences(root, n_frames=(4, 3), H=40, W=48):
    """Two sequences of moving PNG frames written by cv2 (adaptive filters)."""
    from ebfi_tpu_torch.data.synth import render_frames

    for i, n in enumerate(n_frames):
        d = root / f"seq{i}"
        d.mkdir(parents=True)
        for k, f in enumerate(render_frames(n, H, W, seed=i, speed=3.0)):
            assert cv2.imwrite(str(d / f"{k:05d}.png"), f)
    return str(root)


def _run_jax_tool(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["generate_dataset.py"] + argv)
    jax_generate.main()
    out = argv[argv.index("--output_dir") + 1]
    return {os.path.splitext(f)[0]: h5_to_npz(os.path.join(out, f), str(tmp_path / "jax_npz"))
            for f in sorted(os.listdir(out))}


def test_generator_equals_the_jax_tool_with_linear_upsampling(tmp_path, monkeypatch):
    src = _sequences(tmp_path / "in")
    common = ["--input_dir", src, "--fps", "240", "--upsample_factor", "2", "--seed", "4",
              "--refractory", "1e-3", "--contrast_min", "0.05", "--contrast_max", "0.1"]
    want = _run_jax_tool(common + ["--output_dir", str(tmp_path / "jax")], monkeypatch, tmp_path)
    recs = generate.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [r["sequence"] for r in recs] == sorted(want)
    for r in recs:
        assert r["frames_out"] == 2 * r["frames_in"] - 1 and r["events"] > 0
        _assert_same_npz(r["path"], want[r["sequence"]])


def test_generator_with_superslomo_matches_the_jax_tool(tmp_path, monkeypatch):
    p = jax.tree.map(np.asarray, jss.init_params(0, 32, 32))
    p["flow"]["conv3"]["bias"] = p["flow"]["conv3"]["bias"] + np.array(
        [2.6, -1.5, 1.2, -2.2], np.float32)  # |flow| ~ 2.7-3: 2 insertions per pair
    ckpt = str(tmp_path / "SuperSloMo.ckpt")
    tss.save_checkpoint(ckpt, *superslomo_params_from_jax(p))
    src = _sequences(tmp_path / "in", n_frames=(3,))
    common = ["--input_dir", src, "--slomo_ckpt", ckpt, "--seed", "2",
              "--contrast_min", "0.05", "--contrast_max", "0.1"]
    want = _run_jax_tool(common + ["--output_dir", str(tmp_path / "jax")], monkeypatch, tmp_path)
    recs = generate.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])

    # every pair's flow maximum lies far from an integer: the counts are decidable
    slomo = jss.SuperSloMo(jss.convert_torch_checkpoint(ckpt))
    frames = generate.read_frames(os.path.join(src, "seq0")).astype(np.float32) / 255.0
    mean = np.asarray(jss.MEAN, np.float32)
    for i in range(len(frames) - 1):
        pad = lambda f: np.pad(f, ((0, 24), (0, 16), (0, 0)), mode="edge")[None] - mean
        f01, f10 = slomo.flow(pad(frames[i]), pad(frames[i + 1]))
        m = max(float(np.sqrt((np.asarray(f) ** 2).sum(-1)).max()) for f in (f01, f10))
        assert 0.05 < m - np.floor(m) < 0.95, m

    (r,) = recs
    got, ref = _npz(r["path"]), _npz(want["seq0"])
    assert r["frames_out"] == 2 * 3 == len(ref["images"])  # each pair: I0 + 2; never the last
    np.testing.assert_array_equal(got["image_ts"], ref["image_ts"])
    d = np.abs(got["images"].astype(int) - ref["images"].astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())
    for k in ("format", "sensor_resolution"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert abs(len(got["ori_ts"]) - len(ref["ori_ts"])) <= 0.01 * len(ref["ori_ts"])
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k


def test_generator_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _sequences(tmp_path / "in", n_frames=(2,), H=8, W=8)
    ckpt = str(tmp_path / "c.ckpt")
    tss.save_checkpoint(ckpt, tss.SloMoUNet(6, 4).state_dict(), tss.SloMoUNet(20, 5).state_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--input_dir", src, "--output_dir", str(tmp_path / "o"),
                       "--slomo_ckpt", ckpt])
