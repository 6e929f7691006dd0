"""The port's event renderers (``plot_event_cloud_3d``,
``save_event_stack_movie``, ``save_event_cloud_movie`` of
``ebfi_tpu_torch.utils.vis``) against the JAX package's matplotlib ones, on
the CPU.

- The 3D view: the port's limits and projection against matplotlib's
  ``Axes3D.get_proj()`` on a figure made here, in normalised view
  coordinates, within 1e-6.
- The GIFs, decoded with PIL: frame count, size, per-frame delay and loop
  equal to the JAX GIFs'; the stack movie's frames within one palette step
  of ``render_event_cnt``'s output placed where the figure shows it.
- The GIF writer alone: exact below 257 colours, within a palette box
  above, identical consecutive frames merged as pillow merges them.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402
from PIL import Image  # noqa: E402

from ebfi_tpu.utils import vis as jvis  # noqa: E402
from ebfi_tpu_torch.utils import vis as tvis  # noqa: E402
import torch_threads  # noqa: F401,E402  (one intra-op thread per test process)


def _events(rng, n, W=32, H=24):
    return (rng.integers(0, W, n), rng.integers(0, H, n), np.sort(rng.uniform(0, 1, n)),
            np.where(rng.uniform(size=n) < 0.5, -1, 1))


@pytest.mark.parametrize("elev,azim,invert", [(20.0, -60.0, True), (30.0, -60.0, False),
                                              (35.0, 40.0, True), (-10.0, 120.0, False),
                                              (100.0, 10.0, True)])
def test_projection_matches_matplotlib(rng, elev, azim, invert):
    xs, ys, ts, _ = _events(rng, 400)
    ts = ts * 0.8 + 0.2
    fig = plt.figure(figsize=(8, 6))
    try:
        ax = fig.add_subplot(projection="3d")
        ax.scatter(xs, ts, ys, s=0.5)
        ax.view_init(elev=elev, azim=azim)
        if invert:
            ax.invert_zaxis()
        M = ax.get_proj()
        want_lims = ax.get_w_lims()
    finally:
        plt.close(fig)
    lims = tvis.axes3d_limits(xs, ts, ys, invert_z=invert)
    np.testing.assert_allclose(np.ravel(lims), want_lims, rtol=0, atol=1e-12)
    got = tvis.project(tvis.view_matrix(lims, elev, azim), xs, ts, ys)
    want = proj3d.proj_transform(xs.astype(np.float64), ts, ys.astype(np.float64), M)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_degenerate_limits_match_matplotlib():
    fig = plt.figure()
    try:
        ax = fig.add_subplot(projection="3d")
        ax.scatter([5, 5], [0.0, 0.0], [3, 3])
        want = ax.get_w_lims()
    finally:
        plt.close(fig)
    np.testing.assert_allclose(np.ravel(tvis.axes3d_limits([5, 5], [0.0, 0.0], [3, 3])), want,
                               rtol=0, atol=1e-12)


def gif_frames(path):
    """(n_frames, size, [delay ms], loop, [RGB frames]) as PIL decodes them."""
    im = Image.open(path)
    delays, frames = [], []
    for i in range(im.n_frames):
        im.seek(i)
        delays.append(im.info.get("duration"))
        frames.append(np.asarray(im.convert("RGB")))
    return im.n_frames, im.size, delays, im.info.get("loop"), frames


@pytest.mark.parametrize("fps", [3, 10])
def test_stack_movie_matches_the_jax_gif(tmp_path, rng, fps):
    stacks = np.abs(rng.standard_normal((2, 16, 24, 8))).astype(np.float32)
    jvis.save_event_stack_movie(stacks, str(tmp_path / "jax.gif"), fps=fps)
    tvis.save_event_stack_movie(stacks, str(tmp_path / "port.gif"), fps=fps)
    n, size, delays, loop, frames = gif_frames(tmp_path / "port.gif")
    assert (n, size, delays, loop) == gif_frames(tmp_path / "jax.gif")[:4]
    # each frame: one bin's render on white, in the axes' box (a palette
    # of 256 entries over two 256-level ramps: one step is 2 levels)
    step = 255 / 127
    for f, (s, b) in zip(frames, [(s, b) for s in range(2) for b in range(4)]):
        img = tvis.render_event_cnt(stacks[s][..., 2 * b : 2 * b + 2], color_scheme="blue_red",
                                    black_background=False)
        want = np.ones((400, 600, 3))
        tvis._place(want, img, (75.0, 48.0, 465.0, 308.0))
        diff = np.abs(f.astype(int) - tvis._to_uint8(want).astype(int))
        assert diff.max() <= step, diff.max()


def test_cloud_movie_matches_the_jax_gif(tmp_path, rng):
    windows = [_events(rng, 600) for _ in range(3)]
    panel = [rng.uniform(0, 1, (24, 32)) for _ in range(2)]  # the third frame has none
    jvis.save_event_cloud_movie(windows, str(tmp_path / "jax.gif"), frames_panel=panel)
    tvis.save_event_cloud_movie(windows, str(tmp_path / "port.gif"), frames_panel=panel)
    n, size, delays, loop, frames = gif_frames(tmp_path / "port.gif")
    assert (n, size, delays, loop) == gif_frames(tmp_path / "jax.gif")[:4] == (
        3, (700, 600), [200] * 3, 0)
    # positive events blue, the others red; the panel below the cloud
    red = (frames[0][..., 0] > 200) & (frames[0][..., 2] < 60)
    blue = (frames[0][..., 2] > 200) & (frames[0][..., 0] < 60)
    assert red.sum() > 100 and blue.sum() > 100
    assert (frames[0][420:, 245:455] != 255).any() and (frames[2][420:] == 255).all()


def test_cloud_plot_writes_the_figure(tmp_path, rng):
    from ebfi_tpu_torch.utils.vis import read_png

    xs, ys, ts, ps = _events(rng, 2000)
    tvis.plot_event_cloud_3d(xs, ys, ts, ps, str(tmp_path / "c.png"), max_points=500)
    px = read_png(str(tmp_path / "c.png"))
    assert px.shape == (900, 1200, 3)
    # alpha 0.5 over white: (255, 128, 128) red, (128, 128, 255) blue
    colours = {tuple(c) for c in np.unique(px.reshape(-1, 3), axis=0)}
    assert (255, 128, 128) in colours and (128, 128, 255) in colours


def test_write_gif_palette_and_merging(tmp_path, rng):
    few = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    frames = [few[rng.integers(0, 40, (9, 11))] for _ in range(3)]
    frames.insert(1, frames[0].copy())  # merged into the first, its time added
    tvis.write_gif(str(tmp_path / "a.gif"), frames, 70)
    n, size, delays, loop, got = gif_frames(tmp_path / "a.gif")
    assert (n, size, delays, loop) == (3, (11, 9), [140, 70, 70], 0)
    assert all(np.array_equal(g, f) for g, f in zip(got, [frames[0], *frames[2:]]))
    many = [rng.integers(0, 256, (30, 40, 3)).astype(np.uint8) for _ in range(2)]
    palette, idx = tvis.quantize(many)
    assert len(palette) == 256
    tvis.write_gif(str(tmp_path / "b.gif"), many, 100)
    _, _, _, _, got = gif_frames(tmp_path / "b.gif")
    for g, f, i in zip(got, many, idx):
        assert np.array_equal(g, palette[i])
    err = np.abs(np.concatenate(got).astype(int) - np.concatenate(many).astype(int))
    assert err.mean() < 16  # random colours: 256 boxes over the cube
