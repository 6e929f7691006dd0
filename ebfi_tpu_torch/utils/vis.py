"""Frame and event writers (port of ``ebfi_tpu/utils/vis.py``:
``save_frame``, ``render_event_cnt``, ``save_event_cnt``, ``stack_to_cnt``,
``save_event_stack_grid``, and its matplotlib renderers
``plot_event_cloud_3d``, ``save_event_stack_movie`` and
``save_event_cloud_movie``, drawn without matplotlib).

PNGs are written without an image library: 8-bit RGB (or grey), filter 0
on every row unless asked otherwise, the rows deflated by ``zlib`` at
level 1 (the JAX writer's ``cv2.IMWRITE_PNG_COMPRESSION`` 1).  The files
differ from cv2's in their bytes, not in their pixels.  :func:`read_png`
reads 8-bit grey, RGB and RGBA PNGs without interlace, with any of the
five row filters, as the dataset generator's frames come (cv2 and other
writers choose a filter per row).

The renderers rasterize what the JAX functions draw through matplotlib:
the same figure sizes and axes boxes in pixels, the same subsampling,
axes assignment (x -> x, t -> y, y -> z), polarity colours and view.  The
3D view is matplotlib's ``Axes3D`` projection (``get_proj``: its autoscaled
limits with their margins, box aspect 4:4:3, camera distance 10, focal
length 1), reproduced in numpy by :func:`axes3d_limits`,
:func:`view_matrix` and :func:`project`.  Points are one pixel each,
composited with their alpha from the farthest to the nearest.  Movies are
GIF89a files of the port's own writer (:func:`write_gif`): one global
palette, LZW codes of up to 12 bits with clear codes (the native host
plane's :func:`~ebfi_tpu_torch.native.gif_lzw`), a NETSCAPE2.0 loop block,
and pillow's frame timing (``int(1000 / fps)`` ms a frame, written in whole
centiseconds, identical consecutive frames merged with their times added).
Not reproduced (there is no font on the card machine): axis labels, tick
marks and labels, the 3D panes and grid, the cropping of
``bbox_inches="tight"``, matplotlib's depth shading and antialiasing of
markers, and its resampling of images (nearest pixel here).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 1: 0}  # channels -> PNG colour type (RGB, grey)
_READ_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (grey, RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


_FILTERS = 5  # None, Sub, Up, Average, Paeth


def filter_rows(pixels: np.ndarray, filters) -> np.ndarray:
    """PNG row filtering of (H, W, bpp) uint8 pixels: ``filters`` is one
    filter type for every row or one per row.  Returns the (H, 1 + W*bpp)
    rows that IDAT deflates, each led by its filter byte."""
    H, W, bpp = pixels.shape
    ftype = np.broadcast_to(np.asarray(filters, np.uint8), (H,))
    if ftype.max(initial=0) >= _FILTERS:
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(ftype.tolist()))}")
    rows = np.empty((H, 1 + W * bpp), np.uint8)
    rows[:, 0] = ftype
    if not ftype.any():  # filter None on every row: the pixels as they are
        rows[:, 1:] = pixels.reshape(H, W * bpp)
        return rows
    x = pixels.astype(np.int16)
    a = np.zeros_like(x)  # left, up and up-left neighbours; 0 outside
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = np.choose(ftype[:, None, None], [np.zeros_like(x), a, b, (a + b) // 2, _paeth(a, b, c)])
    rows[:, 1:] = ((x - pred) & 255).reshape(H, W * bpp)
    return rows


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Inverse of :func:`filter_rows`: (H, 1 + W*bpp) filtered rows ->
    (H, W, bpp) uint8 pixels.

    Sub, Average and Paeth predict a pixel from its left neighbour, so a
    row cannot be decoded in one vector step.  The decode sweeps the
    anti-diagonals y + x = d instead: each step reconstructs every pixel
    whose left, up and up-left neighbours the earlier steps made, each with
    its row's filter, so a frame takes H + W - 1 vector steps."""
    H = rows.shape[0]
    W = (rows.shape[1] - 1) // bpp
    ftype = rows[:, 0]
    if ftype.max(initial=0) >= _FILTERS:
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(ftype.tolist()))}")
    raw = rows[:, 1:].reshape(H, W, bpp).astype(np.int16)
    if not ftype.any():
        return raw.astype(np.uint8)
    # reconstructed pixels with a zero row above and a zero column left
    rec = np.zeros((H + 1, W + 1, bpp), np.int16)
    flat = rec.reshape(-1, bpp)
    ft = ftype.astype(np.int64)
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H, d + 1))
        xs = d - ys
        at = (ys + 1) * (W + 1) + xs + 1
        a, b, c = flat[at - 1], flat[at - W - 1], flat[at - W - 2]
        f = ft[ys][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(f == 3, (a + b) >> 1, 0)))
        if (f == 4).any():
            pred = np.where(f == 4, _paeth(a, b, c), pred)
        flat[at] = (raw[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def encode_png(frame: np.ndarray, filters=0) -> bytes:
    """HxWx3 uint8 RGB or HxW uint8 grey -> PNG bytes; ``filters``: the
    PNG filter type of every row (0-4), or one per row."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim not in (2, 3) or (
            frame.ndim == 3 and frame.shape[2] != 3):
        raise ValueError(f"expected HxWx3 or HxW uint8, got {frame.shape} {frame.dtype}")
    H, W = frame.shape[:2]
    channels = 1 if frame.ndim == 2 else 3
    rows = filter_rows(frame.reshape(H, W, channels), filters)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Pixels of an 8-bit grey, RGB or RGBA PNG without interlace, any row
    filters: HxW, HxWx3 or HxWx4 uint8, in the file's channel order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = header
    channels = _READ_CHANNELS.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit grey, RGB or RGBA PNGs without interlace are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * channels)
    pixels = unfilter_rows(rows, channels)
    return pixels[:, :, 0] if channels == 1 else pixels


def save_frame(frame: np.ndarray, path: str) -> None:
    """frame: HxWx3 uint8 RGB or HxW grey."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png = encode_png(frame)
    with open(path, "wb") as f:
        f.write(png)


def render_event_cnt(
    event_cnt: np.ndarray,
    color_scheme: str = "green_red",
    black_background: bool = True,
    normalize: bool = True,
) -> np.ndarray:
    """HxWx2 polarity counts (0: positive, 1: negative) -> HxWx3 float RGB
    in [0,1].  Percentile normalization and color conventions follow
    matplotlib_plot_events.py:127-240."""
    if color_scheme not in ("green_red", "gray", "blue_red"):
        raise ValueError(f"Not support {color_scheme}")
    pos = event_cnt[:, :, 0].astype(np.float64).copy()
    neg = event_cnt[:, :, 1].astype(np.float64).copy()

    if normalize:
        pos_min, pos_max = np.percentile(pos, 1), np.percentile(pos, 99)
        neg_min, neg_max = np.percentile(neg, 1), np.percentile(neg, 99)
        top = max(pos_max, neg_max)
        if pos_min != top:
            pos = (pos - pos_min) / (top - pos_min)
        if neg_min != top:
            neg = (neg - neg_min) / (top - neg_min)
    else:
        dominant_pos = (pos >= neg) & (pos != 0)
        dominant_neg = (pos < neg) & (neg != 0)
        pos = np.where(dominant_pos, 1.0, 0.0)
        neg = np.where(dominant_neg, 1.0, 0.0)
    pos = np.clip(pos, 0, 1)
    neg = np.clip(neg, 0, 1)

    H, W = pos.shape
    if color_scheme == "gray":
        return np.repeat((0.5 + 0.5 * pos - 0.5 * neg)[:, :, None], 3, axis=2)

    # channel roles: green_red -> positive=green, negative=red;
    # blue_red -> positive=blue(-ish, reference uses red positive/blue
    # negative in its blue_red branch; we follow dominant-polarity blending)
    pos_rgb = {"green_red": (0.0, 1.0, 0.0), "blue_red": (1.0, 0.0, 0.0)}[color_scheme]
    neg_rgb = {"green_red": (1.0, 0.0, 0.0), "blue_red": (0.0, 0.0, 1.0)}[color_scheme]

    img = np.zeros((H, W, 3)) if black_background else np.ones((H, W, 3))
    dominant = np.where(pos >= neg, pos, neg)
    color = np.where(
        (pos >= neg)[:, :, None],
        np.asarray(pos_rgb)[None, None],
        np.asarray(neg_rgb)[None, None],
    )
    active = ((pos > 0) | (neg > 0))[:, :, None]
    strength = dominant[:, :, None]
    if black_background:
        img = np.where(active, color * strength, img)
    else:
        img = np.where(active, 1.0 - strength * (1.0 - color), img)
    return img


def save_event_cnt(
    event_cnt: np.ndarray,
    path: str,
    color_scheme: str = "green_red",
    black_background: bool = True,
    normalize: bool = True,
) -> None:
    img = render_event_cnt(event_cnt, color_scheme, black_background, normalize)
    save_frame((img * 255).astype(np.uint8), path)


def stack_to_cnt(stack: np.ndarray) -> np.ndarray:
    """(H, W, 2 * TB) bin-major, polarity-minor stack -> (H, W, 2) counts per
    polarity, summed over the bins."""
    H, W, C = stack.shape
    return stack.reshape(H, W, C // 2, 2).sum(axis=2)


def save_event_stack_grid(stack: np.ndarray, path: str, vmax: float = 10.0) -> None:
    """Each bin of an (H, W, 2 * TB) stack as a signed image (positive minus
    negative over ``vmax``, clipped: positive blue, negative red, white
    for none), the bins tiled row-major into a near-square grid with
    2-pixel white gutters."""
    H, W, C = stack.shape
    tb = C // 2
    signed = stack.reshape(H, W, tb, 2)
    signed = signed[..., 0] - signed[..., 1]
    rows = int(np.sqrt(tb))
    while tb % rows:
        rows -= 1
    cols = tb // rows
    canvas = np.ones(((H + 2) * rows, (W + 2) * cols, 3))
    for i in range(tb):
        r, c = divmod(i, cols)
        v = np.clip(signed[:, :, i] / vmax, -1, 1)
        img = np.ones((H, W, 3))
        img[..., 0] -= np.clip(v, 0, 1)
        img[..., 1] -= np.abs(v)
        img[..., 2] -= np.clip(-v, 0, 1)
        canvas[r * (H + 2):r * (H + 2) + H, c * (W + 2):c * (W + 2) + W] = img
    save_frame((np.clip(canvas, 0, 1) * 255).astype(np.uint8), path)


# ---------------------------------------------------------------------- 3D view
#
# matplotlib's Axes3D (mpl_toolkits.mplot3d, 3.10): autoscale margins, box
# aspect, camera and perspective, as get_proj computes them.

_MARGIN = 0.05  # axes.[xyz]margin
_VIEW_MARGIN = 1 / 48  # Axes3D._view_margin
_DIST = 10.0  # Axes3D._dist
_FOCAL = 1.0  # perspective projection, focal length 1
_BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * (1.8294640721620434 * 25 / 24 / np.linalg.norm([4.0, 4.0, 3.0]))
_VIEW_2D = (-0.095, 0.09)  # the 3D axes' 2D view limits, both axes
RED, BLUE = (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)


def _nonsingular(vmin, vmax, expander, tiny):
    """``matplotlib.transforms.nonsingular``."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        vmin -= expander * abs(vmin)
        vmax += expander * abs(vmax)
    return vmin, vmax


def _autoscale(values: np.ndarray) -> Tuple[float, float]:
    lo, hi = (float(values.min()), float(values.max())) if values.size else (np.inf, -np.inf)
    lo, hi = _nonsingular(lo, hi, 0.05, 1e-15)  # the locator's
    delta = (hi - lo) * _MARGIN
    lo, hi = _nonsingular(lo - delta, hi + delta, 1e-12, 1e-13)  # view_limits
    delta = (hi - lo) * _VIEW_MARGIN
    return lo - delta, hi + delta


def axes3d_limits(xs, ys, zs, invert_z: bool = False) -> Tuple[Tuple[float, float], ...]:
    """The (x, y, z) limits an ``Axes3D`` autoscales to around these points
    (``invert_zaxis`` swaps z's)."""
    lims = [_autoscale(np.asarray(v, np.float64).reshape(-1)) for v in (xs, ys, zs)]
    if invert_z:
        lims[2] = lims[2][::-1]
    return tuple(lims)


def _norm_angle(a: float) -> float:
    a = (a + 360) % 360
    return a - 360 if a > 180 else a


def view_matrix(limits, elev: float, azim: float) -> np.ndarray:
    """``Axes3D.get_proj()`` for these limits and this view (roll 0,
    vertical axis z, perspective projection): data -> homogeneous view
    coordinates."""
    (x0, x1), (y0, y1), (z0, z1) = limits
    d = np.array([x1 - x0, y1 - y0, z1 - z0]) / _BOX_ASPECT
    world = np.array([[1 / d[0], 0, 0, -x0 / d[0]],
                      [0, 1 / d[1], 0, -y0 / d[1]],
                      [0, 0, 1 / d[2], -z0 / d[2]],
                      [0, 0, 0, 1]])
    R = 0.5 * _BOX_ASPECT
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + _DIST * ps
    V = np.array([0.0, 0.0, -1.0 if abs(np.deg2rad(_norm_angle(elev))) > np.pi / 2 else 1.0])
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(V, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -(R + _DIST * ps * _FOCAL)
    zf, zb = -_DIST, _DIST
    persp = np.array([[_FOCAL, 0, 0, 0],
                      [0, _FOCAL, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)],
                      [0, 0, -1, 0]])
    return np.dot(persp, np.dot(np.dot(rot, shift), world))


def project(M: np.ndarray, xs, ys, zs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalised view coordinates (tx, ty, tz) of data points
    (``proj3d.proj_transform``)."""
    vec = np.stack([np.asarray(v, np.float64).reshape(-1) for v in (xs, ys, zs)]
                   + [np.ones(np.size(xs))])
    vw = np.dot(M, vec)
    return vw[0] / vw[3], vw[1] / vw[3], vw[2] / vw[3]


# ---------------------------------------------------------------------- raster


def _square_box(rect, fig_px: Tuple[int, int]) -> Tuple[float, float, float]:
    """An ``Axes3D``'s drawing square in pixels (left, top, side): its
    figure-fraction ``rect`` shrunk to a physical square, centred."""
    W, H = fig_px
    l, b, w, h = rect
    side = min(w * W, h * H)
    left = l * W + (w * W - side) / 2
    bottom = b * H + (h * H - side) / 2
    return left, H - bottom - side, side


def _splat(canvas: np.ndarray, box, tx, ty, tz, colors, alpha: float) -> None:
    """Composite points (one pixel each, ``colors`` (n, 3) in [0, 1]) over
    ``canvas`` (H, W, 3) float with ``alpha``, far to near, at their view
    coordinates inside the axes' square ``box``."""
    H, W, _ = canvas.shape
    left, top, side = box
    lo, hi = _VIEW_2D
    col = np.floor(left + (tx - lo) / (hi - lo) * side).astype(np.int64)
    row = np.floor(top + side - (ty - lo) / (hi - lo) * side).astype(np.int64)
    draw = np.argsort(-tz, kind="stable")  # the farthest first, as Path3DCollection
    col, row, colors = col[draw], row[draw], np.asarray(colors, np.float64)[draw]
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)
    flat, colors = (row * W + col)[inside], colors[inside]
    if not len(flat):
        return
    order = np.argsort(flat, kind="stable")  # per pixel, still in drawing order
    flat, colors = flat[order], colors[order]
    first = np.r_[0, np.flatnonzero(np.diff(flat)) + 1]
    count = np.diff(np.r_[first, len(flat)])
    after = np.repeat(first + count, count) - np.arange(len(flat)) - 1  # points drawn over it
    weight = alpha * (1 - alpha) ** after
    out = canvas.reshape(-1, 3)
    pix = flat[first]
    out[pix] *= ((1 - alpha) ** count)[:, None]
    for c in range(3):
        out[pix, c] += np.bincount(flat, weights=weight * colors[:, c], minlength=H * W)[pix]


def _place(canvas: np.ndarray, img: np.ndarray, box) -> None:
    """``imshow`` with equal aspect: ``img`` (h, w, 3) in [0, 1] scaled to
    fit the box (left, top, width, height), centred, nearest pixel."""
    H, W, _ = canvas.shape
    left, top, bw, bh = box
    h, w = img.shape[:2]
    scale = min(bw / w, bh / h)
    x0, y0 = left + (bw - w * scale) / 2, top + (bh - h * scale) / 2
    cols = np.arange(int(np.ceil(x0 - 0.5)), int(np.floor(x0 + w * scale - 0.5)) + 1)
    rows = np.arange(int(np.ceil(y0 - 0.5)), int(np.floor(y0 + h * scale - 0.5)) + 1)
    cols, rows = cols[(cols >= 0) & (cols < W)], rows[(rows >= 0) & (rows < H)]
    sx = np.clip(((cols + 0.5 - x0) / scale).astype(np.int64), 0, w - 1)
    sy = np.clip(((rows + 0.5 - y0) / scale).astype(np.int64), 0, h - 1)
    canvas[rows[:, None], cols[None, :]] = img[sy[:, None], sx[None, :]]


def _to_uint8(canvas: np.ndarray) -> np.ndarray:
    return (np.clip(canvas, 0, 1) * 255 + 0.5).astype(np.uint8)


def _subsample(max_points: int, *arrays):
    n = len(arrays[2])
    if n > max_points:
        sel = np.linspace(0, n - 1, max_points).astype(int)
        return tuple(a[sel] for a in arrays)
    return arrays


def _gray(frame: np.ndarray) -> np.ndarray:
    """``imshow(frame, cmap="gray")``: a 2D frame normalised to its own
    range on the 256-entry grey map; an RGB frame as it is."""
    f = np.asarray(frame)
    if f.ndim == 3:
        return f.astype(np.float64) / 255.0 if f.dtype == np.uint8 else np.clip(f, 0, 1)
    f = f.astype(np.float64)
    lo, hi = f.min(), f.max()
    v = (f - lo) / (hi - lo) if hi > lo else np.zeros_like(f)
    level = np.minimum((v * 256).astype(np.int64), 255) / 255.0
    return np.repeat(level[:, :, None], 3, axis=2)


def plot_event_cloud_3d(
    xs: np.ndarray,
    ys: np.ndarray,
    ts: np.ndarray,
    ps: np.ndarray,
    path: str,
    max_points: int = 50_000,
    elev: float = 20.0,
    azim: float = -60.0,
) -> None:
    """3D event-cloud scatter (x, t, y), positive events red and negative
    blue at alpha 0.5, z (the image rows) inverted, seen from ``elev`` /
    ``azim``; subsampled to ``max_points``.  A PNG of the JAX figure's
    size (8 x 6 in at 150 dpi, 1200 x 900), not cropped."""
    xs, ys, ts, ps = _subsample(max_points, *(np.asarray(a) for a in (xs, ys, ts, ps)))
    fig_px = (1200, 900)
    canvas = np.ones((fig_px[1], fig_px[0], 3))
    M = view_matrix(axes3d_limits(xs, ts, ys, invert_z=True), elev, azim)
    colors = np.where(ps.reshape(-1, 1) > 0, [RED], [BLUE])
    box = _square_box((0.125, 0.11, 0.775, 0.77), fig_px)
    _splat(canvas, box, *project(M, xs, ts, ys), colors, 0.5)
    save_frame(_to_uint8(canvas), path)


def save_event_stack_movie(
    stacks, path: str, fps: int = 10, color_scheme: str = "blue_red"
) -> None:
    """Animated GIF sweeping the temporal bins of one or more event stacks
    (the movie mode of `PlotEventStack`, matplotlib_plot_events.py:614-699).

    stacks: (N, H, W, 2*TB) sequence (or a single (H, W, 2*TB) stack); each
    movie frame is one temporal bin's polarity render on white, fitted to
    the JAX figure's axes (6 x 4 in at 100 dpi: 600 x 400).
    """
    stacks = np.asarray(stacks)
    if stacks.ndim == 3:
        stacks = stacks[None]
    fig_px = (600, 400)
    box = (0.125 * 600, (1 - 0.88) * 400, 0.775 * 600, 0.77 * 400)
    frames = []
    for stack in stacks:
        tb = stack.shape[-1] // 2
        for b in range(tb):
            img = render_event_cnt(stack[..., 2 * b : 2 * b + 2], color_scheme=color_scheme,
                                   black_background=False)
            canvas = np.ones((fig_px[1], fig_px[0], 3))
            _place(canvas, img, box)
            frames.append(_to_uint8(canvas))
    write_gif(path, frames, int(1000 / fps))


def save_event_cloud_movie(
    windows, path: str, fps: int = 5, max_points: int = 20_000,
    frames_panel=None,
) -> None:
    """Animated GIF of 3D event-cloud windows (x, t, y scatter; positive
    events blue, the others red: the JAX movie's colours, swapped from
    :func:`plot_event_cloud_3d`), optionally with a frame panel below (grey
    map), in the JAX figure's layout (7 x 6 in at 100 dpi: 700 x 600; the
    default view, elev 30 and azim -60, z not inverted; the limits span
    every window, as they do on the JAX figure's one axes).

    windows: iterable of (xs, ys, ts, ps) tuples, one movie frame each.
    frames_panel: optional iterable of (H, W[, 3]) images shown beneath.
    """
    windows = [_subsample(max_points, *(np.asarray(a) for a in w)) for w in windows]
    if not windows:
        raise ValueError("save_event_cloud_movie needs at least one event window")
    panel = None if frames_panel is None else list(frames_panel)
    fig_px = (700, 600)
    cat = lambda i: np.concatenate([w[i] for w in windows])
    M = view_matrix(axes3d_limits(cat(0), cat(2), cat(1)), 30.0, -60.0)
    box = _square_box((0.0, 0.3, 1.0, 0.7), fig_px)
    frames = []
    for i, (xs, ys, ts, ps) in enumerate(windows):
        canvas = np.ones((fig_px[1], fig_px[0], 3))
        colors = np.where(ps.reshape(-1, 1) > 0, [BLUE], [RED])
        _splat(canvas, box, *project(M, xs, ts, ys), colors, 1.0)
        if panel is not None and i < len(panel):
            _place(canvas, _gray(panel[i]), (0.35 * 700, 0.7 * 600, 0.3 * 700, 0.3 * 600))
        frames.append(_to_uint8(canvas))
    write_gif(path, frames, int(1000 / fps))


# ---------------------------------------------------------------------- GIF


def quantize(frames: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """One palette for all (H, W, 3) uint8 frames: every colour when there
    are at most 256, else boxes of the colours present cut in two at
    the middle of their widest channel, the widest box first, each box's
    colours mapped to their mean (so a pixel moves by less than its box's
    width).  Returns (palette (k, 3) uint8, per-frame (H, W) indices)."""
    shape = frames[0].shape[:2]
    rgb = np.stack([np.asarray(f, np.uint8) for f in frames]).reshape(-1, 3).astype(np.uint32)
    code = rgb[:, 0] << 16 | rgb[:, 1] << 8 | rgb[:, 2]
    uniq, inverse, counts = np.unique(code, return_inverse=True, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=1).astype(np.int64)
    boxes = [np.arange(len(uniq))]
    while len(boxes) < 256:
        extents = [int((cols[b].max(0) - cols[b].min(0)).max()) for b in boxes]
        k = int(np.argmax(extents))
        if extents[k] == 0:
            break
        b = boxes.pop(k)
        c = cols[b]
        ch = int(np.argmax(c.max(0) - c.min(0)))
        mid = (int(c[:, ch].max()) + int(c[:, ch].min())) / 2
        boxes += [b[c[:, ch] <= mid], b[c[:, ch] > mid]]
    lut = np.empty(len(uniq), np.uint8)
    palette = np.empty((len(boxes), 3), np.uint8)
    for i, b in enumerate(boxes):
        lut[b] = i
        w = counts[b].astype(np.float64)
        palette[i] = np.floor((cols[b] * w[:, None]).sum(0) / w.sum() + 0.5)
    idx = lut[inverse].reshape(len(frames), *shape)
    return palette, list(idx)


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int) -> None:
    """Frames (H, W, 3) uint8 RGB, ``duration_ms`` each -> an animated
    GIF89a: one global palette (:func:`quantize`), a NETSCAPE2.0 block
    (looping forever), each frame's delay ``int(ms / 10)`` centiseconds
    and identical consecutive frames merged, as pillow writes them."""
    if not len(frames):
        raise ValueError("write_gif needs at least one frame")
    from .. import native

    H, W = frames[0].shape[:2]
    palette, indices = quantize(frames)
    bits = max(1, int(np.ceil(np.log2(len(palette)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[: len(palette)] = palette
    merged: List[List] = []  # [indices, ms]
    for idx in indices:
        if merged and np.array_equal(merged[-1][0], idx):
            merged[-1][1] += duration_ms
        else:
            merged.append([idx, duration_ms])
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0x80 | 0x70 | (bits - 1), 0, 0),
           table.tobytes(), b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    code_size = max(2, bits)
    for idx, ms in merged:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", int(ms / 10)) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0) + bytes([code_size]))
        data = native.gif_lzw(idx, code_size)
        out += [bytes([len(data[i : i + 255])]) + data[i : i + 255]
                for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))
