"""Frame and event PNG writers of the inference CLI (port of
``ebfi_tpu/utils/vis.py``: ``save_frame``, ``render_event_cnt``,
``save_event_cnt``, ``stack_to_cnt``, ``save_event_stack_grid``; its
matplotlib renderers are not ported).

PNGs are written without an image library: 8-bit RGB (or grey), filter 0
on every row unless asked otherwise, the rows deflated by ``zlib`` at
level 1 (the JAX writer's ``cv2.IMWRITE_PNG_COMPRESSION`` 1).  The files
differ from cv2's in their bytes, not in their pixels.  :func:`read_png`
reads 8-bit grey, RGB and RGBA PNGs without interlace, with any of the
five row filters, as the dataset generator's frames come (cv2 and other
writers choose a filter per row).
"""
from __future__ import annotations

import os
import struct
import zlib

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
    x = pixels.astype(np.int16)
    a = np.zeros_like(x)  # left, up and up-left neighbours; 0 outside
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = np.choose(ftype[:, None, None], [np.zeros_like(x), a, b, (a + b) // 2, _paeth(a, b, c)])
    rows = np.empty((H, 1 + W * bpp), np.uint8)
    rows[:, 0] = ftype
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
