"""Frame and event PNG writers of the inference CLI (port of
``ebfi_tpu/utils/vis.py``: ``save_frame``, ``render_event_cnt``,
``save_event_cnt``).

PNGs are written without an image library: 8-bit RGB (or grey), filter 0
on every row, the rows deflated by ``zlib`` at level 1 (the JAX writer's
``cv2.IMWRITE_PNG_COMPRESSION`` 1).  The files differ from cv2's in their
bytes, not in their pixels.  :func:`read_png` reads back what
:func:`save_frame` writes.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 1: 0}  # channels -> PNG colour type (RGB, grey)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(frame: np.ndarray) -> bytes:
    """HxWx3 uint8 RGB or HxW uint8 grey -> PNG bytes."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim not in (2, 3) or (
            frame.ndim == 3 and frame.shape[2] != 3):
        raise ValueError(f"expected HxWx3 or HxW uint8, got {frame.shape} {frame.dtype}")
    H, W = frame.shape[:2]
    channels = 1 if frame.ndim == 2 else 3
    rows = np.zeros((H, 1 + W * channels), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = frame.reshape(H, W * channels)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Pixels of a PNG that :func:`save_frame` wrote (8-bit RGB or grey,
    filter 0): HxWx3 or HxW uint8."""
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
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit RGB or grey PNGs without interlace are read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than 0")
    return rows[:, 1:].reshape((H, W, 3) if channels == 3 else (H, W)).copy()


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
