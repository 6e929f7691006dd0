"""Bicubic resizing of uint8 frames in numpy, without cv2.

The JAX package's datasets rescale stored frames to the GT resolution
with ``cv2.resize(frame, (W, H), interpolation=cv2.INTER_CUBIC)``
(``ebfi_tpu/data/h5dataset.py``); :func:`resize_cubic` computes the same
values.  It follows OpenCV's separable cubic resize (``imgproc/src/
resize.cpp``): destination pixel d samples source coordinate
``(d + 0.5) * (src / dst) - 0.5``; its four taps around ``floor`` take
Keys' cubic weights with A = -0.75 (``interpolateCubic``), and the borders
replicate.  The horizontal pass runs first, then the vertical one; the
result is rounded half to even and saturated to [0, 255].  Positions
and weights are computed in float64, the sums in float32, which matches
the OpenCV 5 build the tests hold it against
(``tests/test_torch_data_options.py``) bit for bit on their fixed cases; a
value whose exact result lies within float rounding of a half
can land one level apart (a few in a million on random sizes, which the
tests bound).  A source side shorter than the taps' span of 4 pixels is
not held to cv2, which treats it otherwise.  OpenCV 4's uint8 path sums with 11-bit fixed-point weights
instead, and lands one level apart more often.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """(n,) fractions -> (n, 4) weights of taps -1..2 (OpenCV's
    ``interpolateCubic``, A = -0.75)."""
    A = -0.75
    x1 = f + 1
    w0 = ((A * x1 - 5 * A) * x1 + 8 * A) * x1 - 4 * A
    w1 = ((A + 2) * f - (A + 3)) * f * f + 1
    g = 1 - f
    w2 = ((A + 2) * g - (A + 3)) * g * g + 1
    return np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=-1)


def _taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (dst, 4), replicated at the borders, and their
    weights (dst, 4) along one axis."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    base = np.floor(pos)
    idx = np.clip(base.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, _cubic_weights(pos - base).astype(np.float32)


def resize_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> uint8 at ``size`` = (W, H), cv2's
    argument order, as ``cv2.resize(img, size, interpolation=
    cv2.INTER_CUBIC)`` (which also drops a channel axis of size 1; this
    keeps it).  An image already at ``size`` is copied."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_cubic takes uint8 images, got {img.dtype}")
    W, H = size
    if img.shape[:2] == (H, W):
        return img.copy()
    x = img.reshape(img.shape[0], img.shape[1], -1).astype(np.float32)
    xi, xw = _taps(W, x.shape[1])
    yi, yw = _taps(H, x.shape[0])
    rows = x[:, xi[:, 0]] * xw[None, :, 0, None]
    for k in (1, 2, 3):
        rows = rows + x[:, xi[:, k]] * xw[None, :, k, None]
    out = rows[yi[:, 0]] * yw[:, 0, None, None]
    for k in (1, 2, 3):
        out = out + rows[yi[:, k]] * yw[:, k, None, None]
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((H, W) + img.shape[2:])
