"""Host-side (numpy) event encoder (port of ``ebfi_tpu/data/encodings.py``).

``events_to_stack`` is bit-identical to the JAX package's
``events_to_stack_np``: f64 bin edges in the reference's op order, CLOSED
bins (an event on a shared f64 edge lands in both), weights ``p * max(p, 0)``
and ``p * min(p, 0)``, out-of-range events dropped, and zeros for streams
of <= 3 events or all-zero timestamps.  The accumulation is a
``np.bincount`` over flat pixel indices instead of ``np.add.at``: both add
the weights in f64 in event order, so the sums are the same bit for bit,
and bincount is much faster at 720p.
"""
from __future__ import annotations

import numpy as np


def _accumulate(xs, ys, ws, H: int, W: int) -> np.ndarray:
    """Scatter-add ws at integer (ys, xs) into an HxW f64 image; events
    outside the image are dropped (the reference zeroes their coordinates
    and weights, which adds 0.0 at (0, 0))."""
    xs = np.asarray(xs).astype(np.int64)
    ys = np.asarray(ys).astype(np.int64)
    ws = np.asarray(ws, np.float64)
    oob = (xs < 0) | (xs >= W) | (ys < 0) | (ys >= H)
    flat = np.where(oob, 0, ys * W + xs)
    ws = np.where(oob, 0.0, ws)
    return np.bincount(flat, weights=ws, minlength=H * W).reshape(H, W)


def events_to_stack(
    xs: np.ndarray,
    ys: np.ndarray,
    ts: np.ndarray,
    ps: np.ndarray,
    num_bins: int,
    sensor_size: tuple[int, int],
) -> np.ndarray:
    """Per-polarity temporal-bin count stack, (2, num_bins, H, W) float32."""
    H, W = sensor_size
    ts = np.asarray(ts, np.float64)
    ps = np.asarray(ps, np.float64)
    if ts.sum() == 0 or len(ts) <= 3:
        return np.zeros((2, num_bins, H, W), np.float32)

    dt = np.float64(ts[-1] - ts[0]) + np.float64(1e-6)
    delta = np.float64(dt / np.float64(num_bins))
    out = np.zeros((2, num_bins, H, W), np.float64)
    for bi in range(num_bins):
        tstart = np.float64(ts[0] + delta * np.float64(bi))
        tend = np.float64(tstart + delta)
        beg = int(np.searchsorted(ts, tstart, side="left"))
        end = int(np.searchsorted(ts, tend, side="right"))
        p = ps[beg:end]
        w_pos = p * np.where(p < 0, 0.0, p)
        w_neg = p * np.where(p > 0, 0.0, p)
        out[0, bi] = _accumulate(xs[beg:end], ys[beg:end], w_pos, H, W)
        out[1, bi] = _accumulate(xs[beg:end], ys[beg:end], w_neg, H, W)
    return out.astype(np.float32)


def normalize_event_ts(ts: np.ndarray) -> np.ndarray:
    """``(ts - ts[0]) / (ts[-1] - ts[0] + 1e-6)`` in f64, applied before
    stacking."""
    ts = np.asarray(ts, np.float64)
    return (ts - ts[0]) / (ts[-1] - ts[0] + 1e-6)
