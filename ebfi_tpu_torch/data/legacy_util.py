"""Legacy event-frame helpers (port of ``ebfi_tpu/data/legacy_util.py``),
off the main path in both packages:

- :func:`event2frame`: two-channel polarity count frames before and after
  a reference time, with optional uniform noise events;
- :func:`filter_events`, :func:`filter_events_by_space`: an event list cut
  to a time window or a pixel window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def event2frame(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                resolution: Tuple[int, int], ref_time: float, noise_fraction: float = 0.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(2, 2, H, W) f32: [at or before / after ref_time] x [positive /
    negative] counts of the in-bounds events, after adding
    ``noise_fraction * N`` uniform random events drawn from ``rng``."""
    H, W = resolution
    rng = rng or np.random.default_rng()
    if noise_fraction > 0 and len(ts):
        n = int(noise_fraction * len(ts))
        xs = np.concatenate([xs, rng.integers(0, W, n)])
        ys = np.concatenate([ys, rng.integers(0, H, n)])
        ts = np.concatenate([ts, rng.uniform(ts.min(), ts.max(), n)])
        ps = np.concatenate([ps, rng.choice([-1.0, 1.0], n)])
    out = np.zeros((2, 2, H, W), np.float32)
    xi, yi = xs.astype(np.int64), ys.astype(np.int64)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    for half, sel_t in ((0, ts <= ref_time), (1, ts > ref_time)):
        for pol, sel_p in ((0, ps > 0), (1, ps < 0)):
            sel = ok & sel_t & sel_p
            np.add.at(out[half, pol], (yi[sel], xi[sel]), 1.0)
    return out


def filter_events(xs, ys, ts, ps, t0: float, t1: float):
    """The events with t in [t0, t1)."""
    sel = (ts >= t0) & (ts < t1)
    return xs[sel], ys[sel], ts[sel], ps[sel]


def filter_events_by_space(xs, ys, ts, ps, x0: int, x1: int, y0: int, y1: int):
    """The events inside [x0, x1) x [y0, y1), moved to the window's origin."""
    sel = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    return xs[sel] - x0, ys[sel] - y0, ts[sel], ps[sel]
