"""Metrics of the inference CLI: a running-average tracker (port of
``ebfi_tpu/utils/metrics.py``) and the numpy PSNR and SSIM of
``ebfi_tpu/losses/restore.py`` (skimage semantics: per-channel PSNR with
``data_range = target[c].max() - target.min()``; per-channel SSIM with a
uniform 7x7 window and data_range 2.0; channel means)."""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


class MetricTracker:
    """Running averages of named metrics."""

    def __init__(self, keys: Iterable[str] = ()):
        self._totals: Dict[str, float] = {k: 0.0 for k in keys}
        self._counts: Dict[str, int] = {k: 0 for k in keys}

    def update(self, key: str, value: float, n: int = 1) -> None:
        self._totals[key] = self._totals.get(key, 0.0) + value * n
        self._counts[key] = self._counts.get(key, 0) + n

    def avg(self, key: str) -> float:
        c = self._counts.get(key, 0)
        return self._totals.get(key, 0.0) / c if c else 0.0

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._totals}


# ----------------------------------------------------------------------- #
# PSNR and SSIM (numpy, skimage semantics)

def _psnr(true: np.ndarray, test: np.ndarray, data_range: float) -> float:
    err = np.mean((true.astype(np.float64) - test.astype(np.float64)) ** 2)
    return float(10.0 * np.log10((data_range**2) / err))


def psnr_metric(pred: np.ndarray, target: np.ndarray) -> float:
    """psnr_loss.__call__ (restore.py:67-92): squeeze, per-channel PSNR with
    ``data_range = tgt[c].max() - tgt.min()``, channel mean.  (C,H,W) or
    (H,W) after squeeze."""
    pred = np.squeeze(np.asarray(pred))
    target = np.squeeze(np.asarray(target))
    if pred.ndim == 3:
        vals = []
        for c in range(pred.shape[0]):
            data_range = float(target[c].max() - target.min())
            vals.append(_psnr(target[c], pred[c], data_range))
        return float(np.mean(vals))
    # grayscale path clips to [0,1] and uses the float-dtype default range 2.0
    return _psnr(np.clip(target, 0, 1), np.clip(pred, 0, 1), 2.0)


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """scipy.ndimage.uniform_filter semantics (reflect boundary) in 2D."""
    p_lo = size // 2
    p_hi = size - 1 - p_lo
    xp = np.pad(x, ((p_lo, p_hi), (p_lo, p_hi)), mode="reflect")
    c = np.cumsum(np.cumsum(xp, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    H, W = x.shape
    tot = (
        c[size : size + H, size : size + W]
        - c[0:H, size : size + W]
        - c[size : size + H, 0:W]
        + c[0:H, 0:W]
    )
    return tot / (size * size)


def _ssim_2d(x: np.ndarray, y: np.ndarray, win: int, data_range: float) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win * win
    cov_norm = NP / (NP - 1)
    ux, uy = _uniform_filter(x, win), _uniform_filter(y, win)
    uxx, uyy, uxy = (
        _uniform_filter(x * x, win),
        _uniform_filter(y * y, win),
        _uniform_filter(x * y, win),
    )
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    pad = (win - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim_metric(pred: np.ndarray, target: np.ndarray, data_range: float = 2.0) -> float:
    """ssim_loss.__call__ (restore.py:43-64): squeeze, per-channel SSIM with
    skimage defaults (uniform 7x7, float data_range 2.0), channel mean."""
    pred = np.squeeze(np.asarray(pred))
    target = np.squeeze(np.asarray(target))
    if pred.ndim == 3:
        return float(
            np.mean([_ssim_2d(pred[c], target[c], 7, data_range) for c in range(pred.shape[0])])
        )
    return _ssim_2d(pred, target, 7, data_range)
