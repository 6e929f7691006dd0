"""Flow-pipeline visualization: the legacy ``Visualization`` (port of
``ebfi_tpu/utils/flow_vis.py``).

Renders and stores the images of an optical-flow and reconstruction
pipeline (events, frames, the flow colour wheel, the image of warped
events, reconstructed brightness) as a PNG tree with timestamps.  The
colour wheel's HSV-to-RGB step is matplotlib's ``hsv_to_rgb``, ported in
numpy (the card machine has no matplotlib).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .vis import render_event_cnt, save_frame


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV in [0, 1] -> (..., 3) RGB in [0, 1], as
    ``matplotlib.colors.hsv_to_rgb`` computes it (six hue sectors, a hue
    of 1 in the first)."""
    hsv = np.asarray(hsv, dtype=np.float64)
    if np.any((hsv < 0) | (hsv > 1)):
        raise ValueError("hsv_to_rgb: the HSV values must lie in [0, 1]")
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = i % 6
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    grey = s == 0
    r, g, b = (np.where(grey, v, c) for c in (r, g, b))
    return np.stack([r, g, b], axis=-1)


def flow_to_image(flow_x: np.ndarray, flow_y: np.ndarray) -> np.ndarray:
    """Colour-encode a flow field: hue from the angle, value from the
    min-max normalised magnitude.  (H, W) each -> (H, W, 3) uint8 RGB."""
    mag = np.linalg.norm(np.stack((flow_x, flow_y), axis=2), axis=2)
    min_mag, mag_range = mag.min(), mag.max() - mag.min()
    hsv = np.zeros([flow_x.shape[0], flow_x.shape[1], 3])
    hsv[:, :, 0] = (np.arctan2(flow_y, flow_x) + np.pi) / np.pi / 2.0
    hsv[:, :, 1] = 1.0
    hsv[:, :, 2] = mag - min_mag
    if mag_range != 0.0:
        hsv[:, :, 2] /= mag_range
    return (255 * hsv_to_rgb(hsv)).astype(np.uint8)


def minmax_norm(x: np.ndarray) -> np.ndarray:
    """Min-max normalisation between the 1st and 99th percentiles,
    clipped to [0, 1]."""
    den = np.percentile(x, 99) - np.percentile(x, 1)
    if den != 0:
        x = (x - np.percentile(x, 1)) / den
    return np.clip(x, 0, 1)


class FlowVisualization:
    """Stores rendered flow-pipeline images.  Per sequence: events/ flow/
    frames/ iwe/ brightness/ and timestamps.txt, files %09d.png."""

    def __init__(self, store_dir: str, color_scheme: str = "green_red"):
        self.store_dir = store_dir
        self.color_scheme = color_scheme
        self.img_idx = 0
        self._sequence = None
        self._ts_file = None

    def _sequence_dir(self, sequence: str) -> str:
        path_to = os.path.join(self.store_dir, sequence)
        if sequence != self._sequence:
            for sub in ("events", "flow", "frames", "iwe", "brightness"):
                os.makedirs(os.path.join(path_to, sub), exist_ok=True)
            if self._ts_file is not None:
                self._ts_file.close()
            self._ts_file = open(os.path.join(path_to, "timestamps.txt"), "w")
            self._sequence = sequence
            self.img_idx = 0
        return path_to

    def event_image(self, event_cnt: np.ndarray) -> np.ndarray:
        """(H, W, 2) polarity counts -> uint8 render."""
        img = render_event_cnt(np.asarray(event_cnt), color_scheme=self.color_scheme,
                               black_background=True)
        return (img * 255).astype(np.uint8)

    def store(self, event_cnt: Optional[np.ndarray], flow: Optional[np.ndarray],
              iwe: Optional[np.ndarray], brightness: Optional[np.ndarray], sequence: str,
              frames: Optional[np.ndarray] = None, ts: Optional[float] = None) -> None:
        """Image arguments are HWC numpy: events and iwe (H, W, 2) counts,
        flow (H, W, 2), brightness (H, W) or (H, W, 1)."""
        path_to = self._sequence_dir(sequence)
        name = f"{self.img_idx:09d}.png"
        if event_cnt is not None:
            save_frame(self.event_image(event_cnt), os.path.join(path_to, "events", name))
        if frames is not None:
            save_frame(np.asarray(frames).astype(np.uint8), os.path.join(path_to, "frames", name))
        if flow is not None:
            fl = np.asarray(flow)
            save_frame(flow_to_image(fl[..., 0], fl[..., 1]), os.path.join(path_to, "flow", name))
        if iwe is not None:
            save_frame(self.event_image(iwe), os.path.join(path_to, "iwe", name))
        if brightness is not None:
            b = np.asarray(brightness).reshape(brightness.shape[0], -1)
            save_frame((minmax_norm(b) * 255).astype(np.uint8),
                       os.path.join(path_to, "brightness", name))
        if ts is not None and self._ts_file is not None:
            self._ts_file.write(f"{ts}\n")
            self._ts_file.flush()
        self.img_idx += 1

    def close(self):
        if self._ts_file is not None:
            self._ts_file.close()
            self._ts_file = None
