"""Multiscale clip packaging, the dataset generator's writer (port of
``ebfi_tpu/data/packager.py``'s ``package_sequence``).

Writes the ``ebfi_clip_npz/1`` container (:mod:`.clip_dataset` reads it)
directly, where the JAX package writes a schema H5 that
``tools/h5_to_npz.py`` repacks: the same arrays, bit for bit.  As the
reference packager (generate_dataset/tools/event_packagers.py:119-229)
does, each event group ``down{s}`` holds the same events with their
coordinates integer-divided by ``s`` (events collapse onto the coarser
grid), and ``{p}_event_idx`` is the index of each image's first event at
or after its timestamp (a left ``searchsorted``, :204-226).  Images are
stored as given (BGR, as the H5 stores them).  Per-image exposures, where
given, become ``exposure_begin_t`` and ``exposure_end_t`` (the real-blur
reader's shutter times; the JAX package stores them as image attributes).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .clip_dataset import FORMAT

SCALES = {"ori": 1, "down2": 2, "down4": 4, "down8": 8}


def package_sequence(
    path: str,
    frames_bgr: np.ndarray,
    timestamps: Sequence[float],
    events: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    sensor_resolution: Tuple[int, int],
    scales: Sequence[str] = ("ori", "down2", "down4", "down8"),
    exposures: Optional[Sequence[Tuple[float, float]]] = None,
) -> None:
    """Frames (N, H, W, 3) uint8 BGR, their timestamps and the events
    (xs, ys, ts, ps) -> one ``.npz`` clip at ``path``; ``exposures``: one
    (begin, end) shutter time per frame, or None."""
    xs, ys, ts, ps = events
    image_ts = np.asarray(timestamps, np.float64)
    arrays = {
        "format": np.array(FORMAT),
        "sensor_resolution": np.asarray(sensor_resolution, np.int64),
        "images": np.ascontiguousarray(frames_bgr, np.uint8),
        "image_ts": image_ts,
    }
    ets = np.asarray(ts).astype(np.float64)
    idx = np.searchsorted(ets, image_ts, side="left").astype(np.int64)
    for p in scales:
        f = SCALES[p]
        arrays[f"{p}_xs"] = (xs // f).astype(np.int16)
        arrays[f"{p}_ys"] = (ys // f).astype(np.int16)
        arrays[f"{p}_ts"] = ets
        arrays[f"{p}_ps"] = ps.astype(np.int8)
        arrays[f"{p}_event_idx"] = idx
    if exposures is not None:
        exp = np.asarray([tuple(e) for e in exposures], np.float64).reshape(-1, 2)
        if len(exp) != len(image_ts):
            raise ValueError(f"{len(exp)} exposures for {len(image_ts)} frames")
        arrays["exposure_begin_t"] = np.ascontiguousarray(exp[:, 0])
        arrays["exposure_end_t"] = np.ascontiguousarray(exp[:, 1])
    np.savez(path, **arrays)
