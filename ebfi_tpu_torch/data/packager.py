"""Multiscale clip packaging (port of ``ebfi_tpu/data/packager.py``).

:class:`H5Packager` writes schema H5 clips, the JAX package's API, groups,
attributes and dtypes, through the port's own HDF5 writer
(:mod:`.hdf5_write`, no ``h5py``).

:func:`package_sequence`, the dataset generator's writer, writes the
``ebfi_clip_npz/1`` container (:mod:`.clip_dataset` reads it) directly,
where the JAX package writes a schema H5 that ``tools/h5_to_npz.py``
repacks: the same arrays, bit for bit.  As the
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
from .hdf5_write import Writer

SCALES = {"ori": 1, "down2": 2, "down4": 4, "down8": 8}


class H5Packager:
    """A schema H5 clip written image by image (``hdf5_packager_multiscale``
    of the reference): ``ori_images/image{i:09d}`` (uint8 HWC BGR, with
    ``timestamp``, ``size`` and optional ``exposure_begin_t`` /
    ``exposure_end_t`` attributes), event groups ``{prex}_events/{xs,ys,
    ts,ps}`` (int16, int16, f64, int8; coordinates integer-divided by the
    scale), then per-image ``{prex}_event_idx`` attributes and the file's
    ``sensor_resolution`` and ``num_imgs``.  ``compression``: ``"gzip"``
    (h5py's level 4 and chunk shapes) or None (contiguous)."""

    def __init__(self, path: str, compression: Optional[str] = "gzip"):
        self.h5 = Writer(path)
        self.compression = compression
        self._img_count = 0
        self._img_ts = []
        self._event_ts = {}

    def set_metadata(self, sensor_resolution: Tuple[int, int], **attrs) -> None:
        self.h5.attrs["sensor_resolution"] = np.asarray(sensor_resolution, np.int64)
        for k, v in attrs.items():
            self.h5.attrs[k] = v

    def package_image(self, image_bgr: np.ndarray, timestamp: float,
                      exposure: Optional[Tuple[float, float]] = None) -> None:
        d = self.h5.require_group("ori_images").create_dataset(
            f"image{self._img_count:09d}", data=image_bgr, compression=self.compression)
        d.attrs["timestamp"] = timestamp
        d.attrs["size"] = image_bgr.shape
        if exposure is not None:
            d.attrs["exposure_begin_t"] = exposure[0]
            d.attrs["exposure_end_t"] = exposure[1]
        self._img_count += 1
        self._img_ts.append(timestamp)

    def package_events(self, xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                       scales: Sequence[str] = ("ori", "down2", "down4", "down8")) -> None:
        for prex in scales:
            f = SCALES[prex]
            g = self.h5.require_group(f"{prex}_events")
            g.create_dataset("xs", data=(xs // f).astype(np.int16), compression=self.compression)
            g.create_dataset("ys", data=(ys // f).astype(np.int16), compression=self.compression)
            self._event_ts[prex] = ts.astype(np.float64)
            g.create_dataset("ts", data=self._event_ts[prex], compression=self.compression)
            g.create_dataset("ps", data=ps.astype(np.int8), compression=self.compression)

    def add_event_indices(self, scales: Sequence[str] = ("ori", "down2", "down4", "down8")) -> None:
        """Per-image event index attributes: the first event with t >= the
        image's timestamp (a left ``searchsorted``)."""
        img_ts = np.asarray(self._img_ts)
        for prex in scales:
            if prex not in self._event_ts:
                continue
            idx = np.searchsorted(self._event_ts[prex], img_ts, side="left")
            for i in range(self._img_count):
                self.h5["ori_images"][f"image{i:09d}"].attrs[f"{prex}_event_idx"] = int(idx[i])

    def close(self) -> None:
        self.h5.attrs["num_imgs"] = self._img_count
        self.h5.close()


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
