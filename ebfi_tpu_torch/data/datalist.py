"""Datalists: the text files of clip paths the loaders read (port of
``ebfi_tpu/data/datalist.py``).

:func:`build_datalist` samples train and valid lists of the clips in a
directory, in the JAX package's four modes and with its draws (the same
seed picks the same names).  Clips are ``*.npz``, ``*.h5`` and ``*.hdf5``
files (the JAX package lists ``*.h5``), one per file stem: where
``tools/h5_to_npz.py`` wrote a clip's ``.npz`` beside its ``.h5``, the
memory-mapped ``.npz`` is listed.  The modes:

- 0: ``num`` training clips from ``data_path``;
- 1: ``num`` train and ``valid_num`` valid clips, disjoint, from ``data_path``;
- 2: ``data_path`` split by ``portion`` into train and valid;
- 3: train from ``data_path``, valid from ``valid_data_path``.
"""
from __future__ import annotations

import glob
import os
import random
from typing import List, Optional, Tuple


def read_datalist(path: str) -> List[str]:
    """One clip path per line."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def write_txt(path: str, items: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(items) + "\n")


CLIP_SUFFIXES = (".npz", ".h5", ".hdf5")  # the one listed first where a stem has several


def _clips(directory: str) -> List[str]:
    chosen = {}
    for ext in CLIP_SUFFIXES:
        for p in glob.glob(os.path.join(directory, "*" + ext)):
            chosen.setdefault(os.path.splitext(p)[0], p)
    return sorted(chosen.values())


def build_datalist(
    data_path: str,
    mode: int = 0,
    num: Optional[int] = None,
    valid_num: Optional[int] = None,
    portion: Optional[float] = None,
    valid_data_path: Optional[str] = None,
    seed: int = 0,
) -> Tuple[List[str], List[str]]:
    """(train paths, valid paths); valid is empty in mode 0."""
    paths = _clips(data_path)
    rnd = random.Random(seed)
    if mode == 0:
        return sorted(rnd.sample(paths, len(paths) if num is None else num)), []
    if mode == 1:
        train = rnd.sample(paths, num)
        left = sorted(set(paths) - set(train))
        return train, sorted(random.Random(seed).sample(left, valid_num))
    if mode == 2:
        train = rnd.sample(paths, int(len(paths) * portion))
        return train, sorted(set(paths) - set(train))
    if mode == 3:
        train = sorted(rnd.sample(paths, num))
        valid = sorted(random.Random(seed).sample(_clips(valid_data_path), valid_num))
        return train, valid
    raise ValueError(f"Invalid mode {mode}")
