"""Loader over concatenated clip datasets (port of the inference side of
``ebfi_tpu/data/dataloader.py``: no shuffling, sharding or device
prefetch).

Items are assembled by a thread pool in the calling process or, with
``num_workers > 0``, by worker processes started with ``spawn`` (the
parent may hold a CUDA context, which must not be forked).  Either way
batches come out in order with the same contents: the per-item
augmentation seeds are drawn in the calling thread, in item order, from
python ``random`` (the reference loader's per-item ``random.randint``).
"""
from __future__ import annotations

import concurrent.futures as cf
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .clip_dataset import NpzClipDataset, NpzClipDatasetReal


def read_datalist(path: str) -> List[str]:
    """One clip path per line."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


FETCH_THREADS = 2  # item threads of the in-process path

# worker processes rebuild their datasets from (paths, config) once
_PP_DATASETS: Optional[list] = None


def _pp_init(paths, config, real_data):
    global _PP_DATASETS
    cls = NpzClipDatasetReal if real_data else NpzClipDataset
    _PP_DATASETS = [cls(p, config) for p in paths]


def _pp_fetch(di: int, ii: int, seed: int) -> Dict[str, np.ndarray]:
    return _PP_DATASETS[di].get(ii, seed=seed)


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class EBFIDataLoader:
    """Loader over clip datasets, items in order (the inference loader).

    Args:
      sources: datalist txt path, a single .npz path, or a list of .npz paths.
      dataset_config: per-dataset config dict (see NpzClipDataset).
      batch_size: items per batch; the last batch may be short.
      real_data: use the real-blur reader.
      num_workers: worker processes (spawned) when > 0, else
        ``FETCH_THREADS`` threads of this process.
    """

    def __init__(self, sources, dataset_config: dict, batch_size: int = 1,
                 real_data: bool = False, num_workers: int = 0):
        if isinstance(sources, str):
            paths = [sources] if sources.endswith(".npz") else read_datalist(sources)
        else:
            paths = list(sources)
        cls = NpzClipDatasetReal if real_data else NpzClipDataset
        self._worker_spec = (paths, dataset_config, real_data)
        self.datasets = [cls(p, dataset_config) for p in paths]
        self.index = [(di, ii) for di, ds in enumerate(self.datasets) for ii in range(len(ds))]
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return (len(self.index) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches in item order.  Items are fetched by the pool at most
        one more than it has workers (or a batch) ahead of the batch being
        assembled, which bounds host memory (a 720p window is ~0.6 GB)."""
        order = list(range(len(self.index)))
        batches = [order[b : b + self.batch_size] for b in range(0, len(order), self.batch_size)]
        # drawn here, in the calling thread and in item order, so that
        # augmentation does not depend on scheduling
        seeds = [random.randint(0, 2**32) for _ in order]
        if self.num_workers > 0:
            import multiprocessing as mp

            workers, fetch = self.num_workers, _pp_fetch
            pool = cf.ProcessPoolExecutor(
                workers, mp_context=mp.get_context("spawn"),
                initializer=_pp_init, initargs=self._worker_spec,
            )
        else:
            workers = FETCH_THREADS
            fetch = lambda di, ii, seed: self.datasets[di].get(ii, seed=seed)  # noqa: E731
            pool = cf.ThreadPoolExecutor(workers)
        lookahead = max(workers + 1, self.batch_size)
        pending: List = []
        try:
            for batch in batches:
                want = min(len(order), batch[-1] + 1 + lookahead)
                while len(pending) < want:
                    i = len(pending)
                    pending.append(pool.submit(fetch, *self.index[i], seeds[i]))
                items = [pending[i].result() for i in batch]
                for i in batch:
                    pending[i] = None  # free the (large) result
                yield collate(items)
        finally:
            # not waiting: abandoning the generator must not block on the pool
            pool.shutdown(wait=False, cancel_futures=True)
