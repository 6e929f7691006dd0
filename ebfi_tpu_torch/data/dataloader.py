"""Loader over concatenated clip datasets (port of
``ebfi_tpu/data/dataloader.py``; the trainer does the device prefetch).

Items are assembled by a thread pool in the calling process or, with
``num_workers > 0``, by worker processes started with ``spawn`` (the
parent may hold a CUDA context, which must not be forked).  Either way
batches come out in order with the same contents: the per-item
augmentation seeds are drawn in the calling thread, in item order, from
python ``random`` (the reference loader's per-item ``random.randint``),
for the items of the epoch's batches only.  ``shuffle`` permutes the
items with ``random.Random(seed + epoch)`` (``set_epoch``), and
``drop_last`` drops a short last batch, as the JAX loader does.

Data parallelism: shard ``shard_index`` of ``num_shards`` takes
``order[shard_index::num_shards]`` of the epoch's order, as the JAX
loader does, cut to the smallest shard's length (``len(order) //
num_shards`` items), as ``DistributedSampler(drop_last=True)`` does.
Every shard then yields the same number of batches of the same sizes:
a rank that took one more step than the others would wait for them in
its next collective forever.  (The JAX loader keeps the uneven tail, and
its multi-process run is not defined there.)
"""
from __future__ import annotations

import concurrent.futures as cf
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .clip_dataset import NpzClipDataset, NpzClipDatasetFast, NpzClipDatasetReal
from .datalist import read_datalist


FETCH_THREADS = 2  # item threads of the in-process path

# worker processes rebuild their datasets from (paths, config) once
_PP_DATASETS: Optional[list] = None


def _dataset_class(real_data: bool, fast: bool):
    if real_data:
        return NpzClipDatasetReal
    return NpzClipDatasetFast if fast else NpzClipDataset


def _pp_init(paths, config, real_data, fast):
    global _PP_DATASETS
    _PP_DATASETS = [_dataset_class(real_data, fast)(p, config) for p in paths]


def _pp_fetch(di: int, ii: int, seed: int) -> Dict[str, np.ndarray]:
    return _PP_DATASETS[di].get(ii, seed=seed)


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class EBFIDataLoader:
    """Epoch loader over clip datasets.

    Args:
      sources: datalist txt path, a single .npz path, or a list of .npz paths.
      dataset_config: per-dataset config dict (see NpzClipDataset).
      batch_size, shuffle, drop_last: usual semantics.
      shard_index/num_shards: this process's shard of every epoch (see
        the module docstring).
      real_data: use the real-blur reader.
      seed: shuffle base seed, combined with the epoch (``set_epoch``).
      num_threads: item threads of this process (when num_workers is 0).
      num_workers: worker processes (spawned) when > 0.
      fast: preload every item of a synthetic-blur clip
        (:class:`NpzClipDatasetFast`).  As in the JAX loader, the datasets
        of this process preload only where num_workers is 0 (with workers
        they serve only the index), and each worker preloads its own.
    """

    def __init__(self, sources, dataset_config: dict, batch_size: int = 1,
                 real_data: bool = False, num_workers: int = 0, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_threads: int = FETCH_THREADS,
                 shard_index: int = 0, num_shards: int = 1, fast: bool = False):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {num_shards})")
        if isinstance(sources, str):
            paths = [sources] if sources.endswith(".npz") else read_datalist(sources)
        else:
            paths = list(sources)
        cls = _dataset_class(real_data, fast and num_workers == 0)
        self._worker_spec = (paths, dataset_config, real_data, fast)
        self.datasets = [cls(p, dataset_config) for p in paths]
        self.index = [(di, ii) for di, ds in enumerate(self.datasets) for ii in range(len(ds))]
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.num_threads = num_threads
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard_index = shard_index
        self.num_shards = num_shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_order(self) -> List[int]:
        """This shard's items of the epoch, in order (the JAX loader's
        ``_shard_order``, cut to the smallest shard's length)."""
        order = list(range(len(self.index)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        return order[self.shard_index::self.num_shards][: len(order) // self.num_shards]

    def __len__(self) -> int:
        n = len(self.index) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches.  Items are fetched by the pool at most one
        more than it has workers (or a batch) ahead of the batch being
        assembled, which bounds host memory (a 720p window is ~0.6 GB)."""
        bs = self.batch_size
        order = self._shard_order()
        order = order[: len(self) * bs]  # drop_last drops the short tail
        batches = [list(range(b, min(b + bs, len(order)))) for b in range(0, len(order), bs)]
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
            workers = self.num_threads
            fetch = lambda di, ii, seed: self.datasets[di].get(ii, seed=seed)  # noqa: E731
            pool = cf.ThreadPoolExecutor(workers)
        lookahead = max(workers + 1, self.batch_size)
        pending: List = []
        try:
            for batch in batches:
                want = min(len(order), batch[-1] + 1 + lookahead)
                while len(pending) < want:
                    i = len(pending)
                    pending.append(pool.submit(fetch, *self.index[order[i]], seeds[i]))
                items = [pending[i].result() for i in batch]
                for i in batch:
                    pending[i] = None  # free the (large) result
                yield collate(items)
        finally:
            # not waiting: abandoning the generator must not block on the pool
            pool.shutdown(wait=False, cancel_futures=True)
