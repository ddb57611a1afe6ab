"""Host input pipeline: a pool of workers fetches samples by index while
the device computes, two batches ahead, and collates them into numpy
batches.  Counterpart of ir_ads_tpu/data/loader.py's ``DataLoader`` (the
mesh prefetch is a multi-device feature and is not ported).

Batch order, shuffling (numpy ``default_rng(seed + epoch)``) and
``drop_last`` are the JAX package's, so that both packages see the same
batches.  Workers are threads or processes, chosen by ``workers``; nothing
is read from the environment.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np

# process workers each hold their own dataset and fetch items by index
_WORKER_DS = None


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _fetch_worker(i: int):
    return _WORKER_DS[int(i)]


def _collate(samples: List[Tuple[Dict[str, np.ndarray], np.ndarray]], modals):
    """(modal_0, ..., modal_k, label): uint8 modalities stay uint8, others
    become f32; labels int32."""
    def stack(arrs):
        out = np.stack(arrs)
        return out if out.dtype == np.uint8 else out.astype(np.float32, copy=False)

    batch_modals = tuple(stack([s[0][m] for s in samples]) for m in modals)
    labels = np.stack([s[1] for s in samples]).astype(np.int32, copy=False)
    return batch_modals + (labels,)


class DataLoader:
    """Iterates (modal_0, ..., modal_k, label) numpy batches.
    ``workers="process"`` decodes in a process pool (the dataset must
    pickle); ``"thread"`` (the default) in threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 3407,
                 epoch: int = 0, workers: str = "thread"):
        if workers not in ("thread", "process"):
            raise ValueError(f"workers={workers!r}: 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = epoch
        self.workers = workers

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        idx = self._order()
        modals = self.dataset.modals
        batches = [idx[b * self.batch_size:(b + 1) * self.batch_size]
                   for b in range(len(self))]
        if self.workers == "process":
            pool = futures.ProcessPoolExecutor(
                max_workers=self.num_workers, initializer=_init_worker,
                initargs=(self.dataset,))
            fetch = _fetch_worker
        else:
            pool = futures.ThreadPoolExecutor(max_workers=self.num_workers)
            fetch = lambda i: self.dataset[int(i)]  # noqa: E731
        with pool:
            pending = collections.deque()
            it = iter(batches)
            for b in itertools.islice(it, 2):  # two batches in flight
                pending.append([pool.submit(fetch, i) for i in b])
            for b in it:
                done = pending.popleft()
                pending.append([pool.submit(fetch, i) for i in b])
                yield _collate([f.result() for f in done], modals)
            while pending:
                yield _collate([f.result() for f in pending.popleft()], modals)
