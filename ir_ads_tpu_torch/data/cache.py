"""Decode-once raw sample cache.  Counterpart of ir_ads_tpu/data/cache.py,
with the same files, so that a cache built by either package opens in the
other: under ``cache_dir`` one ``<modality>.npy`` of shape (N, H, W, C)
uint8 a modality, ``mask.npy`` (N, H, W) uint8 or int32, and ``meta.json``
({"n", "modals"}).  Samples must share one shape (true of the eval
pipelines).  A fetch is a copy out of the memory map, not a decode.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np


class RawCache:
    """Materialised decoded samples, indexable like the source dataset."""

    def __init__(self, cache_dir: str, transform: Optional[Callable] = None):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.cache_dir = cache_dir
        self.transform = transform
        self.modals: List[str] = self.meta["modals"]
        self.n = self.meta["n"]
        self._arrays: Dict[str, np.ndarray] = {
            name: np.load(os.path.join(cache_dir, f"{name}.npy"), mmap_mode="r")
            for name in self.modals + ["mask"]
        }

    @classmethod
    def build(cls, dataset, cache_dir: str, transform: Optional[Callable] = None,
              force: bool = False) -> "RawCache":
        """Decode every raw (pre-transform) sample of ``dataset`` into memory
        maps, unless a cache is already there (``force`` rebuilds it).
        ``dataset`` exposes ``load_raw(i) -> (sample, mask)`` or a
        ``transform`` attribute that can be set to None."""
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path) and not force:
            return cls.open(cache_dir, transform)
        os.makedirs(cache_dir, exist_ok=True)
        n = len(dataset)
        writers: Dict[str, np.ndarray] = {}
        for i in range(n):
            sample, mask = _raw_item(dataset, i)
            sample = dict(sample, mask=mask)
            for name, arr in sample.items():
                if name not in writers:
                    small = arr.dtype == np.uint8 or (arr.min() >= 0 and arr.max() <= 255)
                    writers[name] = np.lib.format.open_memmap(
                        os.path.join(cache_dir, f"{name}.npy"), mode="w+",
                        dtype=np.uint8 if small else np.int32, shape=(n, *arr.shape))
                writers[name][i] = arr
        for w in writers.values():
            w.flush()
        modals = list(dataset.modals) if hasattr(dataset, "modals") else [
            m for m in writers if m != "mask"]
        with open(meta_path, "w") as f:
            json.dump({"n": n, "modals": modals}, f)
        return cls(cache_dir, transform)

    @classmethod
    def open(cls, cache_dir: str, transform: Optional[Callable] = None) -> "RawCache":
        return cls(cache_dir, transform)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        sample = {m: np.asarray(self._arrays[m][i]) for m in self.modals}
        sample["mask"] = np.asarray(self._arrays["mask"][i])
        if self.transform is not None:
            rng = np.random.default_rng(abs(hash((i, "cache"))) % (2**31))
            sample = self.transform(sample, rng)
        mask = sample.pop("mask")
        return sample, np.asarray(mask)


def _raw_item(dataset, i: int):
    """Sample i with the dataset's transform off."""
    if hasattr(dataset, "load_raw"):
        return dataset.load_raw(i)
    saved = getattr(dataset, "transform", None)
    try:
        dataset.transform = None
        return dataset[i]
    finally:
        dataset.transform = saved
