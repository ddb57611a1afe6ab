"""Data samplers: counterpart of ir_ads_tpu/detection/samplers.py
(reference detectron2/data/samplers/distributed_sampler.py: the infinite
shard-aware ``TrainingSampler``, ``RepeatFactorTrainingSampler``,
``InferenceSampler``; the aspect-ratio grouping of d2 build.py).

Index streams in numpy, drawn from ``np.random.default_rng(seed + epoch)``
as the JAX package draws them, so the same seed and shard give the same
stream.  The training stream's shard comes from explicit arguments, else
from ``torch.distributed``'s rank and world size where a process group is
initialised, else 0 of 1 (the JAX package reads ``jax.process_index()``
and ``jax.process_count()``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def default_shard() -> Tuple[int, int]:
    """(this process's shard, the number of shards): ``torch.distributed``'s
    rank and world size where a process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def training_sampler(
    size: int,
    shuffle: bool = True,
    seed: int = 0,
    shard_idx: Optional[int] = None,
    num_shards: Optional[int] = None,
) -> Iterator[int]:
    """Infinite shard-aware index stream (TrainingSampler:15-71): epoch e
    is a permutation from ``default_rng(seed + e)``, every ``num_shards``-th
    index of it from ``shard_idx`` on."""
    if shard_idx is None:
        shard_idx, num_shards = default_shard()
    epoch = 0
    while True:
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(size) if shuffle else np.arange(size)
        yield from order[shard_idx::num_shards].tolist()
        epoch += 1


def repeat_factors_from_category_frequency(
    annotations_per_image: Sequence[Sequence[int]],
    num_images: int,
    repeat_thresh: float = 0.001,
) -> np.ndarray:
    """Per-image repeat factors (RepeatFactorTrainingSampler's formula):
    r(c) = max(1, sqrt(t / f(c))), r(img) = max over its categories."""
    freq: Dict[int, float] = {}
    for cats in annotations_per_image:
        for c in set(cats):
            freq[c] = freq.get(c, 0) + 1
    freq = {c: n / num_images for c, n in freq.items()}
    rep = {c: max(1.0, math.sqrt(repeat_thresh / f)) for c, f in freq.items()}
    factors = np.ones(len(annotations_per_image))
    for i, cats in enumerate(annotations_per_image):
        if cats:
            factors[i] = max(rep[c] for c in set(cats))
    return factors


def repeat_factor_sampler(
    repeat_factors: np.ndarray,
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[int]:
    """Infinite stream with stochastic fractional repeats."""
    base = np.floor(repeat_factors).astype(int)
    frac = repeat_factors - base
    epoch = 0
    while True:
        rng = np.random.default_rng(seed + epoch)
        rounds = base + (rng.random(len(base)) < frac)
        idx = np.repeat(np.arange(len(base)), rounds)
        if shuffle:
            rng.shuffle(idx)
        yield from idx.tolist()
        epoch += 1


def inference_sampler(size: int, shard_idx: int = 0, num_shards: int = 1) -> Iterator[int]:
    """Deterministic contiguous sharding for eval (InferenceSampler:245)."""
    per = -(-size // num_shards)
    start = shard_idx * per
    return iter(range(start, min(start + per, size)))


def aspect_ratio_group_stream(
    indices: Iterator[int],
    aspect_wide: Sequence[bool],
    batch_size: int,
) -> Iterator[List[int]]:
    """Batches grouped by w > h against h >= w (d2
    AspectRatioGroupedDataset), so that padded batch shapes stay alike."""
    buckets: Dict[bool, List[int]] = {True: [], False: []}
    for i in indices:
        b = buckets[bool(aspect_wide[i])]
        b.append(i)
        if len(b) == batch_size:
            yield list(b)
            b.clear()
