"""Spatial sharding with a halo exchange: counterpart of
ir_ads_tpu/parallel/halo.py, on one host.

The JAX package runs one H-sharded forward over its mesh's ``space`` axis
under ``shard_map``, each shard trading ``halo`` boundary rows with its
neighbours by ``ppermute``.  Here the shard count ``n`` and the devices are
given: the image is split along H into ``n`` strips, each strip padded with
``halo`` rows from its neighbours (zeros at the image's top and bottom),
``fn`` runs on each haloed strip on its device (that card the current one,
so that a kernel launches on its stream), the halo is cropped off and the
strips are concatenated on the input's device.  With ``n = 1`` the one
strip is the image with ``halo`` zero rows above and below, which is what
JAX's one-device mesh computes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch


def halo_exchange(strips: Sequence[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Each (B, h, W, C) strip with ``halo`` rows of its upper and lower
    neighbours above and below it, zeros past the image's edges: (B, h +
    2 * halo, W, C).  The neighbours' rows are copied to the strip's
    device.  A halo taller than a strip raises, as ``ppermute`` reaches only
    the immediate neighbours."""
    h = strips[0].shape[1]
    if halo > h:
        raise ValueError(f"halo ({halo}) exceeds the local shard height ({h}); a strip's "
                         "halo comes from its immediate neighbours only: use fewer shards "
                         "or a smaller halo")
    out = []
    for i, s in enumerate(strips):
        zeros = s.new_zeros(s.shape[0], halo, *s.shape[2:])
        above = strips[i - 1][:, h - halo:].to(s.device) if i > 0 else zeros
        below = strips[i + 1][:, :halo].to(s.device) if i < len(strips) - 1 else zeros
        out.append(torch.cat([above, s, below], 1))
    return out


def spatial_shard_apply(fn: Callable, n: int, halo: int,
                        devices: Optional[Sequence] = None) -> Callable:
    """``fn`` (B, h + 2 * halo, W, C) -> (B, h + 2 * halo, W, K), wrapped to
    run H-sharded in ``n`` strips (strip i on ``devices[i]``, default the
    input's device) with the halo exchanged and cropped.  ``devices`` holds
    one device a strip and H must divide by ``n``; the output is on the
    input's device."""
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} strips: give one a strip")

    def sharded(x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % n:
            raise ValueError(f"H ({x.shape[1]}) does not divide into {n} strips")
        devs = [x.device] * n if devices is None else [torch.device(d) for d in devices]
        strips = [s.to(d) for s, d in zip(x.chunk(n, 1), devs)]
        outs = []
        for p in halo_exchange(strips, halo):
            # a kernel launches on the current card's stream: make it the strip's
            with torch.cuda.device(p.device) if p.is_cuda else contextlib.nullcontext():
                outs.append(fn(p)[:, halo:p.shape[1] - halo])
        return torch.cat([o.to(x.device) for o in outs], 1)

    return sharded
