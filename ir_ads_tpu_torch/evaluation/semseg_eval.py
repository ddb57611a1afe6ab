"""Sliding-window semantic-segmentation predictor with flip ensembling.

Counterpart of ``make_sliding_window_fn(..., fuse=True)`` in
ir_ads_tpu/evaluation/semseg_eval.py: every tile of every image goes through
one batched forward, the horizontal flip doubles the batch, and when the
model returns the heads' native low-resolution logits the flip ensemble is
summed at that resolution and upsampled once (exact by linearity, see
tests/test_eval_lowres.py).  Overlapping tiles are averaged.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.ops.layers import resize_bilinear


def tile_grid(size: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering [0, size), the last one right-aligned."""
    if size <= tile:
        return [0]
    n = int(math.ceil((size - tile) / stride)) + 1
    return sorted({min(i * stride, size - tile) for i in range(n)})


def flip_w(t: torch.Tensor, cf: int) -> torch.Tensor:
    """Horizontal flip of (N, H, W, C) tiles, or of flat (N, H, W*cf) rows
    as W-groups of cf."""
    if t.ndim == 4:
        return t.flip(2)
    n, h, wc = t.shape
    return t.reshape(n, h, wc // cf, cf).flip(2).reshape(n, h, wc)


def make_sliding_window_fn(
    forward: Callable,
    image_size: Tuple[int, int],
    tile_size: Tuple[int, int],
    num_classes: int,
    overlap: float = 1.0 / 3.0,
    flip: bool = True,
) -> Callable:
    """Returns predict(rgb, dte) -> (B, H, W, num_classes) f32 logits.
    ``forward(rgb, dte)`` maps (N, th, tw, 3) tiles to fused-head logits at
    tile or at head resolution.  ``predict`` also takes flat (B, H, W*3)
    rows, and hands ``forward`` flat (N, th, tw*3) tiles."""
    h, w = image_size
    th, tw = tile_size
    ys = tile_grid(h, th, int(math.ceil(th * (1 - overlap))))
    xs = tile_grid(w, tw, int(math.ceil(tw * (1 - overlap))))
    offsets = [(y, x) for y in ys for x in xs]
    pad_h, pad_w = max(0, th - h), max(0, tw - w)

    def predict(rgb: torch.Tensor, dte: torch.Tensor) -> torch.Tensor:
        b = rgb.shape[0]
        # rank 3: flat (B, H, W*cf) rows, the bench's feed; W offsets and
        # padding scale by the channel factor cf, the flip reverses W-groups
        # of cf (the reference's ``flip_w``)
        flat = rgb.ndim == 3
        cf = rgb.shape[-1] // w if flat else 1
        if pad_h or pad_w:
            pad = (0, pad_w * cf, 0, pad_h) if flat else (0, 0, 0, pad_w, 0, pad_h)
            rgb, dte = F.pad(rgb, pad), F.pad(dte, pad)
        tiles_rgb = torch.cat([rgb[:, y:y + th, x * cf:(x + tw) * cf] for y, x in offsets])
        tiles_dte = torch.cat([dte[:, y:y + th, x * cf:(x + tw) * cf] for y, x in offsets])
        m = tiles_rgb.shape[0]
        if flip:
            tiles_rgb = torch.cat([tiles_rgb, flip_w(tiles_rgb, cf)])
            tiles_dte = torch.cat([tiles_dte, flip_w(tiles_dte, cf)])
        out = forward(tiles_rgb, tiles_dte)
        if flip:
            out = out[:m] + out[m:].flip(2)
        out = resize_bilinear(out.float(), (th, tw), align_corners=False)
        logits = out.reshape(len(offsets), b, th, tw, num_classes)
        if len(offsets) == 1:
            return logits[0][:, :h, :w]
        total = rgb.new_zeros((b, h + pad_h, w + pad_w, num_classes), dtype=torch.float32)
        count = rgb.new_zeros((h + pad_h, w + pad_w, 1), dtype=torch.float32)
        for i, (y, x) in enumerate(offsets):
            total[:, y:y + th, x:x + tw] += logits[i]
            count[y:y + th, x:x + tw] += 1.0
        return (total / count)[:, :h, :w]

    return predict
