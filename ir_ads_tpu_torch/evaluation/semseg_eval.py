"""Segmentation evaluation: the eval forward, single-scale, multi-scale +
flip (MSF) and sliding-window prediction, and the loop over batches.
Counterpart of ir_ads_tpu/evaluation/semseg_eval.py.

``make_forward_fn`` runs the backbone and the fused head only, which is
what the JAX eval forward computes once XLA drops the two unused heads.

``make_sliding_window_fn``: every tile of every image goes through one
batched forward, the horizontal flip doubles the batch, and when the model
returns the heads' native low-resolution logits the flip ensemble is summed
at that resolution in the model's dtype and upsampled once in f32 (exact by
linearity, see tests/test_eval_lowres.py).  Overlapping tiles are averaged.
Its numbers are those of both JAX forms, ``fuse=True`` and the split form
``val_mm.py`` runs.

``msf_logits`` keeps the JAX function's two-stage resize of head-native
logits (align_corners=False up to the scaled size, then align_corners=True
to the full size, each in the logits' dtype), then an f32 softmax; the flip
is batch doubling, its probabilities summed after the softmax.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.data.augmentations import device_normalize
from ir_ads_tpu_torch.ops.layers import resize_bilinear

MSF_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


def make_forward_fn(model, device_norm: bool = False) -> Callable:
    """(rgb, dte) -> fused-head logits of the eval-mode CMNeXt or
    CMNeXtLegacy ``model``, with no autograd; the inputs are cast to the
    model's compute dtype (its classifier's).  ``device_norm``: the inputs
    are (B, H, W, 3) uint8 batches on the device, normalised there (pairs
    with ``augmentations.get_val_augmentation_device_norm``)."""
    dtype = model.decode_head.linear_pred.weight.dtype

    def forward(rgb: torch.Tensor, dte: torch.Tensor) -> torch.Tensor:
        if device_norm:
            rgb, dte = device_normalize(rgb, "img"), device_normalize(dte, "depth")
        with torch.no_grad():
            return model.forward_fused(rgb.to(dtype), dte.to(dtype))

    return forward


def align32(v: float) -> int:
    return int(math.ceil(v / 32.0)) * 32


def msf_logits(forward: Callable, rgb: torch.Tensor, dte: torch.Tensor,
               scales: Sequence[float] = MSF_SCALES, flip: bool = True) -> torch.Tensor:
    """Multi-scale (+ flip) ensembled class probabilities (B, H, W, K), f32:
    at each scale the inputs resized (align_corners=True) to the scaled size
    rounded up to a multiple of 32, the flip as a doubled batch through one
    forward, the logits resized to the full size and softmaxed in f32, and
    the probabilities summed over scales and flips."""
    b, h, w = rgb.shape[:3]
    acc = None
    for s in scales:
        nh, nw = align32(s * h), align32(s * w)
        srgb = resize_bilinear(rgb, (nh, nw), align_corners=True)
        sdte = resize_bilinear(dte, (nh, nw), align_corners=True)
        if flip:
            srgb = torch.cat([srgb, srgb.flip(2)])
            sdte = torch.cat([sdte, sdte.flip(2)])
        logits = forward(srgb, sdte)
        if flip:
            logits = torch.cat([logits[:b], logits[b:].flip(2)])
        if logits.shape[1:3] != (nh, nw):
            # head-native logits: the model's own upsample to the scaled
            # size first, then the MSF resize; one resize would differ
            logits = resize_bilinear(logits, (nh, nw), align_corners=False)
        logits = resize_bilinear(logits, (h, w), align_corners=True)
        probs = torch.softmax(logits.float(), dim=-1)
        if flip:
            probs = probs[:b] + probs[b:]
        acc = probs if acc is None else acc + probs
    return acc


def evaluate(forward: Callable, batches: Iterable, metrics, msf: bool = False,
             scales: Sequence[float] = MSF_SCALES, flip: bool = True,
             timings: Optional[List[float]] = None):
    """Update ``metrics`` over (rgb, dte, label) batches: MSF probabilities,
    or the single-scale forward's (its head-native logits upsampled to the
    input's size first, as the model's own upsample does).  With
    ``timings`` each batch's seconds, up to a device synchronize, are
    appended to it."""
    for rgb, dte, label in batches:
        t0 = time.perf_counter()
        if msf:
            probs = msf_logits(forward, rgb, dte, scales, flip)
        else:
            logits = forward(rgb, dte)
            if logits.shape[1:3] != rgb.shape[1:3]:
                logits = resize_bilinear(logits, rgb.shape[1:3], align_corners=False)
            probs = torch.softmax(logits.float(), dim=-1)
        metrics.update(probs.argmax(dim=-1), label)
        if timings is not None:
            if probs.is_cuda:
                torch.cuda.synchronize()
            timings.append(time.perf_counter() - t0)
    return metrics


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


def make_spatial_sharded_forward(forward: Callable, n: int, halo: int,
                                 devices: Optional[Sequence] = None) -> Callable:
    """predict(*mods) -> ``forward`` run H-sharded in ``n`` strips, each
    with ``halo`` rows of its neighbours (zeros past the image), the halo
    cropped off (``parallel.halo.spatial_shard_apply``).  ``forward`` maps a
    (B, h + 2 * halo, W, sum C) strip of the modalities packed along
    channels to (B, h + 2 * halo, W, K) logits.

    Whole-image equality holds at the strips' inner boundaries when the
    halo covers the network's receptive field (conv stacks, shifted windows
    of bounded reach); the image's outer bands see zeros where the whole
    image wraps its shifted windows.  A DSCF model (CMNeXt) samples over its
    whole input in the strip's normalised coordinates, so no halo covers it:
    its contract is tile equivalence, each strip's output equal to the
    model's on that strip's haloed crop (the JAX package's
    ``make_spatial_sharded_forward`` docstring).  H must divide by ``n``."""
    from ir_ads_tpu_torch.parallel.halo import spatial_shard_apply

    sharded = spatial_shard_apply(forward, n, halo, devices)

    def predict(*mods: torch.Tensor) -> torch.Tensor:
        return sharded(mods[0] if len(mods) == 1 else torch.cat(mods, -1))

    return predict
