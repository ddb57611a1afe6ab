"""Host-side eval transforms (numpy; PIL only where a resize resamples).

Counterpart of the eval half of ir_ads_tpu/data/augmentations.py: samples
are dicts of modality name -> HWC uint8 array plus 'mask' -> HW int array;
``Resize`` scales the short side to the target and aligns both sides up to
a multiple of 32; ``Normalize`` gives 'img' the ImageNet statistics and the
other modalities a plain /255.  ``device_normalize`` is the same
normalisation for uint8 batches already on the device.  The random training
transforms are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Sample = Dict[str, np.ndarray]

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _resize(arr: np.ndarray, size: Tuple[int, int], nearest: bool,
            box: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """PIL resize to size = (H, W) of an HWC uint8 image or an HW int label
    map (nearest); an array already at the size comes back as it is."""
    h, w = size
    if box is None and arr.shape[:2] == (h, w):
        return arr
    from PIL import Image

    if arr.ndim == 2:
        # labels in [0, 255] resample as "L" (the same source pixels as "I")
        if arr.min() >= 0 and arr.max() <= 255:
            im = Image.fromarray(arr.astype(np.uint8), mode="L")
        else:
            im = Image.fromarray(arr.astype(np.int32), mode="I")
        return np.asarray(im.resize((w, h), Image.NEAREST, box=box)).astype(arr.dtype)
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if arr.dtype == np.uint8 and arr.shape[-1] == 3:
        return np.asarray(Image.fromarray(arr).resize((w, h), mode, box=box))
    chans = [np.asarray(Image.fromarray(arr[..., c]).resize((w, h), mode, box=box))
             for c in range(arr.shape[-1])]
    return np.stack(chans, axis=-1)


def resize_sample(sample: Sample, size: Tuple[int, int]) -> Sample:
    return {k: _resize(v, size, nearest=(k == "mask")) for k, v in sample.items()}


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class Resize:
    """Scale so that the short side is size[0], then align both sides up to
    a multiple of 32."""

    def __init__(self, size: Sequence[int]):
        self.size = size

    def __call__(self, sample: Sample, rng=None) -> Sample:
        h, w = sample["img"].shape[:2]
        scale = self.size[0] / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        sample = resize_sample(sample, (nh, nw))
        ah, aw = math.ceil(nh / 32) * 32, math.ceil(nw / 32) * 32
        if (ah, aw) != (nh, nw):
            sample = resize_sample(sample, (ah, aw))
        return sample


class Normalize:
    """img -> /255 and the ImageNet statistics; other modalities -> /255;
    the mask untouched."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Sample, rng=None) -> Sample:
        out = {}
        for k, v in sample.items():
            if k == "mask":
                out[k] = v
            elif k == "img":
                out[k] = (v.astype(np.float32) / 255.0 - self.mean) / self.std
            else:
                out[k] = v.astype(np.float32) / 255.0
        return out


def get_val_augmentation(size: Sequence[int]) -> Compose:
    return Compose([Resize(size), Normalize()])


def get_val_augmentation_device_norm(size: Sequence[int]) -> Compose:
    """The val pipeline without Normalize: batches stay uint8 and
    ``device_normalize`` runs on the device, with the same numbers."""
    return Compose([Resize(size)])


def device_normalize(x: torch.Tensor, modal: str = "img") -> torch.Tensor:
    """Normalize of a (B, H, W, C) uint8 or float batch on its device, in
    f32: 'img' gets /255 and the ImageNet statistics, other modalities /255."""
    x = x.float() / 255.0
    if modal == "img":
        x = (x - torch.as_tensor(IMAGENET_MEAN, device=x.device)) / torch.as_tensor(
            IMAGENET_STD, device=x.device)
    return x
