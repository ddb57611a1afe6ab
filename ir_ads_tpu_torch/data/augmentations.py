"""Host-side transforms (numpy; PIL only where a resize resamples).

Counterpart of ir_ads_tpu/data/augmentations.py: samples are dicts of
modality name -> HWC uint8 array plus 'mask' -> HW int array.  Eval:
``Resize`` scales the short side to the target and aligns both sides up to
a multiple of 32; ``Normalize`` gives 'img' the ImageNet statistics and the
other modalities a plain /255; ``device_normalize`` is the same
normalisation for uint8 batches already on the device.  Train
(``get_train_augmentation``): colour jitter and blur on 'img' only, a
horizontal flip and a random resized crop of every modality and the mask,
each drawing from the ``np.random.Generator`` it is handed, in the JAX
package's order of draws, so that the same generator gives the same sample
bit for bit.  The datasets seed that generator from ``hash((index,
split))`` (``datasets.SegDataset.__getitem__``), as the reference does: a
process draws the same augmentation for a sample in every epoch, and the
draw follows ``PYTHONHASHSEED``.
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


class RandomResizedCrop:
    """A random scale in [lo, hi], resize, a random crop, and a bottom-right
    pad (image 0, mask ``seg_fill``) where the resized map is smaller than
    the crop.  The resize and the crop are one PIL ``resize(box=...)`` of
    the crop's window, the reference's fused form."""

    def __init__(self, size, scale=(0.5, 2.0), seg_fill=255):
        self.size = tuple(size)
        self.scale = scale
        self.seg_fill = seg_fill

    def __call__(self, sample: Sample, rng) -> Sample:
        h, w = sample["img"].shape[:2]
        th, tw = self.size
        ratio = rng.random() * (self.scale[1] - self.scale[0]) + self.scale[0]
        scale = (int(th * ratio), int(tw * 4 * ratio))
        factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
        nh, nw = int(h * factor + 0.5), int(w * factor + 0.5)
        y1 = int(rng.integers(0, max(nh - th, 0) + 1))
        x1 = int(rng.integers(0, max(nw - tw, 0) + 1))
        ch, cw = min(th, nh - y1), min(tw, nw - x1)
        box = (x1 * w / nw, y1 * h / nh, (x1 + cw) * w / nw, (y1 + ch) * h / nh)
        sample = {k: _resize(v, (ch, cw), nearest=(k == "mask"), box=box)
                  for k, v in sample.items()}
        if (ch, cw) == (th, tw):
            return sample
        pads = ((0, th - ch), (0, tw - cw))
        return {k: np.pad(v, pads if v.ndim == 2 else pads + ((0, 0),),
                          constant_values=self.seg_fill if k == "mask" else 0)
                for k, v in sample.items()}


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample: Sample, rng) -> Sample:
        if rng.random() < self.p:
            return {k: np.ascontiguousarray(v[:, ::-1]) for k, v in sample.items()}
        return sample


def _to_gray(img: np.ndarray) -> np.ndarray:
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(
        np.float32)


class RandomColorJitter:
    """Brightness, contrast and saturation, each a factor uniform in [0.5,
    1.5] when the transform fires; every factor and the mean gray are f32
    scalars, so that the image stays f32 (a float64 scalar would widen it
    and move bits)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample: Sample, rng) -> Sample:
        if rng.random() >= self.p:
            return sample
        img = sample["img"].astype(np.float32)
        b = np.float32(rng.uniform(0.5, 1.5))
        img = np.clip(img * b, 0, 255)
        c = np.float32(rng.uniform(0.5, 1.5))
        mean_gray = np.float32(_to_gray(img).mean())
        img = np.clip(c * img + (1 - c) * mean_gray, 0, 255)
        s = np.float32(rng.uniform(0.5, 1.5))
        img = np.clip(s * img + (1 - s) * _to_gray(img)[..., None], 0, 255)
        return {**sample, "img": img.astype(np.uint8)}


class RandomGaussianBlur:
    """A separable Gaussian of ``kernel_size`` taps (sigma from the size, as
    OpenCV's default), reflect padding, as sums of shifted slices."""

    def __init__(self, kernel_size=3, p=0.5):
        self.k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self.p = p
        sigma = 0.3 * ((self.k - 1) * 0.5 - 1) + 0.8
        xs = np.arange(self.k) - (self.k - 1) / 2.0
        kern = np.exp(-(xs ** 2) / (2 * sigma ** 2))
        self.kern = (kern / kern.sum()).astype(np.float32)

    def __call__(self, sample: Sample, rng) -> Sample:
        if rng.random() >= self.p:
            return sample
        img = sample["img"].astype(np.float32)
        r = self.k // 2
        p = np.pad(img, ((r, r), (0, 0), (0, 0)), mode="reflect")
        img = sum(self.kern[t] * p[t:t + img.shape[0]] for t in range(self.k))
        p = np.pad(img, ((0, 0), (r, r), (0, 0)), mode="reflect")
        img = sum(self.kern[t] * p[:, t:t + img.shape[1]] for t in range(self.k))
        return {**sample, "img": np.clip(img, 0, 255).astype(np.uint8)}


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


def get_train_augmentation(size: Sequence[int], seg_fill: int = 255) -> Compose:
    """The training pipeline, in the reference's order."""
    return Compose([
        RandomColorJitter(p=0.2),
        RandomHorizontalFlip(p=0.5),
        RandomGaussianBlur(3, p=0.2),
        RandomResizedCrop(size, scale=(0.5, 2.0), seg_fill=seg_fill),
        Normalize(),
    ])


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
