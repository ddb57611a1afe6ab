"""Detection-side host augmentations: counterpart of
ir_ads_tpu/detection/transforms.py (reference detectron2/data/transforms:
ResizeShortestEdge, RandomFlip; detrex ColorAugSSDTransform).

numpy and PIL on the host, on (image HWC uint8, boxes xyxy absolute)
pairs, as ``detection/data.py`` works.  Every random choice draws from the
numpy ``Generator`` the caller passes, in the JAX package's order, so the
same generator gives the same images and boxes bit for bit.  PIL is
imported on first use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _image():
    from PIL import Image

    return Image


def resize_shortest_edge(
    img: np.ndarray,
    boxes: Optional[np.ndarray],
    short: int,
    max_size: int = 1333,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Scale so that the shorter side is ``short``, capped by ``max_size``
    (d2 ResizeShortestEdge); PIL's bilinear resize."""
    Image = _image()
    h, w = img.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    if boxes is not None:
        boxes = boxes.astype(np.float32) * scale
    return out, boxes


def random_flip(
    img: np.ndarray, boxes: Optional[np.ndarray], rng: np.random.Generator, p: float = 0.5
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A horizontal flip with probability ``p``, the boxes mirrored."""
    if rng.random() >= p:
        return img, boxes
    w = img.shape[1]
    img = img[:, ::-1].copy()
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def color_aug_ssd(img: np.ndarray, rng: np.random.Generator,
                  brightness_delta: int = 32,
                  contrast_range: Tuple[float, float] = (0.5, 1.5),
                  saturation_range: Tuple[float, float] = (0.5, 1.5),
                  hue_delta: int = 18) -> np.ndarray:
    """SSD-style photometric distortion (detrex ColorAugSSDTransform):
    brightness, contrast before or after, saturation and hue in PIL's HSV."""
    Image = _image()
    img = img.astype(np.float32)
    if rng.random() < 0.5:  # brightness
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    contrast_first = rng.random() < 0.5
    if contrast_first and rng.random() < 0.5:
        img = img * rng.uniform(*contrast_range)

    img = np.clip(img, 0, 255).astype(np.uint8)
    hsv = np.asarray(Image.fromarray(img).convert("HSV")).astype(np.float32)
    if rng.random() < 0.5:
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation_range), 0, 255)
    if rng.random() < 0.5:
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 256
    img = np.asarray(
        Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    ).astype(np.float32)

    if not contrast_first and rng.random() < 0.5:
        img = img * rng.uniform(*contrast_range)
    return np.clip(img, 0, 255).astype(np.uint8)
