"""Streaming segmentation metrics over a (C, C) confusion matrix: IoU, F1
and pixel accuracy per class and their means.  Counterpart of
ir_ads_tpu/training/metrics.py.

The matrix stays on the predictions' device and is updated by one
``torch.bincount`` a batch, with an extra bucket for ignored pixels.  It
counts in int64: this is the JAX package's x64 form.  Without x64 the JAX
matrix counts in f32, whose counts stop being exact past 2^24 pixels in one
cell, which a full val split at 480x640 can reach (NYU: 654 images, 201 M
pixels).  Only ``compute_*`` brings the matrix to the host, as f64.

As in the JAX package, acc and F1 are the real statistics, not copies of
the IoU.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def update_confusion(pred: torch.Tensor, label: torch.Tensor, hist: torch.Tensor,
                     ignore_label: int) -> torch.Tensor:
    """hist + the confusion counts of (B, H, W) class predictions against
    labels (rows: label, columns: prediction); ``ignore_label`` pixels fall
    into an extra bucket that is dropped."""
    c = hist.shape[0]
    label = label.to(device=hist.device, dtype=torch.int64)
    pred = pred.to(device=hist.device, dtype=torch.int64)
    idx = torch.where(label != ignore_label, label * c + pred, c * c)
    counts = torch.bincount(idx.reshape(-1), minlength=c * c + 1)[: c * c]
    return hist + counts.reshape(c, c)


class Metrics:
    """Streaming IoU / F1 / pixel accuracy; the matrix lives on ``device``."""

    def __init__(self, num_classes: int, ignore_label: int = 255, device="cpu"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.hist = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                                device=device)

    def update(self, pred_or_logits: torch.Tensor, label) -> None:
        """pred_or_logits: (B, H, W) class ids or (B, H, W, C) logits or
        probabilities; label: (B, H, W) ints."""
        label = torch.as_tensor(label)
        if pred_or_logits.ndim == label.ndim + 1:
            pred = pred_or_logits.argmax(dim=-1)
        else:
            pred = pred_or_logits
        self.hist = update_confusion(pred, label, self.hist, self.ignore_label)

    def reset(self) -> None:
        self.hist = torch.zeros_like(self.hist)

    def _stats(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        hist = self.hist.cpu().numpy().astype(np.float64)
        tp = np.diag(hist)
        fp = hist.sum(0) - tp
        fn = hist.sum(1) - tp
        return tp, fp, fn

    def compute_iou(self) -> Tuple[List[float], float]:
        tp, fp, fn = self._stats()
        iou = tp / np.maximum(tp + fp + fn, 1e-8)
        return iou.tolist(), round(float(iou.mean()) * 100, 2)

    def compute_f1(self) -> Tuple[List[float], float]:
        tp, fp, fn = self._stats()
        f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-8)
        return (f1 * 100).round(2).tolist(), round(float(f1.mean()) * 100, 2)

    def compute_pixel_acc(self) -> Tuple[List[float], float]:
        tp, fp, fn = self._stats()
        acc = tp / np.maximum(tp + fn, 1e-8)
        return (acc * 100).round(2).tolist(), round(float(acc.mean()) * 100, 2)
