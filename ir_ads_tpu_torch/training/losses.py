"""Segmentation losses.  Counterpart of ir_ads_tpu/training/losses.py.

Every loss takes NHWC logits (B, H, W, C) and integer labels (B, H, W),
computes in f32, and leaves the ignore label out of both the numerator and
the averaging denominator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int):
    """Per-pixel negative log-likelihood of the label (0 where ignored) and
    the validity mask."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid, safe


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE over non-ignored pixels: weighted sum / sum of weights."""
    nll, valid, safe = _nll(logits, labels, ignore_label)
    w = valid.float()
    if class_weights is not None:
        w = w * class_weights.float().to(nll.device)[safe]
    return (nll * w).sum() / w.sum().clamp(min=1e-8)


def ohem_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    thresh: float = 0.7,
    min_kept_frac: float = 1.0 / 16.0,
) -> torch.Tensor:
    """Online hard example mining CE: the mean over pixels whose loss is
    above -log(thresh); if fewer than n_valid * min_kept_frac are, the mean
    of that many hardest pixels instead.  Both means are computed and one
    selected, so nothing is read back to the host."""
    nll, valid, _ = _nll(logits, labels, ignore_label)
    nll, valid = nll.reshape(-1), valid.reshape(-1)
    loss_thresh = -torch.log(torch.tensor(thresh, dtype=torch.float32, device=nll.device))
    n_min = (valid.sum() * min_kept_frac).to(torch.int32)
    hard = nll > loss_thresh
    n_hard = hard.sum()
    mean_hard = torch.where(hard, nll, torch.zeros_like(nll)).sum() / n_hard.clamp(min=1)
    sorted_nll = torch.sort(nll, descending=True).values
    ranks = torch.arange(sorted_nll.shape[0], device=nll.device)
    topk_mean = torch.where(ranks < n_min, sorted_nll, torch.zeros_like(nll)).sum() / (
        n_min.clamp(min=1))
    return torch.where(n_hard < n_min, topk_mean, mean_hard)


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    delta: float = 0.5,
) -> torch.Tensor:
    """Tversky/dice loss with the ignored pixels masked out."""
    num_classes = logits.shape[-1]
    valid = (labels != ignore_label)[..., None].float()
    probs = torch.softmax(logits.float(), dim=-1) * valid
    safe = torch.where(labels != ignore_label, labels, torch.zeros_like(labels)).long()
    onehot = F.one_hot(safe, num_classes).float() * valid
    tp = (onehot * probs).sum(dim=(1, 2))
    fn = (onehot * (1 - probs)).sum(dim=(1, 2))
    fp = ((1 - onehot) * probs).sum(dim=(1, 2))
    dice = (tp + 1e-6) / (tp + delta * fn + (1 - delta) * fp + 1e-6)
    return ((1 - dice).sum(dim=-1) / num_classes).mean()


LOSSES = {
    "CrossEntropy": cross_entropy,
    "OhemCrossEntropy": ohem_cross_entropy,
    "Dice": dice_loss,
}


def get_loss(name: str) -> Callable:
    if name not in LOSSES:
        raise ValueError(f"Unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]
