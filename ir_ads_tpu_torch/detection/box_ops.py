"""Box utilities: counterpart of ir_ads_tpu/detection/box_ops.py."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _inter_union(a: torch.Tensor, b: torch.Tensor):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, box_area(a)[:, None] + box_area(b)[None, :] - inter


def box_iou(a: torch.Tensor, b: torch.Tensor):
    """Pairwise IoU: a (N, 4), b (M, 4) xyxy -> (iou (N, M), union (N, M))."""
    inter, union = _inter_union(a, b)
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU, xyxy."""
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def elementwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU for matched pairs, xyxy (..., 4)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / union.clamp(min=1e-9)
    lt_c = torch.minimum(a[..., :2], b[..., :2])
    rb_c = torch.maximum(a[..., 2:], b[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp(min=1e-9)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, 4) xyxy; an empty mask gives zeros."""
    _, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    on = masks.float() > 0
    big = 1e8
    x_min = torch.where(on, xs, big).amin(dim=(1, 2))
    x_max = torch.where(on, xs, -big).amax(dim=(1, 2))
    y_min = torch.where(on, ys, big).amin(dim=(1, 2))
    y_max = torch.where(on, ys, -big).amax(dim=(1, 2))
    out = torch.stack([x_min, y_min, x_max, y_max], -1)
    return torch.where(on.flatten(1).any(1)[:, None], out, torch.zeros_like(out))
