"""PointSup, the point-supervised instance-segmentation loss: counterpart of
ir_ads_tpu/models/projects/pointsup.py (detectron2 projects/PointSup:
point_utils.py, MaskRCNNConvUpsamplePointSupHead's point loss).

Point labels: 0 background, 1 object, -1 ignored (outside the proposal).
The mask logits are sampled at the points with the detection criterion's
``sample_points`` (detectron2's point_sample).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ir_ads_tpu_torch.detection.criterion import sample_points


def get_point_coords_wrt_box(boxes: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """Image-space (R, P, 2) (x, y) points -> box-normalised [0, 1]^2;
    boxes (R, 4) xyxy."""
    x0, y0, x1, y1 = (boxes[:, i:i + 1] for i in range(4))
    px = (point_coords[..., 0] - x0) / (x1 - x0).clamp(min=1e-6)
    py = (point_coords[..., 1] - y0) / (y1 - y0).clamp(min=1e-6)
    return torch.stack([px, py], -1)


def annotation_points_to_labels(boxes: torch.Tensor, point_coords: torch.Tensor,
                                point_labels: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Annotated points in box space, those outside the box labelled -1."""
    coords = get_point_coords_wrt_box(boxes, point_coords)
    outside = ((coords[..., 0] < 0) | (coords[..., 0] > 1)
               | (coords[..., 1] < 0) | (coords[..., 1] > 1))
    labels = torch.where(outside, torch.full_like(coords[..., 0], -1.0), point_labels.float())
    return coords, labels


def point_sup_mask_loss(mask_logits: torch.Tensor, point_coords: torch.Tensor,
                        point_labels: torch.Tensor) -> torch.Tensor:
    """BCE of the mask logits (R, Hm, Wm) sampled at the (R, P, 2) [0, 1]
    points against their labels, label -1 ignored."""
    logits = sample_points(mask_logits.float(), point_coords)
    labels = point_labels.float()
    weight = (labels >= 0).float()
    tgt = labels.clamp(0.0, 1.0)
    bce = logits.clamp(min=0.0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))
    return (bce * weight).sum() / weight.sum().clamp(min=1.0)
