"""Rotated-box ops and ROI align: counterpart of
ir_ads_tpu/detection/rotated_boxes.py (detectron2's box_iou_rotated,
nms_rotated and ROIAlign / ROIAlignRotated).

Boxes are (cx, cy, w, h, angle in degrees, counter-clockwise).  The rotated
IoU clips one quad by the other's four half-planes (Sutherland-Hodgman) in a
padded buffer of ``MAX_VERTS`` vertices, every pair of boxes at once.

Both ROI aligns sample the (B, H, W, C) map where each ROI's batch index
points (``ops.grid_sample.grid_sample(..., batch_idx=)``): the reference's
``grid_sample(features[batch_idx], grid)`` is the same function, but built
eagerly its (R, H, W, C) copy would be 16-32 GB at a P2 level of 800x1216
with 512 proposals.  aligned=True, ``sampling_ratio`` 2, the normalised
coordinates formed as the reference forms them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.ops.grid_sample import grid_sample

MAX_VERTS = 16  # >= 8; padded polygon buffer


def box_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) -> (N, 4, 2) corner points (counter-clockwise)."""
    cx, cy, w, h, ang = boxes.split(1, dim=-1)
    theta = ang * (math.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    dx = torch.cat([-w, w, w, -w], -1) * 0.5  # (N, 4)
    dy = torch.cat([-h, -h, h, h], -1) * 0.5
    x = cx + dx * c - dy * s
    y = cy + dx * s + dy * c
    return torch.stack([x, y], dim=-1)


def _polygon_area(verts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace over the first ``n`` vertices; verts (P, MAX, 2), n (P,)."""
    idx = torch.arange(MAX_VERTS, device=verts.device)
    nxt = torch.where(idx + 1 < n[:, None], idx + 1, 0)
    x, y = verts[..., 0], verts[..., 1]
    cross = x * torch.gather(y, 1, nxt) - torch.gather(x, 1, nxt) * y
    cross = torch.where(idx < n[:, None], cross, torch.zeros_like(cross))
    return 0.5 * cross.sum(-1).abs()


def _clip_halfplane(verts, n, a, b):
    """Clip each polygon (verts (P, MAX, 2), n valid) by the half-plane left
    of its edge a -> b (P, 2)."""
    edge = b - a
    idx = torch.arange(MAX_VERTS, device=verts.device)
    nxt = torch.where(idx + 1 < n[:, None], idx + 1, 0)
    nx = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def side(p):
        return (edge[:, None, 0] * (p[..., 1] - a[:, None, 1])
                - edge[:, None, 1] * (p[..., 0] - a[:, None, 0]))

    s_cur, s_nxt = side(verts), side(nx)
    inside_cur, inside_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = verts + t[..., None] * (nx - verts)

    # per input edge up to two points: the vertex (inside), the crossing
    live = idx < n[:, None]
    emit = torch.cat([inside_cur & live, (inside_cur != inside_nxt) & live], 1)
    pts = torch.cat([verts, inter], 1)  # (P, 2 MAX, 2)
    order = torch.cat([2 * idx, 2 * idx + 1])  # interleaved
    key = torch.where(emit, order, 10_000 + order)  # compact: emitted first, in order
    perm = torch.argsort(key, dim=1, stable=True)[:, :MAX_VERTS]
    pts = torch.gather(pts, 1, perm[..., None].expand(-1, -1, 2))
    return pts, emit.sum(1).clamp(max=MAX_VERTS)


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of quads c1[p] and c2[p], corners (P, 4, 2)."""
    verts = torch.zeros(c1.shape[0], MAX_VERTS, 2, dtype=c1.dtype, device=c1.device)
    verts[:, :4] = c1
    n = torch.full((c1.shape[0],), 4, dtype=torch.long, device=c1.device)
    for i in range(4):
        verts, n = _clip_halfplane(verts, n, c2[:, i], c2[:, (i + 1) % 4])
    area = _polygon_area(verts, n)
    return torch.where(n >= 3, area, torch.zeros_like(area))


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated IoU: (N, 5) x (M, 5) -> (N, M)."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = box_to_corners(boxes1)
    c2 = box_to_corners(boxes2)
    inter = _intersection_area(c1[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2),
                               c2[None].expand(n, m, 4, 2).reshape(-1, 4, 2)).reshape(n, m)
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    union = area1[:, None] + area2[None] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(union))


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy rotated NMS; the keep mask (N,) by original index.  The greedy
    pass runs on the host over the IoU matrix, as ``dino.nms_topk``'s."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True)[1]  # jnp.argsort's order
    sorted_boxes = boxes[order]
    over = (box_iou_rotated(sorted_boxes, sorted_boxes) > iou_threshold).cpu().numpy()
    keep_sorted = np.ones(n, dtype=bool)
    later = np.arange(n)
    for i in range(n):
        if keep_sorted[i]:
            keep_sorted &= ~(over[i] & (later > i))
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def roi_align(
    features: torch.Tensor,  # (B, H, W, C)
    boxes: torch.Tensor,  # (R, 5): (batch_idx, x1, y1, x2, y2) in input coords
    output_size: Tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """ROIAlign (detectron2 layers/roi_align.py semantics): (R, oh, ow, C)."""
    oh, ow = output_size
    b, h, w, c = features.shape
    offset = 0.5 if aligned else 0.0
    boxes = boxes.float()
    x1 = boxes[:, 1] * spatial_scale - offset
    y1 = boxes[:, 2] * spatial_scale - offset
    x2 = boxes[:, 3] * spatial_scale - offset
    y2 = boxes[:, 4] * spatial_scale - offset
    roi_w = (x2 - x1).clamp(min=1e-6)
    roi_h = (y2 - y1).clamp(min=1e-6)

    sr = sampling_ratio
    dev = features.device
    ys = (torch.arange(oh * sr, device=dev) + 0.5) / sr  # bin-relative
    xs = (torch.arange(ow * sr, device=dev) + 0.5) / sr
    gy = y1[:, None] + roi_h[:, None] * ys[None] / oh  # (R, oh*sr)
    gx = x1[:, None] + roi_w[:, None] * xs[None] / ow
    # normalised to [-1, 1] (align_corners=True on pixel centres)
    ny = gy / max(h - 1, 1) * 2 - 1
    nx = gx / max(w - 1, 1) * 2 - 1
    r = boxes.shape[0]
    grid = torch.stack([nx[:, None, :].expand(r, oh * sr, ow * sr),
                        ny[:, :, None].expand(r, oh * sr, ow * sr)], -1)
    sampled = grid_sample(features, grid, align_corners=True,
                          batch_idx=boxes[:, 0].long())
    return sampled.reshape(r, oh, sr, ow, sr, c).mean((2, 4))


def roi_align_rotated(
    features: torch.Tensor,  # (B, H, W, C)
    boxes: torch.Tensor,  # (R, 6): (batch_idx, cx, cy, w, h, angle_deg)
    output_size: Tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """ROIAlignRotated (detectron2 csrc/ROIAlignRotated): (R, oh, ow, C)."""
    oh, ow = output_size
    b, h, w, c = features.shape
    boxes = boxes.float()
    cx = boxes[:, 1] * spatial_scale - 0.5
    cy = boxes[:, 2] * spatial_scale - 0.5
    rw = boxes[:, 3] * spatial_scale
    rh = boxes[:, 4] * spatial_scale
    theta = boxes[:, 5] * (math.pi / 180.0)

    sr = sampling_ratio
    dev = features.device
    ys = (torch.arange(oh * sr, device=dev) + 0.5) / (oh * sr) - 0.5  # [-.5, .5)
    xs = (torch.arange(ow * sr, device=dev) + 0.5) / (ow * sr) - 0.5
    ly = rh[:, None, None] * ys[None, :, None]
    lx = rw[:, None, None] * xs[None, None, :]
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    gx = cx[:, None, None] + lx * cos_t - ly * sin_t
    gy = cy[:, None, None] + lx * sin_t + ly * cos_t
    nx = gx / max(w - 1, 1) * 2 - 1
    ny = gy / max(h - 1, 1) * 2 - 1
    sampled = grid_sample(features, torch.stack([nx, ny], -1), align_corners=True,
                          batch_idx=boxes[:, 0].long())
    return sampled.reshape(-1, oh, sr, ow, sr, c).mean((2, 4))
