"""DINO training criterion: counterpart of ir_ads_tpu/detection/criterion.py.

Focal classification, L1 + GIoU boxes, the point-sampled mask loss (sigmoid
CE + dice at 12544 points, oversampled 3x, importance ratio 0.75), the CDN
denoising losses and the vCLR consistency loss.  GT is padded to ``max_gt``
with a validity mask; matched losses are computed for every slot and
masked.

The point draws of the mask loss are apart from it: ``mask_point_draws``
makes them from a ``torch.Generator``, ``point_sampled_mask_loss`` takes
them as tensors.  The assignment is ``matcher.hungarian_match``'s default
(the auction for CUDA tensors, scipy for CPU tensors).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.detection.box_ops import box_cxcywh_to_xyxy, elementwise_giou
from ir_ads_tpu_torch.detection.matcher import hungarian_match, match_cost
from ir_ads_tpu_torch.detection.transformer import top_k
from ir_ads_tpu_torch.ops.grid_sample import grid_sample

Losses = Dict[str, torch.Tensor]
PointDraws = Tuple[torch.Tensor, torch.Tensor]
OVERSAMPLE, IMPORTANCE_RATIO = 3.0, 0.75  # of the mask loss's point sampling


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` form."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss; targets one-hot float."""
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = sigmoid_ce(logits, targets) * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def num_boxes_of(gt_valid: torch.Tensor) -> torch.Tensor:
    return gt_valid.sum().float().clamp(min=1.0)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, Q, ...) at idx (B, G) along the query axis."""
    shape = idx.shape + t.shape[2:]
    flat = idx.reshape(*idx.shape, *([1] * (t.dim() - 2))).expand(shape)
    return torch.gather(t, 1, flat)


def class_loss(pred_logits, gt_labels, gt_valid, match_q, num_boxes,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Matched queries take their GT class, every other query background."""
    b, q, c = pred_logits.shape
    updates = F.one_hot(gt_labels.long(), c).float() * gt_valid[..., None].float()
    onehot = torch.zeros((b, q, c), device=pred_logits.device).scatter_add(
        1, match_q[..., None].expand(-1, -1, c), updates).clamp(0.0, 1.0)
    return sigmoid_focal_loss(pred_logits.float(), onehot, alpha, gamma).sum() / num_boxes


def box_loss(pred_boxes, gt_boxes, gt_valid, match_q, num_boxes):
    matched = _take(pred_boxes, match_q)
    valid = gt_valid.float()
    l1 = (matched - gt_boxes).abs().sum(-1) * valid
    giou = (1.0 - elementwise_giou(box_cxcywh_to_xyxy(matched),
                                   box_cxcywh_to_xyxy(gt_boxes))) * valid
    return l1.sum() / num_boxes, giou.sum() / num_boxes


def sample_points(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (N, H, W), coords (N, P, 2) in [0, 1] as (x, y) -> (N, P):
    detectron2's ``point_sample`` (grid_sample, align_corners=False)."""
    grid = coords[:, :, None, :] * 2.0 - 1.0
    return grid_sample(masks[..., None], grid)[:, :, 0, 0]


def mask_point_draws(generator: torch.Generator, n: int, num_points: int = 12544) -> PointDraws:
    """The uniform point draws of one mask loss over ``n`` masks: the
    candidates (n, num_points * OVERSAMPLE, 2) and the random rest (n,
    num_points - the uncertain ones, 2), on the generator's device."""
    n_random = num_points - int(IMPORTANCE_RATIO * num_points)
    dev = generator.device
    return (torch.rand((n, int(num_points * OVERSAMPLE), 2), generator=generator, device=dev),
            torch.rand((n, n_random, 2), generator=generator, device=dev))


def point_sampled_mask_loss(
    pred_masks: torch.Tensor,  # (B, G, Hm, Wm) matched mask logits
    gt_masks: torch.Tensor,    # (B, G, H, W) {0, 1}
    gt_valid: torch.Tensor,    # (B, G)
    num_boxes: torch.Tensor,
    draws: PointDraws,
    num_points: int = 12544,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PointRend-style point-sampled sigmoid CE + dice: the candidates where
    the prediction is least certain, then the random rest."""
    b, g = pred_masks.shape[:2]
    n = b * g
    pm = pred_masks.reshape(n, *pred_masks.shape[2:]).float()
    gm = gt_masks.reshape(n, *gt_masks.shape[2:]).float()
    coords, rand_coords = draws
    with torch.no_grad():
        uncertainty = -sample_points(pm, coords).abs()
    top_idx = top_k(uncertainty, int(IMPORTANCE_RATIO * num_points))[1]
    certain = torch.gather(coords, 1, top_idx[..., None].expand(-1, -1, 2))
    pts = torch.cat([certain, rand_coords], 1)
    pred_pts = sample_points(pm, pts)
    gt_pts = sample_points(gm, pts)
    valid = gt_valid.reshape(n, 1).float()
    loss_ce = (sigmoid_ce(pred_pts, gt_pts) * valid).mean(-1).sum() / num_boxes
    prob = torch.sigmoid(pred_pts) * valid
    gt_v = gt_pts * valid
    dice = 1 - (2 * (prob * gt_v).sum(-1) + 1) / (prob.sum(-1) + gt_v.sum(-1) + 1)
    return loss_ce, (dice * valid[:, 0]).sum() / num_boxes


def set_criterion(
    pred_logits: torch.Tensor,  # (B, Q, C)
    pred_boxes: torch.Tensor,   # (B, Q, 4)
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    gt_masks: Optional[torch.Tensor] = None,      # (B, G, H, W)
    mask_draws: Optional[PointDraws] = None,
    num_points: int = 12544,
    mask_embeds: Optional[torch.Tensor] = None,   # (B, Q, D): matched masks
    seg_feat: Optional[torch.Tensor] = None,      # (B, h0 * w0, D) are formed
    seg_hw: Optional[Tuple[int, int]] = None,     # after the match
) -> Losses:
    """One decoder level's Hungarian-matched losses (the JAX package's
    mask-embeds path), weighted 1 / 5 / 2 / 1 / 1."""
    num_boxes = num_boxes_of(gt_valid)
    with torch.no_grad():
        cost = match_cost(pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid)
        match_q = hungarian_match(cost)[0]
    losses = {"loss_class": class_loss(pred_logits, gt_labels, gt_valid, match_q, num_boxes)}
    l1, giou = box_loss(pred_boxes, gt_boxes, gt_valid, match_q, num_boxes)
    losses["loss_bbox"] = 5.0 * l1
    losses["loss_giou"] = 2.0 * giou
    if mask_embeds is not None and gt_masks is not None:
        # the matched queries' masks only: gather the G embeddings, then one
        # product with the seg features (f32 products of the rounded operands)
        emb = _take(mask_embeds, match_q).float()
        matched = (emb @ seg_feat.float().transpose(1, 2)).reshape(*match_q.shape, *seg_hw)
        losses["loss_mask"], losses["loss_dice"] = point_sampled_mask_loss(
            matched, gt_masks, gt_valid, num_boxes, mask_draws, num_points=num_points)
    return losses


def dn_criterion(
    pred_logits: torch.Tensor,  # (B, n_dn, C)
    pred_boxes: torch.Tensor,   # (B, n_dn, 4)
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    n_groups: int,
) -> Losses:
    """CDN losses, weighted 1 / 5 / 2: in each group query i is assigned GT
    i (positive half) or background (negative half)."""
    b, n_dn, c = pred_logits.shape
    g = gt_valid.shape[1]
    assert n_dn == 2 * g * n_groups, (n_dn, g, n_groups)
    num_boxes = num_boxes_of(gt_valid) * n_groups
    logits = pred_logits.reshape(b, n_groups, 2, g, c).float()
    pos_boxes = pred_boxes.reshape(b, n_groups, 2, g, 4)[:, :, 0]
    valid = gt_valid[:, None, :].float()
    onehot_pos = F.one_hot(gt_labels.long(), c).float()[:, None] * valid[..., None]
    loss_cls = (sigmoid_focal_loss(logits[:, :, 0], onehot_pos).sum()
                + sigmoid_focal_loss(logits[:, :, 1], torch.zeros_like(onehot_pos)).sum()
                ) / num_boxes
    l1 = (pos_boxes - gt_boxes[:, None]).abs().sum(-1) * valid
    giou = (1.0 - elementwise_giou(
        box_cxcywh_to_xyxy(pos_boxes),
        box_cxcywh_to_xyxy(gt_boxes[:, None].expand_as(pos_boxes)))) * valid
    return {"loss_class_dn": loss_cls, "loss_bbox_dn": 5.0 * l1.sum() / num_boxes,
            "loss_giou_dn": 2.0 * giou.sum() / num_boxes}


def consistency_cost(student_boxes: torch.Tensor, teacher_boxes: torch.Tensor,
                     teacher_valid: torch.Tensor) -> torch.Tensor:
    """(B, Q, Qt): 5 x box L1 + 2 x -GIoU, 1e8 at teacher slots not kept."""
    bbox = (student_boxes[:, :, None] - teacher_boxes[:, None]).abs().sum(-1)
    q, qt = student_boxes.shape[1], teacher_boxes.shape[1]
    giou = -elementwise_giou(
        box_cxcywh_to_xyxy(student_boxes)[:, :, None].expand(-1, q, qt, 4),
        box_cxcywh_to_xyxy(teacher_boxes)[:, None].expand(-1, q, qt, 4))
    cost = 5.0 * bbox + 2.0 * giou
    return torch.where(teacher_valid[:, None, :], cost, torch.full_like(cost, 1e8))


def consistency_loss(
    student_queries: torch.Tensor,  # (B, Q, D)
    teacher_queries: torch.Tensor,  # (B, Qt, D)
    teacher_boxes: torch.Tensor,    # (B, Qt, 4)
    student_boxes: torch.Tensor,    # (B, Q, 4)
    teacher_valid: torch.Tensor,    # (B, Qt) bool: the teacher detections kept
) -> torch.Tensor:
    """vCLR consistency: match student queries to the teacher's detections
    by box L1 + GIoU, then 1 - cosine similarity of the matched pairs."""
    with torch.no_grad():
        cost = consistency_cost(student_boxes, teacher_boxes, teacher_valid)
        match_q = hungarian_match(cost)[0]
    matched = _take(student_queries, match_q)
    s = matched / (torch.linalg.vector_norm(matched, dim=-1, keepdim=True) + 1e-8)
    t = teacher_queries / (torch.linalg.vector_norm(teacher_queries, dim=-1, keepdim=True)
                           + 1e-8)
    cos = (s * t).sum(-1)
    valid = teacher_valid.float()
    return ((1.0 - cos) * valid).sum() / valid.sum().clamp(min=1.0)
