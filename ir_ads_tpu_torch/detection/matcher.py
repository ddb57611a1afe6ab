"""Hungarian matching with the focal class cost: counterpart of
ir_ads_tpu/detection/matcher.py (``match_cost``, ``hungarian_match``,
``auction_match``).

``hungarian_match(cost, impl)`` assigns one query row to every GT column:
``"scipy"`` solves exactly on the host (scipy's ``linear_sum_assignment``,
one copy of the cost each way), ``"auction"`` runs the parallel Bertsekas
auction on the cost's device (eps-optimal: the total cost within G * eps of
the optimum), and ``"auto"`` takes the auction for CUDA tensors and scipy
for CPU tensors, as the JAX package's ``auto`` takes its host callback on
the CPU and the auction on an accelerator.  The auction's loop condition
reads one flag on the host each iteration; ``auction_solve`` also returns
the iterations each image took.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.detection.box_ops import box_cxcywh_to_xyxy, generalized_box_iou


def _solve_scipy(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from scipy.optimize import linear_sum_assignment

    b, _, g = cost.shape
    flat = cost.detach().float().cpu().numpy()
    rows = np.zeros((b, g), np.int64)
    cols = np.zeros((b, g), np.int64)
    for i in range(b):
        c = np.nan_to_num(flat[i], nan=1e8, posinf=1e8, neginf=-1e8)
        r, cl = linear_sum_assignment(c)
        rows[i, : len(r)] = r
        cols[i, : len(cl)] = cl
    order = np.argsort(cols, axis=1, kind="stable")
    rows = np.take_along_axis(rows, order, axis=1)
    cols = np.take_along_axis(cols, order, axis=1)
    return (torch.from_numpy(rows).to(cost.device), torch.from_numpy(cols).to(cost.device))


AUCTION_EPS, AUCTION_MAX_ITERS = 1e-3, 200
AUCTION_CHECK_EVERY = 16  # iterations between the loop's host reads


def auction_match(cost: torch.Tensor) -> torch.Tensor:
    """cost (B, Q, G), G <= Q -> the query index of each GT (B, G), on the
    cost's device (``auction_solve``'s indices)."""
    return auction_solve(cost)[0]


def auction_solve(cost: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """``auction_match``'s indices and the iterations each image took.  The JAX package's loop, the images side by side: every
    unassigned GT bids on its best query (value - second value + eps), the
    highest bid wins (ties to the lowest GT index) and evicts the holder;
    an image whose GTs all hold a query takes no more bids.  After
    ``AUCTION_MAX_ITERS`` a GT left over takes its best free query (eps-
    optimal: the total cost within G * ``AUCTION_EPS`` of the optimum).
    The host reads whether any image is still bidding only every
    ``AUCTION_CHECK_EVERY`` iterations: a settled image takes no bids, so
    the iterations run past its end change nothing."""
    b, q, g = cost.shape
    val_t = -cost.detach().float().transpose(1, 2)  # (B, G, Q) benefit
    gt_ids = torch.arange(g, device=cost.device)[None, :, None]
    q_ids = torch.arange(q, device=cost.device)
    prices = torch.zeros((b, q), device=cost.device)
    assigned = torch.full((b, g), -1, dtype=torch.long, device=cost.device)
    iters = torch.zeros(b, dtype=torch.long, device=cost.device)
    for it in range(AUCTION_MAX_ITERS):
        active = (assigned < 0).any(1)
        if it % AUCTION_CHECK_EVERY == 0 and not bool(active.any()):
            break
        value = val_t - prices[:, None, :]
        best = value.argmax(2)
        top2 = value.topk(2, dim=2).values
        bid = top2[..., 0] - top2[..., 1] + AUCTION_EPS  # (B, G)
        bids = torch.where((assigned < 0)[..., None] & (q_ids == best[..., None]),
                           bid[..., None], torch.full_like(value, -torch.inf))
        is_win = torch.isfinite(bids) & (bids >= bids.amax(1, keepdim=True))
        first = torch.argmax(is_win.to(torch.uint8), dim=1)  # lowest GT index
        winner = is_win & (gt_ids == first[:, None, :])  # (B, G, Q)
        won_q = winner.any(1)
        holds = assigned[..., None] == q_ids
        assigned = torch.where((holds & won_q[:, None, :]).any(2),
                               torch.full_like(assigned, -1), assigned)
        assigned = torch.where(winner.any(2), (winner * q_ids).sum(2), assigned)
        prices = prices + torch.where(won_q, (winner * bid[..., None]).sum(1),
                                      torch.zeros_like(prices))
        iters += active
    taken = (assigned[..., None] == q_ids).any(1)  # (B, Q)
    fallback = torch.argmax(torch.where(taken[:, None, :], -torch.inf, val_t), dim=2)
    return torch.where(assigned >= 0, assigned, fallback), iters.tolist()


def hungarian_match(cost: torch.Tensor, impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """cost (B, Q, G) -> (query_idx (B, G), gt_idx (B, G)), entry j for GT
    j; G <= Q.  No gradient flows through the assignment."""
    b, _, g = cost.shape
    if impl == "auto":
        impl = "auction" if cost.is_cuda else "scipy"
    if impl == "auction":
        cols = torch.arange(g, device=cost.device).expand(b, g)
        return auction_match(cost), cols
    if impl != "scipy":
        raise ValueError(f"hungarian_match: impl {impl!r} is not scipy, auction or auto")
    return _solve_scipy(cost)


def match_cost(
    pred_logits: torch.Tensor,  # (B, Q, C)
    pred_boxes: torch.Tensor,   # (B, Q, 4) cxcywh
    gt_labels: torch.Tensor,    # (B, G)
    gt_boxes: torch.Tensor,     # (B, G, 4) cxcywh
    gt_valid: torch.Tensor,     # (B, G) bool
) -> torch.Tensor:
    """Focal class (alpha 0.25, gamma 2) x 2 + L1 x 5 + GIoU x 2 matching
    cost (B, Q, G); an invalid GT slot costs 1e8."""
    alpha, gamma = 0.25, 2.0
    prob = pred_logits.float().sigmoid()
    neg_cost = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos_cost = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    b, q, _ = pred_logits.shape
    cls_cost = torch.gather(pos_cost - neg_cost, 2,
                            gt_labels.long()[:, None, :].expand(b, q, -1))
    bbox_cost = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou_cost = -torch.stack([
        generalized_box_iou(box_cxcywh_to_xyxy(p), box_cxcywh_to_xyxy(t))
        for p, t in zip(pred_boxes, gt_boxes)])
    cost = 2.0 * cls_cost + 5.0 * bbox_cost + 2.0 * giou_cost
    return torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, 1e8))


def dynamic_k_match(
    cost: torch.Tensor,  # (B, Q, G)
    ious: torch.Tensor,  # (B, Q, G) prediction-GT IoUs
    gt_valid: torch.Tensor,  # (B, G)
    max_k: int = 10,
) -> torch.Tensor:
    """SimOTA-style dynamic-k assignment (the reference's
    HungarianMatcherDynamicK, shipped unused): each GT takes its
    clip(round(sum of its top-10 IoUs), 1, max_k) cheapest queries, and a
    query claimed by several GTs keeps the cheapest.  Returns the (B, Q, G)
    bool assignment."""
    b, q, g = cost.shape
    topk_iou = torch.topk(ious.transpose(1, 2), min(max_k, q), dim=-1).values  # (B, G, k)
    dynamic_k = torch.round(topk_iou.sum(-1)).long().clamp(1, max_k)
    order = torch.sort(cost.transpose(1, 2), dim=-1, stable=True)[1]  # (B, G, Q)
    ranks = torch.argsort(order, dim=-1)  # each query's rank for each GT
    assign = ((ranks < dynamic_k[..., None]) & gt_valid[..., None]).transpose(1, 2)  # (B, Q, G)
    best_gt = torch.where(assign, cost, torch.full_like(cost, 1e9)).argmin(-1)
    return assign & torch.nn.functional.one_hot(best_gt, g).bool()
