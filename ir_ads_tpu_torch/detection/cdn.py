"""Contrastive denoising (CDN) queries: counterpart of
ir_ads_tpu/detection/cdn.py.

GT is padded to a static ``max_gt`` and the group count is a function of it
(``cdn_groups``), so the query layout is [group_0 pos | group_0 neg |
group_1 pos | ...], padded slots zeroed.  The random draws are apart from
the function that uses them: ``cdn_draws`` makes them from a
``torch.Generator``, ``generate_cdn_queries`` takes them as tensors (the
tests feed it the draws of JAX's key instead).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.detection.box_ops import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh
from ir_ads_tpu_torch.detection.transformer import inverse_sigmoid

Draws = Dict[str, torch.Tensor]


def cdn_groups(dn_number: int, max_gt: int) -> int:
    return max(1, dn_number // max(max_gt, 1))


def make_cdn_attn_mask(max_gt: int, n_groups: int, num_queries: int) -> np.ndarray:
    """(tgt, tgt) bool, True = masked: matching queries cannot see the DN
    queries, and no DN group sees another."""
    pad = 2 * max_gt * n_groups
    tgt = pad + num_queries
    mask = np.zeros((tgt, tgt), bool)
    mask[pad:, :pad] = True
    gs = 2 * max_gt
    for i in range(n_groups):
        mask[gs * i: gs * (i + 1), gs * (i + 1): pad] = True
        mask[gs * i: gs * (i + 1), : gs * i] = True
    return mask


def cdn_draws(generator: torch.Generator, shape: Tuple[int, int, int, int],
              num_classes: int) -> Draws:
    """The draws of one CDN batch, ``shape`` = (B, groups, 2, G): the label
    flip uniforms ``p`` and random labels ``rand_label`` (shape), the box
    noise signs ``sign`` in {-1, +1} and parts ``part`` in [0, 1)
    (shape + (4,)), on the generator's device."""
    dev = generator.device
    return dict(
        p=torch.rand(shape, generator=generator, device=dev),
        rand_label=torch.randint(0, num_classes, shape, generator=generator, device=dev),
        sign=torch.randint(0, 2, shape + (4,), generator=generator, device=dev).float() * 2 - 1,
        part=torch.rand(shape + (4,), generator=generator, device=dev),
    )


def generate_cdn_queries(
    gt_labels: torch.Tensor,    # (B, G)
    gt_boxes: torch.Tensor,     # (B, G, 4) cxcywh in [0, 1]
    gt_valid: torch.Tensor,     # (B, G)
    label_embed: torch.Tensor,  # (num_classes, C)
    draws: Draws,
    n_groups: int,
    label_noise_ratio: float = 0.5,
    box_noise_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dn_query_embeds (B, 2 * G * groups, C), dn_ref_boxes
    unsigmoided (B, 2 * G * groups, 4) f32).  Layout per group: [G
    positives | G negatives]."""
    b, g = gt_labels.shape
    labels = gt_labels[:, None, None, :].expand(b, n_groups, 2, g)
    boxes = gt_boxes.float()[:, None, None].expand(b, n_groups, 2, g, 4)

    # a label flips to a random class with probability ratio / 2
    noised_labels = torch.where(draws["p"] < label_noise_ratio * 0.5,
                                draws["rand_label"], labels)

    # box noise on the corners; negatives shift by [1, 2) half-extents
    xyxy = box_cxcywh_to_xyxy(boxes)
    half = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:] / 2], -1)
    is_neg = torch.zeros((1, 1, 2, 1, 1), device=boxes.device)
    is_neg[:, :, 1] = 1.0
    part = draws["part"] + is_neg
    noised = (xyxy + draws["sign"] * part * half * box_noise_scale).clamp(0.0, 1.0)
    refs = inverse_sigmoid(box_xyxy_to_cxcywh(noised))

    query = label_embed[noised_labels]  # (B, groups, 2, G, C)
    v = gt_valid[:, None, None, :, None]
    query = query * v.to(query.dtype)
    refs = torch.where(v, refs, torch.zeros_like(refs))
    c = query.shape[-1]
    return query.reshape(b, n_groups * 2 * g, c), refs.reshape(b, n_groups * 2 * g, 4)
