"""vCLR deformable-mask DINO detector, inference: counterpart of
ir_ads_tpu/detection/dino.py (``DINODetector`` with ``train=False``).

ResNet backbone -> ChannelMapper neck -> DINO transformer -> per-layer class,
box, ROI and mask heads; the mask logits are the product of each query's mask
embedding with a fused-FPN segmentation map.  Inference ranks boxes by
sqrt(class score x mask score) and applies class-agnostic NMS
(``nms_topk``).  The CDN denoising queries, the criterion and the EMA teacher
belong to training and are not here; the transformer keeps its
``dn_queries / dn_refs / attn_mask`` arguments.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.box_ops import box_cxcywh_to_xyxy, box_iou
from ir_ads_tpu_torch.detection.transformer import (
    MLP, NORM_EPS, DINOTransformer, layer_norm, top_k,
)
from ir_ads_tpu_torch.models.backbones.resnet import ARCHS, ResNet
from ir_ads_tpu_torch.ops.layers import FlaxBatchNorm2d, GroupNorm, conv2d, resize_bilinear

PIXEL_MEAN = np.asarray([123.675, 116.280, 103.530], np.float32)
PIXEL_STD = np.asarray([58.395, 57.120, 57.375], np.float32)


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module on an NHWC map."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def seg_map(m: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``mapping_fpn_features_for_seg`` (conv, BatchNorm, ReLU, conv) on
    NCHW, its convolutions as flax's (``ops.layers.conv2d``)."""
    conv1, bn, _, conv2 = m
    return conv2d(F.relu(bn(conv2d(x, conv1))), conv2)


class _ConvGN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2)
        self.gn = GroupNorm(32, cout, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(conv2d(x, self.conv))


class ChannelMapper(nn.Module):
    """1x1 conv + GroupNorm per level (``convs.i``), then stride-2 3x3 convs
    on the last input for the further levels (``extra_convs.i``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(_ConvGN(c, out_channels, 1) for c in in_channels)
        extra_in = [in_channels[-1]] + [out_channels] * num_outs
        self.extra_convs = nn.ModuleList(
            _ConvGN(extra_in[i], out_channels, 3, 2)
            for i in range(num_outs - len(in_channels)))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = [_nchw(m, f) for m, f in zip(self.convs, feats)]
        src = feats[-1]
        for m in self.extra_convs:
            src = _nchw(m, src)
            outs.append(src)
        return outs


class DINODetector(nn.Module):
    """``forward(images, want_masks=True)``: (B, H, W, 3) raw RGB 0..255 ->
    the JAX detector's eval dict: pred_logits (L, B, Q, classes), pred_boxes
    (L, B, Q, 4) cxcywh, pred_rois, pred_queries, enc_logits, enc_boxes,
    enc_rois and, on request, pred_masks (L, B, Q, h0, w0) f32 and enc_masks."""

    def __init__(self, num_classes: int = 80, num_queries: int = 900,
                 embed_dim: int = 256, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, num_levels: int = 4,
                 backbone_arch: str = "resnet50"):
        super().__init__()
        self.num_decoder_layers = num_decoder_layers
        block, _, widths = ARCHS[backbone_arch]
        self.backbone = ResNet(backbone_arch, out_features=("res3", "res4", "res5"))
        self.neck = ChannelMapper([w * block.expansion for w in widths[1:]],
                                  embed_dim, num_levels)
        self.label_enc = nn.Embedding(num_classes, embed_dim)  # CDN labels; training
        self.transformer = DINOTransformer(
            embed_dim=embed_dim, num_heads=8, ffn_dim=2048,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, num_levels=num_levels,
            num_queries=num_queries)
        n_pred = num_decoder_layers + 1  # the last is the encoder stage's
        seg_dim = num_levels * embed_dim
        self.class_embed = nn.ModuleList(
            nn.Linear(embed_dim, num_classes) for _ in range(n_pred))
        self.bbox_embed = nn.ModuleList(
            MLP(embed_dim, embed_dim, 4, 3) for _ in range(n_pred))
        self.mask_embed = nn.ModuleList(
            MLP(embed_dim, embed_dim, seg_dim, 3) for _ in range(n_pred))
        self.ROI_embed = nn.ModuleList(
            nn.Sequential(MLP(embed_dim, embed_dim, 1024, 3)) for _ in range(n_pred))
        self.mapping_fpn_features_for_seg = nn.Sequential(
            nn.Conv2d(seg_dim, 2 * seg_dim, 3, padding=1),
            FlaxBatchNorm2d(2 * seg_dim, eps=1e-5, momentum=0.1),
            nn.ReLU(),
            nn.Conv2d(2 * seg_dim, seg_dim, 3, padding=1))
        self.post_layernorm = layer_norm(seg_dim)
        self.register_buffer("pixel_mean", torch.from_numpy(PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.from_numpy(PIXEL_STD), persistent=False)

    def forward(self, images: torch.Tensor, want_masks: bool = True) -> Dict[str, torch.Tensor]:
        dtype = self.class_embed[0].weight.dtype
        x = ((images.float() - self.pixel_mean.float()) / self.pixel_std.float()).to(dtype)
        feats = self.backbone(x)
        levels = self.neck([feats["res3"], feats["res4"], feats["res5"]])
        out = self.transformer(levels, self.class_embed, self.bbox_embed)
        hidden = out["hidden_states"]

        # fused FPN segmentation features: every level's encoder memory
        # upsampled to level 0's resolution, concat, conv residual, LN
        spatial_shapes = out["spatial_shapes"]
        h0, w0 = spatial_shapes[0]
        b = images.shape[0]
        start, seg_feats = 0, []
        for h, w in spatial_shapes:
            lvl = out["memory"][:, start:start + h * w].reshape(b, h, w, -1)
            start += h * w
            seg_feats.append(resize_bilinear(lvl, (h0, w0), align_corners=True))
        seg = torch.cat(seg_feats, dim=-1)  # (B, h0, w0, levels * C)
        seg = self.post_layernorm(
            _nchw(lambda t: seg_map(self.mapping_fpn_features_for_seg, t), seg) + seg)
        seg_flat = seg.reshape(b, h0 * w0, -1)

        def mask_logits(head, states):
            # the product of the rounded operands, accumulated and kept in f32
            emb = head(states)  # (B, Q, seg_dim)
            return (emb.float() @ seg_flat.float().transpose(1, 2)).reshape(
                b, states.shape[1], h0, w0)

        def rois(i, states):
            return F.relu(self.ROI_embed[i][0](states))

        n = self.num_decoder_layers
        result = {
            "pred_logits": out["pred_logits"],
            "pred_boxes": out["pred_boxes"],
            "pred_rois": torch.stack([rois(i, hidden[i]) for i in range(n)]),
            "pred_queries": hidden,
            "enc_logits": out["enc_class"],
            "enc_boxes": out["enc_coord"],
            "enc_rois": rois(n, out["enc_state"]),
        }
        if want_masks:
            result["pred_masks"] = torch.stack(
                [mask_logits(self.mask_embed[i], hidden[i]) for i in range(n)])
            result["enc_masks"] = mask_logits(self.mask_embed[n], out["enc_state"])
        return result


def split_dn(tensor: torch.Tensor, n_dn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer predictions -> (denoising part, matching part) along the
    query axis."""
    return tensor[..., :n_dn, :], tensor[..., n_dn:, :]


def nms_topk(
    scores: torch.Tensor,  # (B, Q) ranking scores
    boxes: torch.Tensor,   # (B, Q, 4) cxcywh
    topk: int = 300,
    iou_thresh: float = 0.7,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-agnostic NMS: top-k by score, then greedy suppression over the
    IoU matrix.  Returns (scores (B, k), boxes_xyxy (B, k, 4), keep (B, k)).

    The greedy pass is sequential (a kept box i suppresses every later box j
    with IoU > thresh); it runs on the host over the k x k boolean matrix,
    one copy each way, instead of k rounds of small device launches."""
    top_scores, idx = top_k(scores, topk)
    xyxy = box_cxcywh_to_xyxy(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
    over = torch.stack([box_iou(bx, bx)[0] > iou_thresh for bx in xyxy]).cpu().numpy()
    keep = np.ones(over.shape[:2], dtype=bool)
    later = np.triu(np.ones((topk, topk), dtype=bool), k=1)
    for b in range(over.shape[0]):
        for i in range(topk):
            if keep[b, i]:
                keep[b] &= ~(over[b, i] & later[i])
    return top_scores, xyxy, torch.from_numpy(keep).to(scores.device)
