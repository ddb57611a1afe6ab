"""Classic detection meta-architectures: counterpart of
ir_ads_tpu/detection/meta_arch.py (detectron2's RetinaNet, FCOS and
GeneralizedRCNN with its RPN and ROI heads).

NHWC throughout; attributes carry the flax modules' names, so a flax tree
maps over by ``utils.jax_params.library_from_flax`` (the ResNet by the
detector's map).  Static shapes as in the reference: GT padded to
``max_gt`` with a validity mask, a fixed top-k proposal set per image,
padded slots masked in the losses.  The losses run in train mode
(``model.train()``) when GT is given.

``FasterRCNN`` is split where its selection is: ``rpn`` (backbone, FPN,
objectness and deltas of every anchor), ``select_proposals`` (the static
top-k by objectness, without gradient) and ``roi_stage`` (ROI align on P2
and the box, mask and keypoint heads), so that the ROI stage can run on
given proposals: after a top-k the reference and the port may pick other
anchors at a tie, and what follows is compared on the same proposals.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.box_ops import box_iou, elementwise_giou
from ir_ads_tpu_torch.detection.criterion import sigmoid_ce, sigmoid_focal_loss
from ir_ads_tpu_torch.detection.roi_heads import (
    KeypointHead, MaskHead, crop_and_resize_masks, keypoint_rcnn_loss, mask_rcnn_loss)
from ir_ads_tpu_torch.detection.rotated_boxes import roi_align
from ir_ads_tpu_torch.detection.transformer import top_k
from ir_ads_tpu_torch.models.backbones.resnet import ARCHS, ResNet
from ir_ads_tpu_torch.ops.layers import Conv, Dense

PRIOR = -math.log((1 - 0.01) / 0.01)  # the classification heads' bias init


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of an NHWC map: source index
    floor((i + 0.5) * in / out) in f32, computed as JAX computes it (torch's
    "nearest" takes floor(i * in / out), another pixel at odd sizes)."""
    h, w = x.shape[1:3]

    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
        return torch.floor(pos).long()

    return x.index_select(1, index(h, size[0])).index_select(2, index(w, size[1]))


class FPN(nn.Module):
    """detectron2-style FPN: lateral 1x1 + output 3x3 per level, then
    ``num_extra`` stride-2 3x3 levels (P6, P7)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_extra: int = 2, extra_from_p5: bool = True):
        super().__init__()
        self.num_extra = num_extra
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral_{i}", Conv(c, out_channels, 1))
            setattr(self, f"output_{i}", Conv(out_channels, out_channels, 3, padding=1))
        for i in range(num_extra):
            cin = out_channels if extra_from_p5 or i > 0 else in_channels[-1]
            setattr(self, f"extra_{i}", Conv(cin, out_channels, 3, 2, padding=1))
        self.extra_from_p5 = extra_from_p5

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats)]
        for i in reversed(range(len(laterals) - 1)):
            laterals[i] = laterals[i] + resize_nearest(laterals[i + 1], laterals[i].shape[1:3])
        outs = [getattr(self, f"output_{i}")(lat) for i, lat in enumerate(laterals)]
        src = outs[-1] if self.extra_from_p5 else feats[-1]
        for i in range(self.num_extra):
            src = getattr(self, f"extra_{i}")(F.relu(src) if i > 0 else src)
            outs.append(src)
        return outs


def make_anchors(
    spatial_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    sizes: Sequence[float],
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[float] = (1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
) -> np.ndarray:
    """Every anchor xyxy in input pixels, (sum_l H*W*A, 4) f32
    (detectron2's anchor_generator)."""
    all_anchors = []
    for (h, w), stride, size in zip(spatial_shapes, strides, sizes):
        base = []
        for s in scales:
            area = (size * s) ** 2
            for ar in aspect_ratios:
                bw = math.sqrt(area / ar)
                bh = bw * ar
                base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base)  # (A, 4)
        ys = (np.arange(h) + 0.5) * stride
        xs = (np.arange(w) + 0.5) * stride
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        ctr = np.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
        all_anchors.append((ctr + base[None]).reshape(-1, 4))
    return np.concatenate(all_anchors, 0).astype(np.float32)


def _anchors(levels, strides, sizes, **kw) -> torch.Tensor:
    shapes = tuple((f.shape[1], f.shape[2]) for f in levels)
    return torch.from_numpy(make_anchors(shapes, strides, sizes, **kw)).to(levels[0].device)


def encode_deltas(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Box -> (dx, dy, dw, dh) deltas (detectron2's Box2BoxTransform)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw.clamp(min=1e-6) / aw),
                        torch.log(bh.clamp(min=1e-6) / ah)], -1)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  clip: float = math.log(1000.0 / 16)) -> torch.Tensor:
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw.clamp(max=clip)) * aw
    h = torch.exp(dh.clamp(max=clip)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def match_anchors(
    anchors: torch.Tensor,  # (N, 4) xyxy
    gt_boxes: torch.Tensor,  # (G, 4) xyxy
    gt_valid: torch.Tensor,  # (G,)
    pos_thresh: float = 0.5,
    neg_thresh: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2's Matcher with allow_low_quality_matches: (matched gt index,
    label in {1 positive, 0 negative, -1 ignored}).

    As the reference: a padded GT slot's best anchor is written as anchor 0,
    so anchor 0 is positive whenever the image has a valid GT."""
    iou = box_iou(anchors, gt_boxes)[0]
    iou = torch.where(gt_valid[None], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(-1)
    matched = iou.argmax(-1)
    label = torch.where(best_iou >= pos_thresh, 1, torch.where(best_iou < neg_thresh, 0, -1))
    # low quality: each GT's best anchor becomes positive
    best_anchor = torch.where(gt_valid, iou.argmax(0), 0)
    any_valid = gt_valid.any()
    is_best = torch.zeros(anchors.shape[0], dtype=torch.bool, device=anchors.device)
    is_best[best_anchor] = any_valid
    label = torch.where(is_best & any_valid, 1, label)
    return matched, label


def smooth_l1(x: torch.Tensor, beta: float = 0.1) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def _feature_dims(arch: str, names: Sequence[str]) -> List[int]:
    block, _, widths = ARCHS[arch]
    return [widths[int(n[3:]) - 2] * block.expansion for n in names]


class _Towers(nn.Module):
    """RetinaNet's and FCOS's trunk: ResNet res3-res5, FPN P3-P7, shared
    4-conv class and box towers (``cls_tower_i``, ``box_tower_i``)."""

    FEATURES = ("res3", "res4", "res5")

    def __init__(self, backbone_arch: str, channels: int):
        super().__init__()
        self.backbone = ResNet(backbone_arch, out_features=self.FEATURES, frozen_bn=True)
        self.fpn = FPN(_feature_dims(backbone_arch, self.FEATURES), channels)
        for i in range(4):
            setattr(self, f"cls_tower_{i}", Conv(channels, channels, 3, padding=1))
            setattr(self, f"box_tower_{i}", Conv(channels, channels, 3, padding=1))

    def levels(self, images: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone(images.to(self.fpn.lateral_0.weight.dtype))
        return self.fpn([feats[n] for n in self.FEATURES])

    def towers(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = b = f
        for i in range(4):
            c = F.relu(getattr(self, f"cls_tower_{i}")(c))
            b = F.relu(getattr(self, f"box_tower_{i}")(b))
        return c, b


def _head(cin: int, cout: int, prior: bool = False) -> Conv:
    conv = Conv(cin, cout, 3, padding=1)
    if prior:
        nn.init.constant_(conv.bias, PRIOR)
    return conv


class RetinaNet(_Towers):
    """RetinaNet (detectron2 meta_arch/retinanet.py): FPN P3-P7, shared
    4-conv towers, 9 anchors a location, focal + smooth-L1 losses.

    ``forward(images)`` -> logits (B, N, classes), deltas (B, N, 4), anchors
    (N, 4), boxes (B, N, 4) and the FPN ``levels``; with GT in train mode
    also ``losses``."""

    STRIDES = (8, 16, 32, 64, 128)
    SIZES = (32, 64, 128, 256, 512)

    def __init__(self, num_classes: int = 80, backbone_arch: str = "resnet50",
                 channels: int = 256, max_gt: int = 20):
        super().__init__(backbone_arch, channels)
        self.num_classes, self.max_gt = num_classes, max_gt
        self.cls_head = _head(channels, 9 * num_classes, prior=True)
        self.box_head = _head(channels, 9 * 4)

    def forward(self, images, gt_boxes=None, gt_labels=None, gt_valid=None):
        levels = self.levels(images)
        cls_outs, box_outs = [], []
        for f in levels:
            c, b = self.towers(f)
            n = f.shape[0]
            cls_outs.append(self.cls_head(c).reshape(n, -1, self.num_classes))
            box_outs.append(self.box_head(b).reshape(n, -1, 4))
        logits = torch.cat(cls_outs, 1)
        deltas = torch.cat(box_outs, 1)
        anchors = _anchors(levels, self.STRIDES, self.SIZES)
        out = {"logits": logits, "deltas": deltas, "anchors": anchors,
               "boxes": decode_deltas(anchors[None], deltas), "levels": levels}
        if self.training and gt_boxes is not None:
            out["losses"] = self.losses(logits, deltas, anchors, gt_boxes, gt_labels, gt_valid)
        return out

    def losses(self, logits, deltas, anchors, gt_boxes, gt_labels, gt_valid):
        cls, reg, npos = [], [], []
        for lg, dl, gb, gl, gv in zip(logits, deltas, gt_boxes, gt_labels, gt_valid):
            matched, label = match_anchors(anchors, gb, gv)
            pos = label == 1
            onehot = F.one_hot(gl[matched].long(), self.num_classes).float() * pos[:, None]
            focal = sigmoid_focal_loss(lg.float(), onehot)
            cls.append((focal * (label >= 0)[:, None]).sum())
            target = encode_deltas(anchors, gb[matched])
            reg.append((smooth_l1(dl - target).sum(-1) * pos).sum())
            npos.append(pos.sum().clamp(min=1))
        n = torch.stack(npos).sum().float().clamp(min=1.0)
        return {"loss_cls": torch.stack(cls).sum() / n, "loss_box_reg": torch.stack(reg).sum() / n}


class FCOS(_Towers):
    """FCOS (detectron2 meta_arch/fcos.py): anchor-free l/t/r/b regression
    per location, centerness, a learnt scale a level (``scale_i``).

    ``forward(images)`` -> logits (B, N, classes), boxes (B, N, 4),
    centerness (B, N), ltrb (B, N, 4) and the FPN ``levels``; with GT in
    train mode also ``losses``."""

    STRIDES = (8, 16, 32, 64, 128)
    RANGES = ((0, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))

    def __init__(self, num_classes: int = 80, backbone_arch: str = "resnet50",
                 channels: int = 256, max_gt: int = 20):
        super().__init__(backbone_arch, channels)
        self.num_classes, self.max_gt = num_classes, max_gt
        self.cls_head = _head(channels, num_classes, prior=True)
        self.box_head = _head(channels, 4)
        self.ctr_head = _head(channels, 1)
        for lvl in range(len(self.STRIDES)):
            setattr(self, f"scale_{lvl}", nn.Parameter(torch.ones(())))

    def forward(self, images, gt_boxes=None, gt_labels=None, gt_valid=None):
        levels = self.levels(images)
        logits, ltrb, ctr, centers, ranges = [], [], [], [], []
        for lvl, f in enumerate(levels):
            c, b = self.towers(f)
            n, h, w, _ = f.shape
            stride = self.STRIDES[lvl]
            logits.append(self.cls_head(c).reshape(n, -1, self.num_classes))
            scale = getattr(self, f"scale_{lvl}")
            # the f32 scale promotes a bf16 map to f32, as in JAX
            reg = torch.exp(self.box_head(b).float() * scale) * stride
            ltrb.append(reg.reshape(n, -1, 4))
            ctr.append(self.ctr_head(b).reshape(n, -1))
            ys = (torch.arange(h, device=f.device) + 0.5) * stride
            xs = (torch.arange(w, device=f.device) + 0.5) * stride
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            centers.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
            ranges.append(torch.tensor(self.RANGES[lvl], dtype=torch.float32,
                                       device=f.device).expand(h * w, 2))
        logits = torch.cat(logits, 1)
        ltrb = torch.cat(ltrb, 1)
        ctr = torch.cat(ctr, 1)
        centers = torch.cat(centers, 0)  # (N, 2)
        ranges = torch.cat(ranges, 0)
        boxes = torch.stack([centers[None, :, 0] - ltrb[..., 0],
                             centers[None, :, 1] - ltrb[..., 1],
                             centers[None, :, 0] + ltrb[..., 2],
                             centers[None, :, 1] + ltrb[..., 3]], -1)
        out = {"logits": logits, "boxes": boxes, "centerness": ctr, "ltrb": ltrb,
               "levels": levels}
        if self.training and gt_boxes is not None:
            out["losses"] = self.losses(logits, ltrb, ctr, centers, ranges, gt_boxes,
                                        gt_labels, gt_valid)
        return out

    def losses(self, logits, ltrb, ctr, centers, ranges, gt_boxes, gt_labels, gt_valid):
        cls, giou, ctr_l, npos = [], [], [], []
        for lg, rg, ct, gb, gl, gv in zip(logits, ltrb, ctr, gt_boxes, gt_labels, gt_valid):
            # every location's l/t/r/b to every GT
            reg = torch.stack([centers[:, None, 0] - gb[None, :, 0],
                               centers[:, None, 1] - gb[None, :, 1],
                               gb[None, :, 2] - centers[:, None, 0],
                               gb[None, :, 3] - centers[:, None, 1]], -1)  # (N, G, 4)
            inside = reg.amin(-1) > 0
            maxreg = reg.amax(-1)
            in_range = (maxreg >= ranges[:, None, 0]) & (maxreg <= ranges[:, None, 1])
            area = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
            cand = inside & in_range & gv[None]
            area_m = torch.where(cand, area[None], torch.full_like(reg[..., 0], 1e12))
            gt_idx = area_m.argmin(-1)
            is_pos = cand.any(-1)
            tgt = torch.gather(reg, 1, gt_idx[:, None, None].expand(-1, 1, 4))[:, 0]
            onehot = F.one_hot(gl[gt_idx].long(), self.num_classes).float() * is_pos[:, None]
            cls.append(sigmoid_focal_loss(lg.float(), onehot).sum())
            pred_box = torch.stack([centers[:, 0] - rg[:, 0], centers[:, 1] - rg[:, 1],
                                    centers[:, 0] + rg[:, 2], centers[:, 1] + rg[:, 3]], -1)
            tgt_box = torch.stack([centers[:, 0] - tgt[:, 0], centers[:, 1] - tgt[:, 1],
                                   centers[:, 0] + tgt[:, 2], centers[:, 1] + tgt[:, 3]], -1)
            giou.append(((1 - elementwise_giou(pred_box, tgt_box)) * is_pos).sum())
            lr, tb = tgt[:, [0, 2]], tgt[:, [1, 3]]
            ctr_tgt = torch.sqrt(
                (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6)).clamp(0, 1)
                * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6)).clamp(0, 1))
            ctr_l.append((sigmoid_ce(ct, ctr_tgt) * is_pos).sum())
            npos.append(is_pos.sum().clamp(min=1))
        n = torch.stack(npos).sum().float().clamp(min=1.0)
        return {"loss_cls": torch.stack(cls).sum() / n, "loss_giou": torch.stack(giou).sum() / n,
                "loss_centerness": torch.stack(ctr_l).sum() / n}


class FasterRCNN(nn.Module):
    """Two-stage Faster R-CNN (detectron2 GeneralizedRCNN + RPN +
    StandardROIHeads, box branch) with static top-k proposals; with
    ``with_mask`` Mask R-CNN (``roi_heads.MaskHead``), with
    ``num_keypoints`` Keypoint R-CNN (``roi_heads.KeypointHead``).  Every
    ROI is pooled from P2, the reference's single-level assignment.

    ``forward(images)`` -> rpn_obj (B, N), rpn_deltas (B, N, 4), anchors,
    the FPN ``levels``, proposals (B, k, 4), cls_logits (B, k, classes + 1),
    box_deltas, boxes (B, k, 4) and mask_logits (B, k, 2S, 2S, classes) /
    keypoint_logits (B, k, 4S, 4S, K); with GT in train mode also
    ``losses``."""

    STRIDES = (4, 8, 16, 32)
    SIZES = (32, 64, 128, 256)
    FEATURES = ("res2", "res3", "res4", "res5")

    def __init__(self, num_classes: int = 80, backbone_arch: str = "resnet50",
                 channels: int = 256, num_proposals: int = 256, max_gt: int = 20,
                 with_mask: bool = False, num_keypoints: int = 0, mask_pool: int = 14):
        super().__init__()
        self.num_classes, self.num_proposals, self.max_gt = num_classes, num_proposals, max_gt
        self.with_mask, self.num_keypoints, self.mask_pool = with_mask, num_keypoints, mask_pool
        self.backbone = ResNet(backbone_arch, out_features=self.FEATURES, frozen_bn=True)
        self.fpn = FPN(_feature_dims(backbone_arch, self.FEATURES), channels, num_extra=0)
        self.rpn_conv = Conv(channels, channels, 3, padding=1)
        self.rpn_obj = Conv(channels, 3, 1)
        self.rpn_delta = Conv(channels, 12, 1)
        self.box_fc1 = Dense(channels * 49, 1024)
        self.box_fc2 = Dense(1024, 1024)
        self.cls_score = Dense(1024, num_classes + 1)
        self.bbox_pred = Dense(1024, 4)
        if with_mask:
            self.mask_head = MaskHead(channels, num_classes)
        if num_keypoints:
            self.keypoint_head = KeypointHead(channels, num_keypoints)

    def rpn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Backbone, FPN P2-P5 and the RPN on every level: levels, rpn_obj
        (B, N), rpn_deltas (B, N, 4) and the anchors (N, 4), 3 a location."""
        feats = self.backbone(images.to(self.rpn_conv.weight.dtype))
        levels = self.fpn([feats[n] for n in self.FEATURES])
        b = images.shape[0]
        obj, deltas = [], []
        for f in levels:
            h = F.relu(self.rpn_conv(f))
            obj.append(self.rpn_obj(h).reshape(b, -1))
            deltas.append(self.rpn_delta(h).reshape(b, -1, 4))
        anchors = _anchors(levels, self.STRIDES, self.SIZES, scales=(1.0,))
        return {"levels": levels, "rpn_obj": torch.cat(obj, 1),
                "rpn_deltas": torch.cat(deltas, 1), "anchors": anchors}

    def select_proposals(self, obj: torch.Tensor, deltas: torch.Tensor,
                         anchors: torch.Tensor) -> torch.Tensor:
        """The static top-k proposals by objectness (ties to the lower
        anchor, as ``jax.lax.top_k``), decoded, without gradient: (B, k, 4)."""
        k = min(self.num_proposals, obj.shape[1])
        top = top_k(obj, k)[1]
        proposals = decode_deltas(anchors[None], deltas)
        return torch.gather(proposals, 1, top[..., None].expand(-1, -1, 4)).detach()

    def _pool(self, p2: torch.Tensor, proposals: torch.Tensor, size: int) -> torch.Tensor:
        b, k = proposals.shape[:2]
        batch_idx = torch.arange(b, device=p2.device, dtype=torch.float32)
        rois = torch.cat([batch_idx[:, None, None].expand(b, k, 1), proposals.float()], -1)
        return roi_align(p2, rois.reshape(-1, 5), (size, size),
                         spatial_scale=1.0 / self.STRIDES[0])

    def roi_stage(self, levels: Sequence[torch.Tensor],
                  proposals: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The ROI heads on ``proposals`` (B, k, 4): cls_logits, box_deltas,
        boxes and the mask and keypoint logits where the model has them."""
        b, k = proposals.shape[:2]
        p2 = levels[0]
        flat = self._pool(p2, proposals, 7).reshape(b * k, -1)
        h = F.relu(self.box_fc1(flat))
        h = F.relu(self.box_fc2(h))
        cls_logits = self.cls_score(h).reshape(b, k, -1)
        box_deltas = self.bbox_pred(h).reshape(b, k, 4)
        out = {"proposals": proposals, "cls_logits": cls_logits, "box_deltas": box_deltas,
               "boxes": decode_deltas(proposals, box_deltas)}
        mp = self.mask_pool
        if self.with_mask:
            out["mask_logits"] = self.mask_head(self._pool(p2, proposals, mp)).reshape(
                b, k, 2 * mp, 2 * mp, self.num_classes)
        if self.num_keypoints:
            out["keypoint_logits"] = self.keypoint_head(self._pool(p2, proposals, mp)).reshape(
                b, k, 4 * mp, 4 * mp, self.num_keypoints)
        return out

    def forward(self, images, gt_boxes=None, gt_labels=None, gt_valid=None,
                gt_masks=None, gt_keypoints=None):
        out = self.rpn(images)
        proposals = self.select_proposals(out["rpn_obj"], out["rpn_deltas"], out["anchors"])
        out.update(self.roi_stage(out["levels"], proposals))
        if self.training and gt_boxes is not None:
            out["losses"] = self.losses(out, gt_boxes, gt_labels, gt_valid, gt_masks,
                                        gt_keypoints)
        return out

    def losses(self, out, gt_boxes, gt_labels, gt_valid, gt_masks=None, gt_keypoints=None):
        """The RPN's and the ROI heads' losses from ``rpn`` and ``roi_stage``'s
        outputs (``out``: rpn_obj, rpn_deltas, anchors, proposals,
        cls_logits, box_deltas and the mask / keypoint logits)."""
        anchors = out["anchors"]
        terms: Dict[str, list] = {}
        for i in range(gt_boxes.shape[0]):
            gb, gl, gv = gt_boxes[i], gt_labels[i].long(), gt_valid[i]
            # RPN
            matched, label = match_anchors(anchors, gb, gv, 0.7, 0.3)
            valid, pos = label >= 0, label == 1
            obj = (sigmoid_ce(out["rpn_obj"][i], pos.float()) * valid).sum() / valid.sum().clamp(
                min=1)
            tgt = encode_deltas(anchors, gb[matched])
            rpn_reg = (smooth_l1(out["rpn_deltas"][i] - tgt).sum(-1) * pos).sum() / pos.sum(
            ).clamp(min=1)
            # ROI heads
            pb = out["proposals"][i]
            m2, l2 = match_anchors(pb, gb, gv, 0.5, 0.5)
            fg = l2 == 1
            cls_tgt = torch.where(fg, gl[m2], self.num_classes)  # background last
            ce = -F.log_softmax(out["cls_logits"][i].float(), -1)
            cls = torch.gather(ce, 1, cls_tgt[:, None])[:, 0].mean()
            tgt2 = encode_deltas(pb, gb[m2])
            roi_reg = (smooth_l1(out["box_deltas"][i] - tgt2).sum(-1) * fg).sum() / fg.sum(
            ).clamp(min=1)
            parts = {"loss_rpn_obj": obj, "loss_rpn_reg": rpn_reg, "loss_roi_cls": cls,
                     "loss_roi_reg": roi_reg}
            if "mask_logits" in out and gt_masks is not None:
                s = out["mask_logits"].shape[2]
                target = crop_and_resize_masks(gt_masks[i], pb, m2, s)
                parts["loss_mask"] = mask_rcnn_loss(out["mask_logits"][i], gl[m2], target,
                                                    fg.float())
            if "keypoint_logits" in out and gt_keypoints is not None:
                parts["loss_keypoint"] = keypoint_rcnn_loss(
                    out["keypoint_logits"][i], gt_keypoints[i][m2], pb, fg.float())
            for name, v in parts.items():
                terms.setdefault(name, []).append(v)
        return {name: torch.stack(v).mean() for name, v in terms.items()}


def MaskRCNN(**kw) -> FasterRCNN:
    """Mask R-CNN = Faster R-CNN + the mask branch (mask_rcnn_R_50_FPN)."""
    kw.setdefault("with_mask", True)
    return FasterRCNN(**kw)


def KeypointRCNN(**kw) -> FasterRCNN:
    """Keypoint R-CNN (keypoint_rcnn_R_50_FPN): person keypoints."""
    kw.setdefault("num_keypoints", 17)
    kw.setdefault("num_classes", 1)
    return FasterRCNN(**kw)
