"""CMNeXt: the dual-stream Swin backbone and three SegFormer heads (fused,
rgb-only, dte-only).  Counterpart of ir_ads_tpu/models/cmnext.py.

``upsample_logits=False`` returns the heads' native H/4 logits, so that an
ensembling predictor can sum before one bilinear upsample (exact by
linearity), as the JAX eval path does.  ``dispatch`` names the backbone's
kernel configuration (``swin.DISPATCH``): ``"r5"``, the default, or ``"r4"``
for eval, ``"train"`` for a model that takes gradients.  Under ``"train"``,
in train mode, the MMST modality mask, drop-path, adapter dropout and the
heads' dropout (``head_drop``) draw from ``forward``'s ``generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.swin import DISPATCH, swin_b
from ir_ads_tpu_torch.models.heads.segformer import SegFormerHead
from ir_ads_tpu_torch.ops.layers import resize_bilinear

BACKBONES = {"SwinTransformer-B": swin_b}


class CMNeXt(nn.Module):
    def __init__(
        self,
        backbone: str = "SwinTransformer-B",
        num_classes: int = 40,
        backbone_kwargs: Optional[dict] = None,
        head_dims: Tuple[int, int] = (512, 256),
        upsample_logits: bool = True,
        dispatch: str = "r5",
        head_drop: float = 0.1,
        mmst_mask: bool = True,
    ):
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(f"backbone {backbone!r}: the port has {list(BACKBONES)}")
        if dispatch not in DISPATCH:
            raise NotImplementedError(f"dispatch {dispatch!r}: the port has {list(DISPATCH)}")
        attn_impl, dscf_attn, ffn_impl = DISPATCH[dispatch]
        self.backbone = BACKBONES[backbone](
            attn_impl=attn_impl, dscf_attn=dscf_attn, ffn_impl=ffn_impl,
            mmst_mask=mmst_mask, **(backbone_kwargs or {}))
        dims = self.backbone.num_features
        self.decode_head = SegFormerHead(dims, head_dims[0], num_classes)
        self.decode_head_rgb = SegFormerHead(dims, head_dims[1], num_classes)
        self.decode_head_dte = SegFormerHead(dims, head_dims[1], num_classes)
        self.upsample_logits = upsample_logits
        self.head_drop = float(head_drop)

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x_rgb, x_dte: (B, H, W, 3).  Returns (fused, rgb, dte) logits."""
        feats, feats_rgb, feats_dte = self.backbone(x_rgb, x_dte, generator)
        drop = self.head_drop if self.training and self.backbone.stochastic else 0.0
        ys = (
            self.decode_head(feats, drop, generator),
            self.decode_head_rgb(feats_rgb, drop, generator),
            self.decode_head_dte(feats_dte, drop, generator),
        )
        if self.upsample_logits:
            size = x_rgb.shape[1:3]
            ys = tuple(resize_bilinear(y, size, align_corners=False) for y in ys)
        return ys
