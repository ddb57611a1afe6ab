"""CMNeXt: the dual-stream Swin backbone and three SegFormer heads (fused,
rgb-only, dte-only).  Counterpart of ir_ads_tpu/models/cmnext.py.

``upsample_logits=False`` returns the heads' native H/4 logits, so that an
ensembling predictor can sum before one bilinear upsample (exact by
linearity), as the JAX eval path does.  ``dispatch`` names the backbone's
kernel configuration (``swin.DISPATCH``: ``"r5"``, the default, or
``"r4"``).
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
    ):
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(f"backbone {backbone!r}: the port has {list(BACKBONES)}")
        if dispatch not in DISPATCH:
            raise NotImplementedError(f"dispatch {dispatch!r}: the port has {list(DISPATCH)}")
        attn_impl, dscf_attn = DISPATCH[dispatch]
        self.backbone = BACKBONES[backbone](
            attn_impl=attn_impl, dscf_attn=dscf_attn, **(backbone_kwargs or {}))
        dims = self.backbone.num_features
        self.decode_head = SegFormerHead(dims, head_dims[0], num_classes)
        self.decode_head_rgb = SegFormerHead(dims, head_dims[1], num_classes)
        self.decode_head_dte = SegFormerHead(dims, head_dims[1], num_classes)
        self.upsample_logits = upsample_logits

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor):
        """x_rgb, x_dte: (B, H, W, 3).  Returns (fused, rgb, dte) logits."""
        feats, feats_rgb, feats_dte = self.backbone(x_rgb, x_dte)
        ys = (
            self.decode_head(feats),
            self.decode_head_rgb(feats_rgb),
            self.decode_head_dte(feats_dte),
        )
        if self.upsample_logits:
            size = x_rgb.shape[1:3]
            ys = tuple(resize_bilinear(y, size, align_corners=False) for y in ys)
        return ys
