"""CMNeXt: the dual-stream Swin backbone and three SegFormer heads (fused,
rgb-only, dte-only).  Counterpart of ir_ads_tpu/models/cmnext.py.

``upsample_logits=False`` returns the heads' native H/4 logits, so that an
ensembling predictor can sum before one bilinear upsample (exact by
linearity), as the JAX eval path does.  ``forward_fused`` runs the backbone
and the fused head only, the eval forward (evaluation/semseg_eval.py
``make_forward_fn``).  ``dispatch`` names the backbone's
kernel configuration (``swin.DISPATCH``): ``"r5"``, the default, ``"r4"``,
``"r4i8"`` (w8a8: backbone and heads; call ``ops.int8.quantize_int8_`` once
the weights are loaded), the module-path sets ``"r2"``, ``"r1"`` and
``"xla"``, the block variants ``"v7_01"``, ``"v5"`` and ``"map"``, or the DSCF
variants ``"dscf_pallas4"``, ``"dscf_pallas"`` and ``"dscf_pallas2"`` for eval,
``"train"`` for a model that takes gradients.  Under ``"train"``,
in train mode, the MMST modality mask, drop-path, adapter dropout and the
heads' dropout (``head_drop``) draw from ``forward``'s ``generator``.
The inputs may be flat (B, H, W*3) rows, the bench's feed: ``patch_embed``
then chooses the patch embedding's path (``"xla"``, ``"xla2"`` or
``"pallas"``, K19).
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
        patch_embed: str = "xla",
    ):
        super().__init__()
        if backbone not in BACKBONES:
            raise NotImplementedError(f"backbone {backbone!r}: the port has {list(BACKBONES)}")
        if dispatch not in DISPATCH:
            raise NotImplementedError(f"dispatch {dispatch!r}: the port has {list(DISPATCH)}")
        attn_impl, dscf_attn, ffn_impl, int8, rpe3 = DISPATCH[dispatch]
        self.backbone = BACKBONES[backbone](
            attn_impl=attn_impl, dscf_attn=dscf_attn, ffn_impl=ffn_impl, int8=int8,
            rpe3=rpe3, mmst_mask=mmst_mask, patch_embed=patch_embed,
            **(backbone_kwargs or {}))
        dims = self.backbone.num_features
        self.decode_head = SegFormerHead(dims, head_dims[0], num_classes, int8)
        self.decode_head_rgb = SegFormerHead(dims, head_dims[1], num_classes, int8)
        self.decode_head_dte = SegFormerHead(dims, head_dims[1], num_classes, int8)
        self.upsample_logits = upsample_logits
        self.head_drop = float(head_drop)

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x_rgb, x_dte: (B, H, W, 3) frames or flat (B, H, W*3) rows.
        Returns (fused, rgb, dte) logits."""
        feats, feats_rgb, feats_dte = self.backbone(x_rgb, x_dte, generator)
        drop = self.head_drop if self.training and self.backbone.stochastic else 0.0
        ys = (
            self.decode_head(feats, drop, generator),
            self.decode_head_rgb(feats_rgb, drop, generator),
            self.decode_head_dte(feats_dte, drop, generator),
        )
        return tuple(self._upsample(y, x_rgb) for y in ys)

    def forward_fused(self, x_rgb: torch.Tensor, x_dte: torch.Tensor) -> torch.Tensor:
        """``forward(...)[0]`` in eval, without the rgb and dte heads: what
        the JAX eval forward computes once XLA drops the unused heads."""
        feats = self.backbone(x_rgb, x_dte)[0]
        return self._upsample(self.decode_head(feats, 0.0, None), x_rgb)

    def _upsample(self, y: torch.Tensor, x_rgb: torch.Tensor) -> torch.Tensor:
        """The head-native logits, or (``upsample_logits``) the input's size."""
        if not self.upsample_logits:
            return y
        flat = x_rgb.ndim == 3
        size = (x_rgb.shape[1], x_rgb.shape[2] // 3) if flat else x_rgb.shape[1:3]
        return resize_bilinear(y, size, align_corners=False)
