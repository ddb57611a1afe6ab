"""CMX backbone, NHWC: two MiT stacks, one per modality (``block*`` and
``extra_block*``, unlike CMNeXt's shared-weight streams), each stage
closed by FRM rectification and FFM fusion; returns the fused 4-level
pyramid.  Counterpart of ir_ads_tpu/models/backbones/cmx.py, with its
parameter names.  The rectified maps go on to the next stage.  No DSCF, so
no kernel of the port runs here.  In train mode drop-path acts on both
residual branches of every block (rates ``linspace(0, 0.1, sum(depths))``
over each stack's blocks, drawn from the ``generator``
handed to ``forward``) and the FFMs' BatchNorms normalise with the batch's
statistics.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.mit import (
    HEADS, MIT_SETTINGS, PATCH, SR_RATIOS, MixFFN, SRAttention, check_frames, drop_path_rates,
    patch_embed,
)
from ir_ads_tpu_torch.models.modules.fusion import FeatureFusionModule, FeatureRectifyModule
from ir_ads_tpu_torch.ops.layers import drop_path, layer_norm


class MiTBlock(nn.Module):
    """Plain MiT block: ``x + drop_path(attn(norm1 x))``, then ``x +
    drop_path(mlp(norm2 x))``; drop-path acts in train mode only."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MixFFN(dim, 4 * dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        on, rate = self.training, self.drop_path_rate
        x = x + drop_path(self.attn(layer_norm(x, self.norm1)), rate, on, generator)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2)), rate, on, generator)


class CMX(nn.Module):
    def __init__(self, variant: str = "B2"):
        super().__init__()
        if variant not in MIT_SETTINGS:
            raise ValueError(f"CMX variant {variant!r}: one of {list(MIT_SETTINGS)}")
        dims, depths = MIT_SETTINGS[variant]
        self.num_features, self.depths = list(dims), list(depths)
        rates = drop_path_rates(depths)
        for i in range(4):
            k, s = PATCH[i]
            cin = 3 if i == 0 else dims[i - 1]
            for pre in ("", "extra_"):
                setattr(self, f"{pre}patch_embed{i + 1}", nn.Conv2d(cin, dims[i], k, s, k // 2))
                setattr(self, f"{pre}patch_norm{i + 1}", nn.LayerNorm(dims[i], eps=1e-5))
                setattr(self, f"{pre}norm{i + 1}", nn.LayerNorm(dims[i], eps=1e-5))
                for j in range(depths[i]):
                    setattr(self, f"{pre}block{i + 1}_{j}",
                            MiTBlock(dims[i], HEADS[i], SR_RATIOS[i], rates[i][j]))
            setattr(self, f"frm_{i}", FeatureRectifyModule(dims[i]))
            setattr(self, f"ffm_{i}", FeatureFusionModule(dims[i], num_heads=HEADS[i]))

    def forward(self, x_rgb: torch.Tensor, x_ext: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        check_frames(x_rgb)
        outs = []
        for i in range(4):
            x_rgb = patch_embed(x_rgb, getattr(self, f"patch_embed{i + 1}"),
                                getattr(self, f"patch_norm{i + 1}"))
            x_ext = patch_embed(x_ext, getattr(self, f"extra_patch_embed{i + 1}"),
                                getattr(self, f"extra_patch_norm{i + 1}"))
            for j in range(self.depths[i]):
                x_rgb = getattr(self, f"block{i + 1}_{j}")(x_rgb, generator)
                x_ext = getattr(self, f"extra_block{i + 1}_{j}")(x_ext, generator)
            x_rgb = layer_norm(x_rgb, getattr(self, f"norm{i + 1}"))
            x_ext = layer_norm(x_ext, getattr(self, f"extra_norm{i + 1}"))
            x_rgb, x_ext = getattr(self, f"frm_{i}")(x_rgb, x_ext)
            outs.append(getattr(self, f"ffm_{i}")(x_rgb, x_ext))
        return outs
