"""SegFormer all-MLP decode head, NHWC, with the fuse conv folded into the
per-level projections exactly as ir_ads_tpu/models/heads/segformer.py does:

    fuse(concat_i(resize(proj_i(f_i)))) == sum_i resize((W_fuse_i W_ci)(f_i))

Each level's projection and its block of the 1x1 fuse conv are composed (in
f32, from f32 parameters, which ``serve.cast_model_`` leaves f32) into one
matrix, rounded once to the compute dtype and applied at the level's own
resolution.  Parameter names
are the reference's (linear_c{k}.proj, linear_fuse.conv, linear_fuse.bn,
linear_pred).  In train mode the BatchNorm normalises with the batch's
statistics and updates its running ones as flax does
(``layers.FlaxBatchNorm2d``), and ``forward`` takes the dropout rate applied
before the classifier.

Under ``int8`` (the ``r4i8`` dispatch) each level's composed projection is a
w8a8 product, as ir_ads_tpu/models/heads/segformer.py:98-107 computes it:
``quantize_int8_`` composes wc and bc in f32 from the float weights, rounds
both to the compute dtype and quantizes the rounded wc per output channel;
the product's output is cast to the activation dtype before bc is added.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.int8 import PREFIX, int8_linear, int8_weight, set_int8_weight
from ir_ads_tpu_torch.ops.layers import (
    FlaxBatchNorm2d, conv2d, dropout, resize_bilinear, with_bias,
)


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class _Fuse(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = FlaxBatchNorm2d(cout, eps=1e-5, momentum=0.1)


class SegFormerHead(nn.Module):
    def __init__(self, in_dims: Sequence[int], embed_dim: int = 256,
                 num_classes: int = 19, int8: bool = False):
        super().__init__()
        self.int8 = bool(int8)
        self.num_levels = len(in_dims)
        for i, d in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", _Proj(d, embed_dim))
        self.linear_fuse = _Fuse(self.num_levels * embed_dim, embed_dim)
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def composed_in_f32(self):
        """The modules whose parameters the head composes in f32 before its
        one rounding (``_composed``): they stay f32 in a bf16 model."""
        return [getattr(self, f"linear_c{i + 1}") for i in range(self.num_levels)] + [
            self.linear_fuse.conv]

    def _composed(self, i: int):
        """Level i's projection composed with its block of the fuse conv, in
        f32: (wc (e, C_i), bc (e,))."""
        nl, e = self.num_levels, self.linear_fuse.conv.out_channels
        proj = getattr(self, f"linear_c{i + 1}").proj
        # the reference concatenates the levels reversed (c4..c1)
        blk = self.linear_fuse.conv.weight.flatten(1).float()[:, (nl - 1 - i) * e:(nl - i) * e]
        return blk @ proj.weight.float(), blk @ proj.bias.float()

    def quantize_int8_(self, dtype=None) -> None:
        for i in range(self.num_levels):
            wc, bc = self._composed(i)
            if dtype is not None:
                wc, bc = wc.to(dtype), bc.to(dtype)
            set_int8_weight(self, f"c{i + 1}", wc, floor_first=False)
            self.register_buffer(f"{PREFIX}c{i + 1}_bias", bc.float(), persistent=False)

    def forward(self, features: Sequence[torch.Tensor], drop: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = features[0].shape[1:3]
        acc = None
        for i, feat in enumerate(features):
            if self.int8:
                w_q, s_w = int8_weight(self, f"c{i + 1}")
                bc = getattr(self, f"{PREFIX}c{i + 1}_bias").to(feat.dtype)
                y = int8_linear(feat, w_q, s_w).to(feat.dtype) + bc
            else:
                wc, bc = self._composed(i)
                y = with_bias(F.linear(feat, wc.to(feat.dtype)), bc.to(feat.dtype))
            if i > 0:
                y = resize_bilinear(y, (h, w), align_corners=False)
            acc = y if acc is None else acc + y
        x = torch.relu(self.linear_fuse.bn(acc.permute(0, 3, 1, 2)))
        x = dropout(x, drop, drop > 0.0, generator)
        return conv2d(x, self.linear_pred).permute(0, 2, 3, 1)
