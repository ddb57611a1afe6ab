"""CMX fusion modules, NHWC: Feature Rectify (FRM) and Feature Fusion
(FFM).  Counterpart of ir_ads_tpu/models/modules/fusion.py, with its
parameter names.  In train mode the FFM's two BatchNorms normalise with the
batch's statistics and update their running ones as flax does (momentum
0.9: ``layers.FlaxBatchNorm2d``).

FRM corrects each stream by channel- and spatial-weighted contributions of
the other; FFM crosses the streams by linear attention (each stream's
queries read the other's context ``softmax(k^T v)``), embeds channels, and
merges them into one map through two BatchNorms.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.mit import nhwc_conv
from ir_ads_tpu_torch.ops.layers import FlaxBatchNorm2d, layer_norm, linear, pointwise


def _bn(x: torch.Tensor, bn: FlaxBatchNorm2d) -> torch.Tensor:
    """A BatchNorm on an NHWC map."""
    return bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FeatureRectifyModule(nn.Module):
    """FRM: ``out1 = x1 + lambda_c cw[:, 1] x2 + lambda_s sw[..., 1] x2`` and
    ``out2 = x2 + lambda_c cw[:, 0] x1 + lambda_s sw[..., 0] x1``, the
    channel weights ``cw`` from the pooled mean and max of both streams, the
    spatial weights ``sw`` from a 1x1 convolution pair."""

    def __init__(self, dim: int, reduction: int = 1, lambda_c: float = 0.5,
                 lambda_s: float = 0.5):
        super().__init__()
        self.lambda_c, self.lambda_s = lambda_c, lambda_s
        self.ch_fc1 = nn.Linear(4 * dim, 4 * dim // reduction)
        self.ch_fc2 = nn.Linear(4 * dim // reduction, 2 * dim)
        self.sp_conv1 = nn.Conv2d(2 * dim, dim // reduction, 1)
        self.sp_conv2 = nn.Conv2d(dim // reduction, 2, 1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, _, _, c = x1.shape
        x = torch.cat([x1, x2], dim=-1)
        y = torch.cat([x.mean((1, 2)), x.amax((1, 2))], dim=-1)
        y = linear(torch.relu(linear(y, self.ch_fc1)), self.ch_fc2)
        cw = torch.sigmoid(y).reshape(b, 2, 1, 1, c)
        sw = torch.sigmoid(pointwise(self.sp_conv2, torch.relu(pointwise(self.sp_conv1, x))))
        out1 = x1 + self.lambda_c * cw[:, 1] * x2 + self.lambda_s * sw[..., 1:2] * x2
        out2 = x2 + self.lambda_c * cw[:, 0] * x1 + self.lambda_s * sw[..., 0:1] * x1
        return out1, out2


class _CrossLinearAttention(nn.Module):
    """Linear cross attention on (B, N, C) tokens: q is the stream itself,
    unscaled; k and v from a bias-free projection; the context ``k^T v`` is
    summed in f32, scaled in f32, and softmaxed over axis -2 (the key
    channels) in f32, then cast to v's dtype; each stream's queries read the
    other's context, the product summed in f32 and rounded once."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.kv1 = nn.Linear(dim, 2 * dim, bias=False)
        self.kv2 = nn.Linear(dim, 2 * dim, bias=False)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, c = x1.shape
        heads = self.num_heads
        scale = (c // heads) ** -0.5

        def split(t):  # (B, N, C) -> (B, heads, N, hd)
            return t.reshape(b, n, heads, c // heads).transpose(1, 2)

        def context(kv):
            k, v = split(kv[..., :c]), split(kv[..., c:])
            a = (k.float().transpose(-1, -2) @ v.float()) * scale
            return torch.softmax(a, dim=-2).to(v.dtype)

        ctx1, ctx2 = context(linear(x1, self.kv1)), context(linear(x2, self.kv2))
        y1 = (split(x1).float() @ ctx2.float()).to(x1.dtype)
        y2 = (split(x2).float() @ ctx1.float()).to(x2.dtype)
        return tuple(t.transpose(1, 2).reshape(b, n, c) for t in (y1, y2))


class FeatureFusionModule(nn.Module):
    """FFM: per stream ``relu(channel_proj)`` split into (y, u); the cross
    attention on (u1, u2); ``norm(t + end_proj([y, v]))``; the two streams
    concatenated, then ``out_bn(residual + embed_bn(embed))`` with
    ``embed`` a 1x1, depthwise 3x3, ReLU, 1x1 convolution chain.  The
    BatchNorms are flax's (momentum 0.9, eps 1e-5; ``FlaxBatchNorm2d``)."""

    def __init__(self, dim: int, num_heads: int = 8, reduction: int = 1):
        super().__init__()
        r = dim // reduction
        self.channel_proj1 = nn.Linear(dim, 2 * r)
        self.channel_proj2 = nn.Linear(dim, 2 * r)
        self.cross_attn = _CrossLinearAttention(r, num_heads)
        self.end_proj1 = nn.Linear(2 * r, dim)
        self.end_proj2 = nn.Linear(2 * r, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.residual = nn.Conv2d(2 * dim, dim, 1, bias=False)
        self.embed_conv1 = nn.Conv2d(2 * dim, r, 1)
        self.embed_dw = nn.Conv2d(r, r, 3, padding=1, groups=r)
        self.embed_conv2 = nn.Conv2d(r, dim, 1)
        self.embed_bn = FlaxBatchNorm2d(dim, eps=1e-5, momentum=0.1)
        self.out_bn = FlaxBatchNorm2d(dim, eps=1e-5, momentum=0.1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x1.shape
        t1, t2 = x1.reshape(b, h * w, c), x2.reshape(b, h * w, c)
        p1 = torch.relu(linear(t1, self.channel_proj1))
        p2 = torch.relu(linear(t2, self.channel_proj2))
        r = p1.shape[-1] // 2
        v1, v2 = self.cross_attn(p1[..., r:], p2[..., r:])
        o1 = linear(torch.cat([p1[..., :r], v1], dim=-1), self.end_proj1)
        o2 = linear(torch.cat([p2[..., :r], v2], dim=-1), self.end_proj2)
        t1, t2 = layer_norm(t1 + o1, self.norm1), layer_norm(t2 + o2, self.norm2)
        merge = torch.cat([t1, t2], dim=-1).reshape(b, h, w, 2 * c)
        residual = pointwise(self.residual, merge)
        e = torch.relu(nhwc_conv(pointwise(self.embed_conv1, merge), self.embed_dw))
        e = _bn(pointwise(self.embed_conv2, e), self.embed_bn)
        return _bn(residual + e, self.out_bn)
