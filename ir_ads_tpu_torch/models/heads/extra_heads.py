"""More decode heads: counterpart of ir_ads_tpu/models/heads/extra_heads.py
(UPerHead, LightHamHead with its NMF hamburger, FPNHead, FCNHead, CondHead).

NHWC modules with SegFormerHead's interface, ``head(features) -> logits``
at the first level's resolution (the caller upsamples), built from the
levels' channel counts ``in_dims``.  Attribute names are the flax modules'
names, so ``utils.jax_params.library_from_flax`` carries a flax tree over.
Train mode (``self.training``): BatchNorms use and update batch statistics
as flax's do, and the dropout before the classifier draws its mask from
``generator``; CondHead returns (guidance, seg) there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import (
    BatchNorm, Conv, Dense, GroupNormNHWC, dropout, resize_bilinear,
)


class ConvModule(nn.Module):
    """Conv + BN (or GN) + ReLU (mmcv ConvModule semantics); ``norm`` is
    "bn", "gn" (flax's GroupNorm: 32 groups, eps 1e-6) or "none" (the conv
    then carries a bias)."""

    def __init__(self, cin: int, features: int, kernel: int = 1, norm: str = "bn",
                 act: bool = True):
        super().__init__()
        self.conv = Conv(cin, features, kernel, padding=kernel // 2, bias=norm == "none")
        if norm == "bn":
            self.bn = BatchNorm(features)
        elif norm == "gn":
            self.gn = GroupNormNHWC(features)
        self.norm, self.act = norm, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm == "bn":
            x = self.bn(x)
        elif self.norm == "gn":
            x = self.gn(x)
        return F.relu(x) if self.act else x


def _adaptive_avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """torch's adaptive_avg_pool2d bins [floor(i*n/s), ceil((i+1)*n/s)) on
    an NHWC map -> (B, s, s, C)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


class PPM(nn.Module):
    """Pyramid pooling (reference semseg/models/modules/ppm.py)."""

    def __init__(self, cin: int, out_channels: int, scales: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(len(self.scales)):
            setattr(self, f"stage_{i}", ConvModule(cin, out_channels, 1))
        self.bottleneck = ConvModule(cin + len(self.scales) * out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        outs = [x]
        for i, s in enumerate(self.scales):
            p = getattr(self, f"stage_{i}")(_adaptive_avg_pool(x, s))
            outs.append(resize_bilinear(p, (h, w), align_corners=False))
        return self.bottleneck(torch.cat(outs, -1))


def _classify(head: nn.Module, out: torch.Tensor, conv: nn.Module,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The dropout before the classifier (train mode), then the classifier."""
    return conv(dropout(out, head.drop, head.training, generator))


class UPerHead(nn.Module):
    """UPerNet head (reference heads/upernet.py:9-47)."""

    def __init__(self, in_dims: Sequence[int], channel: int = 128, num_classes: int = 19,
                 scales: Sequence[int] = (1, 2, 3, 6), drop: float = 0.1):
        super().__init__()
        n = len(in_dims)
        self.ppm = PPM(in_dims[-1], channel, scales)
        for i in range(n - 1):
            setattr(self, f"fpn_in_{i}", ConvModule(in_dims[i], channel, 1))
            setattr(self, f"fpn_out_{i}", ConvModule(channel, channel, 3))
        self.bottleneck = ConvModule(n * channel, channel, 3)
        self.conv_seg = Conv(channel, num_classes, 1)
        self.drop = drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f = self.ppm(features[-1])
        fpn = [f]
        for i in reversed(range(len(features) - 1)):
            lateral = getattr(self, f"fpn_in_{i}")(features[i])
            f = lateral + resize_bilinear(f, lateral.shape[1:3], align_corners=False)
            fpn.append(getattr(self, f"fpn_out_{i}")(f))
        fpn.reverse()
        size = fpn[0].shape[1:3]
        fpn = [fpn[0]] + [resize_bilinear(p, size, align_corners=False) for p in fpn[1:]]
        out = self.bottleneck(torch.cat(fpn, -1))
        return _classify(self, out, self.conv_seg, generator)


def _nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` at exactly 2x: a repeat."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FPNHead(nn.Module):
    """Panoptic FPN head (reference heads/fpn.py)."""

    def __init__(self, in_dims: Sequence[int], channel: int = 128, num_classes: int = 19,
                 drop: float = 0.1):
        super().__init__()
        dims = list(in_dims)[::-1]
        for i, d in enumerate(dims):
            setattr(self, f"lateral_{i}", ConvModule(d, channel, 1))
            if i:
                setattr(self, f"output_{i}", ConvModule(channel, channel, 3))
        self.conv_seg = Conv(channel, num_classes, 1)
        self.drop = drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = list(features)[::-1]
        out = self.lateral_0(feats[0])
        for i in range(1, len(feats)):
            out = _nearest_2x(out) + getattr(self, f"lateral_{i}")(feats[i])
            out = getattr(self, f"output_{i}")(out)
        return _classify(self, out, self.conv_seg, generator)


class FCNHead(nn.Module):
    """Plain FCN head on the last feature (reference heads/fcn.py)."""

    def __init__(self, in_dims: Sequence[int], channel: int = 256, num_classes: int = 19):
        super().__init__()
        self.conv = ConvModule(in_dims[-1], channel, 1)
        self.cls = Conv(channel, num_classes, 1)

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls(self.conv(features[-1]))


class CondHead(nn.Module):
    """Conditional dynamic-filter head (reference heads/condnet.py): (guidance
    logits, seg logits) in train mode, seg logits in eval.  The guidance
    softmax and the class filters are f32, as in the JAX head."""

    def __init__(self, in_dims: Sequence[int], channel: int = 512, num_classes: int = 19,
                 drop: float = 0.1):
        super().__init__()
        self.conv = ConvModule(in_dims[-1], channel, 1)
        self.guidance_project = Conv(channel, num_classes, 1)
        self.filter_project = Dense(channel, channel + 1)
        self.num_classes, self.drop = num_classes, drop

    def forward(self, features: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        x = dropout(self.conv(features[-1]), self.drop, self.training, generator)
        b, h, w, c = x.shape
        guidance = self.guidance_project(x)
        gm = torch.softmax(guidance.reshape(b, h * w, self.num_classes).float(), 1)
        filters = gm.transpose(1, 2) @ x.reshape(b, h * w, c).float() / (h * w)
        cond = self.filter_project(filters.to(x.dtype))  # (B, K, C + 1)
        wgt, bias = cond[..., :c], cond[..., c]
        seg = x.reshape(b, h * w, c) @ wgt.transpose(1, 2) + bias[:, None]
        seg = seg.reshape(b, h, w, self.num_classes)
        return (guidance, seg) if self.training else seg


class NMF2D(nn.Module):
    """Non-negative matrix factorisation by multiplicative updates
    (reference hem.py:99-140), in f32: 6 steps in train mode, 7 in eval,
    and one last coefficient update.  ``bases`` (B, C, rank) are the raw
    uniform draws, normalised here; without them they are drawn from
    ``generator`` (the JAX module draws from its ``nmf`` rng, or from
    PRNGKey(0), which the port cannot reproduce)."""

    def __init__(self, rank: int = 64, train_steps: int = 6, eval_steps: int = 7):
        super().__init__()
        self.rank, self.train_steps, self.eval_steps = rank, train_steps, eval_steps

    def forward(self, x: torch.Tensor, bases: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        xf = x.reshape(b, h * w, c).transpose(1, 2).float()  # (B, D, N)
        if bases is None:
            bases = torch.rand((b, c, self.rank), generator=generator, device=x.device)
        bases = bases.float()
        bases = bases / (torch.linalg.vector_norm(bases, dim=1, keepdim=True) + 1e-12)
        coef = torch.softmax(xf.transpose(1, 2) @ bases, -1)  # (B, N, r)

        def update_coef(bases, coef):
            num = xf.transpose(1, 2) @ bases
            den = coef @ (bases.transpose(1, 2) @ bases)
            return coef * num / (den + 1e-6)

        for _ in range(self.train_steps if self.training else self.eval_steps):
            coef = update_coef(bases, coef)
            num = xf @ coef
            den = bases @ (coef.transpose(1, 2) @ coef)
            bases = bases * num / (den + 1e-6)
        coef = update_coef(bases, coef)
        out = bases @ coef.transpose(1, 2)  # (B, D, N)
        return out.transpose(1, 2).reshape(b, h, w, c).to(x.dtype)


class LightHamHead(nn.Module):
    """SegNeXt's LightHam head (reference hem.py:142-202) on levels 1..3."""

    def __init__(self, in_dims: Sequence[int], ham_channels: int = 512,
                 num_classes: int = 25):
        super().__init__()
        self.squeeze = ConvModule(sum(in_dims[1:]), ham_channels, 1, norm="gn")
        self.ham_in = Conv(ham_channels, ham_channels, 1)
        self.ham = NMF2D()
        self.ham_out = ConvModule(ham_channels, ham_channels, 1, norm="gn", act=False)
        self.align = ConvModule(ham_channels, ham_channels, 1, norm="gn")
        self.conv_seg = Conv(ham_channels, num_classes, 1)

    def forward(self, features: Sequence[torch.Tensor], bases: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = list(features[1:])
        size = feats[0].shape[1:3]
        feats = [feats[0]] + [resize_bilinear(f, size, align_corners=False) for f in feats[1:]]
        x = self.squeeze(torch.cat(feats, -1))
        h = self.ham(F.relu(self.ham_in(x)), bases, generator)
        x = F.relu(x + self.ham_out(h))
        return self.conv_seg(self.align(x))
