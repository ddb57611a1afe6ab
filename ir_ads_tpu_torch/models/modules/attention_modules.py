"""Legacy fusion and attention modules: counterpart of
ir_ads_tpu/models/modules/attention_modules.py (MSPA, PSA, bidirectional
cross attention; reference semseg/models/modules/{mspa,psa,crossatt}.py).

NHWC, attribute names the flax modules' (``utils.jax_params.
library_from_flax``).  Softmaxes and the products the JAX modules take with
``preferred_element_type=f32`` are f32, cast back to the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.layers import (
    BatchNorm, Conv, Dense, LayerNorm, cast, drop_path, gelu,
)


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 'same' average pool of an NHWC map, divided by the count of
    real pixels in the window (count_include_pad=False)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, 1, k // 2,
                        count_include_pad=False).permute(0, 2, 3, 1)


class MSPoolAttention(nn.Module):
    """Multi-scale pool attention (mspa.py:40-58)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = Conv(dim, dim, 7, padding=3, groups=dim)
        self.conv4 = Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(x)
        agg = h + _avg_pool_same(h, 3) + _avg_pool_same(h, 7) + _avg_pool_same(h, 11)
        return torch.sigmoid(self.conv4(agg)) * x + x


class MSPABlock(nn.Module):
    """MSPA block with layer scales and ECA-style channel mixing
    (mspa.py:60-95).  ``c_net`` is a 1-D conv over the channel descriptors,
    (1, 1, 3) here from flax's (3, 1, 1)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.norm1 = BatchNorm(dim)
        self.attn = MSPoolAttention(dim)
        self.c_net = nn.Conv1d(1, 1, 3, padding=1, bias=False)
        self.norm2 = BatchNorm(dim)
        self.fc1 = Conv(dim, hidden, 1)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Conv(hidden, dim, 1)
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        rate, on = self.drop_path_rate, self.training
        h = self.attn(self.norm1(x))
        x = x + drop_path(cast(self.layer_scale_1, x) * h, rate, on, generator)
        desc = x.mean((1, 2))  # (B, C)
        gate = F.conv1d(desc[:, None], cast(self.c_net.weight, desc), padding=1)[:, 0]
        x_c_mix = torch.sigmoid(gate)[:, None, None, :] * x
        h = self.fc2(gelu(self.dwconv(self.fc1(self.norm2(x)))))
        return x_c_mix + drop_path(cast(self.layer_scale_2, x) * h, rate, on, generator)


class PSA(nn.Module):
    """Polarized self-attention, parallel form (psa.py:6-44)."""

    def __init__(self, channels: int):
        super().__init__()
        ch = channels // 2
        self.conv_v_right = Conv(channels, ch, 1, bias=False)
        self.conv_q_right = Conv(channels, 1, 1, bias=False)
        self.conv_up = Conv(ch, channels, 1, bias=False)
        self.conv_q_left = Conv(channels, ch, 1, bias=False)
        self.conv_v_left = Conv(channels, ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        v = self.conv_v_right(x)
        qs = torch.softmax(self.conv_q_right(x).reshape(b, h * w).float(), -1)
        ctx = torch.einsum("bnc,bn->bc", v.reshape(b, h * w, -1).float(), qs)
        ctx = self.conv_up(ctx[:, None, None, :].to(x.dtype))
        spatial = x * torch.sigmoid(ctx)
        avg = self.conv_q_left(x).mean((1, 2))  # (B, ch)
        theta = self.conv_v_left(x).reshape(b, h * w, -1)
        ctx2 = torch.einsum("bc,bnc->bn", avg.float(), theta.float())
        ctx2 = torch.softmax(ctx2, -1).reshape(b, h, w, 1)
        return spatial + x * torch.sigmoid(ctx2.to(x.dtype))


class BidirectionalCrossAttention(nn.Module):
    """One similarity matrix softmaxed both ways (crossatt.py:18-101):
    (B, N, dim) tokens and (B, M, context_dim) context -> (out, context_out)."""

    def __init__(self, dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        context_dim = dim if context_dim is None else context_dim
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim, eps=1e-5)
        self.context_norm = LayerNorm(context_dim, eps=1e-5)
        self.to_qk = Dense(dim, inner, bias=False)
        self.context_to_qk = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.context_to_v = Dense(context_dim, inner, bias=False)
        self.to_out = Dense(inner, dim)
        self.context_to_out = Dense(inner, context_dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor):
        b, n, _ = x.shape
        m = context.shape[1]
        xn, cn = self.norm(x), self.context_norm(context)

        def split(t):
            return t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        qk, cqk = split(self.to_qk(xn)), split(self.context_to_qk(cn))
        v, cv = split(self.to_v(xn)), split(self.context_to_v(cn))
        sim = (qk.float() @ cqk.float().transpose(-1, -2)) * self.dim_head ** -0.5
        attn, context_attn = torch.softmax(sim, -1), torch.softmax(sim, -2)
        out = (attn.to(cv.dtype).float() @ cv.float()).to(x.dtype)
        context_out = (context_attn.to(v.dtype).float().transpose(-1, -2)
                       @ v.float()).to(context.dtype)
        out = out.transpose(1, 2).reshape(b, n, -1)
        context_out = context_out.transpose(1, 2).reshape(b, m, -1)
        return self.to_out(out), self.context_to_out(context_out)
