"""MViTv2 backbone: counterpart of ir_ads_tpu/models/projects/mvit.py
(reference detectron2/modeling/backbone/mvit.py).

NHWC; the q/k/v pooling is a per-head depthwise conv then LayerNorm, the
hybrid window attention reuses ViTDet's window helpers and the decomposed
rel-pos bias.  Attribute names are the flax modules'.  The rel-pos tables'
size follows the token grid after the patch embedding, which the JAX module
reads from its first call and this one from ``img_size``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ir_ads_tpu_torch.models.projects.vitdet import (
    add_decomposed_rel_pos, window_partition, window_unpartition,
)
from ir_ads_tpu_torch.ops.layers import Conv, Dense, LayerNorm, drop_path, gelu, max_pool


class _PoolNorm(nn.Module):
    """attention_pool (mvit.py:24-33): depthwise conv pool + LayerNorm on a
    (B', H, W, Ch) per-head map."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.pool = Conv(channels, channels, kernel, stride, padding=kernel // 2,
                         groups=channels, bias=False)
        self.norm = LayerNorm(channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.pool(x))


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention (mvit.py:36-178); scores and softmax in
    f32."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, stride_q: int = 1,
                 stride_kv: int = 1, pool_kernel: int = 3, residual_pooling: bool = True,
                 window_size: int = 0, use_rel_pos: bool = True,
                 input_size: Tuple[int, int] = (56, 56)):
        super().__init__()
        hd = dim_out // num_heads
        self.dim_out, self.num_heads, self.hd = dim_out, num_heads, hd
        self.stride_q, self.stride_kv = stride_q, stride_kv
        self.window_size, self.residual_pooling = window_size, residual_pooling
        self.use_rel_pos = use_rel_pos
        self.qkv = Dense(dim, 3 * dim_out)
        self.pool_q = _PoolNorm(hd, pool_kernel, stride_q)
        self.pool_k = _PoolNorm(hd, pool_kernel, stride_kv)
        self.pool_v = _PoolNorm(hd, pool_kernel, stride_kv)
        if use_rel_pos:
            size = max(input_size)
            rel_dim = 2 * max(size // stride_q, size // stride_kv) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, hd))
        self.proj = Dense(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        nh, hd = self.num_heads, self.hd
        qkv = self.qkv(x).reshape(b, h, w, 3, nh, hd).permute(3, 0, 4, 1, 2, 5)
        qkv = qkv.reshape(3, b * nh, h, w, hd)
        q, k, v = self.pool_q(qkv[0]), self.pool_k(qkv[1]), self.pool_v(qkv[2])
        ori_q = q
        if self.window_size:
            q_ws = self.window_size // self.stride_q
            kv_ws = self.window_size // self.stride_kv
            q, q_pad = window_partition(q, q_ws)
            k, _ = window_partition(k, kv_ws)
            v, _ = window_partition(v, kv_ws)
            q_hw, kv_hw = (q_ws, q_ws), (kv_ws, kv_ws)
        else:
            q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
        qf = q.reshape(q.shape[0], -1, hd)
        kf = k.reshape(k.shape[0], -1, hd)
        vf = v.reshape(v.shape[0], -1, hd)
        attn = (qf * hd ** -0.5).float() @ kf.float().transpose(1, 2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, qf.float(), self.rel_pos_h, self.rel_pos_w,
                                          q_hw, kv_hw)
        o = (torch.softmax(attn, -1).to(vf.dtype) @ vf).reshape(-1, q_hw[0], q_hw[1], hd)
        if self.window_size:
            o = window_unpartition(o, q_ws, q_pad, tuple(ori_q.shape[1:3]))
        if self.residual_pooling:
            o = o + ori_q
        oh, ow = o.shape[1:3]
        o = o.reshape(b, nh, oh, ow, hd).permute(0, 2, 3, 1, 4).reshape(b, oh, ow, self.dim_out)
        return self.proj(o)


class MultiScaleBlock(nn.Module):
    """Transformer block with pooled attention (mvit.py:180-270)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, stride_q: int = 1,
                 stride_kv: int = 1, window_size: int = 0, use_rel_pos: bool = True,
                 residual_pooling: bool = True, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, input_size: Tuple[int, int] = (56, 56)):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, stride_q, stride_kv,
                                        residual_pooling=residual_pooling,
                                        window_size=window_size, use_rel_pos=use_rel_pos,
                                        input_size=input_size)
        if dim != dim_out:
            self.proj = Dense(dim, dim_out)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.fc1 = Dense(dim_out, int(dim_out * mlp_ratio))
        self.fc2 = Dense(int(dim_out * mlp_ratio), dim_out)
        self.stride_q, self.drop_path_rate = stride_q, drop_path_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate, on = self.drop_path_rate, self.training
        xn = self.norm1(x)
        att = self.attn(xn)
        if hasattr(self, "proj"):
            x = self.proj(xn)
        if self.stride_q > 1:  # the skip connection pooled with the same stride
            k = self.stride_q + 1
            x = max_pool(x, k, self.stride_q, k // 2)
        x = x + drop_path(att, rate, on, generator)
        m = self.fc2(gelu(self.fc1(self.norm2(x))))
        return x + drop_path(m, rate, on, generator)


class MViT(nn.Module):
    """MViTv2-T by default (mvit.py:272-455): 16 blocks, stages ending at
    ``last_block_indexes``, width and heads doubling and the kv stride
    halving by stage, windowed attention but in the last block of each of
    the last three stages (the JAX module's schedule, block for block).
    (B, H, W, 3) -> {scale2 .. scale5} for ``out_features``; ``img_size``
    is the (H, W) the rel-pos tables are sized for."""

    def __init__(self, img_size: Tuple[int, int] = (1024, 1024), embed_dim: int = 96,
                 depth: int = 16, num_heads: int = 1,
                 last_block_indexes: Sequence[int] = (0, 2, 11, 15),
                 adaptive_kv_stride: int = 4, adaptive_window_size: int = 56,
                 drop_path_rate: float = 0.0, use_rel_pos: bool = True,
                 out_features: Sequence[str] = ("scale2", "scale3", "scale4", "scale5"),
                 in_chans: int = 3):
        super().__init__()
        last = tuple(last_block_indexes)
        self.depth, self.last, self.out_features = depth, last, tuple(out_features)
        self.patch_embed = Conv(in_chans, embed_dim, 7, 4, padding=3)
        dpr = np.linspace(0, drop_path_rate, depth)
        dim = dim_out = embed_dim
        heads, stride_kv, window = num_heads, adaptive_kv_stride, adaptive_window_size
        input_size = tuple((s + 6 - 7) // 4 + 1 for s in img_size)
        stage = 2
        for i in range(depth):
            stride_kv_ = stride_kv * 2 if i in (last[1], last[2]) else stride_kv
            setattr(self, f"block_{i}", MultiScaleBlock(
                dim, dim_out, heads, stride_q=2 if i - 1 in last else 1, stride_kv=stride_kv_,
                window_size=0 if i in last[1:] else window, use_rel_pos=use_rel_pos,
                drop_path_rate=float(dpr[i]), input_size=input_size))
            dim = dim_out
            if i in last:
                name = f"scale{stage}"
                if name in self.out_features:
                    setattr(self, f"{name}_norm", LayerNorm(dim_out, eps=1e-6))
                dim_out *= 2
                heads *= 2
                stride_kv = max(stride_kv // 2, 1)
                stage += 1
            if i - 1 in last:
                window //= 2
                input_size = (input_size[0] // 2, input_size[1] // 2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        outs: Dict[str, torch.Tensor] = {}
        stage = 2
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
            if i in self.last:
                name = f"scale{stage}"
                if name in self.out_features:
                    outs[name] = getattr(self, f"{name}_norm")(x)
                stage += 1
        return outs
