"""ViTDet: the plain-ViT detection trunk and SimpleFeaturePyramid.
Counterpart of ir_ads_tpu/models/projects/vitdet.py (reference
detectron2/modeling/backbone/vit.py and backbone/utils.py).

NHWC throughout; windows by reshape, padded to a multiple of the window;
decomposed relative-position biases as two small products.  Attribute
names are the flax modules' (``utils.jax_params.library_from_flax``); the
position table ``pos_embed`` (1, gh, gw, C) and the ``rel_pos_*`` tables
(2 * size - 1, head_dim) are held as flax holds them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ir_ads_tpu_torch.ops.layers import (
    Conv, ConvTranspose, Dense, LayerNorm, drop_path, gelu, max_pool,
)
from ir_ads_tpu_torch.utils.torch_import import cubic_resize_weights


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, ws, ws, C), zero-padded at the bottom and
    right to a multiple of ws (backbone/utils.py:16-37)."""
    b, h, w, c = x.shape
    ph, pw = -h % ws, -w % ws
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of ``window_partition`` (backbone/utils.py:40-60)."""
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The (L, C) relative-position table as a (q_size, k_size, C) lookup,
    linearly resized (align_corners=False) when L is not 2 * max - 1
    (backbone/utils.py:63-93)."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        src = rel_pos.shape[0]
        pos = (torch.arange(max_rel, device=rel_pos.device) + 0.5) * (src / max_rel) - 0.5
        lo = torch.clamp(torch.floor(pos).long(), 0, src - 1)
        hi = torch.clamp(lo + 1, 0, src - 1)
        t = torch.clamp(pos - lo, 0.0, 1.0)[:, None]
        rel_pos = rel_pos[lo] * (1 - t) + rel_pos[hi] * t
    qc = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    kc = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (qc - kc) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                           k_size: Tuple[int, int]) -> torch.Tensor:
    """MViTv2's decomposed relative-position bias (backbone/utils.py:96-125):
    attn (B, qh*qw, kh*kw), q (B, qh*qw, C)."""
    qh, qw = q_size
    kh, kw = k_size
    rh = get_rel_pos(qh, kh, rel_pos_h).to(q.dtype)
    rw = get_rel_pos(qw, kw, rel_pos_w).to(q.dtype)
    b, _, dim = q.shape
    rq = q.reshape(b, qh, qw, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    attn = attn.reshape(b, qh, qw, kh, kw) + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, qh * qw, kh * kw)


def resize_cubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "cubic")`` of an NHWC tensor, in
    f32 (``utils.torch_import.cubic_resize_weights``): the absolute position
    table resized to the run's grid."""
    wy = torch.from_numpy(cubic_resize_weights(x.shape[1], size[0])).to(x.device)
    wx = torch.from_numpy(cubic_resize_weights(x.shape[2], size[1])).to(x.device)
    return torch.einsum("bhwc,hH,wW->bHWc", x.float(), wy, wx)


def abs_pos(pos: torch.Tensor, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """The stored (1, gh, gw, C) table at the run's (h, w) grid."""
    if tuple(pos.shape[1:3]) != (h, w):
        pos = resize_cubic(pos, (h, w))
    return pos.to(like.dtype)


class _Attention(nn.Module):
    """Multi-head attention over a 2-D token grid with the decomposed
    rel-pos bias (vit.py Attention); scores and softmax in f32."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: Tuple[int, int] = (14, 14)):
        super().__init__()
        hd = dim // num_heads
        self.dim, self.num_heads, self.use_rel_pos = dim, num_heads, use_rel_pos
        self.qkv = Dense(dim, 3 * dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd)
        attn = (q * hd ** -0.5).float() @ k.float().transpose(1, 2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, q.float(), self.rel_pos_h, self.rel_pos_w,
                                          (h, w), (h, w))
        o = torch.softmax(attn, -1).to(v.dtype) @ v
        o = o.reshape(b, nh, h * w, hd).transpose(1, 2).reshape(b, h, w, self.dim)
        return self.proj(o)


class ViTDet(nn.Module):
    """Plain ViT trunk, windowed attention but at ``global_attn_indexes``
    (vit.py:16-359): (B, H, W, 3) -> {"last_feat": stride-16 map}.  The
    global blocks' rel-pos tables are sized for the token grid ``grid``
    (default img_size / patch_size on both sides): the JAX module sizes them
    for the grid of its first call."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 drop_path_rate: float = 0.1, use_rel_pos: bool = True, in_chans: int = 3,
                 grid: Optional[Tuple[int, int]] = None):
        super().__init__()
        g = img_size // patch_size
        grid = (g, g) if grid is None else tuple(grid)
        self.depth, self.window_size = depth, window_size
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.patch_embed = Conv(in_chans, dim, patch_size, patch_size, padding="same")
        self.pos_embed = nn.Parameter(torch.randn(1, g, g, dim).clamp(-2, 2) * 0.02)
        for i in range(depth):
            size = grid if i in self.global_attn_indexes else (window_size, window_size)
            setattr(self, f"norm1_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn_{i}", _Attention(dim, num_heads, use_rel_pos, size))
            setattr(self, f"norm2_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"fc1_{i}", Dense(dim, 4 * dim))
            setattr(self, f"fc2_{i}", Dense(4 * dim, dim))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        _, h, w, _ = x.shape
        x = x + abs_pos(self.pos_embed, h, w, x)
        ws, on = self.window_size, self.training
        for i in range(self.depth):
            y = getattr(self, f"norm1_{i}")(x)
            attn = getattr(self, f"attn_{i}")
            if i in self.global_attn_indexes:
                y = attn(y)
            else:
                win, pad_hw = window_partition(y, ws)
                y = window_unpartition(attn(win), ws, pad_hw, (h, w))
            x = x + drop_path(y, self.dpr[i], on, generator)
            y = getattr(self, f"fc2_{i}")(gelu(getattr(self, f"fc1_{i}")(
                getattr(self, f"norm2_{i}")(x))))
            x = x + drop_path(y, self.dpr[i], on, generator)
        return {"last_feat": x}


class SimpleFeaturePyramid(nn.Module):
    """{p2 .. p6} from one stride-16 map (vit.py:361-476): scale 4 = two
    stride-2 transposed convs, 2 = one, 1 = the map, 0.5 = a 2x2 max pool;
    each then a 1x1 and a 3x3 conv with LayerNorms; ``top_block_levels``
    stride-2 subsamplings of the deepest level above it."""

    def __init__(self, dim: int = 768, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 top_block_levels: int = 1):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.top_block_levels = top_block_levels
        for idx, scale in enumerate(self.scale_factors):
            cin = dim
            if scale == 4.0:
                setattr(self, f"up_{idx}_a", ConvTranspose(dim, dim // 2, 2))
                setattr(self, f"up_{idx}_ln", LayerNorm(dim // 2, eps=1e-6))
                setattr(self, f"up_{idx}_b", ConvTranspose(dim // 2, dim // 4, 2))
                cin = dim // 4
            elif scale == 2.0:
                setattr(self, f"up_{idx}", ConvTranspose(dim, dim // 2, 2))
                cin = dim // 2
            elif scale not in (1.0, 0.5):
                raise NotImplementedError(f"scale_factor={scale}")
            setattr(self, f"lateral_{idx}", Conv(cin, out_channels, 1, bias=False))
            setattr(self, f"lateral_{idx}_ln", LayerNorm(out_channels, eps=1e-6))
            setattr(self, f"output_{idx}", Conv(out_channels, out_channels, 3, padding=1,
                                                bias=False))
            setattr(self, f"output_{idx}_ln", LayerNorm(out_channels, eps=1e-6))

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = {}
        for idx, scale in enumerate(self.scale_factors):
            x = feat
            if scale == 4.0:
                x = getattr(self, f"up_{idx}_a")(x)
                x = gelu(getattr(self, f"up_{idx}_ln")(x))
                x = getattr(self, f"up_{idx}_b")(x)
            elif scale == 2.0:
                x = getattr(self, f"up_{idx}")(x)
            elif scale == 0.5:
                x = max_pool(x, 2, 2)
            x = getattr(self, f"lateral_{idx}_ln")(getattr(self, f"lateral_{idx}")(x))
            x = getattr(self, f"output_{idx}_ln")(getattr(self, f"output_{idx}")(x))
            outs[f"p{int(np.log2(16 / scale))}"] = x
        last = max(int(k[1:]) for k in outs)
        for i in range(self.top_block_levels):
            outs[f"p{last + 1 + i}"] = max_pool(outs[f"p{last + i}"], 1, 2)
        return outs
