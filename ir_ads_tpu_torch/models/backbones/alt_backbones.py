"""Alternative backbones: counterpart of
ir_ads_tpu/models/backbones/alt_backbones.py (reference
detrex/modeling/backbone/: ConvNeXt, FocalNet, a plain ViT, InternImage on
the DCNv3 core, EVA-02), and the ``BACKBONES`` registry with MViT and
ViTDet from models/projects/.

NHWC in, {res2 .. res5} out (the ViT {res4}, ViTDet and EVA-02
{last_feat}).  Attribute names are the flax modules' (``utils.jax_params.
library_from_flax``); ConvNeXt's ``gamma``, the position tables and the
rel-pos tables are held as flax holds them.  A module whose parameter
shapes the JAX module reads from its first call takes that size here:
``ViT(img_size=...)``, ``MViT(img_size=...)``.  Drop-path draws from
``generator`` in train mode.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.detection.deform_conv import dcn_v3_core
from ir_ads_tpu_torch.models.projects.mvit import MViT
from ir_ads_tpu_torch.models.projects.vitdet import (
    ViTDet, abs_pos, window_partition, window_unpartition,
)
from ir_ads_tpu_torch.ops.layers import Conv, Dense, LayerNorm, cast, drop_path, gelu


def _rates(rate: float, n: int):
    return [float(r) for r in np.linspace(0, rate, n)]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path_rate: float = 0.0, layer_scale: float = 1e-6):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))
        self.drop_path_rate = drop_path_rate

    def forward(self, x, generator=None):
        h = self.pwconv2(gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + drop_path(h * cast(self.gamma, h), self.drop_path_rate, self.training,
                             generator)


class ConvNeXt(nn.Module):
    """ConvNeXt-T by default (detrex backbone/convnext.py)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.0,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_chans: int = 3):
        super().__init__()
        self.depths, self.out_features = tuple(depths), tuple(out_features)
        dpr = _rates(drop_path_rate, sum(depths))
        self.stem = Conv(in_chans, dims[0], 4, 4, padding="same")
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        cur = 0
        for i in range(4):
            if i:
                setattr(self, f"down_norm_{i}", LayerNorm(dims[i - 1], eps=1e-6))
                setattr(self, f"down_{i}", Conv(dims[i - 1], dims[i], 2, 2, padding="same"))
            for j in range(depths[i]):
                setattr(self, f"block{i}_{j}", ConvNeXtBlock(dims[i], dpr[cur + j]))
            cur += depths[i]
            if f"res{i + 2}" in self.out_features:
                setattr(self, f"out_norm_{i}", LayerNorm(dims[i], eps=1e-6))

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        outs = {}
        for i in range(4):
            if i == 0:
                x = self.stem_norm(self.stem(x))
            else:
                x = getattr(self, f"down_{i}")(getattr(self, f"down_norm_{i}")(x))
            for j in range(self.depths[i]):
                x = getattr(self, f"block{i}_{j}")(x, generator)
            if f"res{i + 2}" in self.out_features:
                outs[f"res{i + 2}"] = getattr(self, f"out_norm_{i}")(x)
        return outs


class FocalModulation(nn.Module):
    """Focal modulation (detrex backbone/focalnet.py)."""

    def __init__(self, dim: int, focal_level: int = 2, focal_window: int = 9):
        super().__init__()
        self.dim, self.focal_level = dim, focal_level
        self.f = Dense(dim, 2 * dim + focal_level + 1)
        for lvl in range(focal_level):
            k = focal_window + 2 * lvl
            setattr(self, f"focal_conv_{lvl}", Conv(dim, dim, k, padding=k // 2, groups=dim,
                                                    bias=False))
        self.h = Conv(dim, dim, 1)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        c, n = self.dim, self.focal_level
        qkv = self.f(x)
        q, ctx, gates = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        ctx_all = 0.0
        for lvl in range(n):
            ctx = gelu(getattr(self, f"focal_conv_{lvl}")(ctx))
            ctx_all = ctx_all + ctx * gates[..., lvl:lvl + 1]
        glob = ctx.mean((1, 2), keepdim=True)
        ctx_all = ctx_all + gelu(glob) * gates[..., n:]
        return self.proj(q * self.h(ctx_all))


class FocalNetBlock(nn.Module):
    def __init__(self, dim: int, drop_path_rate: float = 0.0, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.modulation = FocalModulation(dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)
        self.drop_path_rate = drop_path_rate

    def forward(self, x, generator=None):
        rate, on = self.drop_path_rate, self.training
        x = x + drop_path(self.modulation(self.norm1(x)), rate, on, generator)
        return x + drop_path(self.fc2(gelu(self.fc1(self.norm2(x)))), rate, on, generator)


class FocalNet(nn.Module):
    """FocalNet-T by default."""

    def __init__(self, depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.2,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_chans: int = 3):
        super().__init__()
        self.depths, self.out_features = tuple(depths), tuple(out_features)
        dpr = _rates(drop_path_rate, sum(depths))
        self.stem = Conv(in_chans, dims[0], 4, 4, padding="same")
        self.stem_norm = LayerNorm(dims[0], eps=1e-5)
        cur = 0
        for i in range(4):
            if i:
                setattr(self, f"down_{i}", Conv(dims[i - 1], dims[i], 2, 2, padding="same"))
                setattr(self, f"down_norm_{i}", LayerNorm(dims[i], eps=1e-5))
            for j in range(depths[i]):
                setattr(self, f"block{i}_{j}", FocalNetBlock(dims[i], dpr[cur + j]))
            cur += depths[i]

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        x = self.stem_norm(self.stem(x))
        outs = {}
        for i in range(4):
            if i:
                x = getattr(self, f"down_norm_{i}")(getattr(self, f"down_{i}")(x))
            for j in range(self.depths[i]):
                x = getattr(self, f"block{i}_{j}")(x, generator)
            if f"res{i + 2}" in self.out_features:
                outs[f"res{i + 2}"] = x
        return outs


class ViT(nn.Module):
    """Plain ViT-S trunk, one scale (detrex EVA / EVA-02-style): {"res4"}.
    ``pos_embed`` is sized for the token grid of ``img_size`` (H, W), as
    the JAX module sizes it for its first call's."""

    def __init__(self, img_size: Tuple[int, int] = (480, 640), patch_size: int = 16,
                 dim: int = 384, depth: int = 12, num_heads: int = 6,
                 drop_path_rate: float = 0.0, in_chans: int = 3):
        super().__init__()
        gh, gw = (-(-s // patch_size) for s in img_size)
        self.depth, self.num_heads, self.dim = depth, num_heads, dim
        self.dpr = _rates(drop_path_rate, depth)
        self.patch_embed = Conv(in_chans, dim, patch_size, patch_size, padding="same")
        self.pos_embed = nn.Parameter(torch.randn(1, gh, gw, dim).clamp(-2, 2) * 0.02)
        for i in range(depth):
            setattr(self, f"norm1_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"qkv_{i}", Dense(dim, 3 * dim))
            setattr(self, f"proj_{i}", Dense(dim, dim))
            setattr(self, f"norm2_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"fc1_{i}", Dense(dim, 4 * dim))
            setattr(self, f"fc2_{i}", Dense(4 * dim, dim))
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        nh, on = self.num_heads, self.training
        hd = c // nh
        t = (x + cast(self.pos_embed, x)).reshape(b, h * w, c)
        for i in range(self.depth):
            qkv = getattr(self, f"qkv_{i}")(getattr(self, f"norm1_{i}")(t))
            q, k, v = qkv.reshape(b, -1, 3, nh, hd).permute(2, 0, 3, 1, 4)
            attn = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5, -1)
            o = (attn.to(v.dtype).float() @ v.float()).to(v.dtype)
            o = getattr(self, f"proj_{i}")(o.transpose(1, 2).reshape(b, -1, c))
            t = t + drop_path(o, self.dpr[i], on, generator)
            m = getattr(self, f"fc2_{i}")(gelu(getattr(self, f"fc1_{i}")(
                getattr(self, f"norm2_{i}")(t))))
            t = t + drop_path(m, self.dpr[i], on, generator)
        return {"res4": self.norm(t).reshape(b, h, w, c)}


class InternImageBlock(nn.Module):
    """InternImage's basic layer: the DCNv3 mixer and an MLP (detrex
    internimage.py).  The offset and mask projections start at zero."""

    def __init__(self, dim: int, groups: int = 4, drop_path_rate: float = 0.0):
        super().__init__()
        self.groups, self.drop_path_rate = groups, drop_path_rate
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.input_proj = Dense(dim, dim)
        self.offset_dw = Conv(dim, dim, 3, padding=1, groups=dim)
        self.offsets = Dense(dim, groups * 9 * 2)
        self.mask = Dense(dim, groups * 9)
        for lin in (self.offsets, self.mask):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)
        self.output_proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, 4 * dim)
        self.fc2 = Dense(4 * dim, dim)

    def forward(self, x, generator=None):
        rate, on, g = self.drop_path_rate, self.training, self.groups
        h = self.norm1(x)
        v = self.input_proj(h)
        dw = self.offset_dw(h)
        offsets = self.offsets(dw)
        mask = self.mask(dw)
        b, hh, ww, _ = mask.shape
        mask = torch.softmax(mask.reshape(b, hh, ww, g, 9).float(), -1)
        mask = mask.reshape(b, hh, ww, -1).to(x.dtype)
        mixed = self.output_proj(dcn_v3_core(v, offsets.float(), mask, 3, g))
        x = x + drop_path(mixed, rate, on, generator)
        return x + drop_path(self.fc2(gelu(self.fc1(self.norm2(x)))), rate, on, generator)


class InternImage(nn.Module):
    """InternImage-T by default."""

    def __init__(self, depths: Sequence[int] = (4, 4, 18, 4),
                 dims: Sequence[int] = (64, 128, 256, 512),
                 groups: Sequence[int] = (4, 8, 16, 32), drop_path_rate: float = 0.2,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_chans: int = 3):
        super().__init__()
        self.depths, self.out_features = tuple(depths), tuple(out_features)
        dpr = _rates(drop_path_rate, sum(depths))
        self.stem1 = Conv(in_chans, dims[0] // 2, 3, 2, padding=1)
        self.stem_norm1 = LayerNorm(dims[0] // 2, eps=1e-5)
        self.stem2 = Conv(dims[0] // 2, dims[0], 3, 2, padding=1)
        self.stem_norm2 = LayerNorm(dims[0], eps=1e-5)
        cur = 0
        for i in range(4):
            if i:
                setattr(self, f"down_{i}", Conv(dims[i - 1], dims[i], 3, 2, padding=1))
                setattr(self, f"down_norm_{i}", LayerNorm(dims[i], eps=1e-5))
            for j in range(depths[i]):
                setattr(self, f"block{i}_{j}", InternImageBlock(dims[i], groups[i], dpr[cur + j]))
            cur += depths[i]

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        x = self.stem_norm2(self.stem2(gelu(self.stem_norm1(self.stem1(x)))))
        outs = {}
        for i in range(4):
            if i:
                x = getattr(self, f"down_norm_{i}")(getattr(self, f"down_{i}")(x))
            for j in range(self.depths[i]):
                x = getattr(self, f"block{i}_{j}")(x, generator)
            if f"res{i + 2}" in self.out_features:
                outs[f"res{i + 2}"] = x
        return outs


BACKBONES = {
    "convnext": ConvNeXt,
    "focalnet": FocalNet,
    "vit": ViT,
    "internimage": InternImage,
    "mvit": MViT,
    "vitdet": ViTDet,
}


# ------------------------------------------------------------------- EVA-02
def _rope_freqs(head_dim: int, seq_len: int, pt_seq_len: int = 16,
                theta: float = 10000.0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D rotary tables (reference eva_02_utils.py:309-351): per-axis
    frequencies on a pt_seq_len-normalised grid, each repeated in
    interleaved pairs, y and x concatenated.  (seq*seq, head_dim) cos, sin."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    t = np.arange(seq_len, dtype=np.float64) / seq_len * pt_seq_len
    f = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)  # (seq, dim)
    fy = np.broadcast_to(f[:, None, :], (seq_len, seq_len, dim))
    fx = np.broadcast_to(f[None, :, :], (seq_len, seq_len, dim))
    full = np.concatenate([fy, fx], axis=-1).reshape(-1, 2 * dim)
    return (torch.from_numpy(np.cos(full).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(full).astype(np.float32)).to(device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (x1, x2) -> (-x2, x1) (eva_02_utils.py:250-254)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], -1).reshape(*x.shape[:-2], -1)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t (..., N, head_dim); cos, sin (N, head_dim)."""
    return t * cos + _rotate_half(t) * sin


class SwiGLU(nn.Module):
    """w3(silu(w1 x) * w2 x) with the sub-LayerNorm on the hidden
    (eva_02.py:39-63)."""

    def __init__(self, dim: int, hidden: int, subln: bool = True):
        super().__init__()
        self.w1 = Dense(dim, hidden)
        self.w2 = Dense(dim, hidden)
        if subln:
            self.ffn_ln = LayerNorm(hidden, eps=1e-6)
        self.w3 = Dense(hidden, dim)

    def forward(self, x):
        h = F.silu(self.w1(x)) * self.w2(x)
        if hasattr(self, "ffn_ln"):
            h = self.ffn_ln(h)
        return self.w3(h)


class EVA02Attention(nn.Module):
    """q, k (bias-free), v projections, rope on q and k in f32
    (eva_02.py:66-137)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim, bias=False)
        self.v_proj = Dense(dim, dim)
        self.proj = Dense(dim, dim)

    def forward(self, x, rope):
        b, h, w, c = x.shape
        n, nh = h * w, self.num_heads
        hd = self.dim // nh
        xf = x.reshape(b, n, c)

        def heads(t):
            return t.reshape(b, n, nh, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(xf)), heads(self.k_proj(xf)), heads(self.v_proj(xf))
        cos, sin = rope
        q = _apply_rope(q.float(), cos, sin).to(v.dtype)
        k = _apply_rope(k.float(), cos, sin).to(v.dtype)
        attn = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
        o = torch.softmax(attn, -1).to(v.dtype) @ v
        o = self.proj(o.transpose(1, 2).reshape(b, n, self.dim))
        return o.reshape(b, h, w, self.dim)


class EVA02ViT(nn.Module):
    """EVA-02 ViT-B trunk (eva_02.py:290-475): absolute position table, 2-D
    rope attention and SwiGLU blocks, windowed but at ``global_indexes``:
    (B, H, W, 3) -> {"last_feat"} at stride ``patch_size``."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4 * 2 / 3,
                 window_size: int = 16, global_indexes: Sequence[int] = (2, 5, 8, 11),
                 pt_hw_seq_len: int = 16, drop_path_rate: float = 0.1, in_chans: int = 3):
        super().__init__()
        g = img_size // patch_size
        self.depth, self.num_heads, self.dim = depth, num_heads, dim
        self.window_size, self.pt_hw_seq_len = window_size, pt_hw_seq_len
        self.global_indexes = tuple(global_indexes)
        self.dpr = _rates(drop_path_rate, depth)
        self.patch_embed = Conv(in_chans, dim, patch_size, patch_size, padding="same")
        self.pos_embed = nn.Parameter(torch.randn(1, g, g, dim).clamp(-2, 2) * 0.02)
        for i in range(depth):
            setattr(self, f"norm1_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn_{i}", EVA02Attention(dim, num_heads))
            setattr(self, f"norm2_{i}", LayerNorm(dim, eps=1e-6))
            setattr(self, f"mlp_{i}", SwiGLU(dim, int(dim * mlp_ratio)))

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        x = x + abs_pos(self.pos_embed, h, w, x)
        hd, ws, on = self.dim // self.num_heads, self.window_size, self.training
        s = max(h, w)
        cos, sin = _rope_freqs(hd, s, self.pt_hw_seq_len, device=x.device)
        if h != w:  # a non-square grid: the (s, s) table cut to (h, w)
            cos = cos.reshape(s, s, -1)[:h, :w].reshape(h * w, -1)
            sin = sin.reshape(s, s, -1)[:h, :w].reshape(h * w, -1)
        rope_glb = (cos, sin)
        rope_win = _rope_freqs(hd, ws, self.pt_hw_seq_len, device=x.device)
        for i in range(self.depth):
            y = getattr(self, f"norm1_{i}")(x)
            attn = getattr(self, f"attn_{i}")
            if i in self.global_indexes:
                y = attn(y, rope_glb)
            else:
                win, pad_hw = window_partition(y, ws)
                y = window_unpartition(attn(win, rope_win), ws, pad_hw, (h, w))
            x = x + drop_path(y, self.dpr[i], on, generator)
            y = getattr(self, f"mlp_{i}")(getattr(self, f"norm2_{i}")(x))
            x = x + drop_path(y, self.dpr[i], on, generator)
        return {"last_feat": x}
