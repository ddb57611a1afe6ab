"""Dual-stream Swin backbone with MAPA adapters, MPG prompting and DSCF
deformable cross-modal fusion, eval mode, NHWC.

Counterpart of ir_ads_tpu/models/backbones/swin.py under two of its
kernel configurations, chosen by explicit arguments (``DISPATCH``):

  r5 (the default; the JAX package's default dispatch on its chip and the
     bench's production set): stages 0-1 run the half-block kernel (K1,
     ops/swin_block.py) and the block tail (K2, ops/block_tail.py), stages
     2-3 the whole-block kernel (K5, ops/swin_block_v6.py); DSCF levels 0-2
     run the rows-layout rpe bias (K3, ops/dscf_rpe.py) and rows attention
     (K4, ops/dscf_rows.py), level 3 the einsum attention with its bias from
     the packed-layout kernel (K6, ops/dscf_rpe_packed.py);
  r4 (the bench's previous set): K1 + K2 at every stage, K3 + K4 at every
     level.

Module and parameter names are the reference checkpoint's
(semseg/models/backbones/swin.py), the same under both, so a reference
state_dict loads as it is and utils/jax_params.from_flax produces one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.block_tail import block_tail
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_attention
from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_rows
from ir_ads_tpu_torch.ops.dscf_rpe_packed import rpe_bias_packed
from ir_ads_tpu_torch.ops.grid_sample import grid_sample_matmul, make_ref_grid
from ir_ads_tpu_torch.ops.layers import FFN, PatchEmbed, PatchMerging, layer_norm
from ir_ads_tpu_torch.ops.swin_block import window_block
from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6
from ir_ads_tpu_torch.ops.window_attention import (
    gather_rel_pos_bias, relative_position_index, shift_region_ids_on,
)

# (Swin block per stage, DSCF attention per level), as the JAX package's
# IR_ADS_SWIN_ATTN / IR_ADS_DSCF_ATTN lists
DISPATCH = {
    "r5": (("pallas4", "pallas4", "pallas6", "pallas6"),
           ("pallas3", "pallas3", "pallas3", "xla")),
    "r4": (("pallas4",) * 4, ("pallas3",) * 4),
}
SWIN_ATTN = ("pallas4", "pallas6")
DSCF_ATTN = ("pallas3", "xla")


def _require(value, supported, what: str) -> None:
    if value not in supported:
        raise NotImplementedError(
            f"{what}={value!r}: the port implements only {supported!r}"
        )


class WindowMSA(nn.Module):
    """Parameters of one W-MSA: rel-pos bias table, qkv and proj."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(ws, ws)),
        )
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window_size)


class Adapter(nn.Module):
    """Adapter MLP, C -> C*ratio -> C with relu, no skip (the block tail
    kernel computes it; ``forward`` is its plain form)."""

    def __init__(self, dim: int, ratio: float = 0.0625):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.D_fc2(torch.relu(self.D_fc1(x)))


class SwinBlockAdapter(nn.Module):
    """Swin block with per-modality adapters.  ``pallas4``: y = x +
    W-MSA(LN1 x) by K1 on the padded, rolled map, then y + FFN(LN2 y) + 0.5
    Adapter(y) by K2.  ``pallas6``: the whole block by K5 on the real map."""

    def __init__(self, dim, num_heads, ffn_dim, window_size, shift,
                 adapter_ratio=0.0625, attn_impl="pallas4", ffn_impl="fused"):
        super().__init__()
        _require(attn_impl, SWIN_ATTN, "attn_impl")
        _require(ffn_impl, ("fused",), "ffn_impl")
        self.attn_impl = attn_impl
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ffn_dim)
        self.MLP_RGB_Adapter = Adapter(dim, adapter_ratio)
        self.MLP_DTE_Adapter = Adapter(dim, adapter_ratio)

    def forward(self, x: torch.Tensor, sub_mode: str) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        msa = self.attn.w_msa
        bias = gather_rel_pos_bias(msa.relative_position_bias_table,
                                   msa.relative_position_index)
        scale = (c // self.num_heads) ** -0.5
        ad = self.MLP_RGB_Adapter if sub_mode == "rgb" else self.MLP_DTE_Adapter
        f1, f2 = self.ffn.layers[0][0], self.ffn.layers[1]
        if self.attn_impl == "pallas6":
            # pad, roll and crop are index arithmetic inside K5
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            region = shift_region_ids_on(hp, wp, ws, shift, x.device) if shift else None
            return window_block_v6(
                x,
                (self.norm1.weight, self.norm1.bias, msa.qkv.weight,
                 msa.qkv.bias, msa.proj.weight, msa.proj.bias, bias),
                (self.norm2.weight, self.norm2.bias, f1.weight, f1.bias,
                 f2.weight, f2.bias, ad.D_fc1.weight, ad.D_fc1.bias,
                 ad.D_fc2.weight, ad.D_fc2.bias),
                region, scale, self.num_heads, ws, shift,
            )
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        xm = F.pad(x, (0, 0, 0, pad_r, 0, pad_b)) if pad_b or pad_r else x
        hp, wp = h + pad_b, w + pad_r
        region = None
        if shift:
            xm = torch.roll(xm, shifts=(-shift, -shift), dims=(1, 2))
            region = shift_region_ids_on(hp, wp, ws, shift, x.device)
        y = window_block(
            xm, self.norm1.weight, self.norm1.bias, msa.qkv.weight,
            msa.qkv.bias, msa.proj.weight, msa.proj.bias, bias, region,
            scale, self.num_heads, ws, h, w, shift,
        )
        if shift:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        y = y[:, :h, :w].contiguous()
        out = block_tail(
            y.reshape(-1, c), self.norm2.weight, self.norm2.bias, f1.weight,
            f1.bias, f2.weight, f2.bias, ad.D_fc1.weight, ad.D_fc1.bias,
            ad.D_fc2.weight, ad.D_fc2.bias,
        )
        return out.reshape(b, h, w, c)


class SwinStage(nn.Module):
    """Blocks (W-MSA, SW-MSA alternating) plus optional patch merging.  The
    JAX package scans deep stages over stacked block pairs; here the blocks
    are a plain list."""

    def __init__(self, dim, depth, num_heads, window_size, downsample,
                 adapter_ratio=0.0625, mlp_ratio=4.0, attn_impl="pallas4"):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlockAdapter(dim, num_heads, int(mlp_ratio * dim), window_size,
                             shift=j % 2 == 1, adapter_ratio=adapter_ratio,
                             attn_impl=attn_impl)
            for j in range(depth)
        )
        self.downsample = PatchMerging(dim, 2 * dim) if downsample else None

    def forward(self, x: torch.Tensor, sub_mode: str):
        for blk in self.blocks:
            x = blk(x, sub_mode)
        out = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, out


class MPGBlock(nn.Module):
    """Cross-modal prompt generation: down-project both streams, fuse,
    up-project, then per-modality affine (TFTS)."""

    def __init__(self, dim: int, ratio: float = 0.125):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(dim, hidden)
        self.P_fc2 = nn.Linear(2 * hidden, hidden)
        self.U_fc1 = nn.Linear(hidden, dim)
        self.tfts_gamma_rgb = nn.Parameter(torch.ones(dim))
        self.tfts_beta_rgb = nn.Parameter(torch.zeros(dim))
        self.tfts_gamma_dte = nn.Parameter(torch.ones(dim))
        self.tfts_beta_dte = nn.Parameter(torch.zeros(dim))

    def forward(self, x_rgb, x_dte):
        x = torch.cat([self.D_fc1(x_rgb), self.D_fc2(x_dte)], dim=-1)
        x = self.U_fc1(self.P_fc2(x))
        p_rgb = x * self.tfts_gamma_rgb + self.tfts_beta_rgb
        p_dte = x * self.tfts_gamma_dte + self.tfts_beta_dte
        return x + p_rgb, x + p_dte


class _LNProxy(nn.Module):
    """LayerNorm over channels of an NCHW map (reference name ``norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return layer_norm(x.permute(0, 2, 3, 1), self.norm).permute(0, 3, 1, 2)


def offset_head(channels: int, ksize: int, stride: int) -> nn.Sequential:
    """Depthwise conv -> LN -> GELU -> 1x1 conv to 2 (dy, dx), on NCHW."""
    pad = ksize // 2 if ksize != stride else 0
    return nn.Sequential(
        nn.Conv2d(channels, channels, ksize, stride, pad, groups=channels),
        _LNProxy(channels),
        nn.GELU(approximate="tanh"),
        nn.Conv2d(channels, 2, 1, bias=False),
    )


class _ConvBNGELU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1),
            nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.GELU(approximate="tanh"),
        )

    def forward(self, x):
        return self.conv(x)


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on channels-last x, as a linear map."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class DAttentionMM(nn.Module):
    """Bi-directional deformable cross-modal attention (DSCF core).  The JAX
    module's ``pallas3`` branch: rpe bias by K3, attention by K4; its
    ``xla`` branch: rpe bias by K6 (``IR_ADS_DSCF_RPE3=pallas``), the
    attention as f32-accumulated products in PyTorch."""

    def __init__(self, dim, n_heads, n_groups, stride, ksize=9, level=0,
                 rpe_size=(60, 80), attn_impl="pallas3"):
        super().__init__()
        _require(attn_impl, DSCF_ATTN, "attn_impl")
        self.attn_impl = attn_impl
        self.n_heads, self.n_groups = n_heads, n_groups
        gc = dim // n_groups
        self.conv_offset_x = offset_head(gc, ksize, stride)
        self.conv_offset_y = offset_head(gc, ksize, stride)
        self.fuse_q = _ConvBNGELU(2 * dim, dim)
        self.proj_q = nn.Conv2d(dim, dim, 1)
        self.get_sample_weight = nn.Sequential(
            nn.Conv2d(dim, dim, 1), nn.ReLU(), nn.Conv2d(dim, 2, 1)
        )
        self.proj_k = nn.Conv2d(dim, dim, 1)
        self.proj_v = nn.Conv2d(dim, dim, 1)
        self.proj_out = nn.Conv2d(dim, dim, 1)
        rh, rw = rpe_size
        self.rpe_table = nn.Parameter(torch.zeros(n_heads, 2 * rh - 1, 2 * rw - 1))
        self.deform_weight = nn.Parameter(
            torch.full((dim,), (1e-3, 1e-3, 1e-3, 1.0)[level])
        )
        self.identity_weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g, heads = self.n_groups, self.n_heads
        gc, hc, hg = c // g, c // heads, heads // g
        scale = hc ** -0.5
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731

        xy = nhwc(self.fuse_q(nchw(torch.cat([x, y], dim=-1))))
        q = _pointwise(self.proj_q, xy)

        def group_view(t):  # (B, H, W, C) -> (B*g, H, W, gc)
            return t.reshape(b, h, w, g, gc).permute(0, 3, 1, 2, 4).reshape(b * g, h, w, gc)

        x_offset = nhwc(self.conv_offset_x(nchw(group_view(x))))
        y_offset = nhwc(self.conv_offset_y(nchw(group_view(y))))
        hk, wk = x_offset.shape[1], x_offset.shape[2]
        n = hk * wk
        ref = make_ref_grid(hk, wk, b * g, centered=True, device=x.device)
        pos_x = torch.clamp(x_offset.float() + ref, -1.0, 1.0)
        pos_y = torch.clamp(y_offset.float() + ref, -1.0, 1.0)

        def both(feat):  # -> (B, 2n, C): [field x block, field y block]
            s = torch.cat([
                grid_sample_matmul(group_view(feat), pos.flip(-1)).reshape(b, g, n, gc)
                for pos in (pos_x, pos_y)
            ], dim=2)
            return s.transpose(1, 2).reshape(b, 2 * n, c)

        x_s, y_s, q_s = both(x), both(y), both(q)
        fc1, fc2 = self.get_sample_weight[0], self.get_sample_weight[2]
        wgt = _pointwise(fc2, torch.relu(_pointwise(fc1, q_s)))
        wgt = torch.softmax(wgt.float(), dim=-1)
        sampled = (wgt[..., 0:1] * x_s.float() + wgt[..., 1:2] * y_s.float()).to(x_s.dtype)
        k = _pointwise(self.proj_k, sampled)
        v = _pointwise(self.proj_v, sampled)

        s1, s2 = self.rpe_table.shape[1:]
        pos_cat = torch.cat([pos_x.reshape(b * g, n, 2), pos_y.reshape(b * g, n, 2)], dim=1)
        table = self.rpe_table.reshape(g, hg, s1, s2)
        if self.attn_impl == "xla":
            out = self._einsum_attention(q, k, v, pos_cat, table, scale)
        else:
            out = self._rows_attention(q, k, v, pos_cat, table, scale)
        out = _pointwise(self.proj_out, out)
        return self.deform_weight * out + self.identity_weight * xy

    def _einsum_attention(self, q, k, v, pos_cat, table, scale):
        """Scores q.k summed in f32 and scaled in f32, plus the K6 bias in
        f32; f32 softmax; probabilities rounded; P.V summed in f32 and
        rounded once (JAX ``swin.py`` einsum branch)."""
        b, h, w, c = q.shape
        heads, m = self.n_heads, k.shape[1]
        hc = c // heads
        bias = rpe_bias_packed(pos_cat, table, h, w, q.dtype)  # (BG, hg, M, HW)
        bias = bias.reshape(b, heads, m, h * w).transpose(-1, -2)
        qh = q.reshape(b, h * w, heads, hc).transpose(1, 2)
        kh = k.reshape(b, m, heads, hc).transpose(1, 2)
        vh = v.reshape(b, m, heads, hc).transpose(1, 2)
        s = (qh.float() @ kh.float().transpose(-1, -2)) * scale + bias.float()
        p = torch.softmax(s, dim=-1).to(vh.dtype)
        out = (p.float() @ vh.float()).to(vh.dtype)
        return out.transpose(1, 2).reshape(b, h, w, c)

    def _rows_attention(self, q, k, v, pos_cat, table, scale):
        """Bias by K3 in the rows layout, attention by K4."""
        b, h, w, c = q.shape
        g, hg = self.n_groups, self.n_heads // self.n_groups
        gc, n2 = c // g, k.shape[1]
        bias = rpe_bias_rows(pos_cat, table, h, w, q.dtype)

        def to_groups(t, m):  # (B, M, C) -> (B*g, M, gc)
            return t.reshape(b, m, g, gc).transpose(1, 2).reshape(b * g, m, gc)

        mp = -(-n2 // 8) * 8
        kg = F.pad(to_groups(k, n2), (0, 0, 0, mp - n2))
        vg = F.pad(to_groups(v, n2), (0, 0, 0, mp - n2))
        out = dscf_rows_attention(to_groups(q.reshape(b, h * w, c), h * w), kg, vg,
                                  bias, scale, hg)
        return out.reshape(b, g, h * w, gc).transpose(1, 2).reshape(b, h, w, c)


class DeformMPGBlock(nn.Module):
    """DSCF fusion: down-project both streams, DAttentionMM, up-project."""

    def __init__(self, dim, stride, n_groups, n_heads, level, ratio=0.125,
                 attn_impl="pallas3"):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(dim, hidden)
        self.deform_atten = DAttentionMM(hidden, n_heads, n_groups, stride,
                                         level=level, attn_impl=attn_impl)
        self.U_fc1 = nn.Linear(hidden, dim)

    def forward(self, x_rgb, x_dte):
        return self.U_fc1(self.deform_atten(self.D_fc1(x_rgb), self.D_fc2(x_dte)))


class SwinTransformer(nn.Module):
    """Dual-stream Swin backbone; returns three 4-level NHWC pyramids
    (fused, rgb, dte).  Defaults are Swin-B (embed 128, depths 2/2/18/2,
    heads 4/8/16/32, window 12) under the ``r5`` dispatch; ``attn_impl``
    and ``dscf_attn`` take one of the ``DISPATCH`` pairs."""

    def __init__(
        self,
        embed_dim: int = 128,
        depths: Sequence[int] = (2, 2, 18, 2),
        num_heads: Sequence[int] = (4, 8, 16, 32),
        window_size: int = 12,
        patch_size: int = 4,
        mlp_ratio: float = 4.0,
        mapa_ratio: float = 0.125,
        adapter_ratio: float = 0.0625,
        dscf_ratio: float = 0.125,
        dscf_strides: Sequence[int] = (8, 4, 2, 1),
        dscf_groups: Sequence[int] = (1, 2, 4, 8),
        dscf_heads: Sequence[int] = (2, 4, 8, 16),
        dual_batch: bool = False,
        attn_impl: Sequence[str] = DISPATCH["r5"][0],
        dscf_attn: Sequence[str] = DISPATCH["r5"][1],
    ):
        super().__init__()
        if dual_batch:
            raise NotImplementedError("dual_batch=True: the port runs the streams in turn")
        _require((tuple(attn_impl), tuple(dscf_attn)), tuple(DISPATCH.values()),
                 "(attn_impl, dscf_attn)")
        nl = len(depths)
        dims = [embed_dim * 2 ** i for i in range(nl)]
        self.num_features = dims
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.extra_patch_embed = PatchEmbed(embed_dim, patch_size)
        self.stages = nn.ModuleList(
            SwinStage(dims[i], depths[i], num_heads[i], window_size, i < nl - 1,
                      adapter_ratio, mlp_ratio, attn_impl[i])
            for i in range(nl)
        )
        self.MPGBlocks = nn.ModuleList(MPGBlock(d, mapa_ratio) for d in dims)
        self.DeformMPGBlocks = nn.ModuleList(
            DeformMPGBlock(dims[i], dscf_strides[i], dscf_groups[i],
                           dscf_heads[i], level=i, ratio=dscf_ratio,
                           attn_impl=dscf_attn[i])
            for i in range(nl)
        )
        for i, d in enumerate(dims):
            for name in (f"norm{i}", f"extra_norm{i}", f"fuse_norm{i}"):
                setattr(self, name, nn.LayerNorm(d, eps=1e-5))

    def forward(self, x_rgb, x_dte) -> Tuple[List[torch.Tensor], ...]:
        x_rgb = self.patch_embed(x_rgb)
        x_dte = self.extra_patch_embed(x_dte)
        outs, outs_rgb, outs_dte = [], [], []
        for i, stage in enumerate(self.stages):
            prompt_rgb, prompt_dte = self.MPGBlocks[i](x_rgb, x_dte)
            x_rgb = x_rgb + prompt_rgb
            x_dte = x_dte + prompt_dte
            x_rgb, rgb_out = stage(x_rgb, "rgb")
            x_dte, dte_out = stage(x_dte, "dte")
            rgb_out = layer_norm(rgb_out, getattr(self, f"norm{i}"))
            dte_out = layer_norm(dte_out, getattr(self, f"extra_norm{i}"))
            fused = self.DeformMPGBlocks[i](rgb_out, dte_out)
            outs.append(layer_norm(fused, getattr(self, f"fuse_norm{i}")))
            outs_rgb.append(rgb_out)
            outs_dte.append(dte_out)
        return outs, outs_rgb, outs_dte


def swin_b(**kw) -> SwinTransformer:
    return SwinTransformer(**kw)
