"""Dual-stream Swin backbone with MAPA adapters, MPG prompting and DSCF
deformable cross-modal fusion, NHWC.

Counterpart of ir_ads_tpu/models/backbones/swin.py under three of its
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
  train (what the JAX package runs under ``train=True``): K1 at every stage,
     differentiable through K7 (ops/window_attn_bwd.py), with drop-path by
     reconstruction, ``x + drop_path(K1(x) - x)``; the block tail as modules
     under autograd (LN2, FFN with drop-path, 0.5 * Adapter with dropout);
     DSCF as r5, K4 differentiable through K8 (ops/dscf_rows_bwd.py) and the
     bias kernels through their f32 twin.

r5 and r4 are the eval dispatches: K2 and K5 have no backward and raise when
an input requires a gradient, and a model built for them draws no random
numbers in any mode.  Under ``train`` the stochastic pieces (MMST modality
mask, drop-path, adapter dropout) are on while ``module.training`` is set
and draw from the ``generator`` handed to ``forward``.

Parameters may be kept in f32 while the activations are bf16: every module
casts its parameters at use (``layers.cast``), as flax does, and the kernel
wrappers round theirs on entry.

Module and parameter names are the reference checkpoint's
(semseg/models/backbones/swin.py), the same under every dispatch, so a
reference state_dict loads as it is and utils/jax_params.from_flax produces
one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.ops.block_tail import block_tail
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_attention
from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_rows
from ir_ads_tpu_torch.ops.dscf_rpe_packed import rpe_bias_packed
from ir_ads_tpu_torch.ops.grid_sample import grid_sample_matmul, make_ref_grid
from ir_ads_tpu_torch.ops.layers import (
    FFN, FlaxBatchNorm2d, PatchEmbed, PatchMerging, cast, conv2d, drop_path, dropout,
    gelu, layer_norm, linear, pointwise,
)
from ir_ads_tpu_torch.ops.swin_block import window_block
from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6
from ir_ads_tpu_torch.ops.window_attention import (
    gather_rel_pos_bias, relative_position_index, shift_region_ids_on,
)

# (Swin block per stage, DSCF attention per level, block tail), as the JAX
# package's IR_ADS_SWIN_ATTN / IR_ADS_DSCF_ATTN lists and IR_ADS_FFN
DISPATCH = {
    "r5": (("pallas4", "pallas4", "pallas6", "pallas6"),
           ("pallas3", "pallas3", "pallas3", "xla"), "fused"),
    "r4": (("pallas4",) * 4, ("pallas3",) * 4, "fused"),
    "train": (("pallas4",) * 4, ("pallas3", "pallas3", "pallas3", "xla"), "module"),
}
SWIN_ATTN = ("pallas4", "pallas6")
DSCF_ATTN = ("pallas3", "xla")
FFN_IMPL = ("fused", "module")


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
    kernel computes it in eval; ``forward`` is its module form, with dropout
    of rate ``drop`` after the relu)."""

    def __init__(self, dim: int, ratio: float = 0.0625):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, drop: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(torch.relu(linear(x, self.D_fc1)), drop, drop > 0.0, generator)
        return linear(h, self.D_fc2)


class SwinBlockAdapter(nn.Module):
    """Swin block with per-modality adapters.  ``pallas4``: y = x +
    W-MSA(LN1 x) by K1 on the padded, rolled map, then y + FFN(LN2 y) + 0.5
    Adapter(y), by K2 (``ffn_impl="fused"``) or as modules under autograd
    (``"module"``, the training tail: drop-path on the attention and FFN
    branches and dropout inside the adapter while ``training``).
    ``pallas6``: the whole block by K5 on the real map."""

    def __init__(self, dim, num_heads, ffn_dim, window_size, shift,
                 adapter_ratio=0.0625, attn_impl="pallas4", ffn_impl="fused",
                 drop_path_rate=0.0, adapter_drop=0.1):
        super().__init__()
        _require(attn_impl, SWIN_ATTN, "attn_impl")
        _require(ffn_impl, FFN_IMPL, "ffn_impl")
        if attn_impl == "pallas6" and ffn_impl != "fused":
            raise NotImplementedError("pallas6 is the whole block: ffn_impl must be 'fused'")
        self.attn_impl = attn_impl
        self.ffn_impl = ffn_impl
        self.drop_path_rate = float(drop_path_rate)
        self.adapter_drop = float(adapter_drop)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ffn_dim)
        self.MLP_RGB_Adapter = Adapter(dim, adapter_ratio)
        self.MLP_DTE_Adapter = Adapter(dim, adapter_ratio)

    def forward(self, x: torch.Tensor, sub_mode: str,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        y = y[:, :h, :w]
        if self.ffn_impl == "fused":
            out = block_tail(
                y.contiguous().reshape(-1, c), self.norm2.weight, self.norm2.bias, f1.weight,
                f1.bias, f2.weight, f2.bias, ad.D_fc1.weight, ad.D_fc1.bias,
                ad.D_fc2.weight, ad.D_fc2.bias,
            )
            return out.reshape(b, h, w, c)
        rate = self.drop_path_rate if self.training else 0.0
        if rate > 0.0:
            # K1 fused the residual: recover the branch and drop it per sample
            y = x + drop_path(y - x, rate, True, generator)
        adapter_x = 0.5 * ad(y, self.adapter_drop if self.training else 0.0, generator)
        out = self.ffn(layer_norm(y, self.norm2), y, rate, generator)
        return out + adapter_x


class SwinStage(nn.Module):
    """Blocks (W-MSA, SW-MSA alternating) plus optional patch merging.  The
    JAX package scans deep stages over stacked block pairs; here the blocks
    are a plain list."""

    def __init__(self, dim, depth, num_heads, window_size, downsample,
                 adapter_ratio=0.0625, mlp_ratio=4.0, attn_impl="pallas4",
                 ffn_impl="fused", drop_path_rates=None, adapter_drop=0.1):
        super().__init__()
        rates = [0.0] * depth if drop_path_rates is None else list(drop_path_rates)
        self.blocks = nn.ModuleList(
            SwinBlockAdapter(dim, num_heads, int(mlp_ratio * dim), window_size,
                             shift=j % 2 == 1, adapter_ratio=adapter_ratio,
                             attn_impl=attn_impl, ffn_impl=ffn_impl,
                             drop_path_rate=rates[j], adapter_drop=adapter_drop)
            for j in range(depth)
        )
        self.downsample = PatchMerging(dim, 2 * dim) if downsample else None

    def forward(self, x: torch.Tensor, sub_mode: str,
                generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, sub_mode, generator)
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
        x = torch.cat([linear(x_rgb, self.D_fc1), linear(x_dte, self.D_fc2)], dim=-1)
        x = linear(linear(x, self.P_fc2), self.U_fc1)
        p_rgb = x * cast(self.tfts_gamma_rgb, x) + cast(self.tfts_beta_rgb, x)
        p_dte = x * cast(self.tfts_gamma_dte, x) + cast(self.tfts_beta_dte, x)
        return x + p_rgb, x + p_dte


class _LNProxy(nn.Module):
    """LayerNorm over channels of an NCHW map (reference name ``norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return layer_norm(x.permute(0, 2, 3, 1), self.norm).permute(0, 3, 1, 2)


class _OffsetHead(nn.Sequential):
    """Depthwise conv -> LN -> GELU -> 1x1 conv to 2 (dy, dx), on NCHW."""

    def __init__(self, channels: int, ksize: int, stride: int):
        pad = ksize // 2 if ksize != stride else 0
        super().__init__(
            nn.Conv2d(channels, channels, ksize, stride, pad, groups=channels),
            _LNProxy(channels),
            nn.GELU(approximate="tanh"),
            nn.Conv2d(channels, 2, 1, bias=False),
        )

    def forward(self, x):
        return conv2d(gelu(self[1](conv2d(x, self[0]))), self[3])


class _ConvBNGELU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1),
            FlaxBatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.GELU(approximate="tanh"),
        )

    def forward(self, x):
        return gelu(self.conv[1](conv2d(x, self.conv[0])))


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
        self.conv_offset_x = _OffsetHead(gc, ksize, stride)
        self.conv_offset_y = _OffsetHead(gc, ksize, stride)
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
        q = pointwise(self.proj_q, xy)

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
        wgt = pointwise(fc2, torch.relu(pointwise(fc1, q_s)))
        wgt = torch.softmax(wgt.float(), dim=-1)
        sampled = (wgt[..., 0:1] * x_s.float() + wgt[..., 1:2] * y_s.float()).to(x_s.dtype)
        k = pointwise(self.proj_k, sampled)
        v = pointwise(self.proj_v, sampled)

        s1, s2 = self.rpe_table.shape[1:]
        pos_cat = torch.cat([pos_x.reshape(b * g, n, 2), pos_y.reshape(b * g, n, 2)], dim=1)
        table = self.rpe_table.reshape(g, hg, s1, s2)
        if self.attn_impl == "xla":
            out = self._einsum_attention(q, k, v, pos_cat, table, scale)
        else:
            out = self._rows_attention(q, k, v, pos_cat, table, scale)
        out = pointwise(self.proj_out, out)
        return cast(self.deform_weight, out) * out + cast(self.identity_weight, xy) * xy

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
        fused = self.deform_atten(linear(x_rgb, self.D_fc1), linear(x_dte, self.D_fc2))
        return linear(fused, self.U_fc1)


def apply_modality_mask(
    rgb: torch.Tensor, dte: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MMST modality dropout: two distinct random samples of the batch; the
    RGB stream of the first and the DTE stream of the second are zeroed."""
    b = rgb.shape[0]
    perm = torch.randperm(b, device=rgb.device, generator=generator)
    ids = torch.arange(b, device=rgb.device)
    shape = (b,) + (1,) * (rgb.ndim - 1)
    rgb_mask = (ids != perm[0]).to(rgb.dtype).reshape(shape)
    dte_mask = (ids != perm[1 % b]).to(dte.dtype).reshape(shape)
    return rgb * rgb_mask, dte * dte_mask


class SwinTransformer(nn.Module):
    """Dual-stream Swin backbone; returns three 4-level NHWC pyramids
    (fused, rgb, dte).  Defaults are Swin-B (embed 128, depths 2/2/18/2,
    heads 4/8/16/32, window 12) under the ``r5`` dispatch; ``attn_impl``,
    ``dscf_attn`` and ``ffn_impl`` take one of the ``DISPATCH`` triples.
    ``drop_path_rate`` (spread linearly over the blocks), ``adapter_drop``
    and ``mmst_mask`` act only under the ``train`` dispatch, in train mode."""

    def __init__(
        self,
        embed_dim: int = 128,
        depths: Sequence[int] = (2, 2, 18, 2),
        num_heads: Sequence[int] = (4, 8, 16, 32),
        window_size: int = 12,
        patch_size: int = 4,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.3,
        mapa_ratio: float = 0.125,
        adapter_ratio: float = 0.0625,
        adapter_drop: float = 0.1,
        dscf_ratio: float = 0.125,
        dscf_strides: Sequence[int] = (8, 4, 2, 1),
        dscf_groups: Sequence[int] = (1, 2, 4, 8),
        dscf_heads: Sequence[int] = (2, 4, 8, 16),
        dual_batch: bool = False,
        mmst_mask: bool = True,
        attn_impl: Sequence[str] = DISPATCH["r5"][0],
        dscf_attn: Sequence[str] = DISPATCH["r5"][1],
        ffn_impl: str = DISPATCH["r5"][2],
    ):
        super().__init__()
        if dual_batch:
            raise NotImplementedError("dual_batch=True: the port runs the streams in turn")
        _require((tuple(attn_impl), tuple(dscf_attn), ffn_impl),
                 tuple(DISPATCH.values()), "(attn_impl, dscf_attn, ffn_impl)")
        nl = len(depths)
        dims = [embed_dim * 2 ** i for i in range(nl)]
        self.num_features = dims
        self.stochastic = ffn_impl == "module"  # the train dispatch
        self.mmst_mask = mmst_mask
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.extra_patch_embed = PatchEmbed(embed_dim, patch_size)
        self.stages = nn.ModuleList(
            SwinStage(dims[i], depths[i], num_heads[i], window_size, i < nl - 1,
                      adapter_ratio, mlp_ratio, attn_impl[i], ffn_impl,
                      dpr[sum(depths[:i]):sum(depths[:i + 1])], adapter_drop)
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

    def forward(self, x_rgb, x_dte, generator: Optional[torch.Generator] = None,
                ) -> Tuple[List[torch.Tensor], ...]:
        x_rgb = self.patch_embed(x_rgb)
        x_dte = self.extra_patch_embed(x_dte)
        if self.training and self.stochastic and self.mmst_mask:
            x_rgb, x_dte = apply_modality_mask(x_rgb, x_dte, generator)
        outs, outs_rgb, outs_dte = [], [], []
        for i, stage in enumerate(self.stages):
            prompt_rgb, prompt_dte = self.MPGBlocks[i](x_rgb, x_dte)
            x_rgb = x_rgb + prompt_rgb
            x_dte = x_dte + prompt_dte
            x_rgb, rgb_out = stage(x_rgb, "rgb", generator)
            x_dte, dte_out = stage(x_dte, "dte", generator)
            rgb_out = layer_norm(rgb_out, getattr(self, f"norm{i}"))
            dte_out = layer_norm(dte_out, getattr(self, f"extra_norm{i}"))
            fused = self.DeformMPGBlocks[i](rgb_out, dte_out)
            outs.append(layer_norm(fused, getattr(self, f"fuse_norm{i}")))
            outs_rgb.append(rgb_out)
            outs_dte.append(dte_out)
        return outs, outs_rgb, outs_dte


def swin_b(**kw) -> SwinTransformer:
    return SwinTransformer(**kw)
