"""Legacy MiT (SegFormer) dual-stream backbone of CMNeXt-B0..B5, NHWC.
Counterpart of ir_ads_tpu/models/backbones/mit.py: the Swin
flagship's MAPA adapters, MPG prompting and DSCF fusion on SegFormer MiT
blocks (overlapping patch embeddings, spatial-reduction attention, Mix-FFN
with a depthwise convolution).  As there:

  * the MPG block is the additive fuse ``U_fc1(D_fc1(rgb) + D_fc2(dte))``,
    added to both streams;
  * the block weights are shared by the two streams; each stream has its
    own adapter (ratio 0.25, no skip), which reads the un-normed x and
    joins the FFN inside the residual: ``x + drop_path(mlp(norm2 x) + 0.5
    adapter(x))``;
  * the DSCF runs at ``level=3`` at every stage (ratio 0.25, unit
    ``deform_weight``) with the attention that the dispatch gives level 3
    (``swin.DISPATCH[d][1][3]``, as the JAX package's ``IR_ADS_DSCF_ATTN``
    list gives its last entry to every level-3 module): ``pallas3`` under
    r4, r4i8, r2, v5 and map, the rows bias (K3) and K4's unpacked form
    (the reference's ``IR_ADS_DSCF_PACKED`` "1,1,1,0" at level 3) where
    the 2n keys are a multiple of 8, else the einsum; ``pallas`` and
    ``pallas2`` under dscf_pallas and dscf_pallas2, K17 over the packed
    bias (its keys padded to 128) in the XLA form or from K18; ``xla`` (the
    einsum) under r5, train, r1, xla, v7_01 and dscf_pallas4.  The einsum's rpe
    bias is the dispatch's ``rpe3``: K6 (ops/dscf_rpe_packed.py) on query
    planes of at most ``RPE3_PLANE_MAX`` pixels under r5, r4, r4i8, train,
    v7_01, v5 and dscf_pallas4, the XLA form under r2, r1, xla and map (a
    recorded choice, ROADMAP Queue 3 item 1);
  * the next stage takes the normed stream maps, and the backbone returns
    only the fused pyramid.

In train mode (the ``train`` dispatch) drop-path acts on both residual
branches of every block, its rates ``linspace(0, 0.1, sum(depths))`` over
the blocks (the shared block draws once a stream), the adapters drop their
hidden units at 0.1 (the JAX modules' rates) and the DSCF's
BatchNorm normalises with the batch's statistics; every draw comes from the
``generator`` handed to ``forward``.

Parameter names are the flax tree's (``patch_embed{i}``, ``block{i}_{j}``,
...), with the Swin port's names where the two share a module
(``MPGBlocks``, ``DeformMPGBlocks``, ``MLP_RGB_Adapter``), so that
utils/jax_params.from_flax maps either tree.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ir_ads_tpu_torch.models.backbones.swin import Adapter, DeformMPGBlock
from ir_ads_tpu_torch.ops.layers import conv2d, drop_path, gelu, layer_norm, linear, q_scale

MIT_SETTINGS = {
    # name: (embed_dims, depths)
    "B0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "B1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "B2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "B3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "B4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "B5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}
HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))  # (kernel, stride), padding kernel // 2
DSCF_STRIDES = (8, 4, 2, 1)
DSCF_GROUPS = (1, 2, 4, 8)
DSCF_HEADS = (2, 4, 8, 16)
DROP_PATH_RATE = 0.1  # the JAX MiTDualStream's and CMX's default
ADAPTER_DROP = 0.1  # the JAX Adapter's default


def drop_path_rates(depths) -> List[List[float]]:
    """Each stage's blocks' drop-path rates: ``linspace(0, DROP_PATH_RATE,
    sum(depths))`` over the blocks in order."""
    dpr = np.linspace(0.0, DROP_PATH_RATE, sum(depths)).tolist()
    return [dpr[sum(depths[:i]):sum(depths[:i + 1])] for i in range(len(depths))]


def nhwc_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (``layers.conv2d``) on an NHWC map."""
    return conv2d(x.permute(0, 3, 1, 2), conv).permute(0, 2, 3, 1)


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's ``padding="SAME"`` for a k x k convolution of stride s on an
    NCHW map: ceil(n / s) outputs, the padding split with the smaller half
    before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def patch_embed(x: torch.Tensor, conv: nn.Conv2d, norm: nn.LayerNorm) -> torch.Tensor:
    """An overlapping patch embedding: the convolution, then LayerNorm."""
    return layer_norm(nhwc_conv(x, conv), norm)


def check_frames(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError("the legacy backbones take (B, H, W, 3) frames, not flat "
                         "(B, H, W*3) rows (flat_input has no counterpart there)")


class SRAttention(nn.Module):
    """Spatial-reduction attention: keys and values from the map reduced by
    an ``sr_ratio`` x ``sr_ratio`` convolution of that stride (flax's SAME
    padding) and a LayerNorm.  q is scaled in its own dtype (the scale
    rounded to it first, ``layers.q_scale``); scores summed in f32, f32
    softmax, probabilities cast to v's dtype, P.V summed in f32 and rounded
    once."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=1e-5)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        hd = c // heads
        q = linear(x, self.q)
        q = (q * q_scale(hd ** -0.5, q.dtype)).reshape(b, h * w, heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            kv_in = conv2d(same_pad(x.permute(0, 3, 1, 2), s, s), self.sr).permute(0, 2, 3, 1)
            kv_in = layer_norm(kv_in, self.sr_norm)
        n_kv = kv_in.shape[1] * kv_in.shape[2]
        kv = linear(kv_in, self.kv).reshape(b, n_kv, 2, heads, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        p = torch.softmax(q.float() @ k.float().transpose(-1, -2), dim=-1).to(v.dtype)
        out = (p.float() @ v.float()).to(v.dtype)
        return linear(out.transpose(1, 2).reshape(b, h, w, c), self.proj)


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 (``groups = hidden``) -> GELU (tanh) -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(gelu(nhwc_conv(linear(x, self.fc1), self.dwconv)), self.fc2)


class CEBlock(nn.Module):
    """MiT block with per-stream adapters: ``x + drop_path(attn(norm1 x))``,
    then ``x + drop_path(mlp(norm2 x) + 0.5 adapter(x))``; drop-path and the
    adapter's dropout act in train mode only."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, adapter_ratio: float = 0.25,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate, self.adapter_drop = float(drop_path_rate), ADAPTER_DROP
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MixFFN(dim, 4 * dim)
        self.MLP_RGB_Adapter = Adapter(dim, adapter_ratio)
        self.MLP_DTE_Adapter = Adapter(dim, adapter_ratio)

    def forward(self, x: torch.Tensor, sub_mode: str,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if sub_mode not in ("rgb", "dte"):
            raise NotImplementedError(f"sub_mode={sub_mode!r}: a stream is 'rgb' or 'dte'")
        on = self.training
        x = x + drop_path(self.attn(layer_norm(x, self.norm1)), self.drop_path_rate, on,
                          generator)
        mlp = self.mlp(layer_norm(x, self.norm2))
        adapter = (self.MLP_RGB_Adapter if sub_mode == "rgb" else self.MLP_DTE_Adapter)(
            x, self.adapter_drop if on else 0.0, generator)
        return x + drop_path(mlp + 0.5 * adapter, self.drop_path_rate, on, generator)


class AddMPGBlock(nn.Module):
    """Additive MPG fuse: ``U_fc1(D_fc1(a) + D_fc2(b))``."""

    def __init__(self, dim: int, ratio: float = 0.25):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(dim, hidden)
        self.U_fc1 = nn.Linear(hidden, dim)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return linear(linear(a, self.D_fc1) + linear(b, self.D_fc2), self.U_fc1)


class MiTDualStream(nn.Module):
    """Dual-stream MiT returning the fused 4-level pyramid.  ``dscf_attn``:
    the DSCF attention of every stage (the dispatch's level-3 entry,
    ``"pallas3"``, ``"pallas"``, ``"pallas2"`` or ``"xla"``); ``int8``: the DSCF's int8 sites (r4i8);
    ``rpe3``: the einsum branch's bias, ``"pallas"`` (K6 where the plane has
    at most ``RPE3_PLANE_MAX`` pixels) or ``"xla"``."""

    def __init__(self, variant: str = "B2", dscf_attn: str = "xla", int8: bool = False,
                 rpe3: str = "pallas"):
        super().__init__()
        if variant not in MIT_SETTINGS:
            raise ValueError(f"MiT variant {variant!r}: one of {list(MIT_SETTINGS)}")
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
                setattr(self, f"block{i + 1}_{j}",
                        CEBlock(dims[i], HEADS[i], SR_RATIOS[i], drop_path_rate=rates[i][j]))
        self.MPGBlocks = nn.ModuleList(AddMPGBlock(d) for d in dims)
        self.DeformMPGBlocks = nn.ModuleList(
            DeformMPGBlock(dims[i], DSCF_STRIDES[i], DSCF_GROUPS[i], DSCF_HEADS[i], level=3,
                           ratio=0.25, attn_impl=dscf_attn, int8=int8, rpe3=rpe3)
            for i in range(4))

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        check_frames(x_rgb)
        outs = []
        for i in range(4):
            x_rgb = patch_embed(x_rgb, getattr(self, f"patch_embed{i + 1}"),
                                getattr(self, f"patch_norm{i + 1}"))
            x_dte = patch_embed(x_dte, getattr(self, f"extra_patch_embed{i + 1}"),
                                getattr(self, f"extra_patch_norm{i + 1}"))
            fuse = self.MPGBlocks[i](x_rgb, x_dte)
            x_rgb, x_dte = x_rgb + fuse, x_dte + fuse
            for j in range(self.depths[i]):
                block = getattr(self, f"block{i + 1}_{j}")
                x_rgb = block(x_rgb, "rgb", generator)
                x_dte = block(x_dte, "dte", generator)
            x_rgb = layer_norm(x_rgb, getattr(self, f"norm{i + 1}"))
            x_dte = layer_norm(x_dte, getattr(self, f"extra_norm{i + 1}"))
            outs.append(self.DeformMPGBlocks[i](x_rgb, x_dte))
        return outs
