"""Dual-stream Swin backbone with MAPA adapters, MPG prompting and DSCF
deformable cross-modal fusion, NHWC.

Counterpart of ir_ads_tpu/models/backbones/swin.py under thirteen of its
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
  r4i8 (the bench's w8a8 eval set, ``IR_ADS_INT8=1`` on r4): r4 with every
     trunk, DSCF and head product in s8 x s8 -> s32.  The half-block and the
     tail are their int8 kernels, K10 (ops/swin_block_int8.py) and K11
     (ops/block_tail_int8.py); the DSCF's ``QuantConv`` sites (fuse_q conv
     3x3 with one activation scale per tensor, proj_q, the two sample-weight
     convs, proj_k, proj_v; not the offset heads, not proj_out) are
     ``ops.int8`` products.  Quantized weights are non-persistent ``int8_*``
     buffers, made by ``ops.int8.quantize_int8_(model)`` from the float
     weights once they are loaded.
  train (what the JAX package runs under ``train=True``): K1 at every stage,
     differentiable through K7 (ops/window_attn_bwd.py), with drop-path by
     reconstruction, ``x + drop_path(K1(x) - x)``; the block tail as modules
     under autograd (LN2, FFN with drop-path, 0.5 * Adapter with dropout);
     DSCF as r5, K4 differentiable through K8 (ops/dscf_rows_bwd.py) and the
     bias kernels through their f32 twin.
  r2 (the bench's "production r2"), r1 (its round-1 set) and xla (its plain
     set): the module path of every block, LN1 -> ``ShiftWindowMSA`` (pad,
     roll, window partition, ``WindowMSA``: qkv linear, attention, proj
     linear; reverse, roll back, crop) -> residual, then K2.  The attention
     is K12 (ops/window_attention_qkv.py) under r2 and r1, and
     ``window_attention`` with the reference's -100 dense shift mask under
     xla.  DSCF: K3 + K4 at every level under r2, the einsum attention under
     r1 and xla; their einsum branch takes the XLA-form bias
     (``dscf_rpe.rpe_bias_xla``), as the bench leaves ``IR_ADS_DSCF_RPE3``.
  v7_01, v5 and map (the JAX package's opt-in Swin block variants, as
     ``IR_ADS_SWIN_ATTN`` selects them): v7_01 is r5 with the banded whole
     block (K13, ops/swin_block_v7.py: K1's half-block and K2's tail in one
     call, on the padded, rolled map) at stages 0-1 (``dev/sweep_env.py``'s
     variant of that name); v5 is r4 with the whole-map half-block (K14,
     ops/swin_block_full.py: pad, roll and crop inside) in place of K1; map
     is r2 with the attention on the qkv map (K15, ops/window_attention_map.py:
     the window partition and reverse inside) between the module path's
     qkv and proj linears.
  dscf_pallas4, dscf_pallas and dscf_pallas2 (the JAX package's opt-in DSCF
     variants, as ``IR_ADS_DSCF_ATTN`` selects them): r5's blocks, with the
     DSCF fused (K16, ops/dscf_fused.py: the rpe bias sampled inside the
     rows attention) at levels 0-2 and r5's einsum level 3; or at every
     level the query-tiled attention over a packed bias (K17,
     ops/dscf_attention.py), the bias in the XLA form (dscf_pallas) or from
     the j-major bias kernel (K18, ops/dscf_rpe_jmajor.py; dscf_pallas2).

The DSCF rows path (K3 + K4) and the fused one (K16) run only where the 2n
deformable keys are a multiple of 8, as the reference guards ``pallas3``
and ``pallas4``; elsewhere the einsum attention runs, its bias from K6
where ``rpe3`` is "pallas" and the query plane has at most 2048 pixels,
else the XLA form.  ``pallas`` and ``pallas2`` take any 2n: they pad the
keys to a multiple of 128.

All but train are eval dispatches: K2, K5, K10 and K11 have no backward and raise when
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
from ir_ads_tpu_torch.ops.block_tail_int8 import block_tail_int8
from ir_ads_tpu_torch.ops.dscf_attention import KEY_LANES, NEG_INF, dscf_attention
from ir_ads_tpu_torch.ops.dscf_fused import dscf_fused_attention
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_attention
from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_rows, rpe_bias_xla
from ir_ads_tpu_torch.ops.dscf_rpe_jmajor import rpe_bias_jmajor
from ir_ads_tpu_torch.ops.dscf_rpe_packed import rpe_bias_packed
from ir_ads_tpu_torch.ops.grid_sample import grid_sample_matmul, make_ref_grid
from ir_ads_tpu_torch.ops.int8 import int8_conv, int8_linear, int8_weight, set_int8_weight
from ir_ads_tpu_torch.ops.layers import (
    FFN, PATCH_EMBED, FlaxBatchNorm2d, PatchEmbed, PatchMerging, cast, conv2d, drop_path,
    dropout, gelu, layer_norm, linear, pointwise,
)
from ir_ads_tpu_torch.ops.swin_block import window_block
from ir_ads_tpu_torch.ops.swin_block_int8 import window_block_int8
from ir_ads_tpu_torch.ops.swin_block_full import window_block_full
from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6
from ir_ads_tpu_torch.ops.swin_block_v7 import window_block_v7
from ir_ads_tpu_torch.ops.window_attention import (
    gather_rel_pos_bias, relative_position_index, shift_region_ids_on,
    shift_window_mask_on, window_attention, window_partition, window_reverse,
)
from ir_ads_tpu_torch.ops.window_attention_map import window_attention_map
from ir_ads_tpu_torch.ops.window_attention_qkv import window_attention_qkv

# (Swin block per stage, DSCF attention per level, block tail, int8, bias of
# the DSCF einsum branch), as the JAX package's IR_ADS_SWIN_ATTN /
# IR_ADS_DSCF_ATTN lists, IR_ADS_FFN, IR_ADS_INT8 and IR_ADS_DSCF_RPE3.  The
# bench sets no IR_ADS_FFN for r2, r1 and xla: on its chip ``_ffn_impl()``
# is then "fused", K2.  It leaves IR_ADS_DSCF_RPE3 at "auto", the XLA form;
# r5, r4, r4i8 and train take the packed kernel K6 (a recorded choice).
# v7_01 (dev/sweep_env.py's variant of r5), v5 (r4 with pallas5) and map
# (r2 with pallas_map) are the opt-in block variants with IR_ADS_FFN=fused,
# v7_01 and v5 with IR_ADS_DSCF_RPE3=pallas.  dscf_pallas4, dscf_pallas and
# dscf_pallas2 are r5's blocks with the opt-in DSCF variants
# (IR_ADS_DSCF_ATTN=pallas4,pallas4,pallas4,xla with IR_ADS_DSCF_RPE3=pallas;
# pallas; pallas2): pallas4 has no row band at a 15x20 level 3, whose
# einsum branch takes K6's bias as r5's does.
R5_BLOCKS = ("pallas4", "pallas4", "pallas6", "pallas6")
DISPATCH = {
    "r5": (R5_BLOCKS, ("pallas3", "pallas3", "pallas3", "xla"), "fused", False, "pallas"),
    "r4": (("pallas4",) * 4, ("pallas3",) * 4, "fused", False, "pallas"),
    "r4i8": (("pallas4",) * 4, ("pallas3",) * 4, "fused", True, "pallas"),
    "train": (("pallas4",) * 4, ("pallas3", "pallas3", "pallas3", "xla"), "module", False,
              "pallas"),
    "r2": (("pallas",) * 4, ("pallas3",) * 4, "fused", False, "xla"),
    "r1": (("pallas",) * 4, ("xla",) * 4, "fused", False, "xla"),
    "xla": (("xla",) * 4, ("xla",) * 4, "fused", False, "xla"),
    "v7_01": (("pallas7", "pallas7", "pallas6", "pallas6"),
              ("pallas3", "pallas3", "pallas3", "xla"), "fused", False, "pallas"),
    "v5": (("pallas5",) * 4, ("pallas3",) * 4, "fused", False, "pallas"),
    "map": (("pallas_map",) * 4, ("pallas3",) * 4, "fused", False, "xla"),
    "dscf_pallas4": (R5_BLOCKS, ("pallas4", "pallas4", "pallas4", "xla"), "fused", False,
                     "pallas"),
    "dscf_pallas": (R5_BLOCKS, ("pallas",) * 4, "fused", False, "pallas"),
    "dscf_pallas2": (R5_BLOCKS, ("pallas2",) * 4, "fused", False, "pallas"),
}
SWIN_ATTN = ("pallas4", "pallas5", "pallas6", "pallas7", "pallas", "pallas_map", "xla")
# the module path: LN1, ShiftWindowMSA, residual
MODULE_ATTN = ("pallas", "pallas_map", "xla")
DSCF_ATTN = ("pallas3", "pallas4", "pallas", "pallas2", "xla")
DSCF_RPE3 = ("pallas", "xla")
FFN_IMPL = ("fused", "module")
RPE3_PLANE_MAX = 2048  # the packed bias kernel only up to this many query pixels


def _require(value, supported, what: str) -> None:
    if value not in supported:
        raise NotImplementedError(
            f"{what}={value!r}: the port implements only {supported!r}"
        )


def pad_and_roll(x: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
    """An NHWC map padded with zeros at the bottom and right to whole
    windows, then rolled by -shift (the reference's order)."""
    h, w = x.shape[1:3]
    pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    return torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x


def unroll_and_crop(y: torch.Tensor, h: int, w: int, shift: int) -> torch.Tensor:
    """The inverse of ``pad_and_roll`` on a map of real size h x w."""
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    return y[:, :h, :w]


class WindowMSA(nn.Module):
    """One W-MSA: rel-pos bias table, qkv and proj.  The kernel paths read
    its parameters; ``forward`` is the module path's."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        ws = window_size
        self.num_heads, self.window_size = num_heads, ws
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(ws, ws)),
        )
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_impl: str,
                mask: Optional[torch.Tensor] = None,
                region: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B*nW, N, C) windows, or the (B, Hp, Wp, C) map under
        ``"pallas_map"``.  ``"pallas"``: K12 on the unsplit qkv with the
        region ids (None when unshifted, where the reference's zero region
        masks nothing); ``"pallas_map"``: K15 on the qkv map, likewise;
        ``"xla"``: ``window_attention`` with the dense ``mask``.  Returns x's
        shape."""
        c = x.shape[-1]
        heads = self.num_heads
        scale = (c // heads) ** -0.5
        qkv = linear(x, self.qkv)
        bias = gather_rel_pos_bias(self.relative_position_bias_table,
                                   self.relative_position_index)
        if attn_impl == "pallas_map":
            out = window_attention_map(qkv, bias, region, scale, heads, self.window_size)
        elif attn_impl == "pallas":
            out = window_attention_qkv(qkv, bias, region, scale, heads)
        else:
            bn, n = x.shape[:2]
            qkv = qkv.reshape(bn, n, 3, heads, c // heads)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            out = window_attention(q, k, v, bias, mask, scale)
            out = out.transpose(1, 2).reshape(bn, n, c)
        return linear(out, self.proj)


class ShiftWindowMSA(nn.Module):
    """Pad -> cyclic shift -> window partition -> W-MSA -> reverse -> shift
    back -> crop, on an NHWC map (the reference's module path); under
    ``"pallas_map"`` no partition and reverse: K15 takes the map."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int = 0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.w_msa = WindowMSA(dim, num_heads, window_size)

    def forward(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        h, w = x.shape[1:3]
        ws, shift = self.window_size, self.shift
        x = pad_and_roll(x, ws, shift)  # after LN1: pad tokens are zeros, their qkv is bqkv
        hp, wp = x.shape[1:3]
        mask = region = None
        if shift and attn_impl == "xla":
            mask = shift_window_mask_on(hp, wp, ws, shift, x.device)
        elif shift:
            region = shift_region_ids_on(hp, wp, ws, shift, x.device)
        if attn_impl == "pallas_map":
            return unroll_and_crop(self.w_msa(x, attn_impl, None, region), h, w, shift)
        wins = self.w_msa(window_partition(x, ws), attn_impl, mask, region)
        return unroll_and_crop(window_reverse(wins, ws, hp, wp), h, w, shift)


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
    ``pallas5``: y by K14 on the real map (pad, roll and crop inside), then
    K2.  ``pallas6``: the whole block by K5 on the real map.  ``pallas7``:
    the whole block by K13 on the padded, rolled map (K1's half-block, then
    K2's tail on its rounded output).  ``int8`` (with pallas4 and the fused
    tail only): K10 in place of K1 and K11 in place of K2, from the s8
    weights ``quantize_int8_`` makes.  ``pallas``, ``pallas_map`` and
    ``xla`` (with the fused tail only): the module path, y = h + x with h =
    ShiftWindowMSA(LN1 x) rounded at the proj output and the residual a
    rounded add (K1 instead keeps the residual in f32), then K2.  pallas5,
    pallas6 and pallas7 are eval kernels, as the fused tail is."""

    def __init__(self, dim, num_heads, ffn_dim, window_size, shift,
                 adapter_ratio=0.0625, attn_impl="pallas4", ffn_impl="fused",
                 drop_path_rate=0.0, adapter_drop=0.1, int8=False):
        super().__init__()
        _require(attn_impl, SWIN_ATTN, "attn_impl")
        _require(ffn_impl, FFN_IMPL, "ffn_impl")
        if attn_impl in ("pallas5", "pallas6", "pallas7") and ffn_impl != "fused":
            raise NotImplementedError(f"{attn_impl} is an eval kernel: ffn_impl must be 'fused'")
        if int8 and (attn_impl, ffn_impl) != ("pallas4", "fused"):
            raise NotImplementedError("int8 runs the pallas4 half-block and the fused tail only")
        if attn_impl in MODULE_ATTN and ffn_impl != "fused":
            raise NotImplementedError("the module attention path runs with the fused tail only")
        self.attn_impl = attn_impl
        self.ffn_impl = ffn_impl
        self.int8 = bool(int8)
        self.drop_path_rate = float(drop_path_rate)
        self.adapter_drop = float(adapter_drop)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, self.shift)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ffn_dim)
        self.MLP_RGB_Adapter = Adapter(dim, adapter_ratio)
        self.MLP_DTE_Adapter = Adapter(dim, adapter_ratio)

    def quantize_int8_(self, dtype=None) -> None:
        """s8 qkv, proj, fc1 and fc2 from the float weights, per output
        channel (``pallas_mlp.quantize_weight``'s scales)."""
        msa = self.attn.w_msa
        for name, lin in (("qkv", msa.qkv), ("proj", msa.proj),
                          ("fc1", self.ffn.layers[0][0]), ("fc2", self.ffn.layers[1])):
            set_int8_weight(self, name, lin.weight)

    def forward(self, x: torch.Tensor, sub_mode: str,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        ad = self.MLP_RGB_Adapter if sub_mode == "rgb" else self.MLP_DTE_Adapter
        f1, f2 = self.ffn.layers[0][0], self.ffn.layers[1]
        geo = ((c // self.num_heads) ** -0.5, self.num_heads, ws)
        if self.attn_impl == "pallas6":
            # pad, roll and crop are index arithmetic inside K5
            return window_block_v6(x, self._attn_params(), self._tail_params(ad),
                                   self._region(h, w, x.device), *geo, shift)
        if self.attn_impl == "pallas7":
            # pad and roll, K13, un-roll and crop: the tail runs in rolled
            # coordinates, exact at every real position (it is per token)
            out = window_block_v7(pad_and_roll(x, ws, shift), self._attn_params(),
                                  self._tail_params(ad), self._region(h, w, x.device),
                                  *geo, h, w, shift)
            return unroll_and_crop(out, h, w, shift)
        if self.attn_impl in MODULE_ATTN:
            y = self.attn(layer_norm(x, self.norm1), self.attn_impl) + x
        elif self.attn_impl == "pallas5":
            # pad, roll and crop are index arithmetic inside K14
            y = window_block_full(x, *self._attn_params(), self._region(h, w, x.device),
                                  *geo, shift)
        else:
            y = self._half_block(x)
        if self.int8:
            out = block_tail_int8(
                y.contiguous().reshape(-1, c), self.norm2.weight, self.norm2.bias,
                *int8_weight(self, "fc1"), f1.bias, *int8_weight(self, "fc2"), f2.bias,
                ad.D_fc1.weight, ad.D_fc1.bias, ad.D_fc2.weight, ad.D_fc2.bias,
            )
            return out.reshape(b, h, w, c)
        if self.ffn_impl == "fused":
            out = block_tail(y.contiguous().reshape(-1, c), *self._tail_params(ad))
            return out.reshape(b, h, w, c)
        rate = self.drop_path_rate if self.training else 0.0
        if rate > 0.0:
            # K1 fused the residual: recover the branch and drop it per sample
            y = x + drop_path(y - x, rate, True, generator)
        adapter_x = 0.5 * ad(y, self.adapter_drop if self.training else 0.0, generator)
        out = self.ffn(layer_norm(y, self.norm2), y, rate, generator)
        return out + adapter_x

    def _rel_pos_bias(self) -> torch.Tensor:
        msa = self.attn.w_msa
        return gather_rel_pos_bias(msa.relative_position_bias_table,
                                   msa.relative_position_index)

    def _attn_params(self) -> Tuple[torch.Tensor, ...]:
        """LN1, qkv, proj and the gathered rel-pos bias, in the order the
        block kernels take them."""
        msa = self.attn.w_msa
        return (self.norm1.weight, self.norm1.bias, msa.qkv.weight, msa.qkv.bias,
                msa.proj.weight, msa.proj.bias, self._rel_pos_bias())

    def _tail_params(self, ad: Adapter) -> Tuple[torch.Tensor, ...]:
        """LN2, FFN and the stream's adapter, in the order the tail kernels
        take them."""
        f1, f2 = self.ffn.layers[0][0], self.ffn.layers[1]
        return (self.norm2.weight, self.norm2.bias, f1.weight, f1.bias, f2.weight, f2.bias,
                ad.D_fc1.weight, ad.D_fc1.bias, ad.D_fc2.weight, ad.D_fc2.bias)

    def _region(self, h: int, w: int, device) -> Optional[torch.Tensor]:
        """Shift-region ids of the h x w map padded to whole windows, or None
        for an unshifted block."""
        ws = self.window_size
        if not self.shift:
            return None
        return shift_region_ids_on(-(-h // ws) * ws, -(-w // ws) * ws, ws, self.shift, device)

    def _half_block(self, x: torch.Tensor) -> torch.Tensor:
        """y = x + W-MSA(LN1 x) by K1 (K10 under int8) on the padded, rolled
        map; the pad, the roll and the crop around it."""
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        msa = self.attn.w_msa
        scale, region = (c // self.num_heads) ** -0.5, self._region(h, w, x.device)
        xm = pad_and_roll(x, ws, shift)
        if self.int8:
            y = window_block_int8(
                xm, self.norm1.weight, self.norm1.bias, *int8_weight(self, "qkv"),
                msa.qkv.bias, *int8_weight(self, "proj"), msa.proj.bias, self._rel_pos_bias(),
                region, scale, self.num_heads, ws, h, w, shift,
            )
        else:
            y = window_block(xm, *self._attn_params(), region, scale, self.num_heads, ws, h, w,
                             shift)
        return unroll_and_crop(y, h, w, shift)


class SwinStage(nn.Module):
    """Blocks (W-MSA, SW-MSA alternating) plus optional patch merging.  The
    JAX package scans deep stages over stacked block pairs; here the blocks
    are a plain list."""

    def __init__(self, dim, depth, num_heads, window_size, downsample,
                 adapter_ratio=0.0625, mlp_ratio=4.0, attn_impl="pallas4",
                 ffn_impl="fused", drop_path_rates=None, adapter_drop=0.1, int8=False):
        super().__init__()
        rates = [0.0] * depth if drop_path_rates is None else list(drop_path_rates)
        self.blocks = nn.ModuleList(
            SwinBlockAdapter(dim, num_heads, int(mlp_ratio * dim), window_size,
                             shift=j % 2 == 1, adapter_ratio=adapter_ratio,
                             attn_impl=attn_impl, ffn_impl=ffn_impl,
                             drop_path_rate=rates[j], adapter_drop=adapter_drop,
                             int8=int8)
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
    module's branches, chosen by ``attn_impl`` and guarded as the reference
    guards them (``branch``):

      pallas3, where the 2n deformable keys are a multiple of 8: rpe bias by
        K3, attention by K4 in the rounding form the reference's default
        ``IR_ADS_DSCF_PACKED="1,1,1,0"`` gives the level: packed at levels
        0-2, unpacked at level 3 (a fixed choice; the port reads no
        environment);
      pallas4, where 2n is a multiple of 8: K16, the bias sampled inside
        K4's unpacked attention; ``ValueError`` where the reference's fused
        kernel has no row band (a 15x20 or 4x7 plane);
      pallas and pallas2, any 2n: the keys padded with zeros to a multiple
        of 128 and their bias columns with -1e9, attention by K17 over the
        packed bias (BG, HW, hg*Mp), the bias in the XLA form (pallas) or
        from K18 (pallas2);
      the einsum (``xla``) branch otherwise: the attention as f32-accumulated
        products in PyTorch, the bias by K6 under ``rpe3="pallas"``
        (``IR_ADS_DSCF_RPE3=pallas``) up to ``RPE3_PLANE_MAX`` query pixels,
        else in the reference's XLA form (``dscf_rpe.rpe_bias_xla``).

    ``int8``: the JAX module's ``QuantConv`` sites as w8a8 products
    (``ops.int8``), each output cast to the activation dtype before its bias
    is added."""

    INT8_SITES = ("proj_q", "proj_k", "proj_v")

    def __init__(self, dim, n_heads, n_groups, stride, ksize=9, level=0,
                 rpe_size=(60, 80), attn_impl="pallas3", int8=False, rpe3="pallas"):
        super().__init__()
        _require(attn_impl, DSCF_ATTN, "attn_impl")
        _require(rpe3, DSCF_RPE3, "rpe3")
        self.attn_impl, self.rpe3, self.level = attn_impl, rpe3, level
        self.int8 = bool(int8)
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

    def quantize_int8_(self, dtype=None) -> None:
        """s8 weights of the QuantConv sites, with ``quantized_matmul``'s and
        ``quantized_conv``'s scales (floor after the division)."""
        set_int8_weight(self, "fuse_q", self.fuse_q.conv[0].weight, floor_first=False)
        for name in self.INT8_SITES:
            set_int8_weight(self, name, getattr(self, name).weight, floor_first=False)
        for i in (0, 2):
            set_int8_weight(self, f"sample_weight_fc{i // 2 + 1}",
                            self.get_sample_weight[i].weight, floor_first=False)

    def _pointwise(self, name: str, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv on channels-last x: w8a8 under ``int8``, else float."""
        if not self.int8:
            return pointwise(conv, x)
        w_q, s_w = int8_weight(self, name)
        return int8_linear(x, w_q.flatten(1), s_w).to(x.dtype) + cast(conv.bias, x)

    def _fuse_q(self, xy: torch.Tensor) -> torch.Tensor:
        """fuse_q (3x3 conv, BN, GELU) on the channels-last concatenation."""
        if not self.int8:
            return self.fuse_q(xy.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        conv, bn = self.fuse_q.conv[0], self.fuse_q.conv[1]
        y = int8_conv(xy, *int8_weight(self, "fuse_q"), padding=1).to(xy.dtype)
        y = (y + cast(conv.bias, y)).permute(0, 3, 1, 2)
        return gelu(bn(y)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g, heads = self.n_groups, self.n_heads
        gc, hc, hg = c // g, c // heads, heads // g
        scale = hc ** -0.5
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731

        xy = self._fuse_q(torch.cat([x, y], dim=-1))
        q = self._pointwise("proj_q", self.proj_q, xy)

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
        wgt = self._pointwise("sample_weight_fc2", fc2, torch.relu(
            self._pointwise("sample_weight_fc1", fc1, q_s)))
        wgt = torch.softmax(wgt.float(), dim=-1)
        sampled = (wgt[..., 0:1] * x_s.float() + wgt[..., 1:2] * y_s.float()).to(x_s.dtype)
        k = self._pointwise("proj_k", self.proj_k, sampled)
        v = self._pointwise("proj_v", self.proj_v, sampled)

        s1, s2 = self.rpe_table.shape[1:]
        pos_cat = torch.cat([pos_x.reshape(b * g, n, 2), pos_y.reshape(b * g, n, 2)], dim=1)
        table = self.rpe_table.reshape(g, hg, s1, s2)
        branch = self.branch(n)
        if self.rows_path(n):
            out = self._rows_attention(q, k, v, pos_cat, table, scale)
        elif branch == "pallas4":
            out = self._fused_attention(q, k, v, pos_cat, table, scale)
        elif branch in ("pallas", "pallas2"):
            out = self._packed_attention(q, k, v, pos_cat, table, scale)
        else:
            out = self._einsum_attention(q, k, v, pos_cat, table, scale)
        out = pointwise(self.proj_out, out)
        return cast(self.deform_weight, out) * out + cast(self.identity_weight, xy) * xy

    def branch(self, n: int) -> str:
        """The branch taken for ``n`` offsets a field: ``attn_impl``, but the
        einsum ("xla") for pallas3 and pallas4 where 2n % 8 != 0."""
        if self.attn_impl in ("pallas3", "pallas4") and 2 * n % 8:
            return "xla"
        return self.attn_impl

    def rows_path(self, n: int) -> bool:
        """K3 + K4 for ``n`` offsets a field: pallas3 where 2n % 8 == 0."""
        return self.branch(n) == "pallas3"

    def bias_kernel(self, h: int, w: int) -> bool:
        """The einsum branch's bias by K6 (else in the XLA form)."""
        return self.rpe3 == "pallas" and h * w <= RPE3_PLANE_MAX

    def _einsum_attention(self, q, k, v, pos_cat, table, scale):
        """Scores q.k summed in f32 and scaled in f32, plus the bias in f32;
        f32 softmax; probabilities rounded; P.V summed in f32 and rounded
        once (JAX ``swin.py`` einsum branch)."""
        b, h, w, c = q.shape
        heads, m = self.n_heads, k.shape[1]
        hc = c // heads
        build = rpe_bias_packed if self.bias_kernel(h, w) else rpe_bias_xla
        bias = build(pos_cat, table, h, w, q.dtype)  # (BG, hg, M, HW)
        bias = bias.reshape(b, heads, m, h * w).transpose(-1, -2)
        qh = q.reshape(b, h * w, heads, hc).transpose(1, 2)
        kh = k.reshape(b, m, heads, hc).transpose(1, 2)
        vh = v.reshape(b, m, heads, hc).transpose(1, 2)
        s = (qh.float() @ kh.float().transpose(-1, -2)) * scale + bias.float()
        p = torch.softmax(s, dim=-1).to(vh.dtype)
        out = (p.float() @ vh.float()).to(vh.dtype)
        return out.transpose(1, 2).reshape(b, h, w, c)

    def _groups(self, q, k, v, mp):
        """q (B*g, HW, gc) and k, v (B*g, mp, gc) with zero keys past 2n:
        the group-major layout of the DSCF kernels; and its inverse."""
        b, h, w, c = q.shape
        g = self.n_groups
        gc, n2 = c // g, k.shape[1]

        def to_groups(t, m):  # (B, M, C) -> (B*g, M, gc)
            return t.reshape(b, m, g, gc).transpose(1, 2).reshape(b * g, m, gc)

        def back(out):  # (B*g, HW, gc) -> (B, h, w, C)
            return out.reshape(b, g, h * w, gc).transpose(1, 2).reshape(b, h, w, c)

        kg, vg = (F.pad(to_groups(t, n2), (0, 0, 0, mp - n2)) if mp > n2 else to_groups(t, n2)
                  for t in (k, v))
        return to_groups(q.reshape(b, h * w, c), h * w), kg, vg, back

    def _rows_attention(self, q, k, v, pos_cat, table, scale):
        """Bias by K3 in the rows layout, attention by K4 (packed below
        level 3)."""
        h, w = q.shape[1:3]
        qg, kg, vg, back = self._groups(q, k, v, -(-k.shape[1] // 8) * 8)
        bias = rpe_bias_rows(pos_cat, table, h, w, q.dtype)
        return back(dscf_rows_attention(qg, kg, vg, bias, scale,
                                        self.n_heads // self.n_groups, self.level < 3))

    def _fused_attention(self, q, k, v, pos_cat, table, scale):
        """K16: the bias sampled inside the attention."""
        h, w = q.shape[1:3]
        qg, kg, vg, back = self._groups(q, k, v, k.shape[1])
        return back(dscf_fused_attention(qg, kg, vg, pos_cat, table, h, w, scale,
                                         self.n_heads // self.n_groups))

    def _packed_attention(self, q, k, v, pos_cat, table, scale):
        """K17 over the packed bias (B*g, HW, hg*Mp), Mp = 2n padded to 128
        keys with -1e9: the bias in the XLA form (pallas) or K18's j-major
        one transposed (pallas2); the field-x keys before the field-y keys,
        as the reference concatenates its two biases."""
        b, h, w, c = q.shape
        hg, n2 = self.n_heads // self.n_groups, k.shape[1]
        mp = -(-n2 // KEY_LANES) * KEY_LANES
        if self.attn_impl == "pallas2":  # (B*g, hg, 2n, h, w) -> (B*g, h, w, hg, 2n)
            bias = rpe_bias_jmajor(pos_cat, table, h, w, q.dtype).permute(0, 3, 4, 1, 2)
        else:  # (B*g, hg, 2n, HW) -> (B*g, HW, hg, 2n)
            bias = rpe_bias_xla(pos_cat, table, h, w, q.dtype).permute(0, 3, 1, 2)
        bias = F.pad(bias.reshape(-1, h * w, hg, n2), (0, mp - n2), value=NEG_INF)
        qg, kg, vg, back = self._groups(q, k, v, mp)
        return back(dscf_attention(qg, kg, vg, bias.reshape(-1, h * w, hg * mp), scale, hg))


class DeformMPGBlock(nn.Module):
    """DSCF fusion: down-project both streams, DAttentionMM, up-project."""

    def __init__(self, dim, stride, n_groups, n_heads, level, ratio=0.125,
                 attn_impl="pallas3", int8=False, rpe3="pallas"):
        super().__init__()
        hidden = int(dim * ratio)
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(dim, hidden)
        self.deform_atten = DAttentionMM(hidden, n_heads, n_groups, stride, level=level,
                                         attn_impl=attn_impl, int8=int8, rpe3=rpe3)
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
    ``dscf_attn``, ``ffn_impl``, ``int8`` and ``rpe3`` take one of the
    ``DISPATCH`` entries.  The inputs are (B, H, W, 3) frames or flat (B, H,
    W*3) rows; ``patch_embed`` chooses the flat path of both streams'
    ``PatchEmbed`` (``"xla"``, ``"xla2"``, or ``"pallas"``: K19, flat input
    only).
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
        int8: bool = False,
        rpe3: str = DISPATCH["r5"][4],
        patch_embed: str = "xla",
    ):
        super().__init__()
        if dual_batch:
            raise NotImplementedError("dual_batch=True: the port runs the streams in turn")
        _require((tuple(attn_impl), tuple(dscf_attn), ffn_impl, bool(int8), rpe3),
                 tuple(DISPATCH.values()), "(attn_impl, dscf_attn, ffn_impl, int8, rpe3)")
        nl = len(depths)
        dims = [embed_dim * 2 ** i for i in range(nl)]
        self.num_features = dims
        self.stochastic = ffn_impl == "module"  # the train dispatch
        self.mmst_mask = mmst_mask
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        _require(patch_embed, PATCH_EMBED, "patch_embed")
        self.patch_embed = PatchEmbed(embed_dim, patch_size, impl=patch_embed)
        self.extra_patch_embed = PatchEmbed(embed_dim, patch_size, impl=patch_embed)
        self.stages = nn.ModuleList(
            SwinStage(dims[i], depths[i], num_heads[i], window_size, i < nl - 1,
                      adapter_ratio, mlp_ratio, attn_impl[i], ffn_impl,
                      dpr[sum(depths[:i]):sum(depths[:i + 1])], adapter_drop, int8)
            for i in range(nl)
        )
        self.MPGBlocks = nn.ModuleList(MPGBlock(d, mapa_ratio) for d in dims)
        self.DeformMPGBlocks = nn.ModuleList(
            DeformMPGBlock(dims[i], dscf_strides[i], dscf_groups[i],
                           dscf_heads[i], level=i, ratio=dscf_ratio,
                           attn_impl=dscf_attn[i], int8=int8, rpe3=rpe3)
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
