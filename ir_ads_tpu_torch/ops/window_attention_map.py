"""K15: W-MSA / SW-MSA on the qkv map, (B, Hp, Wp, 3C) -> (B, Hp, Wp, C),
heads in the channel dimension, the window partition and reverse folded
into the kernel's indices.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v3 (launched by
``pallas_window_attention_map``; twin ``_map_reference``), which the module
path's ``WindowMSA(attn_impl="pallas_map")`` runs between its qkv and proj
linears.  The CUDA entry point ``window_attention_map`` lives in
csrc/window_attention_qkv.cu beside K12's; its header states the bound and
the two designs, which K15 chooses as K12 does (``tensor_core_design``) and
runs on the map's rows.

``window_attention_map`` launches the kernel for CUDA tensors and runs
``window_attention_map_reference``, the plain version (``_map_reference``:
``window_partition``, K12's plain version, ``window_reverse``), only for CPU
tensors.  It is differentiable in ``qkv`` and ``bias``: its backward is the
vjp of the plain version, as the JAX package's ``_fused_map_bwd`` takes
``jax.vjp`` of ``_map_reference``.  Autograd records the call only where an
input needs a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.window_attention import window_partition, window_reverse
from ir_ads_tpu_torch.ops.window_attention_qkv import (
    first_design_fits, tensor_core_design, window_attention_qkv_reference,
)

KERNEL = CudaKernel(
    "window_attention_map", "window_attention_map", [VOIDP] * 4 + [INT] * 7 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_swin.py:814", unit="window_attention_qkv",
)


def window_attention_map_reference(qkv, bias, region, scale, heads, ws):
    """Plain PyTorch version, ``_map_reference``: K12's plain version on the
    map's windows.  Returns (B, Hp, Wp, C)."""
    hp, wp = qkv.shape[1:3]
    out = window_attention_qkv_reference(window_partition(qkv, ws), bias, region, scale, heads)
    return window_reverse(out, ws, hp, wp)


def _forward(qkv, bias, region, scale, heads, ws):
    if qkv.device.type == "cpu":
        return window_attention_map_reference(qkv, bias, region, scale, heads, ws)
    qkv, bias = qkv.contiguous(), bias.float().contiguous()
    check_cuda("window_attention_map", qkv)
    check_cuda("window_attention_map", bias, dtype=torch.float32)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    mma = c % heads == 0 and tensor_core_design(qkv.dtype, n, c // heads)
    if (hp % ws or wp % ws or c % heads or not (mma or first_design_fits(n, c // heads))
            or (region is not None and tuple(region.shape) != (nw, n))):
        raise ValueError(f"window_attention_map: unsupported shape {tuple(qkv.shape)} "
                         f"heads={heads} ws={ws}")
    if region is not None:
        region = region.to(device=qkv.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL.call(ptr(qkv), ptr(bias), ptr(region) if region is not None else None,
                ptr(out), b, hp, wp, c, heads, ws, int(mma), q_scale(scale, qkv.dtype))
    return out


class _WindowAttentionMap(torch.autograd.Function):
    """K15 forward; backward the vjp of the plain version (recomputed)."""

    @staticmethod
    def forward(ctx, qkv, bias, region, scale, heads, ws):
        ctx.save_for_backward(qkv, bias, region)
        ctx.static = (scale, heads, ws)
        return _forward(qkv, bias, region, scale, heads, ws)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, region = ctx.saved_tensors
        wanted = [i for i in (0, 1) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate((qkv, bias))]
            out = window_attention_map_reference(*leaves, region, *ctx.static)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None, None]
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None, None, None)


def window_attention_map(
    qkv: torch.Tensor,               # (B, Hp, Wp, 3C), the qkv projection of the rolled map
    bias: torch.Tensor,              # (heads, N, N) f32
    region: Optional[torch.Tensor],  # (nW, N) int32 shift-region ids, or None
    scale: float,
    heads: int,
    ws: int,
) -> torch.Tensor:
    """Returns (B, Hp, Wp, C) in qkv's dtype."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttentionMap.apply(qkv, bias, region, scale, heads, ws)
    return _forward(qkv, bias, region, scale, heads, ws)
