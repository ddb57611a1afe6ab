"""K12: W-MSA / SW-MSA on windowed, unsplit qkv, (B*nW, N, 3C) -> (B*nW,
N, C), heads in the channel dimension.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v2 (launched by
``pallas_window_attention_qkv``; twin ``_qkv_reference``), which the module
path's ``WindowMSA(attn_impl="pallas")`` runs.  The CUDA source is
csrc/window_attention_qkv.cu; its header states the bound and the design.

``window_attention_qkv`` launches the kernel for CUDA tensors and runs
``window_attention_qkv_reference``, the plain version (``_qkv_reference``:
``window_attention`` with a -1e9 mask where the region ids of a pair
differ), only for CPU tensors.  It is differentiable in ``qkv`` and
``bias``: its backward is the vjp of the plain version, as the JAX
package's ``_fused_qkv_bwd`` takes ``jax.vjp`` of ``_qkv_reference``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.window_attention import window_attention

KERNEL = CudaKernel(
    "window_attention_qkv", "window_attention_qkv", [VOIDP] * 4 + [INT] * 5 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_swin.py:201",
)


def region_mask(region: torch.Tensor, value: float) -> torch.Tensor:
    """(nW, N, N) f32: ``value`` where the region ids of a pair differ."""
    neq = region[:, :, None] != region[:, None, :]
    return torch.where(neq, value, 0.0).to(torch.float32)


def window_attention_qkv_reference(qkv, bias, region, scale, heads):
    """Plain PyTorch version, ``_qkv_reference``: split the heads, attend
    with ``window_attention`` under a -1e9 region mask, repack the heads."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads

    def split(t):  # (bn, n, c) -> (bn, heads, n, d)
        return t.reshape(bn, n, heads, d).transpose(1, 2)

    q, k, v = (split(qkv[..., i * c:(i + 1) * c]) for i in range(3))
    mask = None if region is None else region_mask(region, -1e9)
    out = window_attention(q, k, v, bias, mask, scale)
    return out.transpose(1, 2).reshape(bn, n, c)


def _forward(qkv, bias, region, scale, heads):
    if qkv.device.type == "cpu":
        return window_attention_qkv_reference(qkv, bias, region, scale, heads)
    qkv, bias = qkv.contiguous(), bias.float().contiguous()
    check_cuda("window_attention_qkv", qkv)
    check_cuda("window_attention_qkv", bias, dtype=torch.float32)
    bn, n, c3 = qkv.shape
    c = c3 // 3
    ws = math.isqrt(n)
    nw = 1 if region is None else region.shape[0]
    if ws * ws != n or n % 16 or c % heads or (c // heads) % 16 or bn % nw:
        raise ValueError(f"window_attention_qkv: unsupported shape {tuple(qkv.shape)} "
                         f"heads={heads} windows per image {nw}")
    if region is not None:
        region = region.to(device=qkv.device, dtype=torch.int32).contiguous()
    out = torch.empty((bn, n, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL.call(ptr(qkv), ptr(bias), ptr(region) if region is not None else None,
                ptr(out), bn, c, heads, ws, nw, q_scale(scale, qkv.dtype))
    return out


class _WindowAttentionQKV(torch.autograd.Function):
    """K12 forward; backward the vjp of the plain version (recomputed)."""

    @staticmethod
    def forward(ctx, qkv, bias, region, scale, heads):
        ctx.save_for_backward(qkv, bias, region)
        ctx.static = (scale, heads)
        return _forward(qkv, bias, region, scale, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, region = ctx.saved_tensors
        wanted = [i for i in (0, 1) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate((qkv, bias))]
            out = window_attention_qkv_reference(*leaves, region, *ctx.static)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None, None]
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None, None)


def window_attention_qkv(
    qkv: torch.Tensor,               # (B*nW, N, 3C), the qkv projection's output
    bias: torch.Tensor,              # (heads, N, N) f32
    region: Optional[torch.Tensor],  # (nW, N) int32 shift-region ids, or None
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Returns (B*nW, N, C) in qkv's dtype."""
    return _WindowAttentionQKV.apply(qkv, bias, region, scale, heads)
