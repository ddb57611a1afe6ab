"""K20: the v1 window attention, from separate q, k and v (B*nW, heads, N,
d) -> (B*nW, heads, N, d), f32 or bf16.

Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel (launched by
``pallas_window_attention`` and ``fused_window_attention``; twin
``_region_mask_attention``).  Nothing in the reference's model calls it,
only its tests do, so nothing in the port's model does either.  The CUDA
source is csrc/window_attention_v1.cu; its header states the bound and the
design.  The TPU kernel pads N to 256 and d to 128 for its compiler, and
its padded keys carry region id -1; the port pads nothing.

The kernel is not its twin in bf16: it upcasts q and k to f32 and scales q
by the f32 scale with no rounding (``pallas_swin.py:51-56``), where the
twin (``window_attention``) rounds ``q * bf16(scale)`` to bf16.  The port
follows the kernel: scores ``f32(q) * scale . f32(k)`` plus the f32 bias,
-1e9 added where the region ids of a pair differ, an f32 softmax, the
probabilities cast to v's dtype, P.V summed in f32 and rounded once.

``window_attention_v1`` launches the kernel for CUDA tensors and runs
``window_attention_v1_reference``, the plain version, only for CPU tensors.
The kernel has two designs, chosen by dtype and shape alone
(``window_attention_qkv.tensor_core_design``, K12's and K15's choice too):
bf16 with d = 16 or 32 and N <= 144 (every Swin
window up to 12 x 12 at 32 channels a head) runs on the tensor cores, q *
scale carried exactly as three bf16 parts; f32, and bf16 with another d or
a larger N, run the thread design (f32 products on the CUDA cores).  A
shape that neither takes raises.
``fused_window_attention`` is differentiable in q, k, v and the bias: its
backward is the vjp of the twin (``window_attention`` under the dense -1e9
region mask), as the JAX package's ``_fused_bwd`` takes ``jax.vjp`` of
``_region_mask_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up
from ir_ads_tpu_torch.ops.window_attention import window_attention
from ir_ads_tpu_torch.ops.window_attention_qkv import region_mask, tensor_core_design

KERNEL = CudaKernel(
    "window_attention_v1", "window_attention_v1", [VOIDP] * 6 + [INT] * 7 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_swin.py:44",
)
SMEM_MAX = 232448  # bytes of shared memory a block may have on an H100


def window_attention_v1_reference(q, k, v, bias, region, scale):
    """Plain PyTorch version, with the Pallas kernel's rounding points."""
    bn, nh, n, _ = q.shape
    s = (up(q) * scale) @ up(k).transpose(-1, -2) + up(bias)[None]
    if region is not None:
        nw = region.shape[0]
        neq = (region[:, :, None] != region[:, None, :])[None, :, None]
        s = s.reshape(bn // nw, nw, nh, n, n)
        s = torch.where(neq, s - 1e9, s).reshape(bn, nh, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (up(p) @ up(v)).to(v.dtype)


def window_attention_v1_twin(q, k, v, bias, region, scale):
    """The twin, ``_region_mask_attention``: ``window_attention`` (q * scale
    rounded to q's dtype) under the dense -1e9 region mask."""
    mask = None if region is None else region_mask(region, -1e9)
    return window_attention(q, k, v, bias, mask, scale)


def _smem_bytes(n: int, d: int) -> int:
    """The thread design's shared memory: q^T and k^T (d, N4), v (N, d) and
    the scores (N, N4 + 1), f32; N4 = N rounded up to 4."""
    n4 = -(-n // 4) * 4
    return 4 * (2 * d * n4 + n * d + n * (n4 + 1))


def window_attention_v1(
    q: torch.Tensor,                 # (B*nW, heads, N, d)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,              # (heads, N, N)
    region: Optional[torch.Tensor],  # (nW, N) int32 shift-region ids, or None
    scale: float,
) -> torch.Tensor:
    """Returns (B*nW, heads, N, d) in v's dtype."""
    if q.device.type == "cpu":
        return window_attention_v1_reference(q, k, v, bias, region, scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    bias = up(bias).contiguous()
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention_v1: expected f32 or bf16, got {q.dtype}")
    check_cuda("window_attention_v1", q, k, v, dtype=q.dtype)
    check_cuda("window_attention_v1", bias, dtype=torch.float32)
    bn, heads, n, d = q.shape
    nw = 1 if region is None else region.shape[0]
    mma = tensor_core_design(q.dtype, n, d)
    if (k.shape != q.shape or v.shape != q.shape or bias.shape != (heads, n, n)
            or bn % nw or (not mma and (d % 4 or _smem_bytes(n, d) > SMEM_MAX))):
        raise ValueError(f"window_attention_v1: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} bias {tuple(bias.shape)} "
                         f"windows per image {nw}")
    if region is not None:
        region = region.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(bias),
                ptr(region) if region is not None else None, ptr(out),
                bn, heads, n, d, nw, int(q.dtype == torch.bfloat16), int(mma), float(scale))
    return out


class _FusedWindowAttention(torch.autograd.Function):
    """K20 forward; backward the vjp of the twin (recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region, scale):
        ctx.save_for_backward(q, k, v, bias, region)
        ctx.scale = scale
        return window_attention_v1(q, k, v, bias, region, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, region = ctx.saved_tensors
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate((q, k, v, bias))]
            out = window_attention_v1_twin(*leaves, region, ctx.scale)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None] * 4
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None)


def fused_window_attention(q, k, v, bias, region, scale):
    """``window_attention_v1`` with the twin's vjp as its backward."""
    return _FusedWindowAttention.apply(q, k, v, bias, region, scale)
