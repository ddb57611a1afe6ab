"""K4: DSCF deformable attention in the rows layout.  Every query pixel and
head attends over M deformable keys with the K3 bias added to the scores.

Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_rows_kernel_packed and
_dscf_rows_kernel (launched by ``pallas_dscf_attention_rows``; twin
``dscf_rows_reference``), which are one function in two TPU layouts.  The
CUDA source is csrc/dscf_rows.cu; its header states the bound and the design.

Layouts: q (BG, h*w, GC), k and v (BG, Mp, GC) with Mp >= M (rows past M are
padding and never attended), bias (BG, hg, h, M, w); head e of a group holds
channels [e*hc, (e+1)*hc).  The probabilities are normalised, then rounded
to the value dtype, then multiplied with V, as in the twin.

``dscf_rows_attention`` launches the kernel for CUDA tensors and runs
``dscf_rows_reference``, the plain version, only for CPU tensors.  It is
differentiable: its backward is K8 (ops/dscf_rows_bwd.py), which saves the
inputs only and recomputes the softmax, as ``pallas_dscf._rows_bwd`` does.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)
from ir_ads_tpu_torch.ops.dscf_rows_bwd import HEAD_CHANNELS, dscf_rows_bwd

KERNEL = CudaKernel(
    "dscf_rows", "dscf_rows_attention", [VOIDP] * 5 + [INT] * 6 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_dscf.py:190",
)


def dscf_rows_reference(q, k, v, bias, scale, hg):
    """Plain PyTorch version, with the twin's rounding points."""
    bg, hw, gc = q.shape
    _, _, h, m, w = bias.shape
    hc = gc // hg
    cdt = q.dtype
    qh = q.reshape(bg, hw, hg, hc).transpose(1, 2)  # (BG, hg, HW, hc)
    kh = k[:, :m].reshape(bg, m, hg, hc).transpose(1, 2)
    vh = v[:, :m].reshape(bg, m, hg, hc).transpose(1, 2)
    bh = up(bias.to(cdt)).permute(0, 1, 2, 4, 3).reshape(bg, hg, hw, m)
    s = up((up(qh) * scale).to(cdt)) @ up(kh).transpose(-1, -2)
    p = torch.softmax(s + bh, dim=-1).to(cdt)
    out = (up(p) @ up(vh)).to(cdt)
    return out.transpose(1, 2).reshape(bg, hw, gc)


def _forward(q, k, v, bias, scale, hg):
    bg, hw, gc = q.shape
    mp = k.shape[1]
    _, _, h, m, w = bias.shape
    if hw != h * w or m > mp:
        raise ValueError(f"dscf_rows_attention: shapes {q.shape} {k.shape} {bias.shape}")
    if q.device.type == "cpu":
        return dscf_rows_reference(q, k, v, bias, scale, hg)
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    check_cuda("dscf_rows_attention", q, k, v, bias)
    if gc != hg * HEAD_CHANNELS:
        raise ValueError(f"dscf_rows_attention: needs {HEAD_CHANNELS} channels per head")
    out = torch.empty_like(q)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), bg, hg, h, w, m,
                mp, float(scale))
    return out


class _RowsAttention(torch.autograd.Function):
    """K4 forward, K8 backward; saves inputs only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, hg):
        ctx.save_for_backward(q, k, v, bias)
        ctx.static = (scale, hg)
        return _forward(q, k, v, bias, scale, hg)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = dscf_rows_bwd(q, k, v, bias, g, *ctx.static)
        return dq, dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype), None, None


def dscf_rows_attention(
    q: torch.Tensor,     # (BG, h*w, GC)
    k: torch.Tensor,     # (BG, Mp, GC)
    v: torch.Tensor,     # (BG, Mp, GC)
    bias: torch.Tensor,  # (BG, hg, h, M, w)
    scale: float,
    hg: int,
) -> torch.Tensor:
    return _RowsAttention.apply(q, k, v, bias, scale, hg)
