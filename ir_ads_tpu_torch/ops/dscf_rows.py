"""K4: DSCF deformable attention in the rows layout.  Every query pixel and
head attends over M deformable keys with the K3 bias added to the scores.

Replaces the two rows kernels of ir_ads_tpu/ops/pallas_dscf.py, launched by
``pallas_dscf_attention_rows`` (twin ``dscf_rows_reference``), which round
differently in bf16; ``packed`` chooses between them as the reference's
``IR_ADS_DSCF_PACKED`` does:

  packed=True   ``_dscf_rows_kernel_packed`` (:190): the probabilities
                normalised, ``ex / den`` in f32, rounded to the value dtype,
                then P.V summed in f32 and rounded (the twin's form);
  packed=False  ``_dscf_rows_kernel`` (:137): the unnormalised
                ``ex = exp(s - max)`` rounded to the value dtype, P.V summed
                in f32, divided by ``den``, then rounded once.

In f32 the two agree to an ulp; in bf16 about 40 % of the outputs differ by
a bf16 ulp.  The CUDA source is csrc/dscf_rows.cu; its header states the
bound and the design.  Up to 1024 keys both forms run csrc/dscf.cuh's
``dscf_attend_mma``: a warpgroup for 16 query pixels on the tensor cores,
every score computed once and held in registers until the final max, den
the f32 sum of the unrounded ``exp(s - max)`` over each warp's keys, then
over the warps in order; the packed form divides each weight before P.V,
the unpacked one rounds the weights as they are and divides the summed P.V
after.  K17 shares the packed form's code and K16 the unpacked form's.
Past 1024 keys both run ``dscf_attend``, a thread a query pixel.  Against
the plain version only the f32 sums' order differs, which flips a bf16
rounding now and then.

Layouts: q (BG, h*w, GC), k and v (BG, Mp, GC) with Mp >= M (rows past M are
padding and never attended), bias (BG, hg, h, M, w); head e of a group holds
channels [e*hc, (e+1)*hc).  The kernel takes hc = 8 (every Swin-B DSCF
level) and hc = 12 (every Swin-L level): a 12-channel head is staged in
shared memory as two planes of 8 channels, the last four zero, so that the
score and P.V products keep the 8-channel design's steps and its rounding
points.

``dscf_rows_attention`` launches the kernel for CUDA tensors and runs
``dscf_rows_reference``, the plain version, only for CPU tensors.  It is
differentiable: its backward is K8 (ops/dscf_rows_bwd.py), which saves the
inputs only and recomputes the softmax, as ``pallas_dscf._rows_bwd`` does;
the reference has one backward for both forms.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.dscf_rows_bwd import ROWS_HEAD_CHANNELS, dscf_rows_bwd

KERNEL = CudaKernel(
    "dscf_rows", "dscf_rows_attention", [VOIDP] * 5 + [INT] * 6 + [FLOAT, INT, INT],
    replaces="ir_ads_tpu/ops/pallas_dscf.py:190",
)


def attend_reference(qh, kh, vh, bh, scale, packed):
    """Attention of (BG, hg, N, hc) heads over (BG, hg, M, hc) keys with the
    bias bh (BG, hg, N, M), rounding where the Pallas DSCF kernels do: the
    scaled query to q's dtype, the scores and softmax in f32 with a true
    division, then ``packed`` (normalise, round, P.V) or not (round the
    unnormalised weights, P.V, divide); P.V summed in f32, rounded once."""
    cdt = qh.dtype
    s = up((up(qh) * q_scale(scale, cdt)).to(cdt)) @ up(kh).transpose(-1, -2) + up(bh)
    ex = torch.exp(s - s.amax(-1, keepdim=True))
    den = ex.sum(-1, keepdim=True)
    if packed:
        return (up((ex / den).to(cdt)) @ up(vh)).to(cdt)
    return ((up(ex.to(cdt)) @ up(vh)) / den).to(cdt)


def dscf_rows_reference(q, k, v, bias, scale, hg, packed):
    """Plain PyTorch version: ``packed`` chooses the Pallas kernel's form."""
    bg, hw, gc = q.shape
    _, _, h, m, w = bias.shape
    hc = gc // hg
    qh = q.reshape(bg, hw, hg, hc).transpose(1, 2)  # (BG, hg, HW, hc)
    kh = k[:, :m].reshape(bg, m, hg, hc).transpose(1, 2)
    vh = v[:, :m].reshape(bg, m, hg, hc).transpose(1, 2)
    bh = up(bias.to(q.dtype)).permute(0, 1, 2, 4, 3).reshape(bg, hg, hw, m)
    out = attend_reference(qh, kh, vh, bh, scale, packed)
    return out.transpose(1, 2).reshape(bg, hw, gc)


def _forward(q, k, v, bias, scale, hg, packed):
    bg, hw, gc = q.shape
    mp = k.shape[1]
    _, _, h, m, w = bias.shape
    if hw != h * w or m > mp:
        raise ValueError(f"dscf_rows_attention: shapes {q.shape} {k.shape} {bias.shape}")
    if q.device.type == "cpu":
        return dscf_rows_reference(q, k, v, bias, scale, hg, packed)
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    check_cuda("dscf_rows_attention", q, k, v, bias)
    hc = gc // hg
    if gc != hg * hc or hc not in ROWS_HEAD_CHANNELS:
        raise ValueError(f"dscf_rows_attention: needs {ROWS_HEAD_CHANNELS} channels per head; "
                         f"got {gc} over {hg} heads")
    out = torch.empty_like(q)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), bg, hg, h, w, m,
                mp, q_scale(scale, q.dtype), int(bool(packed)), hc)
    return out


class _RowsAttention(torch.autograd.Function):
    """K4 forward, K8 backward; saves inputs only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, hg, packed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.static = (scale, hg)
        return _forward(q, k, v, bias, scale, hg, packed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = dscf_rows_bwd(q, k, v, bias, g, *ctx.static)
        return dq, dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype), None, None, None


def dscf_rows_attention(
    q: torch.Tensor,     # (BG, h*w, GC)
    k: torch.Tensor,     # (BG, Mp, GC)
    v: torch.Tensor,     # (BG, Mp, GC)
    bias: torch.Tensor,  # (BG, hg, h, M, w)
    scale: float,
    hg: int,
    packed: bool,
) -> torch.Tensor:
    """``packed``: the Pallas kernel whose rounding to compute (module
    docstring); the reference's DAttentionMM takes the packed one at levels
    0-2 and the unpacked one at level 3.  Autograd records the call only
    where an input needs a gradient: its bookkeeping costs host time of the
    order of the kernel's own at level 3."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _RowsAttention.apply(q, k, v, bias, scale, hg, packed)
    return _forward(q, k, v, bias, scale, hg, packed)
