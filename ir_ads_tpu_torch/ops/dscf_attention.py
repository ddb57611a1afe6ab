"""K17: DSCF deformable attention over the packed bias, the attention of the
reference's ``pallas`` and ``pallas2`` DSCF.  Every query pixel and head of
a group attends over the group's Mp keys with the bias added to the scores.

Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_kernel (launched by
``pallas_dscf_attention``; twin ``dscf_reference``).  The CUDA source is
csrc/dscf_attention.cu; its header states the bound and the design.

Layouts, the TPU kernel's: q (BG, HW, GC), k and v (BG, Mp, GC) with Mp a
multiple of 128, bias (BG, HW, hg*Mp) with head e's keys at lanes
[e*Mp, (e+1)*Mp); head e holds channels [e*hc, (e+1)*hc).  The kernel takes
K4's widths, hc = 8 (every Swin-B DSCF level), 12 (every Swin-L level), and
the MiT's 10, 4 and 5 (``dscf_heads.HEAD_CHANNELS``), with K4's design: a
head of 10 or 12 channels staged as two planes of 8 channels, a head of 4
or 5 as one, the channels past the head zero, rows read in words the
head's alignment allows and each channel stored alone.  The caller pads
the keys with zeros and their bias columns with -1e9, as DAttentionMM does.
Rounding: ``bf16(q * scale) . k`` in f32 plus the bias in f32, an f32
softmax, the normalised probabilities rounded to the value dtype before P.V
(``jax.nn.softmax`` then the cast), P.V summed in f32 and rounded once: K4's
``packed=True`` form (``dscf_rows.attend_reference``).

``dscf_attention`` launches the kernel for CUDA tensors and runs
``dscf_attention_reference``, the plain version (any width), only for CPU
tensors.  On a CUDA tensor a width outside the five raises ``ValueError``,
and a launch the card refuses (the thread form past 1024 keys stages K and
V in shared memory: at 12 channels up to 2304 keys) raises ``RuntimeError``;
nothing falls back to the plain version.  It is differentiable: its backward is the vjp of the plain version, as the JAX
package's ``_bwd`` takes ``jax.vjp`` of ``dscf_reference``.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.dscf_heads import head_channels
from ir_ads_tpu_torch.ops.dscf_rows import attend_reference

KERNEL = CudaKernel(
    "dscf_attention", "dscf_attention", [VOIDP] * 5 + [INT] * 4 + [FLOAT, INT],
    replaces="ir_ads_tpu/ops/pallas_dscf.py:44",
)
NEG_INF = -1e9  # the bias of a padded key (pallas_dscf.NEG_INF)
KEY_LANES = 128  # Mp, the keys padded to a multiple of the TPU's lane width


def dscf_attention_reference(q, k, v, bias, scale, hg):
    """Plain PyTorch version, the twin ``dscf_reference``'s rounding points."""
    bg, hw, gc = q.shape
    mp = k.shape[1]
    hc = gc // hg

    def heads(t, n):  # (BG, N, GC) -> (BG, hg, N, hc)
        return t.reshape(bg, n, hg, hc).transpose(1, 2)

    bh = bias.reshape(bg, hw, hg, mp).transpose(1, 2)  # (BG, hg, HW, Mp)
    out = attend_reference(heads(q, hw), heads(k, mp), heads(v, mp), bh, scale, packed=True)
    return out.transpose(1, 2).reshape(bg, hw, gc)


def _forward(q, k, v, bias, scale, hg):
    bg, hw, gc = q.shape
    mp = k.shape[1]
    if bias.shape != (bg, hw, hg * mp) or v.shape != k.shape:
        raise ValueError(f"dscf_attention: shapes {q.shape} {k.shape} {bias.shape}")
    if q.device.type == "cpu":
        return dscf_attention_reference(q, k, v, bias, scale, hg)
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    check_cuda("dscf_attention", q, k, v, bias)
    hc = head_channels("dscf_attention", gc, hg)
    if mp % KEY_LANES:
        raise ValueError(f"dscf_attention: needs keys padded to a multiple of {KEY_LANES}, "
                         f"got {tuple(k.shape)}")
    out = torch.empty_like(q)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), bg, hg, hw, mp,
                q_scale(scale, q.dtype), hc)
    return out


class _Attention(torch.autograd.Function):
    """K17 forward; backward the vjp of the plain version (recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, hg):
        ctx.save_for_backward(q, k, v, bias)
        ctx.static = (scale, hg)
        return _forward(q, k, v, bias, scale, hg)

    @staticmethod
    def backward(ctx, g):
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(ctx.saved_tensors)]
            out = dscf_attention_reference(*leaves, *ctx.static)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None] * 4
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None)


def dscf_attention(
    q: torch.Tensor,     # (BG, HW, GC)
    k: torch.Tensor,     # (BG, Mp, GC)
    v: torch.Tensor,     # (BG, Mp, GC)
    bias: torch.Tensor,  # (BG, HW, hg*Mp)
    scale: float,
    hg: int,
) -> torch.Tensor:
    """Returns (BG, HW, GC) in q's dtype."""
    return _Attention.apply(q, k, v, bias, scale, hg)
