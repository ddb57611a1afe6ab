"""K16: the fused DSCF attention of the reference's ``pallas4``: the rpe bias
of every (query pixel, key) pair sampled inside the attention, which runs
in the unpacked rows form.  No bias is stored.

Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_fused_kernel (launched by
``pallas_dscf_attention_fused``; twin ``dscf_fused_reference``).  The CUDA
source is csrc/dscf_fused.cu; its header states the bound and the design:
up to 1024 keys, K4's unpacked attention on the tensor cores
(``dscf_attend_mma``), each (query pixel, key) bias sampled once where its
score sits, from a bf16 table and per-key and per-row parts staged in
shared memory; past 1024 keys, a thread a query pixel, as K4 there.

The TPU kernel builds a band's bias in VMEM with ``_rpe_rows_kernel``'s
hat-weight products and rounding points, rounds it to the store dtype and
runs ``_dscf_rows_kernel``'s attention on it: the unnormalised weights
rounded, P.V summed in f32, divided after.  So its function is K3 followed
by K4 with ``packed=False``, and the plain version
``dscf_fused_reference`` is exactly that composition of their plain
versions (``dscf_rpe.rpe_bias_rows_reference``, then
``dscf_rows.dscf_rows_reference(..., packed=False)``); the CUDA kernel runs
K3's and K4's device code and is bit-equal on the card to the two kernels
(at 12 channels a head where both take the same tile count: M up to 128,
513 to 640, and past 1024).  The bias is rounded to q's dtype, the
reference's store dtype.  The kernel takes heads of 8 channels (every
Swin-B DSCF level) and 12 (every Swin-L level), the widths a path runs it
at (``dscf_heads.HEAD_CHANNELS``): at 12, K and V staged as two 8-channel
planes, as K4 does, on the tensor cores up to 640 keys (Swin-L's 600) and
a thread a query pixel past them.

Layouts: q (BG, h*w, GC), k and v (BG, Mp, GC) with Mp >= M, pos (BG, M, 2)
f32 (y, x) in [-1, 1], table (G, hg, S1, S2) f32; BG = B * G group-minor.

``dscf_fused_attention`` raises ``ValueError`` where the reference's
``_pick_band_rows`` does (``band_rows``), so that pallas4 has the
reference's domain, on every device.  It launches the kernel for CUDA
tensors and runs the plain version (any width) only for CPU tensors.  On a
CUDA tensor another width raises ``ValueError``, and a launch whose shared
memory passes what a block may take is refused and raises
``RuntimeError``; nothing falls back to the plain version.  It is
differentiable in q, k, v, pos and table: its backward is the vjp of the
plain version (recomputed), as ``_dscf_fused_bwd`` takes ``jax.vjp`` of the
twin.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.dscf_heads import head_channels
from ir_ads_tpu_torch.ops.layers import q_scale
from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_reference
from ir_ads_tpu_torch.ops.dscf_rpe import hat_slopes, rpe_bias_rows_reference

KERNEL = CudaKernel(
    "dscf_fused", "dscf_fused_attention", [VOIDP] * 6 + [INT] * 9 + [FLOAT] * 3 + [INT],
    replaces="ir_ads_tpu/ops/pallas_dscf.py:460",
)
BAND_BYTES = 24 * 1024 * 1024  # the reference's VMEM budget for a band's bias


def band_rows(h: int, w: int, m: int, hg: int) -> int:
    """The reference's ``_pick_band_rows``: the largest row band whose f32
    bias (hg, rows, M, w) fits its VMEM budget, rows dividing h and rows * w
    a multiple of 8; ``ValueError`` where there is none (a 15x20 or a 4x7
    plane).  The CUDA kernel needs no band; this is the domain check."""
    for rows in range(h, 0, -1):
        if h % rows or (rows * w) % 8:
            continue
        if hg * rows * m * w * 4 <= BAND_BYTES:
            return rows
    raise ValueError(f"dscf_fused_attention: no legal row band for (h={h}, w={w}, m={m}, "
                     f"hg={hg}): rows * w must be a multiple of 8 within the budget")


def dscf_fused_reference(q, k, v, pos, table, h, w, scale, hg):
    """Plain PyTorch version: K3's plain version, then K4's unpacked form."""
    bias = rpe_bias_rows_reference(pos, table, h, w, q.dtype)  # (BG, hg, h, M, w)
    return dscf_rows_reference(q, k, v, bias, scale, hg, packed=False)


def _forward(q, k, v, pos, table, h, w, scale, hg):
    bg, hw, gc = q.shape
    mp, m = k.shape[1], pos.shape[1]
    if hw != h * w or m > mp or v.shape != k.shape or table.shape[1] != hg:
        raise ValueError(f"dscf_fused_attention: shapes {q.shape} {k.shape} {pos.shape} "
                         f"{table.shape}")
    band_rows(h, w, m, hg)
    if q.device.type == "cpu":
        return dscf_fused_reference(q, k, v, pos, table, h, w, scale, hg)
    q, k, v, pos, table = (t.contiguous() for t in (q, k, v, pos, table))
    check_cuda("dscf_fused_attention", q, k, v)
    check_cuda("dscf_fused_attention", pos, table, dtype=torch.float32)
    hc = head_channels("dscf_fused", gc, hg)
    g, _, s1, s2 = table.shape
    out = torch.empty_like(q)
    KERNEL.call(ptr(q), ptr(k), ptr(v), ptr(pos), ptr(table), ptr(out), bg, g, hg, h, w, m,
                mp, s1, s2, q_scale(scale, q.dtype), *hat_slopes(s1, s2, h, w), hc)
    return out


class _FusedAttention(torch.autograd.Function):
    """K16 forward; backward the vjp of the plain version (recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, pos, table, h, w, scale, hg):
        ctx.save_for_backward(q, k, v, pos, table)
        ctx.static = (h, w, scale, hg)
        return _forward(q, k, v, pos, table, h, w, scale, hg)

    @staticmethod
    def backward(ctx, g):
        wanted = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(ctx.saved_tensors)]
            out = dscf_fused_reference(*leaves, *ctx.static)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None] * 5
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None, None, None)


def dscf_fused_attention(
    q: torch.Tensor,      # (BG, h*w, GC)
    k: torch.Tensor,      # (BG, Mp, GC)
    v: torch.Tensor,      # (BG, Mp, GC)
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    scale: float,
    hg: int,
) -> torch.Tensor:
    """Returns (BG, h*w, GC) in q's dtype."""
    if h < 2 or w < 2:
        raise ValueError(f"dscf_fused_attention: query plane {h}x{w} needs h, w >= 2")
    pos, table = pos.float(), table.float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, pos, table)):
        return _FusedAttention.apply(q, k, v, pos, table, h, w, scale, hg)
    return _forward(q, k, v, pos, table, h, w, scale, hg)
