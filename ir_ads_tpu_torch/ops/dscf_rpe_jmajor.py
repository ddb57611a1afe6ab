"""K18: the DSCF continuous relative-position bias in the j-major layout
(BG, hg, M, h, w), in the f32 form of the pallas2 DSCF's bias kernel.

Replaces ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_kernel (launched by
``dscf_rpe_bias_pallas``; twin ``dscf_rpe_bias_reference``), which the
reference's DAttentionMM runs under ``pallas2`` before transposing the bias
into ``_dscf_kernel``'s packed layout (K17, ops/dscf_attention.py).  The
CUDA entry point ``dscf_rpe_jmajor`` lives in csrc/dscf_rpe.cu beside K3's
and K6's; the header states the bound and the design.  BG = B * G is
group-minor: row bg uses table group bg % G.

The function is K3's and K6's sample with other rounding points:
``_rpe_kernel`` computes its hat weights in the f32 order
``(ay*r + by) - s`` and keeps them, the table and the partial product u in
f32 whatever it stores; the output is rounded once.  That is the twin's
form, ``dscf_rpe.rpe_bias_f32``, so the plain version
``rpe_bias_jmajor_reference`` is ``rpe_bias_f32`` in the ``bemhw`` order,
rounded once (not K3's ``rpe_bias_bf16``).  ``rpe_bias_jmajor_ordered`` is
the same function in the CUDA kernel's order of operations, one torch
elementwise op per rounding: four taps an axis, zero weights and taps off
the table skipped, each product and sum rounded in f32, no matmul and no
fused multiply-add.  The kernel computes that sequence bit for bit (its
header says why its two middle taps are enough); the einsum plain version
sums by f32 dots, which may fuse a multiply-add, so an output near a bf16
rounding boundary can land one bf16 ulp away from it.

``rpe_bias_jmajor`` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors.  It is differentiable in ``pos`` and
``table`` through ``dscf_rpe.RpeBias`` (a recompute through
``rpe_bias_f32`` under autograd), as ``_rpe_bwd`` recomputes through the
twin.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr
from ir_ads_tpu_torch.ops.dscf_rpe import (
    check_plane, hat_slopes, rpe_bias_f32, slopes, with_grad,
)

KERNEL = CudaKernel(
    "dscf_rpe_jmajor", "dscf_rpe_jmajor", [VOIDP] * 3 + [INT] * 8 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_dscf_rpe.py:75", unit="dscf_rpe",
)


def rpe_bias_jmajor_reference(pos, table, h, w, out_dtype):
    """Plain PyTorch version: the twin's f32 hat-weight products, rounded
    once to ``out_dtype``."""
    return rpe_bias_f32(pos, table, h, w, "bemhw").to(out_dtype)  # (BG, hg, M, h, w)


def rpe_bias_jmajor_ordered(pos, table, h, w, out_dtype, chunk_elems=1 << 23):
    """Plain PyTorch version in the kernel's order: ``_rpe_kernel``'s sample
    written out as the sequence the CUDA kernel computes, one elementwise f32
    op per rounding.  For each (bg, e, key j, row r, column c): the key's
    origin ``by = ((0.5 - 0.5 py) * 0.5) * (S1 - 1)`` (and bx), the sample
    index ``x = ay * r + by``, four taps ``s = floor(x) - 1 + dy``, the
    weight ``max(0, 1 - |x - s|)``; a tap off the table or of weight 0 is
    skipped; ``u = sum_dx wx * T[s, t]`` and ``acc = sum_dy wy * u``, each
    from +0 in tap order; the output rounded once.  Runs over chunks of
    keys of at most ``chunk_elems`` outputs, so that level 0 fits on the
    card."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    dev, f32 = pos.device, torch.float32
    ay, ax = hat_slopes(s1, s2, h, w)
    pos = pos.float()
    by = ((0.5 - 0.5 * pos[..., 0]) * 0.5) * float(s1 - 1)  # (BG, M)
    bx = ((0.5 - 0.5 * pos[..., 1]) * 0.5) * float(s2 - 1)
    ar = lambda n, a: torch.arange(n, dtype=f32, device=dev) * a  # noqa: E731
    tb = table.float()[torch.arange(bg, device=dev) % g].reshape(bg, hg, s1 * s2)

    def taps(x, size):
        """The four taps of x (..., n) and their weights, (4, ..., n)."""
        first = torch.floor(x) - 1.0
        t = torch.stack([first + float(d) for d in range(4)])
        wt = torch.clamp(1.0 - (x - t).abs(), min=0.0)
        on = (t >= 0) & (t < size)
        return t.long().clamp(0, size - 1), torch.where(on, wt, torch.zeros_like(wt))

    step = max(1, chunk_elems // (bg * hg * h * w))
    out = []
    for j0 in range(0, m, step):
        mc = min(step, m - j0)
        ty, wy = taps(ar(h, ay) + by[:, j0:j0 + mc, None], s1)  # (4, BG, mc, h)
        tx, wx = taps(ar(w, ax) + bx[:, j0:j0 + mc, None], s2)  # (4, BG, mc, w)
        acc = torch.zeros(bg, hg, mc, h, w, dtype=f32, device=dev)
        for dy in range(4):
            u = torch.zeros_like(acc)
            for dx in range(4):
                idx = (ty[dy][..., :, None] * s2 + tx[dx][..., None, :]).reshape(bg, 1, -1)
                tv = torch.gather(tb, 2, idx.expand(bg, hg, -1)).reshape(acc.shape)
                wdx = wx[dx][:, None, :, None, :]
                u = torch.where(wdx != 0, u + wdx * tv, u)
            wdy = wy[dy][:, None, :, :, None]
            acc = torch.where(wdy != 0, acc + wdy * u, acc)
        out.append(acc.to(out_dtype))
    return torch.cat(out, dim=2)


def _jmajor_forward(pos, table, h, w, out_dtype):
    pos, table = pos.contiguous(), table.contiguous()
    if pos.device.type == "cpu":
        return rpe_bias_jmajor_reference(pos, table, h, w, out_dtype)
    check_cuda("rpe_bias_jmajor", pos, table, dtype=torch.float32)
    if out_dtype != torch.bfloat16:
        raise ValueError("rpe_bias_jmajor: the CUDA kernel stores bf16")
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    check_plane("rpe_bias_jmajor", s1, s2, h, bf16_pairs=False)
    out = torch.empty((bg, hg, m, h, w), dtype=out_dtype, device=pos.device)
    KERNEL.call(ptr(pos), ptr(table), ptr(out), bg, g, hg, h, m, w, s1, s2,
                *slopes(s1, s2, h, w))
    return out


def rpe_bias_jmajor(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Returns the bias (BG, hg, M, h, w) in ``out_dtype``."""
    if h < 2 or w < 2:
        raise ValueError(f"rpe_bias_jmajor: query plane {h}x{w} needs h, w >= 2")
    return with_grad(pos, table, h, w, out_dtype, "bemhw", _jmajor_forward)
