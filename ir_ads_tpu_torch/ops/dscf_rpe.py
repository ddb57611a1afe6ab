"""K3: the DSCF continuous relative-position bias in the rows layout
(BG, hg, h, M, w): a bilinear sample of the learned table at the
displacement between every query pixel and every deformable key.

Replaces ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_rows_kernel (launched by
``dscf_rpe_bias_rows_pallas``; twin ``dscf_rpe_bias_rows_reference``).  The
CUDA source is csrc/dscf_rpe.cu; its header states the bound, the design
and its domain (the table plane staged in shared memory: ``plane_smem``).
BG = B * G is group-minor: row bg uses table group bg % G.

``rpe_bias_rows`` launches the kernel for CUDA tensors and runs
``rpe_bias_rows_reference``, the plain version, only for CPU tensors.  In
bf16 it rounds where the TPU kernel does (``rpe_bias_bf16``): the hat
weights, in the TPU kernel's f32 order, the table and the partial product u
are rounded to bf16 before their f32 sums, and the output once; the CUDA
kernel computes the same in its 2 x 2-tap form, bit for bit.  In f32 it is
the twin's hat-weight products (``rpe_bias_f32``).

``rpe_bias_rows`` is differentiable in ``pos`` and ``table``: its backward
recomputes the bias through ``rpe_bias_f32`` under autograd, as the JAX
package's ``_rpe_rows_bwd`` recomputes through its XLA twin.

``rpe_bias_xla`` is the reference's XLA form of the same bias (``rpe_bias``
inside ``DAttentionMM``), which its einsum branch takes where no bias kernel
runs: plain PyTorch with the reference's rounding points, no kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ir_ads_tpu_torch.ops.cuda_lib import FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "dscf_rpe", "dscf_rpe_rows", [VOIDP] * 3 + [INT] * 8 + [FLOAT] * 2,
    replaces="ir_ads_tpu/ops/pallas_dscf_rpe.py:182",
)
SMEM_MAX = 232448  # bytes of shared memory a block may have on an H100


def plane_smem(s1: int, s2: int, h: int, bf16_pairs: bool) -> int:
    """The least shared memory csrc/dscf_rpe.cu's block of K3, K6 (the table
    plane as bf16 pairs with a zero row and column past its last:
    ``bf16_pairs``) or K18 (the f32 plane) takes: the plane aligned to 128
    bytes, one key's y-tap records (h rounded up to 8 rows; 8 bytes a row
    for K3 and K6, 16 for K18), and 16 warps' 8 x 32 bf16 staging tiles."""
    table = (s1 + 1) * s2 * 4 if bf16_pairs else s1 * s2 * 4
    keys = -(-h // 8) * 8 * (8 if bf16_pairs else 16)
    return -(-table // 128) * 128 + -(-keys // 128) * 128 + 16 * 8 * 32 * 2


def check_plane(name: str, s1: int, s2: int, h: int, bf16_pairs: bool) -> None:
    """Raises where the table plane does not fit a block's shared memory."""
    need = plane_smem(s1, s2, h, bf16_pairs)
    if need > SMEM_MAX:
        raise ValueError(f"{name}: a {s1}x{s2} table needs {need} bytes of shared memory, "
                         f"over {SMEM_MAX}")


def per_image(table: torch.Tensor, bg: int) -> torch.Tensor:
    """The (G, ...) table for each of the BG = B * G image groups, group
    b % G for row b: a broadcast, whose backward is a sum over the images
    in a fixed order (an index gather's backward accumulates in an order
    that varies from run to run, on the CPU too)."""
    g = table.shape[0]
    return table[None].expand(bg // g, *table.shape).reshape(bg, *table.shape[1:])


def rpe_bias_f32(pos, table, h, w, order):
    """The bias in f32 by separable hat-weight products, with the output
    axes in ``order`` over (b, e, m, h, w) = (BG, hg, M, h, w)."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    dev = pos.device
    ay = (s1 - 1.0) / (2.0 * (h - 1.0))
    ax = (s2 - 1.0) / (2.0 * (w - 1.0))
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa: E731
    pos = pos.float()
    by = (0.5 - 0.5 * pos[..., 0]) * 0.5 * (s1 - 1.0)  # (BG, M)
    bx = (0.5 - 0.5 * pos[..., 1]) * 0.5 * (s2 - 1.0)
    iy = ay * ar(h)[None, None, :] + by[..., None]  # (BG, M, h)
    ix = ax * ar(w)[None, None, :] + bx[..., None]  # (BG, M, w)
    wy = torch.clamp(1.0 - (iy[..., None] - ar(s1)).abs(), min=0.0)  # (BG,M,h,S1)
    wx = torch.clamp(1.0 - (ix[..., None] - ar(s2)).abs(), min=0.0)  # (BG,M,w,S2)
    tb = per_image(table.float(), bg)  # (BG, hg, S1, S2)
    u = torch.einsum("best,bmwt->bmesw", tb, wx)
    return torch.einsum(f"bmhs,bmesw->{order}", wy, u)


def hat_slopes(s1, s2, h, w):
    """(ay, ax): the sample index's step per query row and column, in f32
    as the TPU kernels take them (a Python double rounded once)."""
    return (float(torch.tensor((s1 - 1.0) / (2.0 * (h - 1.0)), dtype=torch.float32)),
            float(torch.tensor((s2 - 1.0) / (2.0 * (w - 1.0)), dtype=torch.float32)))


@functools.lru_cache(maxsize=None)
def slopes(s1, s2, h, w):
    """``hat_slopes`` once for each shape: its two small tensors cost host
    time at every launch, as much as a bias kernel takes at level 3."""
    return hat_slopes(s1, s2, h, w)


def searching_coordinates(size, slope, n_query, want):
    """Up to ``want`` position coordinates in [-1, 1] at which the CUDA
    kernels of K3 and K6 search the four taps of an axis (table extent
    ``size``, hat slope ``slope``, ``n_query`` query rows or columns) for
    some query index i: the index (slope * i + b) rounded, just below an
    integer N, rounds up to it, and the first tap's distance in the f32
    order (slope * i - (N - 1)) + b comes out under 1, so that its bf16
    weight is not 0.  Found by a scan in f32 around b = N - slope * i, as
    the kernels compute b = ((0.5 - 0.5 p) * 0.5) * (size - 1) from p.  The
    tests and chip_smoke.py feed them to the kernels to reach that path."""
    f = np.float32
    found = []
    for i in range(1, n_query):
        ai = f(slope) * f(i)
        for big in range(int(ai) + 1, int(ai) + size - 1):
            p0 = f(1.0 - 4.0 * (big - float(ai)) / (size - 1))
            p = (p0.view(np.int32) + np.arange(-4096, 4097, dtype=np.int32)).view(f)
            p = p[(p >= -1) & (p <= 1)]
            b = ((f(0.5) - f(0.5) * p) * f(0.5)) * f(size - 1)
            xf = np.floor(ai + b)
            d0 = (ai - (xf - f(1.0))) + b
            d3 = (ai - (xf + f(2.0))) + b
            found.extend(p[(np.abs(d0) < 1) | (np.abs(d3) < 1)][:1].tolist())
            if len(found) >= want:
                return np.array(found, np.float32)
    return np.array(found, np.float32)


def rpe_bias_bf16(pos, table, h, w, order):
    """The bias with the TPU kernels' bf16 rounding points, before its final
    rounding: the hat weights max(0, 1 - |(ay*r - s) + by|) in that f32
    order, rounded to bf16; the table rounded to bf16; u[s] = sum_t wx T[s,t]
    summed in f32 and rounded to bf16; sum_s wy u[s] in f32.  Output axes in
    ``order`` over (b, e, m, h, w) = (BG, hg, M, h, w)."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    dev, f32, bf16 = pos.device, torch.float32, torch.bfloat16
    ay, ax = (torch.tensor(a, dtype=f32, device=dev) for a in hat_slopes(s1, s2, h, w))
    ar = lambda n: torch.arange(n, dtype=f32, device=dev)  # noqa: E731
    pos = pos.float()
    by = (0.5 - 0.5 * pos[..., 0]) * 0.5 * (s1 - 1.0)  # (BG, M)
    bx = (0.5 - 0.5 * pos[..., 1]) * 0.5 * (s2 - 1.0)
    base_y = ay * ar(h)[:, None] - ar(s1)  # (h, S1)
    base_x = ax * ar(w)[:, None] - ar(s2)  # (w, S2)
    wy = torch.clamp(1.0 - (base_y + by[..., None, None]).abs(), min=0.0)  # (BG,M,h,S1)
    wx = torch.clamp(1.0 - (base_x + bx[..., None, None]).abs(), min=0.0)  # (BG,M,w,S2)
    wy, wx = wy.to(bf16).float(), wx.to(bf16).float()
    tb = table.to(bf16).float()[torch.arange(bg, device=dev) % g]  # (BG, hg, S1, S2)
    # bf16 x bf16 products are exact in f32; the sums round once each
    u = torch.einsum("best,bmwt->bmesw", tb, wx).to(bf16).float()
    return torch.einsum(f"bmhs,bmesw->{order}", wy, u)


def rpe_bias_rows_reference(pos, table, h, w, out_dtype):
    """Plain PyTorch version: the TPU kernel's bf16 rounding points when it
    stores bf16, else the hat-weight products in f32."""
    build = rpe_bias_bf16 if out_dtype == torch.bfloat16 else rpe_bias_f32
    return build(pos, table, h, w, "behmw").to(out_dtype)  # (BG, hg, h, M, w)


class RpeBias(torch.autograd.Function):
    """A bias kernel's forward (K3 or K6, or its plain version) with the
    backward taken through ``rpe_bias_f32`` in the layout ``order``."""

    @staticmethod
    def forward(ctx, pos, table, h, w, out_dtype, order, build):
        ctx.save_for_backward(pos, table)
        ctx.static = (h, w, out_dtype, order)
        return build(pos, table, h, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        h, w, out_dtype, order = ctx.static
        wanted = [i for i in (0, 1) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(ctx.saved_tensors)]
            out = rpe_bias_f32(*leaves, h, w, order).to(out_dtype)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g.reshape(out.shape))
        grads = [None, None]
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None, None, None, None)


def _rows_forward(pos, table, h, w, out_dtype):
    pos, table = pos.contiguous(), table.contiguous()
    if pos.device.type == "cpu":
        return rpe_bias_rows_reference(pos, table, h, w, out_dtype)
    check_cuda("rpe_bias_rows", pos, table, dtype=torch.float32)
    if out_dtype != torch.bfloat16:
        raise ValueError("rpe_bias_rows: the CUDA kernel stores bf16")
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    check_plane("rpe_bias_rows", s1, s2, h, bf16_pairs=True)
    out = torch.empty((bg, hg, h, m, w), dtype=out_dtype, device=pos.device)
    KERNEL.call(ptr(pos), ptr(table), ptr(out), bg, g, hg, h, m, w, s1, s2,
                *slopes(s1, s2, h, w))
    return out


def rpe_bias_rows(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Returns the bias (BG, hg, h, M, w) in ``out_dtype``."""
    if h < 2 or w < 2:
        raise ValueError(f"rpe_bias_rows: query plane {h}x{w} needs h, w >= 2")
    return with_grad(pos, table, h, w, out_dtype, "behmw", _rows_forward)


def with_grad(pos, table, h, w, out_dtype, order, build):
    """``build``'s bias, recorded through ``RpeBias`` only where a gradient
    is wanted: the Function's bookkeeping costs host time at every launch."""
    pos, table = pos.float(), table.float()
    if torch.is_grad_enabled() and (pos.requires_grad or table.requires_grad):
        return RpeBias.apply(pos, table, h, w, out_dtype, order, build)
    return build(pos, table, h, w, out_dtype)  # no graph to record


def rpe_bias_xla(
    pos: torch.Tensor,    # (BG, M, 2) f32, (y, x) in [-1, 1]
    table: torch.Tensor,  # (G, hg, S1, S2) f32
    h: int,
    w: int,
    store: torch.dtype,
) -> torch.Tensor:
    """The bias (BG, hg, M, h*w) as the reference's einsum branch builds it
    (ir_ads_tpu/models/backbones/swin.py ``rpe_bias``): the sample index
    from the query grid ``qy`` and the key position in the reference's own
    expression and order (f32 is ill-conditioned there: the index reaches
    S1 - 1), the hat weights ``wy``, ``wx`` and the table cast to ``store``,
    the contraction over S2 summed in f32 and rounded to ``store`` (``u``),
    the one over S1 likewise.  Differentiable by autograd, as the
    reference's is by autodiff."""
    bg, m, _ = pos.shape
    g, hg, s1, s2 = table.shape
    dev = pos.device
    f32 = torch.float32
    qy = torch.arange(h, dtype=f32, device=dev) / max(h - 1, 1) * 2.0 - 1.0
    qx = torch.arange(w, dtype=f32, device=dev) / max(w - 1, 1) * 2.0 - 1.0
    pf = pos.float()
    iy = (0.5 * (qy[None, None, :] - pf[:, :, 0:1]) + 1.0) * 0.5 * (s1 - 1)  # (BG, M, h)
    ix = (0.5 * (qx[None, None, :] - pf[:, :, 1:2]) + 1.0) * 0.5 * (s2 - 1)  # (BG, M, w)
    wy = torch.clamp(1.0 - (iy[..., None] - torch.arange(s1, dtype=f32, device=dev)).abs(),
                     min=0.0).to(store)  # (BG, M, h, S1)
    wx = torch.clamp(1.0 - (ix[..., None] - torch.arange(s2, dtype=f32, device=dev)).abs(),
                     min=0.0).to(store)  # (BG, M, w, S2)
    tb = per_image(table.to(store), bg)  # (BG, hg, S1, S2)
    # products of store-dtype operands, summed in f32 and rounded once: a
    # bf16 product on the card and on the CPU accumulates in f32
    u = torch.einsum("best,bmwt->bmwse", tb, wx)  # (BG, M, w, S1, hg)
    bias = torch.einsum("bmhs,bmwse->bemhw", wy, u)  # (BG, hg, M, h, w)
    return bias.reshape(bg, hg, m, h * w)
