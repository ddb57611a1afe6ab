"""K9's backward: the gradients of multi-scale deformable attention sampling
(``ops.msdeform``) with respect to the value stack, the locations and the
attention weights.

The JAX package's K9 (ir_ads_tpu/ops/pallas_msdeform.py) differentiates
through ``_bwd``, ``jax.vjp`` of ``ms_deform_attn_xla``: XLA gathers and
scatter-adds, no Pallas kernel.  The port's backward is a kernel of its own,
csrc/msdeform_bwd.cu (the gather-transpose of the reference's CUDA op);
its header states the formula, the design and the bound.

``ms_deform_attn_bwd`` launches the kernel for CUDA tensors and runs
``ms_deform_attn_bwd_plain`` only for CPU tensors.  The plain version is the
explicit formula, not autograd of the forward: per level and corner, the
forward's corners (``ops.msdeform.corner_terms``), the gathered value rows' dot
products with the cotangent, and one ``index_add_`` of the weighted
cotangent into an f32 dvalue.  Rounding points, both versions: everything
in f32, dvalue rounded once to the value dtype, dweights once to the
weights' dtype, dlocations f32.  A corner outside its level contributes
nothing to any of the three gradients (its index is clamped, its value
term masked), as JAX's zeros padding reads no value there.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ir_ads_tpu_torch.ops.cuda_lib import INT, VOIDP, CudaKernel, ptr
from ir_ads_tpu_torch.ops.msdeform import corner_terms

KERNEL = CudaKernel(
    "msdeform_bwd", "msdeform_attn_bwd",
    [VOIDP] * 7 + [ctypes.POINTER(INT)] + [INT] * 8,
    replaces="ir_ads_tpu/ops/pallas_msdeform.py:240",
)

Shapes = Sequence[Tuple[int, int]]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def corner_derivatives(fx: torch.Tensor, fy: torch.Tensor):
    """The derivatives of the four bilinear corner weights of
    ``ops.msdeform.corner_terms`` by fx and by fy."""
    return (-(1 - fy), 1 - fy, -fy, fy), (-(1 - fx), -fx, 1 - fx, fx)


def ms_deform_attn_bwd_plain(value: torch.Tensor, spatial_shapes: Shapes,
                             locations: torch.Tensor, weights: torch.Tensor,
                             grad_out: torch.Tensor) -> Grads:
    """Plain PyTorch version; shapes as ``ms_deform_attn_bwd``."""
    b, s, heads, d = value.shape
    lq, n_levels, n_points = locations.shape[1], locations.shape[3], locations.shape[4]
    g = grad_out.reshape(b, lq, heads, 1, d).float()
    loc, att = locations.float(), weights.float()
    rows = value.permute(0, 2, 1, 3).reshape(b * heads * s, d)
    base = ((torch.arange(b, device=value.device)[:, None] * heads
             + torch.arange(heads, device=value.device)[None, :]) * s)[:, None, :, None]
    dvalue = torch.zeros((b * heads * s, d), dtype=torch.float32, device=value.device)
    dloc = torch.zeros((b, lq, heads, n_levels, n_points, 2), dtype=torch.float32,
                       device=value.device)
    datt = torch.zeros((b, lq, heads, n_levels, n_points), dtype=torch.float32,
                       device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        a = att[:, :, :, lvl]  # (B, Lq, H, P)
        tx = ty = da = 0.0
        corners, fx, fy = corner_terms(h, w, loc[:, :, :, lvl])
        for (idx, valid, cw), ddx, ddy in zip(corners, *corner_derivatives(fx, fy)):
            flat = (idx + start + base).reshape(-1)
            v = rows.index_select(0, flat).reshape(b, lq, heads, n_points, d).float()
            dot = torch.where(valid, (v * g).sum(-1), torch.zeros_like(a))
            da = da + cw * dot
            tx = tx + ddx * dot
            ty = ty + ddy * dot
            wgt = torch.where(valid, cw, torch.zeros_like(cw)) * a
            dvalue.index_add_(0, flat, (wgt[..., None] * g).reshape(-1, d))
        dloc[:, :, :, lvl, :, 0] = tx * (a * w)
        dloc[:, :, :, lvl, :, 1] = ty * (a * h)
        datt[:, :, :, lvl] = da
        start += h * w
    dvalue = dvalue.reshape(b, heads, s, d).permute(0, 2, 1, 3).to(value.dtype)
    return dvalue, dloc.to(locations.dtype), datt.to(weights.dtype)


def ms_deform_attn_bwd(
    value: torch.Tensor,      # (B, sum(h*w), heads, D) bf16 or f32
    spatial_shapes: Shapes,   # static [(h, w), ...]
    locations: torch.Tensor,  # (B, Lq, heads, L, P, 2) f32
    weights: torch.Tensor,    # (B, Lq, heads, L, P), the value dtype
    grad_out: torch.Tensor,   # (B, Lq, heads * D), the value dtype
) -> Grads:
    """Returns (dvalue like value, dlocations like locations, dweights like
    weights)."""
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_plain(value, spatial_shapes, locations, weights, grad_out)
    b, s, heads, d = value.shape
    _, lq, _, n_levels, n_points, _ = locations.shape
    if value.dtype not in (torch.bfloat16, torch.float32) or weights.dtype != value.dtype:
        raise ValueError(f"ms_deform_attn_bwd: value {value.dtype} and weights "
                         f"{weights.dtype} must both be bf16 or both f32")
    if d > 32 or d % 2 or n_levels > 8 or n_levels != len(spatial_shapes):
        raise ValueError(f"ms_deform_attn_bwd: the CUDA kernel takes an even head_dim <= 32 "
                         f"and at most 8 levels, got {d} and {n_levels}")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError("ms_deform_attn_bwd: spatial_shapes do not add up to the value "
                         "length")
    if (weights.shape != (b, lq, heads, n_levels, n_points)
            or grad_out.shape != (b, lq, heads * d)
            or not all(t.is_cuda for t in (weights, locations, grad_out))):
        raise ValueError("ms_deform_attn_bwd: weights / locations / grad_out shape or "
                         "device mismatch")
    # the kernel reads channel pairs and locations as 4- and 8-byte words
    value, weights, loc, gout = (
        t if t.is_contiguous() and t.data_ptr() % 8 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (value, weights, locations.float(), grad_out.to(value.dtype)))
    dvalue = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    dloc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    datt = torch.empty(weights.shape, dtype=weights.dtype, device=value.device)
    shapes = (INT * (2 * n_levels))(*[int(v) for hw in spatial_shapes for v in hw])
    KERNEL.call(ptr(value), ptr(loc), ptr(weights), ptr(gout), ptr(dvalue), ptr(dloc),
                ptr(datt), shapes, b, s, lq, heads, d, n_levels, n_points,
                int(value.dtype == torch.bfloat16))
    return dvalue.to(value.dtype), dloc.to(locations.dtype), datt
