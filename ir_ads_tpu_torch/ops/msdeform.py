"""K9: multi-scale deformable attention sampling (the DINO encoder's
self-attention and decoder's cross-attention core): per (query, head), the
bilinear samples of the value maps at L * P locations, weighted by the
attention weights and summed.

Replaces ir_ads_tpu/ops/pallas_msdeform.py:_gather_kernel (launched by
``_pallas_forward``, entry ``ms_deform_attn_pallas``).  The CUDA source is
csrc/msdeform.cu, whose header states the bound and the design.

``ms_deform_attn`` launches the kernel for CUDA tensors and runs
``ms_deform_attn_plain`` only for CPU tensors.  The plain version is the TPU
kernel's arithmetic written with tensor ops: the corner tables of
``_corner_tables`` (grid_sample ``align_corners=False`` with zeros padding:
pixel coordinate ``loc * size - 0.5``, an out-of-bounds corner has weight 0
and a clamped index), an index gather, and the weighted sum.  Rounding
points, both versions: locations and attention weights in f32, corner weight
x attention weight one f32 product, the gathered value cast to f32, all
L * P * 4 slots summed in f32, one rounding to the value dtype.  (The JAX
package's CPU default, ``ms_deform_attn_xla``, samples per level in the value
dtype and then weights: the same function in f32, not in bf16.)

Under autograd (an input requires a gradient and grad mode is on) the
wrapper goes through ``MSDeformAttnFunction``: the same forward, and as
backward K9's backward kernel (``ops.msdeform_bwd``, csrc/msdeform_bwd.cu),
which also runs its plain version only for CPU tensors.  Without a gradient
the wrapper calls the forward directly, bits as before.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ir_ads_tpu_torch.ops.cuda_lib import INT, VOIDP, CudaKernel, ptr

KERNEL = CudaKernel(
    "msdeform", "msdeform_attn",
    [VOIDP] * 4 + [ctypes.POINTER(INT)] + [INT] * 8,
    replaces="ir_ads_tpu/ops/pallas_msdeform.py:118",
)

Shapes = Sequence[Tuple[int, int]]


def corner_terms(h: int, w: int, loc: torch.Tensor):
    """One level's corners for locations ``loc`` (..., 2) f32 in [0, 1]
    (pixel coordinate ``loc * size - 0.5``, align_corners=False): a list of
    four (flat index into the level, clamped; inside the level; bilinear
    weight), then the fractions (fx, fy)."""
    gx = loc[..., 0] * w - 0.5  # align_corners=False
    gy = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    x0i, y0i = x0.long(), y0.long()
    corners = []
    for dy, dx, cw in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                       (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0i + dx, y0i + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        corners.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), valid, cw))
    return corners, fx, fy


def corner_tables(spatial_shapes: Shapes, locations: torch.Tensor,
                  weights: torch.Tensor):
    """Per level, the flat corner indices into the level-concatenated value
    stack and the combined weights (bilinear corner weight x attention
    weight, 0 for a corner outside its level): two lists of L tensors
    (B, Lq, H, P, 4), int64 and f32."""
    loc = locations.float()
    att = weights.float()
    idx, wgt = [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        a = att[:, :, :, lvl]  # (B, Lq, H, P)
        corners = corner_terms(h, w, loc[:, :, :, lvl])[0]
        idx.append(torch.stack([start + i for i, _, _ in corners], -1))
        wgt.append(torch.stack([torch.where(v, cw, torch.zeros_like(cw)) * a
                                for _, v, cw in corners], -1))
        start += h * w
    return idx, wgt


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Shapes,
                         locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version; shapes as ``ms_deform_attn``.  The gather runs
    level by level to bound its memory; the sum over all slots stays f32."""
    b, s, heads, d = value.shape
    lq = locations.shape[1]
    idx, wgt = corner_tables(spatial_shapes, locations, weights)
    rows = value.permute(0, 2, 1, 3).reshape(b * heads * s, d)
    base = (torch.arange(b, device=value.device)[:, None] * heads
            + torch.arange(heads, device=value.device)[None, :]) * s  # (B, H)
    acc = torch.zeros((b, lq, heads, d), dtype=torch.float32, device=value.device)
    for i, w in zip(idx, wgt):
        flat = (i + base[:, None, :, None, None]).reshape(-1)
        g = rows.index_select(0, flat).reshape(b, lq, heads, -1, d).float()
        acc += (g * w.reshape(b, lq, heads, -1, 1)).sum(dim=3)
    return acc.to(value.dtype).reshape(b, lq, heads * d)


def fma_f32(v: torch.Tensor, w: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """fmaf(v, w, acc) for f32 tensors (finite, no overflow): one rounding of
    v * w + acc to f32, by f64 rounded to odd (the product of a bf16 or f32
    value and an f32 weight is exact in f64; TwoSum's error decides the last
    bit)."""
    a, p = acc.double(), v.double() * w.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)  # s + err == a + p exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def ordered_sums(value: torch.Tensor, spatial_shapes: Shapes, locations: torch.Tensor,
                 weights: torch.Tensor, skip_zero: bool = False) -> torch.Tensor:
    """The plain version in the kernel's order of work (csrc/msdeform.cu):
    per channel one f32 chain of fused multiply-adds from +0, sample-major
    (level, point), then corner, every corner added.  Returns the f32 sums
    (B, Lq, H, D), the kernel's bits on finite inputs.  ``skip_zero``: the
    first design's chain, which took no corner of weight 0."""
    b, s, heads, d = value.shape
    lq = locations.shape[1]
    idx, wgt = corner_tables(spatial_shapes, locations, weights)
    idx = torch.stack(idx, 3).reshape(b, lq, heads, -1, 4)  # sample-major
    wgt = torch.stack(wgt, 3).reshape(b, lq, heads, -1, 4)
    rows = value.float().permute(0, 2, 1, 3)  # (B, H, S, D)
    bi = torch.arange(b, device=value.device)[:, None, None]
    hi = torch.arange(heads, device=value.device)[None, None, :]
    acc = torch.zeros(b, lq, heads, d, device=value.device)
    for smp in range(idx.shape[3]):
        for k in range(4):
            v = rows[bi, hi, idx[:, :, :, smp, k]]  # (B, Lq, H, D)
            w = wgt[:, :, :, smp, k, None]
            nxt = fma_f32(v, w.expand_as(v), acc)
            acc = torch.where(w != 0, nxt, acc) if skip_zero else nxt
    return acc


def ms_deform_attn_ordered(value: torch.Tensor, spatial_shapes: Shapes,
                           locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``ordered_sums`` rounded once to the value dtype, (B, Lq, heads * D):
    the plain version with the kernel's bits, where ``ms_deform_attn_plain``
    sums in another order (one bf16 ulp apart on some outputs)."""
    b, lq = locations.shape[:2]
    return ordered_sums(value, spatial_shapes, locations, weights).to(value.dtype).reshape(
        b, lq, -1)


class MSDeformAttnFunction(torch.autograd.Function):
    """K9 under autograd: the forward kernel, and K9's backward kernel for
    the gradients (each its plain version for CPU tensors)."""

    @staticmethod
    def forward(ctx, value, locations, weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locations, weights)
        return _forward(value, spatial_shapes, locations, weights)

    @staticmethod
    def backward(ctx, grad_out):
        from ir_ads_tpu_torch.ops import msdeform_bwd

        value, locations, weights = ctx.saved_tensors
        dvalue, dloc, datt = msdeform_bwd.ms_deform_attn_bwd(value, ctx.spatial_shapes,
                                                             locations, weights, grad_out)
        need = ctx.needs_input_grad
        return (dvalue if need[0] else None, dloc if need[1] else None,
                datt if need[2] else None, None)


def ms_deform_attn(
    value: torch.Tensor,      # (B, sum(h*w), heads, D) bf16 or f32
    spatial_shapes: Shapes,   # static [(h, w), ...]
    locations: torch.Tensor,  # (B, Lq, heads, L, P, 2) in [0, 1]
    weights: torch.Tensor,    # (B, Lq, heads, L, P), the value dtype
) -> torch.Tensor:
    """Returns (B, Lq, heads * D) in the value dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, locations, weights)):
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        return MSDeformAttnFunction.apply(value, locations, weights, shapes)
    return _forward(value, spatial_shapes, locations, weights)


def _forward(value, spatial_shapes, locations, weights) -> torch.Tensor:
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, locations, weights)
    b, s, heads, d = value.shape
    _, lq, _, n_levels, n_points, _ = locations.shape
    if value.dtype not in (torch.bfloat16, torch.float32) or weights.dtype != value.dtype:
        raise ValueError(f"ms_deform_attn: value {value.dtype} and weights "
                         f"{weights.dtype} must both be bf16 or both f32")
    if d > 32 or d % 2 or n_levels > 8 or n_levels != len(spatial_shapes):
        raise ValueError(f"ms_deform_attn: the CUDA kernel takes an even head_dim <= 32 "
                         f"and at most 8 levels, got {d} and {n_levels}")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError("ms_deform_attn: spatial_shapes do not add up to the value length")
    if weights.shape != (b, lq, heads, n_levels, n_points) or not weights.is_cuda \
            or not locations.is_cuda:
        raise ValueError("ms_deform_attn: weights / locations shape or device mismatch")
    # the kernel reads channel pairs and locations as 4- and 8-byte words
    value, weights, locations = (
        t if t.is_contiguous() and t.data_ptr() % 8 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (value, weights, locations.float()))
    out = torch.empty((b, lq, heads * d), dtype=value.dtype, device=value.device)
    shapes = (INT * (2 * n_levels))(*[int(v) for hw in spatial_shapes for v in hw])
    KERNEL.call(ptr(value), ptr(locations), ptr(weights), ptr(out), shapes,
                b, s, lq, heads, d, n_levels, n_points,
                int(value.dtype == torch.bfloat16))
    return out
