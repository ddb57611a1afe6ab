"""K19: the flat-input patch embedding, patchify + projection + LayerNorm in
one pass, (B, H, W*c) -> (B, H/p, W/p, E).

Replaces ir_ads_tpu/ops/pallas_patch.py:_patch_kernel (launched by
``pallas_patch_embed``; twin ``_xla_twin``), which ``PatchEmbed`` runs on
flat input under ``IR_ADS_PATCH_EMBED=pallas``.  The CUDA source is
csrc/patch_embed.cu; its header states the bound and the design.

The kernel is not its twin in bf16: ``pallas_patch_embed`` rounds the
projection bias and the LayerNorm scale and bias to the compute dtype
(``vec``), where the twin and the XLA path keep the LayerNorm's in f32.  The
port follows the kernel.  Its rounding points: the product summed in f32
and rounded, plus the rounded bias and rounded again, the LayerNorm
statistics in f32, times the rounded scale plus the rounded bias in f32,
one rounding at the end.

``patch_embed`` launches the kernel for CUDA tensors and runs
``patch_embed_reference``, the plain version, only for CPU tensors.  It is
differentiable: its backward is the vjp of the twin's form
(``patch_embed_reference(..., round_ln=False)``, f32 LayerNorm
parameters), as the JAX package's
``_fpe_bwd`` takes ``jax.vjp`` of ``_xla_twin``.
"""

from __future__ import annotations

import torch

from ir_ads_tpu_torch.ops.cuda_lib import (
    FLOAT, INT, VOIDP, CudaKernel, check_cuda, ptr, up,
)

KERNEL = CudaKernel(
    "patch_embed", "patch_embed", [VOIDP] * 6 + [INT] * 3 + [FLOAT],
    replaces="ir_ads_tpu/ops/pallas_patch.py:30",
)
PATCH, CHANNELS, EMBED = 4, 3, 128  # the kernel's domain: Swin-B's patch embedding


def patchify_flat(x: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """(B, H, W*c) flat rows -> (B, H/p, W/p, p*p*c) patches in slice order
    (p_row, x_in_patch, c): the order of the conv kernel reshaped from its
    (E, c, p, p) layout as (E, p, p, c), so the same weight serves both."""
    b, h, wc = x.shape
    w = wc // c
    return (x.reshape(b, h // p, p, w // p, p * c).permute(0, 1, 3, 2, 4)
            .reshape(b, h // p, w // p, p * p * c))


def patch_embed_reference(x, wk2, bias, ln_w, ln_b, p, c, eps=1e-5, round_ln=True):
    """Plain PyTorch version, with the Pallas kernel's rounding points:
    every parameter rounded to x's dtype, the LayerNorm's included.  With
    ``round_ln=False`` it is the twin's form (``_xla_twin``), whose
    LayerNorm scale and bias stay f32: what the backward differentiates."""
    cdt = x.dtype
    if round_ln:
        ln_w, ln_b = ln_w.to(cdt), ln_b.to(cdt)
    y = (up(patchify_flat(x, p, c)) @ up(wk2.to(cdt))).to(cdt)
    y = up((up(y) + up(bias.to(cdt))).to(cdt))
    yc = y - y.mean(dim=-1, keepdim=True)
    yn = yc * torch.rsqrt((yc * yc).mean(dim=-1, keepdim=True) + eps)
    return (yn * up(ln_w) + up(ln_b)).to(cdt)


def _forward(x, wk2, bias, ln_w, ln_b, p, c, eps):
    b, h, wc = x.shape
    e = wk2.shape[1]
    if h % p or wc % (p * c) or wk2.shape[0] != p * p * c:
        raise ValueError(f"patch_embed: input {tuple(x.shape)} is not whole {p}x{p} "
                         f"patches of {c} channels, or weight {tuple(wk2.shape)}")
    if x.device.type == "cpu":
        return patch_embed_reference(x, wk2, bias, ln_w, ln_b, p, c, eps)
    cdt = x.dtype
    # the kernel copies each pixel's patch rows in 8-byte pieces
    if not x.is_contiguous() or x.data_ptr() % 8:
        x = x.clone(memory_format=torch.contiguous_format)
    # the LayerNorm's parameters go in f32, as the module holds them: the
    # kernel rounds them to bf16 as it stages them
    wk2, bias = (t.to(cdt).contiguous() for t in (wk2, bias))
    ln_w, ln_b = (t.float().contiguous() for t in (ln_w, ln_b))
    check_cuda("patch_embed", x, wk2, bias)
    check_cuda("patch_embed", ln_w, ln_b, dtype=torch.float32)
    if (p, c, e) != (PATCH, CHANNELS, EMBED):
        raise ValueError(f"patch_embed: the kernel takes p={PATCH}, c={CHANNELS}, "
                         f"E={EMBED}, not p={p}, c={c}, E={e}")
    out = torch.empty((b, h // p, wc // (p * c), e), dtype=cdt, device=x.device)
    KERNEL.call(ptr(x), ptr(wk2), ptr(bias), ptr(ln_w), ptr(ln_b), ptr(out),
                b, h, wc // c, float(eps))
    return out


class _PatchEmbed(torch.autograd.Function):
    """K19 forward; backward the vjp of the twin's form (recomputed)."""

    @staticmethod
    def forward(ctx, x, wk2, bias, ln_w, ln_b, p, c, eps):
        ctx.save_for_backward(x, wk2, bias, ln_w, ln_b)
        ctx.static = (p, c, eps)
        return _forward(x, wk2, bias, ln_w, ln_b, p, c, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = patch_embed_reference(*leaves, *ctx.static, round_ln=False)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        grads = [None] * 5
        for i, gi in zip(wanted, got):
            grads[i] = gi
        return (*grads, None, None, None)


def patch_embed(
    x: torch.Tensor,      # (B, H, W*c) flat rows, H and W multiples of p
    wk2: torch.Tensor,    # (p*p*c, E): the conv kernel as (E, p, p, c), transposed
    bias: torch.Tensor,   # (E,)
    ln_w: torch.Tensor,   # (E,) LayerNorm scale
    ln_b: torch.Tensor,   # (E,) LayerNorm bias
    p: int,
    c: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Returns (B, H/p, W/p, E) in x's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wk2, bias, ln_w, ln_b)):
        return _PatchEmbed.apply(x, wk2, bias, ln_w, ln_b, p, c, eps)
    return _forward(x, wk2, bias, ln_w, ln_b, p, c, eps)
