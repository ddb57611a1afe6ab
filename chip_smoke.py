#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--batch 2]

Phases, each of which raises on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the slice from csrc/ (one nvcc per source,
     all started together) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the main path gives it, element by element and on
     what the kernel adds (the branch, for the residual kernels); show that
     a planted fault in the plain version fails the same bar; print the
     errors against the stated tolerances and the kernel's, the plain
     version's and (where one PyTorch call computes the same function) the
     library call's times;
  4. serve a few requests of 480x640 RGB-D frames through
     ``SemSegPredictor`` (full-width, full-depth Swin-B CMNeXt, 40 classes,
     bf16, flip, weights drawn from --seed) under its default ``r5``
     dispatch (K1 + K2 at stages 0-1, K5 at stages 2-3, K3 + K4 at DSCF
     levels 0-2, K6 and the einsum attention at level 3): check shapes,
     finiteness, that every kernel ran on the main path as often as the
     dispatch says, and that one request's logits match the same model run
     with the plain versions on the card, while the plain path with a
     planted fault in K1 or in K5 does not; then, for the record, the same
     requests' latency under the ``r4`` dispatch (K1 + K2 and K3 + K4
     everywhere).
The line before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor cores
F32_FLOPS = 67e12              # f32 outside the tensor cores
IMAGE = (480, 640)
NUM_CLASSES = 40


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# --------------------------------------------------------------------------

def _rand(g, *shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
    t = torch.randn(*shape, generator=g, device="cuda") * std + mean
    return t.to(dtype)


def _linear(g, fan_out, fan_in):
    """A weight ~ N(0, 1/fan_in): the layer's output is as large as its
    input, so a residual kernel's branch is as large as x."""
    return _rand(g, fan_out, fan_in, std=fan_in ** -0.5)


# Each case holds a kernel against its plain version twice:
#   * element by element on the output, |got - want| <= atol + rtol |want|;
#   * on what the kernel adds, in f32: for the residual kernels (K1, K2)
#     the branch out - x, else the output itself,
#     rel = ||got - want|| / ||want - x|| <= REL_TOL.
# The second bar sees the branch whatever the size of x.  A planted fault
# (the plain version with one piece of the function left out) must fail it,
# which shows the bar is tight enough to see that piece.
REL_TOL = 1e-2


def check_window_block(g, b, h_real, w_real, c, heads, shift, fault):
    from ir_ads_tpu_torch.ops import swin_block as k1
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    x = _rand(g, b, hp, wp, c)
    args = [
        _rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05),
        _linear(g, 3 * c, c), _rand(g, 3 * c, std=0.02),
        _linear(g, c, c), _rand(g, c, std=0.02),
        _rand(g, heads, n, n, dtype=torch.float32),
    ]
    region = shift_region_ids_on(hp, wp, ws, shift, x.device) if shift else None
    scale = (c // heads) ** -0.5
    run = lambda: k1.window_block(  # noqa: E731
        x, *args, region, scale, heads, ws, h_real, w_real, shift)
    plain = lambda: k1.window_block_reference(  # noqa: E731
        x, *args, region, scale, heads, ws, h_real, w_real, shift)
    bad_args, bad_region = list(args), region
    if fault == "region mask dropped":
        bad_region = None
    else:  # "rel-pos bias dropped"
        bad_args[6] = torch.zeros_like(args[6])
    faulted = lambda: k1.window_block_reference(  # noqa: E731
        x, *bad_args, bad_region, scale, heads, ws, h_real, w_real, shift)
    t = b * hp * wp
    flops = t * (8 * c * c + 4 * n * c)
    io = nbytes(x, *args, region) + nbytes(x)
    return dict(
        name="swin_block", case=f"stage C={c} map {hp}x{wp} shift {shift}",
        # kernel and plain version round to bf16 at the same points; their f32
        # sums run in another order, so a rounding can flip by one bf16 ulp
        # (2^-7 relative) inside (qkv, probabilities) and on the output
        run=run, plain=plain, faulted=faulted, fault=fault, base=x,
        library=None, atol=3e-2, rtol=2e-2,
        bytes=io, flops=flops, rate=BF16_TENSOR_FLOPS,
    )


def check_window_block_v6(g, b, h, w, c, heads, shift, fault, streams=1):
    from ir_ads_tpu_torch.ops import swin_block_v6 as k5
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    hid, ca = 4 * c, c // 16
    lead = (streams,) if streams > 1 else ()
    x = _rand(g, b, h, w, c)
    attn = (
        _rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05),
        _linear(g, 3 * c, c), _rand(g, 3 * c, std=0.02),
        _linear(g, c, c), _rand(g, c, std=0.02),
        _rand(g, heads, n, n, dtype=torch.float32),
    )
    tail = (
        _rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05),
        _linear(g, hid, c), _rand(g, hid, std=0.02),
        _linear(g, c, hid), _rand(g, c, std=0.02),
        _rand(g, *lead, ca, c, std=c ** -0.5), _rand(g, *lead, ca, std=0.02),
        _rand(g, *lead, c, ca, std=ca ** -0.5), _rand(g, *lead, c, std=0.02),
    )
    region = shift_region_ids_on(hp, wp, ws, shift, x.device) if shift else None
    scale = (c // heads) ** -0.5
    run = lambda: k5.window_block_v6(  # noqa: E731
        x, attn, tail, region, scale, heads, ws, shift)
    plain = lambda: k5.window_block_v6_reference(  # noqa: E731
        x, attn, tail, region, scale, heads, ws, shift)
    bad_tail, bad_shift, bad_scale = tail, shift, 0.5
    if fault == "roll left out, mask kept":
        bad_shift = 0
    elif fault == "adapter dropped":
        bad_scale = 0.0
    else:  # "streams swapped"
        bad_tail = tail[:6] + tuple(t.flip(0) for t in tail[6:])
    faulted = lambda: k5.window_block_v6_reference(  # noqa: E731
        x, attn, bad_tail, region, scale, heads, ws, bad_shift,
        adapter_scale=bad_scale)
    t = b * h * w  # qkv, proj, FFN and adapter of the real tokens; each
    flops = t * (24 * c * c + 4 * c * ca + 4 * n * c)  # real query sees N keys
    return dict(
        name="swin_block_v6",
        case=f"C={c} map {h}x{w} shift {shift}" + (f" S={streams}" if streams > 1 else ""),
        run=run, plain=plain, faulted=faulted, fault=fault, base=x,
        # as K1 + K2: the same rounding points (y kept in f32 by both), f32
        # sums of another order -> bf16 flips of an ulp or two
        library=None, atol=3e-2, rtol=2e-2,
        bytes=nbytes(x, *attn, region, *tail) + nbytes(x), flops=flops,
        rate=BF16_TENSOR_FLOPS,
    )


def check_block_tail(g, rows, c):
    from ir_ads_tpu_torch.ops import block_tail as k2

    hid, ca = 4 * c, c // 16
    x = _rand(g, rows, c)
    args = (
        _rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05),
        _linear(g, hid, c), _rand(g, hid, std=0.02),
        _linear(g, c, hid), _rand(g, c, std=0.02),
        _linear(g, ca, c), _rand(g, ca, std=0.02),
        _linear(g, c, ca), _rand(g, c, std=0.02),
    )
    flops = rows * (16 * c * c + 4 * c * ca)
    return dict(
        name="block_tail", case=f"C={c} rows {rows}",
        run=lambda: k2.block_tail(x, *args),
        plain=lambda: k2.block_tail_reference(x, *args),
        faulted=lambda: k2.block_tail_reference(x, *args, adapter_scale=0.0),
        fault="adapter dropped", base=x,
        # as K1: same rounding points (hidden after GELU, adapter after relu),
        # another f32 summation order -> bf16 flips of an ulp or two
        library=None, atol=3e-2, rtol=2e-2,
        bytes=nbytes(x, *args) + nbytes(x), flops=flops,
        rate=BF16_TENSOR_FLOPS,
    )


def _dscf_inputs(g, b, level):
    h, w = 120 >> level, 160 >> level
    groups = 1 << level
    bg, hg, m = b * groups, 2, 600
    pos = (torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1)
    table = _rand(g, groups, hg, 119, 159, std=0.5, dtype=torch.float32)
    return h, w, groups, bg, hg, m, pos, table


def check_rpe(g, b, level):
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    out_elems = bg * hg * h * m * w

    # the library call: the same bilinear samples through F.grid_sample, in
    # its (BG, hg, HW, M) layout (the grid is built outside the timing)
    qy = torch.arange(h, device="cuda") / (h - 1) * 2 - 1
    qx = torch.arange(w, device="cuda") / (w - 1) * 2 - 1
    qg = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1).reshape(1, h * w, 1, 2)
    grid = ((qg - pos[:, None]) * 0.5)[..., (1, 0)].contiguous()
    tb = table[torch.arange(bg, device="cuda") % groups].contiguous()

    def library():
        return F.grid_sample(tb, grid, mode="bilinear", align_corners=True)

    swapped = pos.flip(-1).contiguous()
    return dict(
        name="dscf_rpe", case=f"level {level} plane {h}x{w} BG={bg}",
        run=lambda: k3.rpe_bias_rows(pos, table, h, w, torch.bfloat16),
        plain=lambda: k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16),
        faulted=lambda: k3.rpe_bias_rows_reference(
            swapped, table, h, w, torch.bfloat16),
        fault="key (y, x) read as (x, y)", base=None,
        # rtol: one bf16 rounding of the stored value (2^-7 relative at most).
        # atol: the sample index (up to 158) carries an f32 ulp of ~1.5e-5,
        # and the output moves by up to |T[s+1] - T[s]| (~3 for this table)
        # per unit of index, so two f32 implementations differ by ~5e-5.
        library=library, atol=1e-4, rtol=8e-3,
        bytes=nbytes(pos, table) + out_elems * 2, flops=out_elems * 20,
        rate=F32_FLOPS,
    )


def check_rpe_packed(g, b, level):
    from ir_ads_tpu_torch.ops import dscf_rpe_packed as k6

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    out_elems = bg * hg * m * h * w

    # the library call: F.grid_sample in its own (BG, hg, M, HW) layout
    qy = torch.arange(h, device="cuda") / (h - 1) * 2 - 1
    qx = torch.arange(w, device="cuda") / (w - 1) * 2 - 1
    qg = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1).reshape(1, 1, h * w, 2)
    grid = ((qg - pos[:, :, None]) * 0.5)[..., (1, 0)].contiguous()
    tb = table[torch.arange(bg, device="cuda") % groups].contiguous()

    def library():
        return F.grid_sample(tb, grid, mode="bilinear", align_corners=True)

    swapped = pos.flip(-1).contiguous()
    return dict(
        name="dscf_rpe_packed", case=f"level {level} plane {h}x{w} BG={bg}",
        run=lambda: k6.rpe_bias_packed(pos, table, h, w, torch.bfloat16),
        plain=lambda: k6.rpe_bias_packed_reference(pos, table, h, w, torch.bfloat16),
        faulted=lambda: k6.rpe_bias_packed_reference(
            swapped, table, h, w, torch.bfloat16),
        fault="key (y, x) read as (x, y)", base=None,
        # K3's function and bars (see check_rpe)
        library=library, atol=1e-4, rtol=8e-3,
        bytes=nbytes(pos, table) + out_elems * 2, flops=out_elems * 20,
        rate=F32_FLOPS,
    )


def check_rows(g, b, level):
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    gc = 16
    q = _rand(g, bg, h * w, gc)
    k = _rand(g, bg, m, gc)
    v = _rand(g, bg, m, gc)
    bias = k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16)
    scale = 8 ** -0.5
    qh = q.reshape(bg, h * w, hg, 8).transpose(1, 2)
    kh = k.reshape(bg, m, hg, 8).transpose(1, 2)
    vh = v.reshape(bg, m, hg, 8).transpose(1, 2)
    mask = bias.permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m).contiguous()
    flops = 4 * 8 * bg * hg * h * w * m
    return dict(
        name="dscf_rows", case=f"level {level} plane {h}x{w} BG={bg}",
        run=lambda: k4.dscf_rows_attention(q, k, v, bias, scale, hg),
        plain=lambda: k4.dscf_rows_reference(q, k, v, bias, scale, hg),
        faulted=lambda: k4.dscf_rows_reference(
            q, k, v, torch.zeros_like(bias), scale, hg),
        fault="rpe bias dropped", base=None,
        library=lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale),
        # probabilities rounded to bf16 before P.V in both; the f32 max/sum
        # order differs (online in the kernel), flipping a rounding now and then
        atol=1e-2, rtol=2e-2,
        bytes=nbytes(q, k, v, bias) + nbytes(q), flops=flops,
        rate=BF16_TENSOR_FLOPS,
    )


def _rel(got, want, base):
    """||got - want|| / ||want - base|| in f32 (base None: zero)."""
    ref = want.float() if base is None else want.float() - base.float()
    return float((got.float() - want.float()).norm() / ref.norm())


def phase_kernels(seed: int, images: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the r5 main path: K1 + K2 at stages 0-1, K5 at stages 2-3, K3 + K4 at
    # DSCF levels 0-2, K6 at level 3
    cases = [
        lambda: check_window_block(g, images, 120, 160, 128, 4, 6,
                                   "region mask dropped"),
        lambda: check_window_block(g, images, 60, 80, 256, 8, 6,
                                   "rel-pos bias dropped"),
        lambda: check_block_tail(g, images * 120 * 160, 128),
        lambda: check_block_tail(g, images * 60 * 80, 256),
        lambda: check_window_block_v6(g, images, 30, 40, 512, 16, 6,
                                      "roll left out, mask kept"),
        lambda: check_window_block_v6(g, images, 15, 20, 1024, 32, 6,
                                      "adapter dropped"),
        lambda: check_window_block_v6(g, images, 30, 40, 512, 16, 6,
                                      "streams swapped", streams=2),
        lambda: check_rpe(g, images, 0),
        lambda: check_rpe(g, images, 2),
        lambda: check_rows(g, images, 0),
        lambda: check_rows(g, images, 2),
        lambda: check_rpe_packed(g, images, 3),
    ]
    rows = []
    for make in cases:
        case = make()
        run, plain, library = case.pop("run"), case.pop("plain"), case.pop("library")
        faulted, base = case.pop("faulted"), case.pop("base")
        got = run()
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = case["atol"] + case["rtol"] * want.float().abs()
        finite = bool(torch.isfinite(got.float()).all())
        elem_ok = bool((err <= tol).all())
        max_err = float(err.max())
        rel = _rel(got, want, base)
        del got, err, tol
        bad = faulted()
        fault_rel = _rel(bad, want, base)
        del want, bad
        ms = time_ms(run)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(library) if library else None
        b_ms, b_by = bound_ms(case["bytes"], case["flops"], case["rate"])
        print(
            f"  {case['name']:<15} {case['case']:<34} max_abs_err {max_err:.3e} "
            f"(tol atol {case['atol']} + rtol {case['rtol']}) rel {rel:.3e} "
            f"(tol {REL_TOL}; planted fault '{case['fault']}': {fault_rel:.3e}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {'%.4f' % lib_ms if lib_ms is not None else 'n/a'} ms "
            f"bound {b_ms:.4f} ms ({b_by})",
            flush=True,
        )
        if not (finite and elem_ok and rel <= REL_TOL):
            fail(f"{case['name']} ({case['case']}) disagrees with its plain version")
        if fault_rel <= REL_TOL:
            fail(f"{case['name']} ({case['case']}): the planted fault "
                 f"'{case['fault']}' passes the bar, which is too loose")
        rows.append(dict(case, max_abs_err=max_err, rel_err=rel,
                         fault_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        del run, plain, library, faulted, base, case
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phase 4: serve requests through the port's entry point
# --------------------------------------------------------------------------

# Kernel path against plain path, both bf16, 24 blocks deep: one bf16 flip
# in a block moves every later block's output a little, so the logits agree
# to ~1e-2 of their size on average and ~1.5e-2 at the worst logit (measured
# on the card under r4).  With random weights many pixels have two classes
# within that of each other, so labels agree on ~98 % of pixels.  A planted
# fault in one kernel must fail one of the three bars: a region-mask fault
# in K5 (stages 2-3, where every shifted window crosses the roll's seam)
# moves the logits everywhere; the same fault in K1 (stages 0-1 under r5)
# touches only the windows on the seam, near the bottom and right edges, so
# it moves the mean little but the worst logit by ~0.1 of the largest.
LOGIT_TOL = dict(rel_mean=2e-2, rel_max=0.06, label_agree=0.97)


def _ops_modules():
    from ir_ads_tpu_torch.ops import (
        block_tail, dscf_rows, dscf_rpe, dscf_rpe_packed, swin_block, swin_block_v6,
    )

    return (swin_block, block_tail, swin_block_v6, dscf_rpe, dscf_rows,
            dscf_rpe_packed)


def expected_launches(model):
    """Launches of each kernel in one forward, from the model's dispatch:
    every block of a stage runs K1 + K2 (pallas4) or K5 (pallas6), every
    DSCF level K3 + K4 (pallas3) or K6 (xla); the two streams run in turn."""
    n = dict.fromkeys(("swin_block", "block_tail", "swin_block_v6", "dscf_rpe",
                       "dscf_rows", "dscf_rpe_packed"), 0)
    for stage in model.backbone.stages:
        for blk in stage.blocks:
            names = ("swin_block_v6",) if blk.attn_impl == "pallas6" else (
                "swin_block", "block_tail")
            for k in names:
                n[k] += 2
    for dm in model.backbone.DeformMPGBlocks:
        names = ("dscf_rpe_packed",) if dm.deform_atten.attn_impl == "xla" else (
            "dscf_rpe", "dscf_rows")
        for k in names:
            n[k] += 1
    return n


def _window_block_no_region(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                            region, *rest):
    """K1's plain version with a planted fault: the shift-region mask left
    out, so shifted windows attend across the roll's seams."""
    from ir_ads_tpu_torch.ops.swin_block import window_block_reference

    return window_block_reference(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                                  None, *rest)


def _window_block_v6_no_region(x, attn, tail, region, *rest):
    """K5's plain version with the same planted fault."""
    from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6_reference

    return window_block_v6_reference(x, attn, tail, None, *rest)


def _plain_path(**faults):
    """Point the backbone at the plain versions (on CUDA tensors), with any
    of them replaced by ``faults``, and return a function that restores the
    kernels."""
    from ir_ads_tpu_torch.models.backbones import swin
    from ir_ads_tpu_torch.ops import (
        block_tail, dscf_rows, dscf_rpe, dscf_rpe_packed, swin_block, swin_block_v6,
    )

    swap = {
        "window_block": swin_block.window_block_reference,
        "block_tail": block_tail.block_tail_reference,
        "window_block_v6": swin_block_v6.window_block_v6_reference,
        "rpe_bias_rows": lambda pos, table, h, w, dt: dscf_rpe.rpe_bias_rows_reference(
            pos.float(), table.float(), h, w, dt),
        "rpe_bias_packed": lambda pos, table, h, w, dt: (
            dscf_rpe_packed.rpe_bias_packed_reference(pos.float(), table.float(), h, w, dt)),
        "dscf_rows_attention": dscf_rows.dscf_rows_reference,
        **faults,
    }
    saved = {k: getattr(swin, k) for k in swap}
    for k, f in swap.items():
        setattr(swin, k, f)
    return lambda: [setattr(swin, k, f) for k, f in saved.items()]


def _warm_up(pred, frames):
    """One request first (allocator, cuBLAS handles), not timed."""
    pred(*frames[0])
    torch.cuda.synchronize()


def _serve(pred, frames):
    """Each request timed on the host clock up to a synchronize."""
    lat, outs = [], []
    for rgb, dep in frames:
        t = time.perf_counter()
        outs.append(pred(rgb, dep))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return lat, outs


def _p50(lat):
    return sorted(lat)[len(lat) // 2]


def phase_serve(seed: int, requests: int, batch: int, card_line: str):
    from ir_ads_tpu_torch.serve import SemSegPredictor

    t0 = time.time()
    pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                           image_size=IMAGE)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  model: Swin-B CMNeXt, {n_params / 1e6:.1f} M parameters, bf16, "
          f"r5 dispatch, built in {time.time() - t0:.1f} s", flush=True)
    g = torch.Generator().manual_seed(seed + 1)
    frames = [
        (torch.randint(0, 256, (batch, *IMAGE, 3), generator=g, dtype=torch.uint8),
         torch.randint(0, 256, (batch, *IMAGE, 3), generator=g, dtype=torch.uint8))
        for _ in range(requests)
    ]
    _warm_up(pred, frames)

    kernels = [m.KERNEL for m in _ops_modules()]
    for k in kernels:
        k.launches = 0
    lat, outs = _serve(pred, frames)
    launches = {k.name: k.launches for k in kernels}

    per_request = expected_launches(pred.model)
    r5 = {"swin_block": 8, "block_tail": 8, "swin_block_v6": 40, "dscf_rpe": 3,
          "dscf_rows": 3, "dscf_rpe_packed": 1}
    if per_request != r5:
        fail(f"the predictor's dispatch gives {per_request} launches per request, "
             f"not r5's {r5}")
    for name, n in launches.items():
        if n != per_request[name] * requests:
            fail(f"{name} launched {n} times on the main path, expected "
                 f"{per_request[name]} per request x {requests}")
    for logits, labels in outs:
        if logits.shape != (batch, *IMAGE, NUM_CLASSES) or labels.shape != (batch, *IMAGE):
            fail(f"output shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail("non-finite logits")

    def plain_request(**faults):
        restore = _plain_path(**faults)
        try:
            out = pred(*frames[0])
            torch.cuda.synchronize()
        finally:
            restore()
        return out

    def compare(got, got_labels, what):
        err = (got - want).abs()
        rel_mean = float(err.mean() / want.abs().mean())
        rel_max = float(err.max() / want.abs().max())
        agree = float((got_labels == want_labels).float().mean())
        print(f"  {what} vs plain versions on the card: mean |err| / mean |ref| "
              f"{rel_mean:.3e} (tol {LOGIT_TOL['rel_mean']}), max |err| / max |ref| "
              f"{rel_max:.3e} (tol {LOGIT_TOL['rel_max']}), labels agree "
              f"{agree:.4f} (tol {LOGIT_TOL['label_agree']})", flush=True)
        return (rel_mean <= LOGIT_TOL["rel_mean"] and rel_max <= LOGIT_TOL["rel_max"]
                and agree >= LOGIT_TOL["label_agree"])

    want, want_labels = plain_request()
    if not compare(*outs[0], "kernel path"):
        fail("kernel path disagrees with the plain path end to end")
    # the same bar must see a fault in one piece of one kernel's function
    if compare(*plain_request(window_block=_window_block_no_region),
               "planted fault (K1 without the shift-region mask)"):
        fail("a K1 without its shift-region mask passes the end-to-end bar")
    if compare(*plain_request(window_block_v6=_window_block_v6_no_region),
               "planted fault (K5 without the shift-region mask)"):
        fail("a K5 without its shift-region mask passes the end-to-end bar")

    p50 = _p50(lat)
    print(f"  r5: {requests} requests x {batch} frames 480x640 RGB-D, flip, "
          f"latency ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, "
          f"{batch * 1e3 / p50:.2f} frames/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card_line}]",
          flush=True)
    print(f"  launches on the main path ({requests} requests): {launches}",
          flush=True)
    serve = dict(dispatch="r5", latency_ms=lat, p50_ms=p50,
                 frames_per_s=batch * 1e3 / p50)

    # for the record: the same weights and requests under r4 (no check)
    ref5 = outs[0][0]
    del pred, outs
    torch.cuda.empty_cache()
    pred4 = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                            image_size=IMAGE, dispatch="r4")
    _warm_up(pred4, frames)
    lat4, outs4 = _serve(pred4, frames)
    p50_4 = _p50(lat4)
    diff = float((outs4[0][0] - ref5).abs().mean() / ref5.abs().mean())
    print(f"  r4 (for the record): latency ms {['%.1f' % v for v in lat4]} p50 "
          f"{p50_4:.1f}, {batch * 1e3 / p50_4:.2f} frames/s; logits vs r5: mean "
          f"|diff| / mean |r5| {diff:.3e} [{card_line}]", flush=True)
    serve["r4"] = dict(latency_ms=lat4, p50_ms=p50_4,
                       frames_per_s=batch * 1e3 / p50_4, rel_mean_vs_r5=diff)
    return launches, serve


def kernel_table(rows, launches):
    from ir_ads_tpu_torch.ops.cuda_lib import PKG

    out = []
    for mod in _ops_modules():
        k = mod.KERNEL
        cases = [r for r in rows if r["name"] == k.name]
        first = cases[0]
        out.append(dict(
            name=k.name, route="cuda",
            source=str(k.source.relative_to(PKG.parent)),
            replaces=k.replaces, launches=launches[k.name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"],
            cases=[{key: c[key] for key in (
                "case", "max_abs_err", "rel_err", "fault", "fault_rel_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                   for c in cases],
        ))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    # a reference states both: plain f32 products and convolutions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card_line = card()
    print(card_line, flush=True)
    print(f"phase 1: torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}", flush=True)

    from ir_ads_tpu_torch.ops.cuda_lib import build_all

    t0 = time.time()
    logs = build_all([m.KERNEL for m in _ops_modules()])
    print(f"phase 2: built {len(logs)} sources of {len(_ops_modules())} kernels in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(regs), flush=True)

    print("phase 3: kernels against their plain versions (bf16, main-path shapes)",
          flush=True)
    rows = phase_kernels(args.seed, 2 * args.batch)

    print("phase 4: serving", flush=True)
    launches, serve = phase_serve(args.seed, args.requests, args.batch, card_line)

    print(json.dumps({"kernels": kernel_table(rows, launches), "serve": serve,
                      "card": card_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
