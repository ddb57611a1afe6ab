#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--batch 2]

Phases, each of which raises on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the slice from csrc/ (one nvcc per source,
     all started together) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the main paths (serving and training) give it,
     element by element and on
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
     everywhere);
  5. train: ``SemSegTrainer`` (the same model under the ``train`` dispatch,
     f32 master parameters, bf16 compute, adapter-only AdamW, MMST 3-head
     loss) on batches of 4 frames drawn from --seed.  (a) With every
     stochastic rate at 0, one forward and backward on the kernel path (K1
     with its backward K7 at every stage, K3 + K4 with K8 at DSCF levels
     0-2, K6 at level 3).  Backward kernels: its gradients, parameter group
     by group, against the same forward with the plain K7 and K8 behind it.
     Forward kernels: every launch of K1, K3, K4 and K6 inside the step
     against its plain version on that launch's own inputs; the loss against
     the all-plain path; and its gradients, group by group, no further from
     the all-plain path's than a control is (the plain versions with f32
     inside, which compute the same functions with fewer roundings).  A
     planted fault must fail each bar: K7 without its region mask, K8 with
     a scaled dbias, K1 without its region mask at stage 3 alone.  (b) Four
     steps of the shipped recipe (drop-path, dropout and the modality mask
     on), the first a warm-up: finite losses, every trainable parameter
     moved, every frozen one bit-equal, and per step 48 launches of K1 and
     of K7, 3 of K3, K4 and K8, 1 of K6 and none of K2 and K5.  (c) The p50
     step time, images per second and peak memory.
The line before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import functools
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
TRAIN_BATCH = 4               # the shipped recipe's (configs/nyu_rgbd.yaml)


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


def _rms(t):
    return float(t.float().pow(2).mean().sqrt())


def check_window_attn_bwd(g, b, h_real, w_real, c, heads, shift, want_ow, want_dbias):
    """K7 at one stage's training shape.  Outputs are barred one by one:
    dqkv and ow are bf16 roundings of f32 sums over 144 (or 32) bf16
    products, in another order than the plain version's, after two bf16
    roundings inside (pc, dS * scale) that can each flip by an ulp (2^-8):
    rtol two ulps, atol 5 % of the output's rms for the elements that
    cancel to near zero.  dbias is an f32 sum of f32 dS over all windows,
    which differs only by the sums' order and the exp's last bits: 1e-3."""
    from ir_ads_tpu_torch.ops import window_attn_bwd as k7
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    bn = b * (hp // ws) * (wp // ws)
    qkvw = _rand(g, bn, n, 3 * c)
    dow = _rand(g, bn, n, c)
    bias = _rand(g, heads, n, n, dtype=torch.float32)
    region = shift_region_ids_on(hp, wp, ws, shift, qkvw.device) if shift else None
    scale = (c // heads) ** -0.5
    keep = lambda outs: tuple(o for o in outs if o is not None)  # noqa: E731
    run = lambda: keep(k7.window_attention_bwd(  # noqa: E731
        qkvw, dow, bias, region, scale, heads, want_ow, want_dbias))
    plain = lambda: keep(k7.window_attention_bwd_reference(  # noqa: E731
        qkvw, dow, bias, region, scale, heads, want_ow, want_dbias))
    faulted = lambda: keep(k7.window_attention_bwd_reference(  # noqa: E731
        qkvw, dow, bias, None, scale, heads, want_ow, want_dbias))
    names = ["dqkv"] + ["ow"] * want_ow + ["dbias"] * want_dbias
    tol = {"dqkv": (0.05, 2e-2), "ow": (0.05, 2e-2), "dbias": (1e-3, 1e-3)}

    # the library call: the backward of scaled_dot_product_attention with
    # bias + region mask as its float mask (the graph is built outside the
    # timing; gradients of q, k, v and of the bias)
    d = c // heads
    heads_of = lambda t: t.reshape(bn, n, heads, d).transpose(1, 2)  # noqa: E731
    leaves = [heads_of(qkvw[..., i * c:(i + 1) * c]).detach().requires_grad_()
              for i in range(3)]
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    mask = bias_leaf[None]
    if region is not None:
        neq = (region[:, :, None] != region[:, None, :]).repeat(b, 1, 1)
        mask = mask + torch.where(neq, -1e9, 0.0).to(torch.bfloat16)[:, None]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask.expand(bn, -1, -1, -1),
                                         scale=scale)
    do = heads_of(dow)
    wanted = leaves + [bias_leaf] * want_dbias

    def library():
        return torch.autograd.grad(out, wanted, do, retain_graph=True)

    flops = bn * heads * 2 * n * n * d * (5 + want_ow)
    io = (nbytes(qkvw, dow, bias, region) + nbytes(qkvw)
          + nbytes(dow) * want_ow + nbytes(bias) * want_dbias)
    return dict(
        name="window_attn_bwd",
        case=f"C={c} {bn} windows shift {shift} ow {int(want_ow)} dbias {int(want_dbias)}",
        run=run, plain=plain, faulted=faulted, fault="region mask dropped",
        base=None, library=library, outputs=names,
        atol=[tol[k][0] for k in names], rtol=[tol[k][1] for k in names],
        atol_of_rms=True, bytes=io, flops=flops, rate=BF16_TENSOR_FLOPS,
    )


def check_rows_bwd(g, b, level):
    """K8 at one DSCF level's training shape.  dq is a bf16 rounding of an
    f32 sum over 600 keys of bf16(dS * scale) products (rtol two ulps, atol
    5 % of rms); dk and dv are f32 sums over every query pixel of products
    of bf16-rounded factors whose rounding can flip (1 % of rms, rtol two
    ulps); dbias is dS itself in f32 (1e-3, the exp's and the sums' last
    bits)."""
    from ir_ads_tpu_torch.ops import dscf_rows_bwd as k8
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    gc = 16
    q = _rand(g, bg, h * w, gc)
    k = _rand(g, bg, m, gc)
    v = _rand(g, bg, m, gc)
    dout = _rand(g, bg, h * w, gc)
    bias = k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16)
    scale = 8 ** -0.5
    run = lambda: k8.dscf_rows_bwd(q, k, v, bias, dout, scale, hg)  # noqa: E731
    plain = lambda: k8.dscf_rows_bwd_reference(q, k, v, bias, dout, scale, hg)  # noqa: E731

    def faulted():
        dq, dk, dv, dbias = plain()
        return dq, dk, dv, dbias * scale

    heads_of = lambda t, n: t.reshape(bg, n, hg, 8).transpose(1, 2)  # noqa: E731
    leaves = [heads_of(q, h * w).detach().requires_grad_(),
              heads_of(k, m).detach().requires_grad_(),
              heads_of(v, m).detach().requires_grad_(),
              bias.permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m).contiguous()
              .requires_grad_()]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)
    do = heads_of(dout, h * w)

    def library():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    scores = bg * hg * h * w * m
    return dict(
        name="dscf_rows_bwd", case=f"level {level} plane {h}x{w} BG={bg}",
        run=run, plain=plain, faulted=faulted, fault="dbias scaled by scale",
        base=None, library=library, outputs=["dq", "dk", "dv", "dbias"],
        atol=[0.05, 0.01, 0.01, 1e-3], rtol=[2e-2, 2e-2, 2e-2, 1e-3],
        atol_of_rms=True,
        bytes=nbytes(q, k, v, bias, dout) + nbytes(q) + 2 * nbytes(k) * 2 + scores * 4,
        flops=scores * 80, rate=BF16_TENSOR_FLOPS,
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
        # the training path: K1 again at stages 2-3; K7 at the four stages as
        # the adapter recipe runs it (attention parameters frozen: no ow, no
        # dbias) and once with every gradient wanted; K8 at levels 0 and 2
        lambda: check_window_block(g, TRAIN_BATCH, 30, 40, 512, 16, 6,
                                   "region mask dropped"),
        lambda: check_window_block(g, TRAIN_BATCH, 15, 20, 1024, 32, 6,
                                   "rel-pos bias dropped"),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 120, 160, 128, 4, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 60, 80, 256, 8, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 30, 40, 512, 16, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 15, 20, 1024, 32, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 60, 80, 256, 8, 6, True, True),
        lambda: check_rows_bwd(g, TRAIN_BATCH, 0),
        lambda: check_rows_bwd(g, TRAIN_BATCH, 2),
    ]
    rows = []
    for make in cases:
        case = make()
        run, plain, library = case.pop("run"), case.pop("plain"), case.pop("library")
        faulted, base = case.pop("faulted"), case.pop("base")
        names = case.pop("outputs", ["out"])
        of_rms = case.pop("atol_of_rms", False)
        as_list = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
        atols, rtols = as_list(case["atol"]), as_list(case["rtol"])
        got, want = as_list(run()), as_list(plain())
        torch.cuda.synchronize()
        bad = as_list(faulted())
        finite, elem_ok, max_err, rel, fault_rel, parts = True, True, 0.0, 0.0, 0.0, []
        for name, gt, wt, bd, atol, rtol in zip(names, got, want, bad, atols, rtols):
            err = (gt.float() - wt.float()).abs()
            tol = atol * (_rms(wt) if of_rms else 1.0) + rtol * wt.float().abs()
            finite = finite and bool(torch.isfinite(gt.float()).all())
            elem_ok = elem_ok and bool((err <= tol).all())
            r, fr = _rel(gt, wt, base), _rel(bd, wt, base)
            parts.append(f"{name} max_abs_err {float(err.max()):.3e} rel {r:.3e}")
            max_err, rel, fault_rel = max(max_err, float(err.max())), max(rel, r), max(fault_rel, fr)
            del err, tol
        del got, want, bad
        ms = time_ms(run)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(library) if library else None
        b_ms, b_by = bound_ms(case["bytes"], case["flops"], case["rate"])
        print(
            f"  {case['name']:<15} {case['case']:<34} " + "; ".join(parts) +
            f" (tol atol {case['atol']}{' x rms' if of_rms else ''} + rtol {case['rtol']}; "
            f"rel tol {REL_TOL}; planted fault '{case['fault']}': {fault_rel:.3e}) "
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
        block_tail, dscf_rows, dscf_rows_bwd, dscf_rpe, dscf_rpe_packed, swin_block,
        swin_block_v6, window_attn_bwd,
    )

    return (swin_block, block_tail, swin_block_v6, dscf_rpe, dscf_rows,
            dscf_rpe_packed, window_attn_bwd, dscf_rows_bwd)


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

    torch.cuda.reset_peak_memory_stats()  # phase 3 allocated more than serving does
    kernels = _reset_launches()
    lat, outs = _serve(pred, frames)
    launches = {k.name: k.launches for k in kernels}

    per_request = expected_launches(pred.model)
    r5 = {"swin_block": 8, "block_tail": 8, "swin_block_v6": 40, "dscf_rpe": 3,
          "dscf_rows": 3, "dscf_rpe_packed": 1}
    if per_request != r5:
        fail(f"the predictor's dispatch gives {per_request} launches per request, "
             f"not r5's {r5}")
    for name, n in launches.items():
        if n != per_request.get(name, 0) * requests:
            fail(f"{name} launched {n} times on the main path, expected "
                 f"{per_request.get(name, 0)} per request x {requests}")
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


# --------------------------------------------------------------------------
# phase 5: training steps through the port's entry point
# --------------------------------------------------------------------------

# launches per training step under the ``train`` dispatch: every block of
# both streams runs K1 forward and K7 backward (24 x 2), every DSCF level
# 0-2 runs K3, K4 and K8, level 3 runs K6; the eval kernels do not run
TRAIN_LAUNCHES = {"swin_block": 48, "window_attn_bwd": 48, "dscf_rpe": 3,
                  "dscf_rows": 3, "dscf_rows_bwd": 3, "dscf_rpe_packed": 1,
                  "block_tail": 0, "swin_block_v6": 0}

# One forward and backward in bf16 with f32 master parameters, every
# stochastic rate 0, gradients taken group by group (a group's parameters as
# one vector, ||got - want|| / ||want||).  Measured on the card
# (grad_noise.py): the same path run twice differs by ~1 % of a group's norm
# (PyTorch's own backward sums with atomics), and two bf16 forwards of the
# same function that round at different points give gradients 0.6 % (decode
# heads) to 100 % (DSCF offsets) apart, group by group, while their losses
# agree to 1e-5.  So the two halves are barred apart:
#   * backward kernels (K7, K8): the kernel path against the path with the
#     SAME forward kernels and the plain versions of K7 and K8 in the
#     backward.  The forwards are bit-equal, so only the backward kernels'
#     summation order and the run-to-run 1 % remain: every group within
#     ``bwd_group_rel``.
#   * forward kernels (K1 at all four stages, K3, K4, K6), three bars.
#     Every launch inside the step against its plain version on that
#     launch's own inputs, on what it adds (phase 3's bar, ``fwd_call_rel``).
#     The loss against the all-plain path within ``loss``.  And every
#     group's gradient against the all-plain path's, no further from it than
#     ``noise_ratio`` times a control is: the plain path with f32 inside K1
#     and K4 (the same functions with fewer roundings; K3 and K6 compute in
#     f32 already), which measures in this run what a change of rounding
#     alone does to each group.  grad_noise.py: the kernel path is 0.69 to
#     1.14 times as far from the plain path as the control, group by group,
#     and all of that distance comes from K1 (swapping K3, K4 or K6 alone
#     moves no group beyond the run-to-run 1 %).
# One planted fault per bar must fail it: K7 without its region mask, K8
# with dbias scaled by ``scale``, and K1's forward without its region mask
# at stage 3 alone (2 of the 48 launches).
GRAD_TOL = dict(loss=2e-3, bwd_group_rel=0.05, fwd_call_rel=REL_TOL, noise_ratio=2.0)
FORWARD = ("swin_block", "dscf_rpe", "dscf_rows", "dscf_rpe_packed")
BACKWARD = ("window_attn_bwd", "dscf_rows_bwd")


def _grad_group(name: str) -> str:
    parts = name.split(".")
    if parts[0] != "backbone":
        return parts[0]
    if parts[1] == "DeformMPGBlocks":
        leaf = "rpe_table" if parts[-1] == "rpe_table" else (
            "offsets" if "conv_offset" in name else "rest")
        return f"DeformMPGBlocks.{parts[2]}.{leaf}"
    if parts[1] in ("stages", "MPGBlocks"):
        return ".".join(parts[1:3])
    return parts[1]


def _train_wrappers():
    """Kernel name -> (module, the name through which the differentiable
    wrapper reaches the kernel, the plain version to put there)."""
    from ir_ads_tpu_torch.ops import (
        dscf_rows, dscf_rows_bwd, dscf_rpe, dscf_rpe_packed, swin_block, window_attn_bwd,
    )

    return {
        "swin_block": (swin_block, "_forward", _block_forward_plain),
        "dscf_rpe": (dscf_rpe, "_rows_forward", dscf_rpe.rpe_bias_rows_reference),
        "dscf_rows": (dscf_rows, "_forward", dscf_rows.dscf_rows_reference),
        "dscf_rpe_packed": (dscf_rpe_packed, "_packed_forward",
                            dscf_rpe_packed.rpe_bias_packed_reference),
        "window_attn_bwd": (swin_block, "window_attention_bwd",
                            window_attn_bwd.window_attention_bwd_reference),
        "dscf_rows_bwd": (dscf_rows, "dscf_rows_bwd",
                          dscf_rows_bwd.dscf_rows_bwd_reference),
    }


def _swap_train_path(plain=(), **replaced):
    """Point the kernels named in ``plain`` at their plain versions (on CUDA
    tensors) and those in ``replaced`` at the given functions, and return a
    function that restores the kernels."""
    wrappers = _train_wrappers()
    swap = {name: wrappers[name][2] for name in plain}
    swap.update(replaced)
    saved = {name: getattr(*wrappers[name][:2]) for name in swap}
    for name, f in swap.items():
        setattr(*wrappers[name][:2], f)
    return lambda: [setattr(*wrappers[name][:2], f) for name, f in saved.items()]


def _block_forward_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, region,
                         *rest, no_region_at=(), inside=None):
    """K1's plain forward behind its wrapper's parameter rounding.  With
    ``no_region_at`` a planted fault: the shift-region mask left out at
    those channel widths.  With ``inside=torch.float32`` the control: the
    same rounded inputs, no rounding inside, the output rounded once."""
    from ir_ads_tpu_torch.ops.swin_block import window_block_reference

    params = (t.to(x.dtype).to(inside or x.dtype)
              for t in (ln_w, ln_b, wqkv, bqkv, wproj, bproj))
    keep = x.shape[-1] not in no_region_at
    return window_block_reference(x.to(inside or x.dtype), *params, bias.float(),
                                  region if keep else None, *rest).to(x.dtype)


def _rows_f32_inside(q, k, v, bias, scale, hg):
    """K4's plain version as the control: no rounding inside."""
    from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_reference

    return dscf_rows_reference(q.float(), k.float(), v.float(), bias.float(),
                               scale, hg).to(q.dtype)


CONTROL = dict(swin_block=functools.partial(_block_forward_plain, inside=torch.float32),
               dscf_rows=_rows_f32_inside)


def _checked_forwards(log, **faults):
    """Replacements for the four forward kernels that launch the kernel, run
    its plain version (or ``faults``' version of it) on the same inputs, add
    (kernel, output shape, error on what the kernel adds) to ``log`` and
    hand on the kernel's output."""
    def both(name, kernel, plain):
        def run(*args):
            got, want = kernel(*args), plain(*args)
            base = args[0] if name == "swin_block" else None  # K1: y - x
            log.append((name, tuple(got.shape), _rel(got, want, base)))
            return got
        return run

    wrappers = _train_wrappers()
    return {name: both(name, getattr(*wrappers[name][:2]),
                       faults.get(name, wrappers[name][2])) for name in FORWARD}


def _attn_bwd_no_region(qkvw, dow, bias, region, *rest, **kw):
    """K7's plain version with a planted fault: the shift-region mask left out."""
    from ir_ads_tpu_torch.ops.window_attn_bwd import window_attention_bwd_reference

    return window_attention_bwd_reference(qkvw, dow, bias, None, *rest, **kw)


def _rows_bwd_scaled_dbias(q, k, v, bias, dout, scale, hg):
    """K8's plain version with a planted fault: dbias scaled by ``scale``."""
    from ir_ads_tpu_torch.ops.dscf_rows_bwd import dscf_rows_bwd_reference

    dq, dk, dv, dbias = dscf_rows_bwd_reference(q, k, v, bias, dout, scale, hg)
    return dq, dk, dv, dbias * scale


def _train_batches(seed: int, batch: int, n: int):
    """Normalised frames and labels (one row band ignored) from the seed."""
    g = torch.Generator().manual_seed(seed + 2)
    out = []
    for _ in range(n):
        rgb = torch.randn(batch, *IMAGE, 3, generator=g)
        dte = torch.rand(batch, *IMAGE, 3, generator=g)
        label = torch.randint(0, NUM_CLASSES, (batch, *IMAGE), generator=g)
        label[:, :8] = 255
        out.append((rgb, dte, label))
    return out


def _reset_launches():
    kernels = [m.KERNEL for m in _ops_modules()]
    for k in kernels:
        k.launches = 0
    return kernels


def gradient_run(seed: int, dtype, batch):
    """A trainer with every stochastic rate at 0 and a function that runs one
    forward and backward on ``batch`` with the train path swapped as
    ``_swap_train_path`` says, and returns the loss and the gradient of every
    parameter group as one f32 vector."""
    from ir_ads_tpu_torch.train import SemSegTrainer
    from ir_ads_tpu_torch.training.train_state import compute_loss

    tr = SemSegTrainer(device="cuda", dtype=dtype, seed=seed, num_classes=NUM_CLASSES,
                       head_drop=0.0, mmst_mask=False,
                       backbone_kwargs=dict(drop_path_rate=0.0, adapter_drop=0.0))
    params = dict(tr.model.named_parameters())
    data = tr.batch(*batch)

    def run(plain=(), **replaced):
        restore = _swap_train_path(plain, **replaced)
        try:
            tr.model.train()
            tr.optimizer.zero_grad(set_to_none=True)
            loss, _ = compute_loss(tr.model, data, tr.loss_fn, tr.generator)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            restore()
        groups = {}
        for name, p in params.items():
            if p.requires_grad:
                groups.setdefault(_grad_group(name), []).append(p.grad.flatten().float())
        grads = {k: torch.cat(v) for k, v in groups.items()}
        if not all(bool(torch.isfinite(v).all()) for v in grads.values()):
            fail("non-finite gradients")
        return float(loss.detach()), grads

    return tr, run


def group_rel(got, want):
    return {k: float((got[k] - want[k]).norm() / want[k].norm()) for k in want}


def phase_train(seed: int, card_line: str):
    from ir_ads_tpu_torch.train import SemSegTrainer

    batch = TRAIN_BATCH
    batches = _train_batches(seed, batch, 4)

    # (a) kernel path against plain versions, stochastic rates 0
    def median(rels):
        return sorted(rels.values())[len(rels) // 2]

    t0 = time.time()
    tr, run = gradient_run(seed, torch.bfloat16, batches[0])
    n_all = sum(p.numel() for p in tr.model.parameters())
    n_train = sum(p.numel() for p in tr.model.parameters() if p.requires_grad)
    print(f"  model: Swin-B CMNeXt under the train dispatch, f32 masters, bf16 compute, "
          f"{n_train / 1e6:.2f} M of {n_all / 1e6:.1f} M parameters trainable, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    kernels = _reset_launches()
    loss_k, grads_k = run()
    once = {k.name: k.launches for k in kernels}
    if once != TRAIN_LAUNCHES:
        fail(f"one forward and backward launched {once}, expected {TRAIN_LAUNCHES}")

    # backward kernels: same forward, K7 and K8 against their plain versions
    _, grads_pb = run(BACKWARD)

    def backward_bar(grads, what):
        rels = group_rel(grads, grads_pb)
        worst = max(rels, key=rels.get)
        print(f"  {what} vs the plain K7 and K8 behind the same forward: gradient "
              f"||diff|| / ||ref|| over {len(rels)} parameter groups: worst "
              f"{rels[worst]:.3e} ({worst}), median {median(rels):.3e} "
              f"(tol {GRAD_TOL['bwd_group_rel']})", flush=True)
        return rels, rels[worst] <= GRAD_TOL["bwd_group_rel"]

    bwd_rels, ok = backward_bar(grads_k, "kernel path")
    if not ok:
        fail("K7 or K8 disagrees with its plain version inside the training step")
    if backward_bar(run(BACKWARD, window_attn_bwd=_attn_bwd_no_region)[1],
                    "planted fault (K7 without the shift-region mask)")[1]:
        fail("a K7 without its shift-region mask passes the gradient bar")
    if backward_bar(run(BACKWARD, dscf_rows_bwd=_rows_bwd_scaled_dbias)[1],
                    "planted fault (K8 with dbias scaled by scale)")[1]:
        fail("a K8 whose dbias is scaled passes the gradient bar")
    del grads_pb

    # forward kernels, launch by launch inside the step
    stage3_fault = functools.partial(_block_forward_plain, no_region_at=(1024,))

    def forward_calls(what, **faults):
        log = []
        run(**_checked_forwards(log, **faults))
        worst = {}
        for name, shape, r in log:
            if r >= worst.get(name, (0.0, None))[0]:
                worst[name] = (r, shape)
        print(f"  {what}: {len(log)} forward launches inside the step against their "
              f"plain versions on the same inputs, worst error on what the kernel adds: "
              + ", ".join(f"{k} {r:.3e} {shape}" for k, (r, shape) in worst.items())
              + f" (tol {GRAD_TOL['fwd_call_rel']})", flush=True)
        if len(log) != sum(TRAIN_LAUNCHES[k] for k in FORWARD):
            fail(f"{len(log)} forward launches were checked inside the step")
        return ({k: r for k, (r, _) in worst.items()},
                all(r <= GRAD_TOL["fwd_call_rel"] for r, _ in worst.values()))

    call_rels, ok = forward_calls("kernel path")
    if not ok:
        fail("a forward kernel disagrees with its plain version inside the training step")
    if forward_calls("planted fault (plain K1 without the shift-region mask at stage 3)",
                     swin_block=stage3_fault)[1]:
        fail("a K1 without its shift-region mask at stage 3 passes the launch bar")

    # forward kernels, through the step: loss and gradients against the
    # all-plain path, the gradients barred by the control's distance from it
    loss_p, grads_p = run(FORWARD + BACKWARD)
    loss_c, grads_c = run(FORWARD + BACKWARD, **CONTROL)
    noise = group_rel(grads_c, grads_p)

    def forward_bar(grads, what):
        rels = group_rel(grads, grads_p)
        ratio = {k: rels[k] / noise[k] for k in rels}
        worst = max(ratio, key=ratio.get)
        print(f"  {what} vs all plain versions: gradient ||diff|| / ||ref|| over "
              f"{len(rels)} parameter groups, median {median(rels):.3e} (control "
              f"{median(noise):.3e}); worst against the control {ratio[worst]:.3f} x "
              f"({worst}: {rels[worst]:.3e}, control {noise[worst]:.3e}; tol "
              f"{GRAD_TOL['noise_ratio']} x)", flush=True)
        return rels, ratio[worst] <= GRAD_TOL["noise_ratio"]

    dloss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  kernel path vs all plain versions: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{dloss:.2e}, tol {GRAD_TOL['loss']}; control {loss_c:.6f})", flush=True)
    if dloss > GRAD_TOL["loss"]:
        fail("the training loss on the kernel path disagrees with the plain path")
    fwd_rels, ok = forward_bar(grads_k, "kernel path")
    if not ok:
        fail("the kernel path's gradients are further from the plain path's than a "
             "change of rounding explains")
    if forward_bar(run(FORWARD + BACKWARD, swin_block=stage3_fault)[1],
                   "planted fault (K1 forward without the shift-region mask at stage 3)")[1]:
        fail("a K1 forward without its shift-region mask at stage 3 passes the "
             "gradient bar")
    rels = dict(backward=bwd_rels, forward_calls=call_rels, kernel_vs_plain=fwd_rels,
                control_vs_plain=noise)
    del tr, run, grads_k, grads_p, grads_c
    torch.cuda.empty_cache()

    # (b) the shipped recipe: dropout, drop-path and the modality mask on
    tr = SemSegTrainer(device="cuda", seed=seed, num_classes=NUM_CLASSES)
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.step(*batches[0])  # warm-up (allocator, cuBLAS handles, AdamW state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    ms, metrics = [], []
    for b in batches[1:]:
        t = time.perf_counter()
        metrics.append(tr.step(*b))  # returns floats: the step has finished
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    steps = len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, n in launches.items():
        if n != TRAIN_LAUNCHES[name] * steps:
            fail(f"{name} launched {n} times in {steps} training steps, expected "
                 f"{TRAIN_LAUNCHES[name]} per step")
    for m in metrics:
        if not all(torch.isfinite(torch.tensor(list(m.values())))):
            fail(f"non-finite loss {m}")
    for name, p in tr.model.named_parameters():
        same = torch.equal(p, start[name])
        # softmax ignores a shift of all scores, so the DSCF key bias has a zero
        # gradient and may stay where it was
        if p.requires_grad and same and not name.endswith("proj_k.bias"):
            fail(f"trainable parameter {name} did not change in {steps + 1} steps")
        if not p.requires_grad and not same:
            fail(f"frozen parameter {name} changed")
        if p.dtype != torch.float32:
            fail(f"parameter {name} is {p.dtype}, not an f32 master")
    p50 = _p50(ms)
    print(f"  shipped recipe: {steps} steps x {batch} frames {IMAGE[0]}x{IMAGE[1]} RGB-D after a "
          f"warm-up step, loss {['%.4f' % m['loss'] for m in metrics]} loss_main "
          f"{['%.4f' % m['loss_main'] for m in metrics]}, step ms "
          f"{['%.1f' % v for v in ms]} p50 {p50:.1f}, {batch * 1e3 / p50:.2f} images/s, "
          f"peak memory {peak:.2f} GiB [{card_line}]", flush=True)
    print(f"  launches on the training path ({steps} steps): {launches}", flush=True)
    return launches, dict(batch=batch, steps=steps, step_ms=ms, p50_ms=p50,
                          images_per_s=batch * 1e3 / p50, peak_memory_gib=peak,
                          losses=metrics, group_rel_err=rels)


def kernel_table(rows, launches, train_launches):
    """One entry per kernel; ``launches`` sums the two main paths' runs (the
    serving requests and the training steps, each counted from 0)."""
    from ir_ads_tpu_torch.ops.cuda_lib import PKG

    out = []
    for mod in _ops_modules():
        k = mod.KERNEL
        cases = [r for r in rows if r["name"] == k.name]
        first = cases[0]
        out.append(dict(
            name=k.name, route="cuda",
            source=str(k.source.relative_to(PKG.parent)),
            replaces=k.replaces,
            launches=launches[k.name] + train_launches[k.name],
            launches_serve=launches[k.name], launches_train=train_launches[k.name],
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

    print("phase 5: training", flush=True)
    train_launches, train = phase_train(args.seed, card_line)

    print(json.dumps({"kernels": kernel_table(rows, launches, train_launches),
                      "serve": serve, "train": train, "card": card_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
