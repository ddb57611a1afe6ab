#!/usr/bin/env python3
"""Where the time goes on the GPU: one request of the port's predictors, or
one step of its trainer, under torch.profiler.

    python3 profile_port.py [--seed 0] [--batch 2]
                            [--dispatch r5|r4|r4i8|r2|r1|xla|v7_01|v5|map|
                                        dscf_pallas4|dscf_pallas|dscf_pallas2]
                            [--flat [--patch-embed xla|xla2|pallas]]
                            [--requests N] [--backbone SwinTransformer-L|CMNeXt-B2|CMX-B2]
                            [--dual]
    python3 profile_port.py --train [--seed 0] [--batch 4] [--backbone SwinTransformer-L]
                            [--dual]
    python3 profile_port.py --det [--seed 0]
    python3 profile_port.py --det-train [--seed 0]
    python3 profile_port.py --eval [--seed 0] [--backbone CMNeXt-B2]
    python3 profile_port.py --dscf [--seed 0]
    python3 profile_port.py --jmajor-v1 [--seed 0]
    python3 profile_port.py --rpe [--seed 0]
    python3 profile_port.py --qkv-map-bwd [--seed 0]
    python3 profile_port.py --shares [--seed 0]
    python3 profile_port.py --k9-k19 [--logits-dir DIR] [--seed 0]
    python3 profile_port.py --logits r5,r4,...,r5_flat,r5_flat_pallas,det --logits-dir DIR
                            [--seed 0]
    python3 profile_port.py --same-logits DIR_A DIR_B
    (each also takes --port-dir DIR)

Serving: builds the full-size predictor (Swin-B CMNeXt, or with --backbone
SwinTransformer-L the Swin-L one, or a legacy CMNeXt-Bx / CMX-Bx under any
dispatch but dscf_pallas and dscf_pallas2; --dual: both streams through each stage
in one call, ``dual_batch``; 480x640 RGB-D, flip, bf16, weights from
--seed) under the given kernel dispatch (r5, the default,
r4, the w8a8 r4i8, the module-path sets r2, r1 and xla, the block
variants v7_01, v5 and map, or the DSCF variants dscf_pallas4, dscf_pallas
and dscf_pallas2), serves one warm-up request, then one profiled request,
and sums its port kernels' device time by kernel (K1-K20) with their
launches, and K1's, K2's, K5's, K10's, K11's, K13's and K14's by launch of
their sequences.  With --flat the frames enter the model as flat (B, H, W*3) rows
and --patch-embed chooses the patch embedding's path (pallas: K19).  With
--requests N it first times N requests on the host clock, each ended by a
synchronize, and prints their p50.
Training (--train): builds the full-size trainer (the ``train`` dispatch, f32
masters, bf16 compute, the shipped adapter-only AdamW recipe; --backbone and
--dual as for serving, Swin-L with remat on every block), takes two
warm-up steps, then profiles one step in three parts: forward with the loss,
backward, optimizer update; and K7's share of the step's device time.
Detection (--det): builds the full-size detector (DINO-R50 deformable-mask,
6 + 6 layers, 2000 queries, bf16, weights from --seed), serves one warm-up
request of one 800x1216 image, then profiles one request in two parts: the
model, and the post-processing (mask-scored ranking, top-k, NMS); before
that, one unprofiled request's timeline is split by module (backbone, neck,
encoder, decoder, the seg map and mask heads) with CUDA events around each;
after it, one more profiled request gives K9's device time by launch, the
encoder's six and the decoder's six.
Detection training (--det-train): ``chip_smoke.py`` phase 12's full-width
DINO-R50 trainer and batch (4 images 512x512, 2000 queries + 200 CDN, bf16
on f32 masters), two warm-up steps, then one step profiled in three parts:
the EMA teacher, the student and the losses (the auction among
them); the backward; AdamW and the EMA update.  Device time by
kernel (K9 and its backward), busy and idle share, peak memory; then 4 + 4
unprofiled steps in turns with the auction's host read every iteration
and every ``matcher.AUCTION_CHECK_EVERY``.
Evaluation (--eval): builds the model as ``ir_ads_tpu_torch.val_mm`` does
for ``chip_smoke.py``'s phase 7 (configs/nyu_rgbd.yaml's EVAL: Swin-B
CMNeXt, or --backbone, bf16, r5, 40 classes, weights from --seed), runs one warm-up MSF
image (480x640 RGB-D, six scales, flip), then profiles one MSF image scale
by scale (the resize, the forward of the image and its flip, the two
resizes and the softmax) and whole: device time by port kernel at each
scale, busy time and idle share.
DSCF attention (--dscf): K4's two forms at DSCF levels 0-3 (bias as K3
writes it, contiguous), K17 at levels 0 and 3 (the packed bias as K18's
layout pads it) and K16 at levels 0-2, 4 images, each timed with CUDA
events over 20 launches through its wrapper (ms; the host's time per call
bounds it for the smallest) and by the profiler's device time of its
kernels (device_ms), beside one SDPA call with the bias as its float mask;
K16 also beside K3 followed by K4's unpacked form.
K18 and K20 (--jmajor-v1): K18 at DSCF levels 0-3 on random positions and
on positions with a third of their coordinates at -1 (as the served model
clamps them), beside F.grid_sample, and K20 at the four Swin stages of 4
tiles, shifted and not, beside SDPA with the bias and region mask as its
float mask, each by CUDA events and by the profiler's device time.
K3 and K6 (--rpe): K3 at DSCF levels 0-3 and K6 at level 3, on random
positions and on positions with a third of their coordinates at -1 or +1,
beside F.grid_sample in the layout each writes, each by CUDA events and by
the profiler's device time; with --port-dir in turns with the parent.
K12, K15 and K8 (--qkv-map-bwd): K12 and K15 at the four Swin stages of 4
tiles, shifted and not, beside SDPA with the bias and region mask as its
float mask (K15's with the window partition and reverse copies it needs),
and K8 at DSCF levels 0-2 of a training batch of 4 beside
``torch.autograd.grad`` through SDPA, each by CUDA events and by the
profiler's device time.
Shares (--shares): the Swin block kernels K1, K2, K5, K10, K13 and K14 on
``chip_smoke.py``'s phase-3 inputs (4 images; K1 and K10 at the four
stages, K2 and K14 at the four, K5 at stages 2-3, K13 at stages 0-1): the
share of outputs that differ from the plain version, the distance on what
the kernel adds, and the kernel's time by CUDA events; with --port-dir on
another checkout's kernels, the inputs drawn alike.
K9 and K19 (--k9-k19): K9 at phase 3's four cases (encoder and decoder
shapes, bf16 and f32) and K19 at its one, each held against its plain
version as phase 3 holds it (chip_smoke.hold: errors, planted fault, CUDA
event times beside the grid_sample and conv2d + layer_norm forms), with the
profiler's device time; the outputs go to DIR/<case>.pt for --same-logits.
Logits (--logits LIST --logits-dir DIR): one request of --batch frames from
--seed under each dispatch of the comma-separated LIST (<dispatch>_flat:
that dispatch on flat frames with the XLA patch embedding;
<dispatch>_flat_pallas: with K19), each predictor built from --seed; the
logits go to DIR/<name>.pt.  ``det``: one seeded 800x1216 detection
request's raw outputs (encoder memory, encoder scores, selected tokens, the
last layer's class logits and boxes) as one file.  --same-logits A B
counts, for each name in both (each tensor of a saved dict), the elements
of A and B that differ: run the first with --port-dir on the parent, then
on the change, to show which paths a change leaves bit for bit as they
were.
--port-dir DIR imports the port package from DIR, another checkout (the
parent commit unpacked with ``git archive``), so that two commits can be
run in turns on one card.
Prints, for each part, its wall time, the summed device time of its kernels,
the device idle share (1 - busy / wall; kernels run on one stream, so their
sum is the busy time), and device time by kernel, the port's own kernels
marked.  The last line is the same as JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

# device kernel names of each port kernel (window_attn_kernel, the first
# design of K1's and K10's attention, is both's: a dispatch runs one of
# them; ln_qkv_kernel, proj_add_kernel and block_tail_kernel are K1's and
# K2's fused launches before their products moved to gemm_mma.cuh, and
# v7_ln_qkv_kernel, v7_proj_tail_kernel, v5_ln_qkv_kernel and
# v5_proj_add_kernel K13's and K14's, for --port-dir; dscf_rows_packed_kernel is K4's
# tensor-core kernel in checkouts where only the packed form ran on it, and
# rpe_rows_kernel, rpe_packed_kernel and rpe_jmajor_kernel K3's, K6's and
# K18's before they shared rpe_plane_kernel, for --port-dir; msdeform_kernel
# and patch_embed_kernel are K9's and K19's first designs, for --port-dir).
# A name with template arguments (K3, K6, K18: one template) matches those
# instances.
BY_KERNEL = {
    "K1": ("swin_ln1_kernel", "gemm_kernel<SwinQkvOut", "swin_attn_mma_kernel",
           "gemm_kernel<SwinProjAdd"),
    "K1/K10 attention": ("window_attn_kernel",),
    "K1 rows": ("ln_qkv_kernel", "proj_add_kernel"),
    "K2": ("block_tail_kernel", "gemm_kernel<TailAdapterUp", "gemm_kernel<TailAdapterDown",
           "tail_ln2_kernel", "gemm_kernel<TailFc1", "gemm_kernel<TailOut"),
    "K5": ("v6_ln1_kernel", "gemm_kernel<QkvOut", "v6_attn_kernel", "v6_attn_mma_kernel",
           "gemm_kernel<ProjOut", "gemm_kernel<AdapterUp", "gemm_kernel<AdapterDown",
           "v6_ln2_kernel", "gemm_kernel<Fc1Out", "gemm_kernel<Fc2Out", "v6_ln_qkv_kernel",
           "proj_tail_kernel"),
    "K3": ("rpe_rows_kernel", "rpe_plane_kernel<Bf16Form, true"),
    "K4": ("dscf_rows_kernel", "dscf_rows_mma_kernel", "dscf_rows_packed_kernel"),
    "K6": ("rpe_packed_kernel", "rpe_plane_kernel<Bf16Form, false"),
    "K7": ("window_attn_bwd_kernel", "window_attn_bwd_mma_kernel"),
    "K8": ("dscf_rows_bwd_kernel",),
    "K9": ("msdeform_kernel", "msdeform_pairs_kernel"),
    "K9 backward": ("msdeform_bwd_kernel",),
    "K10 rows": ("k10_ln1_kernel", "igemm_kernel<K10QkvOut", "k10_att_quant_kernel",
                 "igemm_kernel<K10ProjAdd", "ln_quant_qkv_kernel", "quant_proj_add_kernel"),
    "K10 attention": ("int8_attn_mma_kernel",),
    "K11": ("tail8_ln2_kernel", "gemm_kernel<Tail8AdapterUp", "gemm_kernel<Tail8AdapterDown",
            "igemm_kernel<Tail8Fc1Max", "igemm_kernel<Tail8Fc1Quant", "igemm_kernel<Tail8Fc2",
            "block_tail_int8_kernel"),
    "K12": ("window_attention_qkv_kernel", "window_qkv_mma_kernel"),
    "K13": ("v7_ln1_kernel", "gemm_kernel<V7QkvOut", "v7_attn_kernel", "v7_attn_mma_kernel",
            "gemm_kernel<V7ProjAdd", "gemm_kernel<V7AdapterUp", "gemm_kernel<V7AdapterDown",
            "v7_ln2_kernel", "gemm_kernel<V7Fc1Out", "gemm_kernel<V7Fc2Out", "v7_ln_qkv_kernel",
            "v7_proj_tail_kernel"),
    "K14": ("v5_ln1_kernel", "gemm_kernel<FullQkvOut", "v5_attn_kernel", "v5_attn_mma_kernel",
            "gemm_kernel<FullProjAdd", "v5_ln_qkv_kernel", "v5_proj_add_kernel"),
    "K15": ("window_attention_map_kernel", "window_map_mma_kernel"),
    "K16": ("dscf_fused_kernel", "dscf_fused_mma_kernel"), "K17": ("dscf_attention_kernel",),
    "K18": ("rpe_jmajor_kernel", "rpe_plane_kernel<F32Form"),
    "K19": ("patch_embed_kernel", "patch_embed_mma_kernel"),
    "K20": ("window_attention_v1_kernel", "window_attention_v1_mma_kernel"),
}
PORT_KERNELS = tuple(n for names in BY_KERNEL.values() for n in names)
# K1, K2, K5, K10, K11, K13 and K14 by launch: K1's four, K2's five, K5's
# nine, K10's five, K11's six, K13's nine and K14's four (the LNs, the GEMMs
# by epilogue, the attention), and the launches of their earlier fused
# forms (--port-dir)
BY_LAUNCH = {
    "K1": {"LN1": ("swin_ln1_kernel",), "qkv GEMM": ("gemm_kernel<SwinQkvOut",),
           "attention": ("swin_attn_mma_kernel", "window_attn_kernel"),
           "proj GEMM": ("gemm_kernel<SwinProjAdd",),
           "LN1 + qkv (fused form)": ("ln_qkv_kernel",),
           "proj (fused form)": ("proj_add_kernel",)},
    "K2": {"adapter up GEMM": ("gemm_kernel<TailAdapterUp",),
           "adapter down GEMM": ("gemm_kernel<TailAdapterDown",), "LN2": ("tail_ln2_kernel",),
           "fc1 GEMM": ("gemm_kernel<TailFc1",), "fc2 GEMM": ("gemm_kernel<TailOut",),
           "fused form": ("block_tail_kernel",)},
    "K5": {"LN1": ("v6_ln1_kernel",), "qkv GEMM": ("gemm_kernel<QkvOut",),
           "attention": ("v6_attn_mma_kernel", "v6_attn_kernel"),
           "proj GEMM": ("gemm_kernel<ProjOut",),
           "adapter up GEMM": ("gemm_kernel<AdapterUp",),
           "adapter down GEMM": ("gemm_kernel<AdapterDown",), "LN2": ("v6_ln2_kernel",),
           "fc1 GEMM": ("gemm_kernel<Fc1Out",), "fc2 GEMM": ("gemm_kernel<Fc2Out",),
           "LN1 + qkv (fused form)": ("v6_ln_qkv_kernel",),
           "proj + tail (fused form)": ("proj_tail_kernel",)},
    "K10": {"LN1 + s8 rows": ("k10_ln1_kernel",), "qkv s8 GEMM": ("igemm_kernel<K10QkvOut",),
            "attention": ("int8_attn_mma_kernel", "window_attn_kernel"),
            "attention s8 rows": ("k10_att_quant_kernel",),
            "proj s8 GEMM": ("igemm_kernel<K10ProjAdd",),
            "LN1 + qkv (fused form)": ("ln_quant_qkv_kernel",),
            "proj (fused form)": ("quant_proj_add_kernel",)},
    "K11": {"LN2 + s8 rows": ("tail8_ln2_kernel",),
            "adapter up GEMM": ("gemm_kernel<Tail8AdapterUp",),
            "adapter down GEMM": ("gemm_kernel<Tail8AdapterDown",),
            "W1 s8 GEMM, max pass": ("igemm_kernel<Tail8Fc1Max",),
            "W1 s8 GEMM, quantize pass": ("igemm_kernel<Tail8Fc1Quant",),
            "W2 s8 GEMM": ("igemm_kernel<Tail8Fc2",), "fused form": ("block_tail_int8_kernel",)},
    "K13": {"LN1": ("v7_ln1_kernel",), "qkv GEMM": ("gemm_kernel<V7QkvOut",),
            "attention": ("v7_attn_mma_kernel", "v7_attn_kernel"),
            "proj GEMM": ("gemm_kernel<V7ProjAdd",),
            "adapter up GEMM": ("gemm_kernel<V7AdapterUp",),
            "adapter down GEMM": ("gemm_kernel<V7AdapterDown",), "LN2": ("v7_ln2_kernel",),
            "fc1 GEMM": ("gemm_kernel<V7Fc1Out",), "fc2 GEMM": ("gemm_kernel<V7Fc2Out",),
            "LN1 + qkv (fused form)": ("v7_ln_qkv_kernel",),
            "proj + tail (fused form)": ("v7_proj_tail_kernel",)},
    "K14": {"LN1": ("v5_ln1_kernel",), "qkv GEMM": ("gemm_kernel<FullQkvOut",),
            "attention": ("v5_attn_mma_kernel", "v5_attn_kernel"),
            "proj GEMM": ("gemm_kernel<FullProjAdd",),
            "LN1 + qkv (fused form)": ("v5_ln_qkv_kernel",),
            "proj (fused form)": ("v5_proj_add_kernel",)},
}


def _is(name: str, kernel: str) -> bool:
    """``name`` (a profiler key: a demangled or mangled C++ signature) is the
    device kernel ``kernel`` or an instance of it (a template such as K4's
    two forms), not one whose name contains it; ``kernel<A, b`` is the
    instances whose template arguments start with the class A (in any
    namespace) and the bools b."""
    if "<" in kernel:
        fn, args = kernel.rstrip(">").split("<")
        cls, *flags = [a.strip() for a in args.split(",")]
        demangled = (rf"(?<![A-Za-z0-9_]){fn}<([^<>,]*::)?{cls}"
                     + "".join(rf", {f}" for f in flags) + r"[,>]")
        mangled = (rf"{len(fn)}{fn}I\w*?{len(cls)}{cls}E"
                   + "".join(f"Lb{int(f == 'true')}E" for f in flags))
        return re.search(f"{demangled}|{mangled}", name) is not None
    return re.search(rf"(?<![A-Za-z0-9_]){kernel}(<[^>]*>)?\(|{len(kernel)}{kernel}[EI]",
                     name) is not None


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


def profiled(fn, top=25):
    """Run ``fn`` under the profiler up to a synchronize; returns its result
    and the part's summary (the ``top`` device kernels by time)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for evt in prof.key_averages():
        us = device_us(evt)
        # kernels and copies only: a record_function range mirrored on the
        # device (AdamW's "Optimizer.step#AdamW.step") spans its kernels and
        # is no work; a kernel's own name may hold a '#' too, in a lambda
        # ("{lambda(int)#1}", PyTorch's broadcasting elementwise kernels)
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not re.search(r"#(?!\d+\})", evt.key)):
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    port = sum(r[1] for r in rows if any(_is(r[0], k) for k in PORT_KERNELS))
    def by(labels, count):
        """Device time and launches by label: a port kernel's launches are
        the most of any of its device kernels (K1 runs two a call), a K5
        launch's the sum over its instances (a GEMM's two tiles)."""
        found = {}
        for label, names in labels.items():
            mine = [r for r in rows if any(_is(r[0], k) for k in names)]
            if mine:
                found[label] = dict(ms=sum(r[1] for r in mine),
                                    launches=count(r[2] for r in mine))
        return found

    return out, dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                     port_kernels_ms=port, by_kernel=by(BY_KERNEL, max),
                     by_launch={k: by(labels, sum) for k, labels in BY_LAUNCH.items()},
                     top=[{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:top]])


def show(what: str, part: dict) -> None:
    print(f"{what}: wall {part['wall_ms']:.2f} ms, device busy "
          f"{part['device_busy_ms']:.2f} ms, idle share {part['idle_share']:.3f}; "
          f"port kernels {part['port_kernels_ms']:.2f} ms "
          f"({part['port_kernels_ms'] / part['device_busy_ms']:.3f} of busy)")
    print("  port kernels: " + "; ".join(
        f"{k} {v['ms']:.3f} ms in {v['launches']} launches "
        f"({v['ms'] / v['launches']:.4f} ms each)" for k, v in part["by_kernel"].items()))
    for kernel, launches in part["by_launch"].items():
        if launches:
            print(f"  {kernel} by launch: " + "; ".join(
                f"{k} {v['ms']:.3f} ms in {v['launches']} "
                f"({v['ms'] / v['launches']:.4f} ms each)" for k, v in launches.items()))
    for row in part["top"]:
        mark = "*" if any(_is(row["name"], k) for k in PORT_KERNELS) else " "
        print(f" {mark} {row['ms']:9.3f} ms  x{row['count']:<5d} {row['name'][:100]}")


def profile_request(args) -> dict:
    from ir_ads_tpu_torch.serve import SemSegPredictor

    pred = SemSegPredictor(device="cuda", seed=args.seed, dispatch=args.dispatch,
                           flat_input=args.flat, patch_embed=args.patch_embed,
                           **_model_kw(args))
    g = torch.Generator().manual_seed(args.seed + 1)
    rgb, dep = (torch.randint(0, 256, (args.batch, 480, 640, 3), generator=g,
                              dtype=torch.uint8) for _ in range(2))
    pred(rgb, dep)
    torch.cuda.synchronize()
    lat = []
    for _ in range(args.requests):
        t = time.perf_counter()
        pred(rgb, dep)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    p50 = sorted(lat)[len(lat) // 2] if lat else None
    _, part = profiled(lambda: pred(rgb, dep), args.top)
    flat = f" on flat frames, patch embedding {args.patch_embed}" if args.flat else ""
    show(f"{torch.cuda.get_device_name(0)}; {_model_name(args)}; {args.dispatch}{flat}; "
         f"request of {args.batch} frames", part)
    if lat:
        print(f"p50 of {len(lat)} requests: {p50:.2f} ms ({args.batch / p50 * 1e3:.2f} "
              f"frames/s); each: " + ", ".join(f"{v:.2f}" for v in lat))
    return dict(part, dispatch=args.dispatch, flat_input=args.flat,
                patch_embed=args.patch_embed, backbone=args.backbone, dual_batch=args.dual,
                p50_ms=p50, latencies_ms=lat)


def _model_kw(args) -> dict:
    """--backbone and --dual as the entry points' arguments (none for the
    defaults, which an older checkout's entry points take too)."""
    kw = {} if args.backbone == "SwinTransformer-B" else dict(backbone=args.backbone)
    if args.dual:
        kw["backbone_kwargs"] = dict(dual_batch=True)
    return kw


def _model_name(args) -> str:
    return args.backbone.replace("SwinTransformer", "Swin") + (" dual" if args.dual else "")


def _events_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20) -> float:
    """Device time of ``fn``'s kernels per call, from the profiler: free of
    the host time that bounds _events_ms for a kernel of a few dozen us."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def time_dscf(args) -> dict:
    """K4's two forms at DSCF levels 0-3, K17 at levels 0 and 3 and K16 at
    levels 0-2, at phase 3's shapes, beside SDPA; K16 also beside K3
    followed by K4's unpacked form, the two kernels it fuses."""
    import torch.nn.functional as F

    from ir_ads_tpu_torch.ops import dscf_attention as k17
    from ir_ads_tpu_torch.ops import dscf_fused as k16
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rand = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    scale, hg, m, mp, images, bf = 8 ** -0.5, 2, 600, 640, 4, torch.bfloat16
    rows = []
    for name, levels in (("K4 packed", (0, 1, 2, 3)), ("K4 unpacked", (0, 1, 2, 3)),
                         ("K17", (0, 3)), ("K16", (0, 1, 2))):
        for level in levels:
            h, w, bg = 120 >> level, 160 >> level, images << level
            q = rand(bg, h * w, 16).to(bf)
            kv = [rand(bg, m, 16).to(bf) for _ in range(2)]
            pos = torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1
            table = 0.5 * rand(1 << level, hg, 119, 159)
            if name == "K16":  # K3's bias, as the two kernels K16 fuses meet in it
                bias = k3.rpe_bias_rows(pos, table, h, w, bf)
            else:
                bias = (0.33 * rand(bg, hg, h, m, w)).to(bf)  # K3's spread
            mask = bias.permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m)
            extra = {}
            if name == "K17":
                kv = [F.pad(t, (0, 0, 0, mp - m)) for t in kv]
                mask = F.pad(mask, (0, mp - m), value=k17.NEG_INF)
                bias = mask.transpose(1, 2).reshape(bg, h * w, hg * mp).contiguous()
                run = lambda: k17.dscf_attention(q, *kv, bias, scale, hg)  # noqa: E731
            elif name == "K16":
                run = lambda: k16.dscf_fused_attention(  # noqa: E731
                    q, *kv, pos, table, h, w, scale, hg)
                k3_k4 = lambda: k4.dscf_rows_attention(  # noqa: E731
                    q, *kv, k3.rpe_bias_rows(pos, table, h, w, bf), scale, hg, False)
                extra = dict(k3_k4_ms=_events_ms(k3_k4), k3_k4_device_ms=_device_ms(k3_k4))
            else:
                run = lambda: k4.dscf_rows_attention(  # noqa: E731
                    q, *kv, bias, scale, hg, name == "K4 packed")
            heads = [t.reshape(bg, -1, hg, 8).transpose(1, 2) for t in (q, *kv)]
            mask = mask.contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *heads, attn_mask=mask, scale=scale)
            ms, sdpa_ms = _events_ms(run), _events_ms(sdpa)
            times = dict(ms=ms, device_ms=_device_ms(run), sdpa_ms=sdpa_ms,
                         sdpa_device_ms=_device_ms(sdpa), **extra)
            rows.append(dict(kernel=name, level=level, plane=f"{h}x{w}", bg=bg, **times))
            print(f"{name} level {level} ({h}x{w}, BG {bg}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
            del q, kv, bias, mask, heads, pos, table
            torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), dscf=rows)


def time_jmajor_v1(args) -> dict:
    """K18 at levels 0-3 (random and clamped positions) beside F.grid_sample,
    K20 at the four stages (shifted and not) beside SDPA, at phase 3's
    shapes (4 images)."""
    import torch.nn.functional as F

    from ir_ads_tpu_torch.ops import dscf_rpe_jmajor as k18
    from ir_ads_tpu_torch.ops import window_attention_v1 as k20
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    images, hg, m, bf = 4, 2, 600, torch.bfloat16
    rows = []

    def record(what, run, library, **info):
        times = dict(ms=_events_ms(run), device_ms=_device_ms(run),
                     library_ms=_events_ms(library), library_device_ms=_device_ms(library))
        rows.append(dict(kernel=what, **info, **times))
        print(f"{what} {info}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)

    for clamped in (False, True):
        for level in range(4):
            h, w, groups = 120 >> level, 160 >> level, 1 << level
            bg = images * groups
            pos = torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1
            if clamped:
                pos = torch.where(torch.rand(bg, m, 2, generator=g, device="cuda") < 1 / 3,
                                  -1.0, pos)
            table = 0.5 * torch.randn(groups, hg, 119, 159, generator=g, device="cuda")
            qy = torch.arange(h, device="cuda") / (h - 1) * 2 - 1
            qx = torch.arange(w, device="cuda") / (w - 1) * 2 - 1
            qg = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1).reshape(1, 1, h * w, 2)
            grid = ((qg - pos[:, :, None]) * 0.5)[..., (1, 0)].contiguous()
            tb = table[torch.arange(bg, device="cuda") % groups].contiguous()
            record("K18", lambda: k18.rpe_bias_jmajor(pos, table, h, w, bf),
                   lambda: F.grid_sample(tb, grid, mode="bilinear", align_corners=True),
                   level=level, plane=f"{h}x{w}", bg=bg, clamped=clamped)
            del pos, table, grid, tb
            torch.cuda.empty_cache()
    ws, n = 12, 144
    for hr, wr, c, heads in ((120, 160, 128, 4), (60, 80, 256, 8), (30, 40, 512, 16),
                             (15, 20, 1024, 32)):
        hp, wp = -(-hr // ws) * ws, -(-wr // ws) * ws
        bn, d = images * (hp // ws) * (wp // ws), c // heads
        for shift in (0, 6):
            q, k, v = (torch.randn(bn, heads, n, d, generator=g, device="cuda").to(bf)
                       for _ in range(3))
            bias = torch.randn(heads, n, n, generator=g, device="cuda")
            region = shift_region_ids_on(hp, wp, ws, shift, q.device) if shift else None
            mask = bias.to(bf)[None]
            if region is not None:
                neq = (region[:, :, None] != region[:, None, :]).repeat(bn // region.shape[0],
                                                                        1, 1)
                mask = mask + torch.where(neq, -1e9, 0.0).to(bf)[:, None]
            mask = mask.expand(bn, -1, -1, -1)
            scale = d ** -0.5
            record("K20", lambda: k20.window_attention_v1(q, k, v, bias, region, scale),
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
                   stage_c=c, windows=bn, shift=shift)
            del q, k, v, bias, mask
            torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), kernels=rows)


def time_rpe(args) -> dict:
    """K3 at levels 0-3 and K6 at level 3, at phase 3's shapes (4 images),
    on random positions and on positions with a third of their coordinates
    clamped to -1 or +1, beside F.grid_sample in the layout each writes, by
    CUDA events and by the profiler's device time."""
    import torch.nn.functional as F

    from ir_ads_tpu_torch.ops import dscf_rpe as k3
    from ir_ads_tpu_torch.ops import dscf_rpe_packed as k6

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    images, hg, m, bf = 4, 2, 600, torch.bfloat16
    rows = []
    for name, level in (("K3", 0), ("K3", 1), ("K3", 2), ("K3", 3), ("K6", 3)):
        for clamped in (False, True):
            h, w, groups = 120 >> level, 160 >> level, 1 << level
            bg = images * groups
            pos = torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1
            if clamped:
                at = torch.rand(bg, m, 2, generator=g, device="cuda")
                pos = torch.where(at < 1 / 6, -1.0, torch.where(at < 1 / 3, 1.0, pos))
            table = 0.5 * torch.randn(groups, hg, 119, 159, generator=g, device="cuda")
            qy = torch.arange(h, device="cuda") / (h - 1) * 2 - 1
            qx = torch.arange(w, device="cuda") / (w - 1) * 2 - 1
            qg = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1)
            # K3's rows layout against (BG, hg, HW, M), K6's against (BG, hg, M, HW)
            grid = ((qg.reshape(1, h * w, 1, 2) - pos[:, None]) if name == "K3"
                    else (qg.reshape(1, 1, h * w, 2) - pos[:, :, None]))
            grid = (grid * 0.5)[..., (1, 0)].contiguous()
            tb = table[torch.arange(bg, device="cuda") % groups].contiguous()
            fn = k3.rpe_bias_rows if name == "K3" else k6.rpe_bias_packed
            run = lambda: fn(pos, table, h, w, bf)  # noqa: E731
            library = lambda: F.grid_sample(  # noqa: E731
                tb, grid, mode="bilinear", align_corners=True)
            times = dict(ms=_events_ms(run), device_ms=_device_ms(run),
                         library_ms=_events_ms(library), library_device_ms=_device_ms(library))
            rows.append(dict(kernel=name, level=level, plane=f"{h}x{w}", bg=bg,
                             clamped=clamped, **times))
            print(f"{name} level {level} ({h}x{w}, BG {bg}){' clamped' if clamped else ''}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
            del pos, table, grid, tb
            torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), kernels=rows)


def _chip_smoke():
    """chip_smoke.py as a module (its phase-3 cases), products in full f32."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return c


def swin_shares(args) -> dict:
    """The share of each Swin block kernel's outputs apart from its plain
    version (module docstring, --shares)."""
    c = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    s, b = c.STAGES, 4
    cases = [
        *(("K1", lambda h=h, w=w, ch=ch, hd=hd: c.check_window_block(
            g, b, h, w, ch, hd, 6, "region mask dropped")) for h, w, ch, hd in s),
        *(("K2", lambda h=h, w=w, ch=ch: c.check_block_tail(g, b * h * w, ch))
          for h, w, ch, _ in s),
        *(("K5", lambda h=h, w=w, ch=ch, hd=hd: c.check_window_block_v6(
            g, b, h, w, ch, hd, 6, "adapter dropped")) for h, w, ch, hd in s[2:]),
        *(("K10", lambda i=i, h=h, w=w, ch=ch, hd=hd: c.check_window_block_int8(
            g, b, h, w, ch, hd, 6 * (i != 1))) for i, (h, w, ch, hd) in enumerate(s)),
        *(("K13", lambda h=h, w=w, ch=ch, hd=hd, sh=sh: c.check_window_block_v7(
            g, b, h, w, ch, hd, sh)) for h, w, ch, hd in s[:2] for sh in (0, 6)),
        *(("K14", lambda h=h, w=w, ch=ch, hd=hd, sh=sh: c.check_window_block_full(
            g, b, h, w, ch, hd, sh)) for h, w, ch, hd in s for sh in (0, 6)),
    ]
    rows = []
    for kernel, make in cases:
        case = make()
        got, want = case["run"](), case["plain"]()
        torch.cuda.synchronize()
        row = dict(kernel=kernel, case=case["case"], share=float((got != want).float().mean()),
                   rel=c._rel(got, want, case["base"]), ms=c.time_ms(case["run"]))
        print(f"{kernel:4s} {row['case']:<38} outputs apart {row['share']:.5f}, "
              f"rel {row['rel']:.3e}, kernel {row['ms']:.4f} ms", flush=True)
        rows.append(row)
        del got, want, case
        torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), cases=rows)


def time_k9_k19(args) -> dict:
    """K9 at phase 3's four cases and K19 at its one (--k9-k19): each held
    against its plain version by chip_smoke.hold (errors, planted fault,
    times by CUDA events beside the grid_sample and conv2d + layer_norm
    forms), its device time by the profiler, and its output saved to
    --logits-dir for --same-logits."""
    c = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    s_det, bf, f32 = sum(h * w for h, w in c.DET_LEVELS), torch.bfloat16, torch.float32
    os.makedirs(args.logits_dir, exist_ok=True)
    cases = [
        ("k9_encoder_bf16", lambda: c.check_msdeform(g, s_det, bf, "no -0.5")),
        ("k9_decoder_bf16", lambda: c.check_msdeform(g, c.DET_QUERIES, bf, "zeros padding lost")),
        ("k9_encoder_f32", lambda: c.check_msdeform(g, s_det, f32, "zeros padding lost")),
        ("k9_decoder_f32", lambda: c.check_msdeform(g, c.DET_QUERIES, f32, "no -0.5")),
        ("k19", lambda: c.check_patch_embed(g, 4)),
    ]
    rows = []
    for name, make in cases:
        case = make()
        run = case["run"]
        torch.save(run().cpu(), os.path.join(args.logits_dir, f"{name}.pt"))
        device_ms = _device_ms(run)
        row = c.hold(case)
        rows.append(dict(case=name, device_ms=device_ms, **{
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "rel_err")}))
        print(f"{name}: device {device_ms:.4f} ms", flush=True)
        del case, run, row
        torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), kernels=rows)


def time_qkv_map_bwd(args) -> dict:
    """K12 and K15 at the four stages (shifted and not) beside SDPA, and K8
    at DSCF levels 0-2 beside autograd.grad through SDPA, at phase 3's
    shapes (4 images; K8 a training batch of 4)."""
    import torch.nn.functional as F

    from ir_ads_tpu_torch.ops import dscf_rows_bwd as k8
    from ir_ads_tpu_torch.ops import window_attention_map as k15
    from ir_ads_tpu_torch.ops import window_attention_qkv as k12
    from ir_ads_tpu_torch.ops.window_attention import (
        shift_region_ids_on, window_partition, window_reverse,
    )

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rand = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    images, bf, ws, n = 4, torch.bfloat16, 12, 144
    rows = []

    def record(what, run, library, **info):
        times = dict(ms=_events_ms(run), device_ms=_device_ms(run),
                     library_ms=_events_ms(library), library_device_ms=_device_ms(library))
        rows.append(dict(kernel=what, **info, **times))
        print(f"{what} {info}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)

    for hr, wr, c, heads in ((120, 160, 128, 4), (60, 80, 256, 8), (30, 40, 512, 16),
                             (15, 20, 1024, 32)):
        hp, wp = -(-hr // ws) * ws, -(-wr // ws) * ws
        bn, scale = images * (hp // ws) * (wp // ws), (c // heads) ** -0.5
        for shift in (0, 6):
            qkv = rand(images, hp, wp, 3 * c).to(bf)
            wins = window_partition(qkv, ws).contiguous()
            bias = rand(heads, n, n)
            region = shift_region_ids_on(hp, wp, ws, shift, qkv.device) if shift else None
            mask = bias.to(bf)[None]
            if region is not None:
                neq = (region[:, :, None] != region[:, None, :]).repeat(images, 1, 1)
                mask = mask + torch.where(neq, -1e9, 0.0).to(bf)[:, None]
            mask = mask.expand(bn, -1, -1, -1)
            split = lambda t: [t[..., i * c:(i + 1) * c].reshape(  # noqa: E731
                t.shape[0], n, heads, c // heads).transpose(1, 2) for i in range(3)]
            sdpa = lambda t: F.scaled_dot_product_attention(  # noqa: E731
                *split(t), attn_mask=mask, scale=scale)
            record("K12", lambda: k12.window_attention_qkv(wins, bias, region, scale, heads),
                   lambda: sdpa(wins), stage_c=c, windows=bn, shift=shift)
            record("K15", lambda: k15.window_attention_map(qkv, bias, region, scale, heads, ws),
                   lambda: window_reverse(sdpa(window_partition(qkv, ws)).transpose(1, 2)
                                          .reshape(bn, n, c), ws, hp, wp),
                   stage_c=c, map=f"{hp}x{wp}", shift=shift)
            del qkv, wins, bias, mask
            torch.cuda.empty_cache()
    hg, m, scale = 2, 600, 8 ** -0.5
    for level in range(3):
        h, w, bg = 120 >> level, 160 >> level, images << level
        q, k, v, dout = (rand(bg, rows_, 16).to(bf) for rows_ in (h * w, m, m, h * w))
        bias = (0.33 * rand(bg, hg, h, m, w)).to(bf)  # K3's spread
        heads_of = lambda t, rows_: t.reshape(bg, rows_, hg, 8).transpose(1, 2)  # noqa: E731
        leaves = [heads_of(q, h * w).detach().requires_grad_(),
                  heads_of(k, m).detach().requires_grad_(),
                  heads_of(v, m).detach().requires_grad_(),
                  bias.permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m).contiguous()
                  .requires_grad_()]
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)
        do = heads_of(dout, h * w)
        record("K8", lambda: k8.dscf_rows_bwd(q, k, v, bias, dout, scale, hg),
               lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
               level=level, plane=f"{h}x{w}", bg=bg)
        del q, k, v, dout, bias, leaves, out, do
        torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), kernels=rows)


def _det_request(seed: int):
    """The seeded detector and its one 800x1216 image (--det, --logits det)."""
    from ir_ads_tpu_torch.serve import DetPredictor

    pred = DetPredictor(device="cuda", seed=seed)
    g = torch.Generator().manual_seed(seed + 3)
    image = torch.randint(0, 256, (1, 800, 1216, 3), generator=g, dtype=torch.uint8).cuda()
    return pred, image


def det_outputs(seed: int) -> dict:
    """One detection request's raw outputs: the encoder memory and proposal
    scores, the selected tokens, the last decoder layer's class logits and
    boxes (read by a forward hook on the transformer)."""
    pred, image = _det_request(seed)
    seen = {}
    hook = pred.model.transformer.register_forward_hook(lambda mod, a, out: seen.update(out))
    try:
        with torch.no_grad():
            pred.model(image, want_masks=False)
    finally:
        hook.remove()
    return dict(memory=seen["memory"], enc_scores=seen["enc_scores"],
                topk_idx=seen["topk_idx"], logits=seen["pred_logits"][-1],
                boxes=seen["pred_boxes"][-1])


def build_every_kernel() -> None:
    """Build every CUDA kernel of the imported port package at once (one
    nvcc a source, in parallel), as ``chip_smoke.py``'s phase 2 does, so
    that a run that meets them one by one does not build them in turn."""
    import importlib
    import pkgutil

    import ir_ads_tpu_torch.ops as ops
    from ir_ads_tpu_torch.ops.cuda_lib import CudaKernel, build_all

    mods = [importlib.import_module(f"{ops.__name__}.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__)]
    build_all([m.KERNEL for m in mods if isinstance(getattr(m, "KERNEL", None), CudaKernel)])


def save_logits(args) -> dict:
    """One request's logits under each dispatch of --logits, into
    --logits-dir; ``det``: one detection request's raw outputs."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    build_every_kernel()
    os.makedirs(args.logits_dir, exist_ok=True)
    g = torch.Generator().manual_seed(args.seed + 1)
    rgb, dep = (torch.randint(0, 256, (args.batch, 480, 640, 3), generator=g,
                              dtype=torch.uint8) for _ in range(2))
    saved = {}
    for name in args.logits.split(","):
        path = os.path.join(args.logits_dir, f"{name}.pt")
        if name == "det":
            outs = det_outputs(args.seed)
            torch.save({k: v.cpu() for k, v in outs.items()}, path)
            saved[name] = dict(path=path, shapes={k: list(v.shape) for k, v in outs.items()},
                               finite=all(bool(torch.isfinite(v.float()).all())
                                          for v in outs.values()))
            print(f"det: {', '.join(f'{k} {tuple(v.shape)}' for k, v in outs.items())} "
                  f"-> {path}", flush=True)
            del outs
            torch.cuda.empty_cache()
            continue
        # <dispatch>_flat: flat frames, the XLA patch embedding;
        # <dispatch>_flat_pallas: flat frames through K19
        base, _, embed = name.partition("_flat")
        flat = name != base
        pred = SemSegPredictor(device="cuda", seed=args.seed, dispatch=base, flat_input=flat,
                               patch_embed="pallas" if embed == "_pallas" else "xla",
                               backbone=args.backbone)
        logits, _ = pred(rgb, dep)
        torch.save(logits.cpu(), path)
        saved[name] = dict(path=path, shape=list(logits.shape),
                           finite=bool(torch.isfinite(logits).all()))
        print(f"{name}: logits {tuple(logits.shape)} -> {path}", flush=True)
        del pred, logits
        torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), logits=saved)


def same_logits(dir_a: str, dir_b: str) -> dict:
    """For each name saved in both directories, how many elements differ
    (for a saved dict of tensors, key by key), and for floats that differ
    the largest difference and the mean difference over A's mean size."""
    names = sorted(f[:-3] for f in os.listdir(dir_a)
                   if f.endswith(".pt") and os.path.exists(os.path.join(dir_b, f)))
    out = {}
    for name in names:
        a, b = (torch.load(os.path.join(d, f"{name}.pt")) for d in (dir_a, dir_b))
        pairs = ({f"{name}.{k}": (a[k], b[k]) for k in a} if isinstance(a, dict)
                 else {name: (a, b)})
        for key, (x, y) in pairs.items():
            out[key] = dict(differ=int((x != y).sum()), of=x.numel())
            far = ""
            if out[key]["differ"] and x.is_floating_point():
                d = (x.float() - y.float()).abs()
                out[key].update(max_abs=float(d.max()),
                                rel_mean=float(d.mean() / x.float().abs().mean()))
                far = (f" (max |diff| {out[key]['max_abs']:.3e}, mean |diff| / mean |A| "
                       f"{out[key]['rel_mean']:.3e})")
            print(f"{key}: {out[key]['differ']} of {x.numel()} elements differ{far}", flush=True)
    return dict(a=dir_a, b=dir_b, logits=out)


def profile_eval(args) -> dict:
    from ir_ads_tpu_torch.evaluation.semseg_eval import align32, make_forward_fn, msf_logits
    from ir_ads_tpu_torch.val_mm import build_eval_model

    smoke = _chip_smoke()
    cfg = smoke.eval_config("msf")
    cfg["MODEL"]["BACKBONE"] = args.backbone
    model = build_eval_model(cfg, smoke.NUM_CLASSES, "cuda", "r5", args.seed)
    forward = make_forward_fn(model)
    g = torch.Generator().manual_seed(args.seed + 1)
    rgb = torch.randn((1, *smoke.IMAGE, 3), generator=g).cuda()
    dte = torch.rand((1, *smoke.IMAGE, 3), generator=g).cuda()
    scales = smoke.EVAL_SCALES
    msf_logits(forward, rgb, dte, scales)
    torch.cuda.synchronize()
    out = {}
    for s in scales:
        size = (align32(s * smoke.IMAGE[0]), align32(s * smoke.IMAGE[1]))
        _, part = profiled(lambda: msf_logits(forward, rgb, dte, (s,)), args.top)
        show(f"{torch.cuda.get_device_name(0)}; {_model_name(args)}; r5 MSF scale {s} "
             f"({size[0]}x{size[1]}, image and flip)", part)
        out[str(s)] = part
    _, part = profiled(lambda: msf_logits(forward, rgb, dte, scales), args.top)
    show(f"{torch.cuda.get_device_name(0)}; {_model_name(args)}; r5 MSF image, six scales "
         "with flip", part)
    out["image"] = part
    return dict(out, peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def profile_step(args) -> dict:
    from ir_ads_tpu_torch.train import SemSegTrainer
    from ir_ads_tpu_torch.training.optim import set_lr
    from ir_ads_tpu_torch.training.train_state import compute_loss

    tr = SemSegTrainer(device="cuda", seed=args.seed, **_model_kw(args))
    g = torch.Generator().manual_seed(args.seed + 2)
    rgb = torch.randn(args.batch, 480, 640, 3, generator=g)
    dte = torch.rand(args.batch, 480, 640, 3, generator=g)
    label = torch.randint(0, 40, (args.batch, 480, 640), generator=g)
    for _ in range(2):
        tr.step(rgb, dte, label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # one step of train_state.train_step, taken apart
    batch = tr.batch(rgb, dte, label)
    tr.optimizer.zero_grad(set_to_none=True)
    (loss, _), fwd = profiled(lambda: compute_loss(
        tr.model, batch, tr.loss_fn, tr.generator, tr.ignore_label), args.top)
    _, bwd = profiled(loss.backward, args.top)
    set_lr(tr.optimizer, tr.schedule(tr.steps))
    _, upd = profiled(tr.optimizer.step, args.top)
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = (f"{torch.cuda.get_device_name(0)}; {_model_name(args)}; train; step of "
            f"{args.batch} frames")
    for what, part in (("forward + loss", fwd), ("backward", bwd), ("optimizer", upd)):
        show(f"{card}; {what}", part)
    busy = sum(p["device_busy_ms"] for p in (fwd, bwd, upd))
    wall = sum(p["wall_ms"] for p in (fwd, bwd, upd))
    print(f"{card}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}, peak memory {peak:.2f} GiB")
    k7 = bwd["by_kernel"].get("K7", dict(ms=0.0, launches=0))
    print(f"{card}: K7 {k7['ms']:.3f} ms in {k7['launches']} launches, "
          f"{k7['ms'] / busy:.3f} of the step's device busy time")
    return dict(dispatch="train", backbone=args.backbone, dual_batch=args.dual,
                batch=args.batch, wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall, peak_memory_gib=peak, forward=fwd,
                backward=bwd, optimizer=upd, k7_ms=k7["ms"], k7_share=k7["ms"] / busy)


def profile_det_step(args) -> dict:
    """One full-width DINO-R50 training step (``chip_smoke.py`` phase 12's
    trainer and batch, --det-train) taken apart: the teacher, student and
    losses; the backward; the optimizer and the EMA update."""
    c = _chip_smoke()
    state = c._det_trainer(args.seed)
    batch = c._det_train_batch(args.seed)
    for _ in range(2):
        state.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def forward():
        draws = state.draws(batch[0].shape[0])
        return state.losses(state.params, batch, draws, state.teacher(batch[1]))[0]

    total, fwd = profiled(forward, args.top)
    grads, bwd = profiled(lambda: torch.autograd.grad(
        total, list(state.params.values()), allow_unused=True), args.top)

    _, upd = profiled(lambda: state.apply_gradients(grads), args.top)
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = (f"{torch.cuda.get_device_name(0)}; DINO-R50 train step of "
            f"{c.DET_TRAIN_BATCH} images {c.DET_TRAIN_IMAGE[0]}x{c.DET_TRAIN_IMAGE[1]}, "
            f"{c.DET_QUERIES} queries + {c.DET_TRAIN_DN_QUERIES} CDN")
    for what, part in (("teacher + student + losses", fwd), ("backward", bwd),
                       ("optimizer + EMA", upd)):
        show(f"{card}; {what}", part)
    busy = sum(p["device_busy_ms"] for p in (fwd, bwd, upd))
    wall = sum(p["wall_ms"] for p in (fwd, bwd, upd))
    k9 = {k: sum(p["by_kernel"].get(k, dict(ms=0.0))["ms"] for p in (fwd, bwd))
          for k in ("K9", "K9 backward")}
    print(f"{card}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}, peak memory {peak:.2f} GiB; K9 {k9['K9']:.3f} ms, its "
          f"backward {k9['K9 backward']:.3f} ms, "
          f"{(k9['K9'] + k9['K9 backward']) / busy:.3f} of the device busy time")
    turns = auction_read_turns(state, batch)
    print(f"{card}: step ms in turns by the auction's host-read period (iterations) "
          + "; ".join(f"{k}: {['%.1f' % v for v in vs]}, p50 {sorted(vs)[len(vs) // 2]:.1f}"
                      for k, vs in turns.items()))
    return dict(what="det_train", batch=c.DET_TRAIN_BATCH, wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall, peak_memory_gib=peak, forward=fwd, backward=bwd,
                optimizer=upd, k9_ms=k9["K9"], k9_backward_ms=k9["K9 backward"],
                auction_read_turns=turns)


def auction_read_turns(state, batch, rounds: int = 4) -> dict:
    """Unprofiled steps in turns with the auction reading its flag on the
    host every iteration and every ``AUCTION_CHECK_EVERY`` (the shipped
    period; the assignments are the same): step ms by period."""
    from ir_ads_tpu_torch.detection import matcher

    shipped = matcher.AUCTION_CHECK_EVERY
    out = {1: [], shipped: []}
    try:
        for r in range(rounds):
            for every in (1, shipped) if r % 2 == 0 else (shipped, 1):
                matcher.AUCTION_CHECK_EVERY = every
                torch.cuda.synchronize()
                t = time.perf_counter()
                state.train_step(batch)
                torch.cuda.synchronize()
                out[every].append((time.perf_counter() - t) * 1e3)
    finally:
        matcher.AUCTION_CHECK_EVERY = shipped
    return out


def launch_ms(fn, names) -> list:
    """Device time (ms) of each launch of the device kernels ``names`` in
    one profiled call of ``fn``, in the order they ran."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    runs = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(_is(e.key, k) for k in names)]
    runs.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in runs]


def profile_detection(args) -> dict:
    pred, image = _det_request(args.seed)
    pred(image)
    torch.cuda.synchronize()
    card = f"{torch.cuda.get_device_name(0)}; detection; request of 1 image 800x1216"

    # the request's timeline by module, before the profiler runs: CUDA events
    # at each module's ends.  An event fires when the device reaches it, so a
    # span holds the module's kernels and the device's waits for the host
    m, marks = pred.model, []

    def mark(name):
        def hook(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))
        return hook

    mods = {"backbone": m.backbone, "neck": m.neck, "encoder": m.transformer.encoder.layers,
            "decoder": m.transformer.decoder.layers}
    hooks = []
    for name, mod in mods.items():
        first, last = (mod[0], mod[-1]) if isinstance(mod, torch.nn.ModuleList) else (mod, mod)
        hooks.append(first.register_forward_pre_hook(mark(name + " start")))
        hooks.append(last.register_forward_hook(mark(name + " end")))
    with torch.no_grad():
        mark("request start")()
        out = pred.model(image, want_masks=True)
        mark("model end")()
        pred.postprocess(out)
        mark("request end")()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    at = {name: marks[0][1].elapsed_time(e) for name, e in marks}
    by_module = {name: at[name + " end"] - at[name + " start"] for name in mods}
    by_module["two-stage selection"] = at["decoder start"] - at["encoder end"]
    by_module["seg map, mask and ROI heads"] = at["model end"] - at["decoder end"]
    by_module["post-processing"] = at["request end"] - at["model end"]
    total = at["request end"]
    del out  # 0.85 GB of mask logits: one copy alive while the peak is read
    print(f"{card}: timeline by module (CUDA events, no profiler; waits for the host "
          "included), ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in by_module.items()) + f"; request {total:.2f}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out, model = profiled(lambda: pred.model(image, want_masks=True), args.top)
        _, post = profiled(lambda: pred.postprocess(out), args.top)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for what, part in (("model", model), ("post-processing", post)):
        show(f"{card}; {what}", part)

    busy = model["device_busy_ms"] + post["device_busy_ms"]
    wall = model["wall_ms"] + post["wall_ms"]
    print(f"{card}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}, K9 {model['port_kernels_ms']:.2f} ms "
          f"({model['port_kernels_ms'] / busy:.3f} of busy), peak memory {peak:.2f} GiB")
    # K9 by launch: the encoder's self-attentions run first, then the
    # decoder's cross-attentions
    with torch.no_grad():
        k9 = launch_ms(lambda: pred.model(image, want_masks=True), BY_KERNEL["K9"])
    n_enc = len(m.transformer.encoder.layers)
    enc, dec = k9[:n_enc], k9[n_enc:]
    print(f"{card}: K9 by launch, ms: encoder ({len(enc)}) {sum(enc):.3f} = "
          + " / ".join(f"{t:.4f}" for t in enc) + f"; decoder ({len(dec)}) {sum(dec):.3f} = "
          + " / ".join(f"{t:.4f}" for t in dec))
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                peak_memory_gib=peak, model=model, postprocess=post, by_module_ms=by_module,
                request_ms_no_profiler=total, k9_encoder_ms=enc, k9_decoder_ms=dec)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per request (default 2) or per step (default 4)")
    ap.add_argument("--dispatch", default="r5",
                    choices=("r5", "r4", "r4i8", "r2", "r1", "xla", "v7_01", "v5", "map",
                             "dscf_pallas4", "dscf_pallas", "dscf_pallas2"))
    ap.add_argument("--backbone", default="SwinTransformer-B",
                    choices=("SwinTransformer-B", "SwinTransformer-L",
                             *(f"{f}-B{i}" for f in ("CMNeXt", "CMX") for i in range(6))),
                    help="serving, --eval, --train and --logits: the model's backbone")
    ap.add_argument("--dual", action="store_true",
                    help="serving and --train: both streams through each stage in one call")
    ap.add_argument("--flat", action="store_true",
                    help="serve flat (B, H, W*3) frames, as the bench feeds them")
    ap.add_argument("--patch-embed", default="xla", choices=("xla", "xla2", "pallas"),
                    help="the patch embedding's flat path (pallas: K19; needs --flat)")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of one request")
    ap.add_argument("--eval", action="store_true",
                    help="one MSF image of the eval entry point, scale by scale")
    ap.add_argument("--det-train", action="store_true",
                    help="one DINO-R50 training step: forward, backward, optimizer")
    ap.add_argument("--det", action="store_true",
                    help="profile one detection request instead")
    ap.add_argument("--dscf", action="store_true",
                    help="time K4's two forms, K16 and K17 beside SDPA instead")
    ap.add_argument("--jmajor-v1", action="store_true",
                    help="time K18 beside F.grid_sample and K20 beside SDPA instead")
    ap.add_argument("--rpe", action="store_true",
                    help="time K3 (levels 0-3) and K6 (level 3) beside F.grid_sample instead")
    ap.add_argument("--qkv-map-bwd", action="store_true",
                    help="time K12 and K15 beside SDPA and K8 beside autograd.grad instead")
    ap.add_argument("--shares", action="store_true",
                    help="print the Swin block kernels' shares of outputs apart instead")
    ap.add_argument("--k9-k19", action="store_true",
                    help="hold and time K9 and K19 at phase 3's cases, saving their outputs")
    ap.add_argument("--logits", default=None,
                    help="comma-separated dispatches whose logits to save instead "
                         "(<dispatch>_flat, <dispatch>_flat_pallas: flat frames; det: "
                         "a detection request's raw outputs)")
    ap.add_argument("--logits-dir", default="output/logits",
                    help="where --logits saves them")
    ap.add_argument("--same-logits", nargs=2, default=None, metavar=("A", "B"),
                    help="count the logits that differ between two --logits-dir")
    ap.add_argument("--requests", type=int, default=0,
                    help="serving: first time this many requests and print their p50")
    ap.add_argument("--port-dir", default=None,
                    help="import the port package from this checkout instead")
    ap.add_argument("--top", type=int, default=25, help="device kernels to list by time")
    args = ap.parse_args()
    if args.same_logits:
        print(json.dumps(same_logits(*args.same_logits)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: CUDA is not available")
    if args.port_dir:
        sys.path.insert(0, os.path.abspath(args.port_dir))
    import ir_ads_tpu_torch

    print(f"port package: {os.path.dirname(ir_ads_tpu_torch.__file__)}; "
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    if args.batch is None:
        args.batch = 4 if args.train else 2
    run = (time_dscf if args.dscf else time_jmajor_v1 if args.jmajor_v1
           else time_rpe if args.rpe
           else time_qkv_map_bwd if args.qkv_map_bwd else save_logits if args.logits
           else swin_shares if args.shares else time_k9_k19 if args.k9_k19
           else profile_det_step if args.det_train
           else profile_detection if args.det else profile_eval if args.eval
           else profile_step if args.train else profile_request)
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
