#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--batch 2]

Phases, each of which raises on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the slice from csrc/ (one nvcc per source,
     all started together) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the main paths (serving under r5, r4i8, r2, r1,
     v7_01, v5 and map, training, detection) give it (K12 also under
     autograd: its output and the gradients its backward, the plain
     version's vjp, gives), element by element and on what the kernel adds
     (the branch, for the residual kernels); K3 (levels 0-3) and K6 (level
     3, and level 2's 30x40 plane, the legacy CMNeXt's stage 2) bit for
     bit, each also on positions with a third of their
     coordinates clamped to -1 or +1 and on positions where the kernel
     searches the four taps of an axis (K3 at level 0); show
     that a planted fault in the plain version fails the same bar (for K3
     and K6 the all-f32 form that rounds only the output); hold K13, K14
     and K15 bit for bit against the compositions of kernels they replace
     (K1, un-roll and crop, K2; pad and roll, K1, un-roll and crop;
     partition, K12, reverse); the DSCF variants' kernels: K18 (the pallas2
     bias, f32 form) at levels 0-3 on random positions and on positions
     with a third of their coordinates at -1 or +1, also bit for bit against
     ``rpe_bias_jmajor_ordered`` (its own sequence of roundings in torch
     elementwise ops), K17 (the pallas / pallas2 attention, on K18's
     packed bias) at levels 0 and 3, K16 (pallas4) at levels 0-2, bit
     for bit against K3 followed by K4 with packed=False (and not against
     K4's packed form), K4's packed form at levels 0-2 and its unpacked
     form at levels 0-3, each also held to a share of differing outputs
     (planted faults: K3's rounding for K18, padded bias columns 0 for K17,
     the packed form for K16 and K4's unpacked form, the rpe bias dropped
     for K4's packed form); K4's unpacked form at the MiT's head widths
     (10 channels at the 30x40 plane of BG 16, 4 and 5 at CMNeXt-B0's four
     stages), held to ``ROUNDING_SHARE`` (planted faults: a head's last
     channel dropped, or each head's first channel overwritten by the
     previous head's last, as a store past the head would leave it); K4's
     two forms, K17 and K16 over the shape envelope (the tiny
     configurations' planes, odd widths, tiles over several image rows,
     more keys than the tensor-core design takes; K4's unpacked form also
     at 4, 5 and 10 channels a head; K16 also bit for bit against K3
     followed by K4 unpacked);
     K19 (the flat patch embedding) on one stream of a request's flat
     frames (planted fault: the XLA form, whose LayerNorm scale and bias
     stay f32; F.conv2d then F.layer_norm timed for the record) and K20
     (the v1 window attention, which no model path runs) at the four
     stages, shifted and not, on the tensor cores (planted faults: the
     region mask left out, the twin's form that rounds q * bf16(scale)),
     outside the tensor-core design's shapes in bf16 (d = 64) and in f32,
     where it takes the thread design, and once under autograd (its
     gradients, the twin's vjp, against the twin's; K12's and K20's autograd
     cases time torch.autograd.grad through SDPA as their library call);
     K1 (stages 0-3), K2 (stages 0-1), K5 (stages 2-3), K13 (stages 0-1)
     and K14 (stages 0-3) also by launch of their sequences (four, five,
     nine, nine and four; the profiler's device time), each GEMM beside
     torch.matmul at its (M, N, K); K10 and K11 (stages
     0-3) by launch of theirs (five and six), each s8 GEMM beside
     torch._int_mm at its (M, N, K); their s8 GEMM (csrc/igemm.cuh) at each
     of the sixteen products of the four stages, its raw s32 output equal to
     torch._int_mm's bit for bit (planted fault: the last 32 of k dropped);
     K11's two W1 passes against the f32 hidden of the same helper written
     out: the row max, the scale and the codes bit for bit (planted fault:
     the max of one 64-column chunk); K1, K5, K10, K13 and
     K14 each held to a share of differing outputs of its own
     (SWIN_SHARE: their plain versions' cuBLAS order sets it), and each
     once at d = 64, outside the tensor-core design, on its attention's
     first design (K1, K10, K13 on the map, K5, K14 on the real map); K7 at
     the four stages on the tensor cores and once at d = 16 on its first
     design; then, for the record,
     the share of K1's outputs at stage 0 and K4's at level 0 that the
     parent commit's f32 attention scale moves;
     print the errors against the stated tolerances and the kernel's, the
     plain version's and (where one PyTorch call computes the same
     function) the library call's times;
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
     everywhere); then the same weights and requests under the w8a8 ``r4i8``
     dispatch (K10 + K11 at every block, K3 + K4 at every level, the DSCF
     and head products in s8): launches, shapes, finiteness, one request's
     logits against the all-plain r4i8 path on the card (a K10 without its
     region mask must fail), p50 and frames/s beside r5's, and, with no
     bar, the logit distance and label agreement between r4i8 and r5; then
     the bench's module-path sets on the same weights and requests: r2 (the
     module path of every block with K12 and K2, K3 + K4 at every level;
     launches per request K12 48, K2 48, K3 4, K4 4; a K12 without its
     region mask must fail the logit bar), r1 (K12 48, K2 48, the einsum
     DSCF with its XLA-form bias) and xla (``window_attention`` with the
     -100 mask, K2 48), each against its own all-plain path, with p50,
     frames/s, peak memory and, with no bar, the distance from r2 and r5;
     then the block variants on the same weights and requests: v7_01 (r5
     with K13 at stages 0-1: K13 8, K5 40, K3 3, K4 3, K6 1 per request), v5
     (r4 with K14: K14 48, K2 48, K3 4, K4 4) and map (r2 with K15 on the
     qkv map: K15 48, K2 48, K3 4, K4 4), each against its own all-plain
     path, v7_01's logits bit-equal to r5's and v5's to r4's, map's
     compared with r2's and printed, with p50, frames/s and peak memory;
     under r4, r4i8, r2, v5 and map, how far K4's packed form at level 3
     (before the repair) moves the logits, printed; then the DSCF variants
     on r5's blocks: dscf_pallas4 (K16 at levels 0-2, K6 and the einsum at
     level 3: K16 3, K6 1, K1 8, K2 8, K5 40 per request), dscf_pallas (K17
     4) and dscf_pallas2 (K18 4, K17 4), each launch of K16, K17 and K18 in
     one request against its plain version on its own inputs (phase 3's
     planted faults must fail), the logits against each dispatch's
     all-plain path and, tighter, against the same path with the variant's
     kernels alone plain (a planted fault in each variant must fail), each
     served in turns with r5; then r5 on flat (B, H, W*3) frames
     (``flat_input=True``): with the XLA patch embedding, logits bit-equal
     to r5's; with K19 (``patch_embed="pallas"``, 2 launches a request),
     each launch against its plain version on its own inputs, stage 0's
     output against the same path with K19 alone plain (the XLA form must
     fail both bars; the logits cannot tell them apart and are printed),
     served in turns with r5; r5's and the flat path's logits under the
     parent's f32 attention scale, printed (no bar);
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
     step time, images per second and peak memory;
  6. detect: ``DetPredictor`` (vCLR deformable-mask DINO at the full width
     and depth of configs/detection/dino_r50.py: frozen-BN ResNet-50, 4
     levels at 256 channels, 6 + 6 layers, 2000 queries, 20 classes, mask and
     ROI heads, bf16, weights drawn from --seed, the zero-initialised
     sampling projections included) on one 800x1216 image per request, a
     warm-up and 3 requests: shapes, finiteness, 12 launches of K9 per
     request and none of K1-K8; each of a request's 12 launches against its
     plain version on that launch's own inputs (a plain version without the
     -0.5 of the pixel coordinate in one decoder layer must fail the bar);
     the encoder memory and the proposal scores before the top-k selection
     against the all-plain path on the card (the same planted fault, in
     every layer, must fail), then the share of the 2000 selected tokens and
     of the kept boxes that agree; the last layer's class logits and boxes
     of the kernel path run on the plain path's selected tokens against the
     plain path's (the planted fault in the decoder layers alone must fail);
     p50 request time, images per second, the post-processing's share, peak
     memory; and, with no bar, how far the parent's f32 attention scale
     moves the encoder memory and the proposal scores (K9 attends there:
     they do not move) and the last decoder layer's class logits and boxes
     (the decoder's self-attention scales q);
  7. evaluate: ``ir_ads_tpu_torch.val_mm.main`` on the card with a config
     dict (``eval_config``: configs/nyu_rgbd.yaml's EVAL section, MSF at
     the six scales 0.5-1.75 with flip, batch 1, the Swin-B CMNeXt in bf16
     under r5, on the Synthetic dataset at 480x640 with 40 classes, 4 val
     images, weights from --seed; no image, YAML or checkpoint reader is
     reached).  Each call of the eval forward is counted: its input shape,
     the launches of each kernel (K1 8, K2 8 and K5 40 at every scale; K3
     and K4 3 at scales 0.5-1.0 and 0 at 1.25-1.75, where 2n % 8 != 0; K6 2
     at 1.25, where level 2's 38x50 plane takes it too, else 1:
     ``EVAL_LAUNCHES``, also against ``expected_launches`` at each scale's
     size) and finite logits.  On one image every launch of the six kernels
     at all six scales is held against its plain version on its own inputs
     with phase 3's bars (the distance on what it adds, each element within
     atol x rms + rtol, and a share apart: K1 and K5 their ``SWIN_SHARE``, K4
     ``ROUNDING_SHARE``, K3 and K6 bit for bit), each kernel's planted fault
     failing them over the image's launches; that image's MSF probabilities against the all-plain path
     (``EVAL_PROB_TOL``), where a K5 without its shift-region mask must
     fail.  Then single-scale and sliding (a 384x384 tile, overlap 1/3,
     flip: 8 tiles an image) once each, with the same checks on launches
     and finiteness.  Prints mIoU, ms per image and images/s (p50 over the
     images after the first), peak memory and the card line;
  8. train_mm: ``ir_ads_tpu_torch.train_mm.main`` on the card with
     ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_train.yaml (the Swin-B
     CMNeXt at 480x640, batch 4, bf16 compute on f32 masters, adapter-only
     AdamW, the recipe's dropout, drop-path and modality mask, Synthetic
     with 8 train and 2 val images, 2 epochs, weights from --seed; this
     phase reads the YAML file and writes checkpoints, so it comes after
     phase 7's check that nothing of the kind was imported): every epoch's
     loss and the gate's mIoU finite, every step's launches
     ``TRAIN_LAUNCHES``, each gate r5's single-scale launches for its two
     images, best/ and latest/ written, latest/ read back by
     ``load_weights`` + ``from_flax`` bit-equal to the live state dict.  Then
     the run resumed from latest/ for a third epoch, from the stored epoch
     and step: its one resumed step's update of the trainable parameters
     against that of an uninterrupted run (``RESUME_TOL``: a second
     uninterrupted run is the noise; a resume with fresh AdamW moments must
     fail).  Then one step with ``BACKBONE_KWARGS.drop_rate`` 0.1: K12 48
     launches in place of K1's, no K7; its gradients against the all-plain
     path drawing the same masks at ``GRAD_TOL`` (K12 without its region
     mask at stage 3 must fail).  Prints epoch seconds, the p50 step,
     images/s, the gates' seconds, the checkpoints' bytes and write seconds
     and the host's milliseconds for a train batch beside the card line;
  9. Swin-L and dual_batch.  The Swin-L CMNeXt (embed 192, heads
     6/12/24/48, DSCF heads of 12 channels) at full width and depth:
     ``SemSegPredictor(backbone="SwinTransformer-L")`` serves --requests
     requests of --batch 480x640 frames under r5 (launches per request
     ``R5_LAUNCHES``: K1 8, K2 8, K5 40, K3 3, K4 3 at 12 channels a head,
     K6 1), every launch of K1-K6 in one request held against its plain
     version on its own inputs (``_held_launches``, phase 7's bars), the
     logits against the all-plain path (``LOGIT_TOL``; K5 without its
     region mask must fail).  One training step with remat at batch 4
     (``SWIN_L_TRAIN_LAUNCHES``: K1 96, 48 forward and 48 recomputed, K7
     48, K3 3, K4 3, K8 3 at 12 channels, K6 1): K7 and K8 against their
     plain versions behind the same forward (``GRAD_TOL``'s bwd_group_rel;
     K8 with a scaled dbias must fail), the loss and every group's gradient
     against the all-plain path at phase 5's control bar (K1 without its
     region mask at stage 3 must fail); with the recipe's dropout,
     drop-path and modality mask, the remat step against the step without
     remat drawing the same masks (``REMAT_TOL``; the recomputation
     drawing from the generator where the forward left it must fail),
     peak memory with and without remat, and two timed recipe steps.  The
     Swin-B CMNeXt with ``dual_batch``: r5 requests (``DUAL_LAUNCHES``: K1
     4, K2 8, K5 20, K3 3, K4 3, K6 1), logits against r5's streams in turn
     (bit for bit, else ``LOGIT_TOL``), and one dual training step (K1 24,
     K7 24) against the streams-in-turn step at phase 5's control bar.
     Prints p50 ms, frames/s and images/s beside the card line;
 10. the legacy family at full width (``models.CMNeXtLegacy``, weights from
     --seed, bf16, r5).  CMNeXt-B2 (the MiT dual stream: embed
     64/128/320/512, depths 3/4/6/3, the einsum DSCF at every stage) behind
     ``SemSegPredictor(backbone="CMNeXt-B2")``: --requests requests of
     --batch 480x640 frames, tile = image, overlap 1/3, flip; launches per
     request ``LEGACY_LAUNCHES`` (K6 2: stages 2-3, 30x40 and 15x20; no
     other kernel); every K6 launch of one request bit for bit against its
     plain version (``_held_launches``; the all-f32 form must fail); the
     logits against the all-plain path at ``LOGIT_TOL`` and bit for bit (K6
     sampling at (x, y) and K6's all-f32 form must fail; their
     ``LOGIT_TOL`` readings printed); p50, frames/s, peak
     memory, and one request under the profiler: wall, device busy time,
     idle share.  CMX-B2 the same way, with no kernel launched.  For both,
     one frame's f32 logits on the card against the same model's on the
     host CPU (the xla dispatch: K6 stores bf16 only) at the CPU tests'
     atol 2e-3 / rtol 1e-3.  CMNeXt-B2 under r4 and r4i8 (K3 + K4's
     unpacked form at every stage, at 8, 8, 10 and 8 channels a head: K3
     4 and K4 4 a request), every K3 and K4 launch of one request held
     against its plain version (``_held_launches``), the logits against the
     all-plain path at ``LOGIT_TOL`` (under r4 a K4 without its rpe bias
     must fail it), p50, frames/s, busy and idle.  Then ``val_mm.main`` on
     ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_cmnext_b2.yaml (2 of its
     Synthetic images: MSF at six scales with flip), each eval forward's
     launches against ``expected_launches`` at its size, images/s, peak
     memory beside the reckoned size of stage 0's f32 scores at scale 1.75;
 11. the legacy family trained: ``SemSegTrainer(backbone="CMNeXt-B2")``
     and ``"CMX-B2"`` (the train dispatch, bf16 on f32 masters, the
     recipe's adapter-only AdamW, drop-path, the adapters' and the head's
     dropout) for 3 steps of 4 480x640 frames: finite losses, launches per
     step ``LEGACY_TRAIN_LAUNCHES`` (K6 2 for CMNeXt-B2, none for CMX-B2),
     p50 step, images/s, peak memory; CMNeXt-B2's first step's loss and
     update of the trainable parameters against the all-plain path
     (``LEGACY_STEP_TOL``).  Then ``train_mm.main`` on
     ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_cmnext_b2_train.yaml (2
     epochs of 2 steps, the r5 gate after each, K6 2 a step and 4 a gate),
     latest/ read back bit for bit, and the run resumed from latest/ for
     one step against two uninterrupted runs (``RESUME_TOL``; fresh AdamW
     moments must fail).
 12. DINO-R50 training at configs/detection/dino_r50.py's width (2000
     queries + 200 CDN, 512x512, batch 4, bf16 on f32 masters): (a) K9's
     backward kernel alone at the step's encoder (Lq 5440) and decoder (Lq
     2200) shapes, bf16 and f32, against ``ms_deform_attn_bwd_plain`` (each
     output to ``K9_BWD_REL``; planted faults: the out-of-bounds value term
     kept in dlocations, the -0.5 dropped), autograd through four
     F.grid_sample timed beside it; (b) ``DetTrainState`` steps: launches
     a step ``DET_TRAIN_LAUNCHES`` (K9 24, its backward 12), p50 of 3 after
     a warm-up, peak memory, the auction's iterations and share of the step,
     every K9 launch of a step held against its plain version, the first
     step's loss and update against the all-plain path (K9's plain forward
     in the kernel's order, its plain backward) within 2x two kernel runs'
     distance (``DET_STEP_TOL``; a backward keeping the out-of-bounds value
     term must fail), the kernel path's selections and assignments
     replayed in each run; (c)
     ``train_net.main`` on 8 synthetic 512x512 images (``DET_NET_FLAGS``:
     4 steps, the EMA weights' COCO eval, the weights written and read
     back).
 13. The anomaly stack and the LVIS evaluator.  An MVTec-AD class tree is
     written from --seed (``AD_TREE``: 64 train/good, 16 test/good, 10 each
     of three defects, 1024x1024 RGB PNG).  (a) ``train_ad.main`` at the JAX
     driver's defaults (``AD_FLAGS``: ResNet-18, 448x448, batch 48, lr 2e-4,
     10 anomalies, LightSB with 10 potentials) cut to one epoch of 8 steps
     (``AD_CUTS``): no hand-written kernel launches; step p50 (each step
     synchronised), images/s, peak memory, the host milliseconds of a
     ``balanced_batches`` batch, the eval pass's and the LightSB fit's
     seconds, its final objective, the three AUROCs, the weights file read
     back bit for bit.  (b) One f32 deviation step on the card against the
     same step on the host CPU (same weights, the first balanced batch):
     the loss and each parameter group's gradient at ``AD_STEP_TOL``, a
     second card run's distance printed; the trunk's BatchNorm in eval mode
     must fail.  (c) LightSB (dim 512, 10 potentials, batch 128, diagonal
     and rotated): ``get_log_C``, ``get_log_potential``, ``get_drift`` and a
     10-step Euler-Maruyama rollout on the same noise, card against host
     CPU at ``SB_CARD_TOL``; the drift without its epsilon * gradient term
     must fail.  (d) ``train_net.main --evaluator lvis`` on phase 12 (c)'s
     synthetic set with every third box enlarged (``LVIS_NET_FLAGS``: two
     steps, then the LVIS evaluation): its keys finite, K9's launches as
     counted.
The line before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor cores
INT8_TENSOR_OPS = 1979e12      # dense int8 tensor cores
F32_FLOPS = 67e12              # f32 outside the tensor cores
IMAGE = (480, 640)
NUM_CLASSES = 40
TRAIN_BATCH = 4               # the shipped recipe's (configs/nyu_rgbd.yaml)
DET_IMAGE = (800, 1216)       # one image per detection request
DET_LEVELS = ((100, 152), (50, 76), (25, 38), (13, 19))  # strides 8 .. 64
DET_QUERIES, DET_CLASSES, DET_TOPK = 2000, 20, 300


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


def bound_ms(nbytes: float, flops, rate):
    """The larger of the bytes' time and the operations' time; ``flops`` and
    ``rate`` may be tuples (int8 and bf16 operations of one kernel), whose
    times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    pairs = zip(flops, rate) if isinstance(flops, (tuple, list)) else [(flops, rate)]
    t_ops = sum(f / r for f, r in pairs) * 1e3
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


def _design(c, heads):
    """A Swin block case's note on its attention launch: none on the
    tensor cores (every Swin-B stage), else the first design's, which the
    kernels take by shape alone."""
    from ir_ads_tpu_torch.ops.window_attention_qkv import tensor_core_design

    d = c // heads
    return "" if tensor_core_design(torch.bfloat16, 144, d) else f" d={d} first design"


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
    launches = (  # label, device kernel names, the product's (batches, M, N, K)
        ("LN1", ("swin_ln1_kernel",), None), ("qkv GEMM", ("SwinQkvOut",), (1, t, 3 * c, c)),
        ("attention", ("swin_attn_mma_kernel", "window_attn_kernel"), None),
        ("proj GEMM", ("SwinProjAdd",), (1, t, c, c)))
    return dict(
        name="swin_block", case=f"stage C={c} map {hp}x{wp} shift {shift}" + _design(c, heads),
        # kernel and plain version round to bf16 at the same points; their f32
        # sums run in another order, so a rounding can flip by one bf16 ulp
        # (2^-7 relative) inside (qkv, probabilities) and on the output; the
        # share of outputs apart is held to SWIN_SHARE
        run=run, plain=plain, faulted=faulted, fault=fault, base=x,
        per_launch=lambda: launch_times(g, run, "K1", launches),
        library=None, atol=3e-2, rtol=2e-2, share_tol=SWIN_SHARE["swin_block"],
        bytes=io, flops=flops, rate=BF16_TENSOR_FLOPS,
    )


def _block_params(g, c, heads, streams=1):
    """A block's attention and tail parameters at one stage (the port's
    layout, bf16 but the f32 rel-pos bias; adapters stacked over
    ``streams`` when more than one)."""
    n, hid, ca = 144, 4 * c, c // 16
    lead = (streams,) if streams > 1 else ()
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
    return attn, tail


def check_window_block_v6(g, b, h, w, c, heads, shift, fault, streams=1):
    from ir_ads_tpu_torch.ops import swin_block_v6 as k5
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = _rand(g, b, h, w, c)
    attn, tail = _block_params(g, c, heads, streams)
    ca = tail[6].shape[-2]
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
    hid, ts = tail[2].shape[0], t // streams
    launches = (  # label, device kernel names, the product's (batches, M, N, K)
        ("LN1", ("v6_ln1_kernel",), None), ("qkv GEMM", ("QkvOut",), (1, t, 3 * c, c)),
        ("attention", ("v6_attn_mma_kernel", "v6_attn_kernel"), None),
        ("proj GEMM", ("ProjOut",), (1, t, c, c)),
        ("adapter up GEMM", ("AdapterUp",), (streams, ts, ca, c)),
        ("adapter down GEMM", ("AdapterDown",), (streams, ts, c, ca)),
        ("LN2", ("v6_ln2_kernel",), None), ("fc1 GEMM", ("Fc1Out",), (1, t, hid, c)),
        ("fc2 GEMM", ("Fc2Out",), (1, t, c, hid)))
    return dict(
        name="swin_block_v6",
        case=f"C={c} map {h}x{w} shift {shift}" + (f" S={streams}" if streams > 1 else "")
        + _design(c, heads),
        run=run, plain=plain, faulted=faulted, fault=fault, base=x,
        per_launch=lambda: launch_times(g, run, "K5", launches),
        # as K1 + K2: the same rounding points (y kept in f32 by both), f32
        # sums of another order -> bf16 flips of an ulp or two; the share of
        # outputs apart is held to SWIN_SHARE
        library=None, atol=3e-2, rtol=2e-2, share_tol=SWIN_SHARE["swin_block_v6"],
        bytes=nbytes(x, *attn, region, *tail) + nbytes(x), flops=flops,
        rate=BF16_TENSOR_FLOPS,
    )


def launch_times(g, run, kernel, launches, iters=10):
    """The time per launch of a kernel's sequence (K1, K2, K5, K13, K14:
    the profiler's device time over ``iters`` calls of ``run``) and, beside each
    GEMM, one ``torch.matmul`` of the same (M, N, K) in bf16 (batched over
    the adapter's streams) as a yardstick for the GEMM alone.  ``launches``
    holds (label, device kernel names, (batches, M, N, K) or None); a name
    matches a profiler key holding it as a word (not QkvOut in SwinQkvOut).
    Returns one dict a launch."""
    import re

    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    device = {}
    for evt in prof.key_averages():
        us = next((float(getattr(evt, a)) for a in ("self_device_time_total",
                                                    "self_cuda_time_total")
                   if hasattr(evt, a)), 0.0)
        for label, names, _ in launches:
            if any(re.search(rf"(?<![A-Za-z0-9_]){n}(?![A-Za-z0-9_])", evt.key)
                   or re.search(rf"(?<![0-9]){len(n)}{n}", evt.key) for n in names):
                device[label] = device.get(label, 0.0) + us / iters / 1e3
    out = []
    for label, names, mnk in launches:
        row = dict(launch=label, kernel=names[0], ms=device.get(label))
        if mnk is not None and mnk[-1] == "s8":
            _, m, n, k, _ = mnk
            a, w = _s8(g, m, k), _s8(g, n, k)
            row.update(mnk=[m, n, k], batches=1,
                       int_mm_ms=time_ms(lambda: torch._int_mm(a, w.t()), iters=20))
            del a, w
        elif mnk is not None:
            z, m, n, k = mnk
            a, w = _rand(g, z, m, k).squeeze(0), _rand(g, z, k, n).squeeze(0)
            row.update(mnk=[m, n, k], batches=z,
                       matmul_ms=time_ms(lambda: torch.matmul(a, w), iters=20))
            del a, w
        out.append(row)

    def yardstick(r):
        if "int_mm_ms" in r:
            return f" (_int_mm {r['mnk']} {r['int_mm_ms']:.4f} ms)"
        if "mnk" in r:
            return (f" (matmul {r['mnk']}{' x%d' % r['batches'] if r['batches'] > 1 else ''}"
                    f" {r['matmul_ms']:.4f} ms)")
        return ""

    print(f"    {kernel} per launch (profiler device time; torch.matmul at a bf16 GEMM's, "
          "torch._int_mm at an s8 GEMM's (M, N, K)): "
          + "; ".join(f"{r['launch']} "
                      + ("not measured" if r["ms"] is None else f"{r['ms']:.4f} ms")
                      + yardstick(r) for r in out), flush=True)
    return out


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
    run = lambda: k2.block_tail(x, *args)  # noqa: E731
    launches = (  # label, device kernel names, the product's (batches, M, N, K)
        ("adapter up GEMM", ("TailAdapterUp",), (1, rows, ca, c)),
        ("adapter down GEMM", ("TailAdapterDown",), (1, rows, c, ca)),
        ("LN2", ("tail_ln2_kernel",), None), ("fc1 GEMM", ("TailFc1",), (1, rows, hid, c)),
        ("fc2 GEMM", ("TailOut",), (1, rows, c, hid)))
    return dict(
        name="block_tail", case=f"C={c} rows {rows}",
        run=run, plain=lambda: k2.block_tail_reference(x, *args),
        faulted=lambda: k2.block_tail_reference(x, *args, adapter_scale=0.0),
        fault="adapter dropped", base=x,
        per_launch=lambda: launch_times(g, run, "K2", launches),
        # as K1: same rounding points (hidden after GELU, adapter after relu),
        # another f32 summation order -> bf16 flips of an ulp or two
        library=None, atol=3e-2, rtol=2e-2,
        bytes=nbytes(x, *args) + nbytes(x), flops=flops,
        rate=BF16_TENSOR_FLOPS,
    )


def _channel_scaled(g, fan_out, fan_in):
    """A float weight ~ N(0, 1/fan_in) whose output channels differ in
    scale (x 1/4 to 1, log-uniform), as trained weights' do: a per-tensor
    scale then costs the small channels precision."""
    w = _linear(g, fan_out, fan_in).float()
    return w * torch.exp(-math.log(4.0) * torch.rand(fan_out, 1, generator=g, device="cuda"))


def _per_tensor(w):
    """w quantized with one scale for the whole tensor, as (codes, scale per
    output channel): the planted fault of K11's weights."""
    s = torch.clamp(w.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s.expand(w.shape[0])


def _int8_linear_per_tensor(x, w_q, s_w, floor_first=False):
    """``ops.int8.int8_linear`` with one activation scale for the whole
    tensor instead of one per row: the planted fault of K10's plain version
    (both its LN output and its attention output quantized so)."""
    from ir_ads_tpu_torch.ops.int8 import int_mm

    xf = x.float()
    s_x = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), w_q)
    return (acc.float().reshape(*x.shape[:-1], -1) * s_x) * s_w.float()


# K10 and K11 against their plain versions: both quantize the same values
# with the same scales and sum s8 products exactly; they differ where f32
# sums of another order (the LN statistics, the attention, the adapter) flip
# a bf16 rounding, and one such flip upstream of an s8 stage can move a code
# by one step: an output by max|a| max|w| / 127, 2 to 8 times the flip
# itself.  K11's only such stage is fed by f32 values (its hidden), where a
# flip is rare: 6.2e-4 to 9.5e-4 on an H100 80GB HBM3 at 700 W, against
# 1.3e-2 to 1.7e-2 between int8 and float in the CPU tests, so K11's bar is
# 4e-3, which a fault of the quantization's own size (per-tensor weights,
# 1.5e-2 to 1.9e-2) fails.  K10 quantizes its bf16 attention output, where
# K1's flips (one bf16 ulp, common) become code steps: 7.7e-3 to 1.08e-2 on
# the card, so its bar is 2e-2; its fault (per-tensor activation scales)
# sits at 4.6e-2 to 5.7e-2.  That bar would pass K1's float function too
# (about 1.5e-2 from the int8 one), so one more K10 case makes the attention
# all but one-hot (rel-pos bias x 30): the attention output then has no
# flips, K10 is held at K11's bar, and K1's float half-block on the same
# float weights must fail it.
INT8_REL_TOL = dict(swin_block_int8=2e-2, block_tail_int8=4e-3, peaked=4e-3)


def check_window_block_int8(g, b, h_real, w_real, c, heads, shift, peaked=False):
    from ir_ads_tpu_torch.ops import swin_block_int8 as k10
    from ir_ads_tpu_torch.ops.int8 import quantize_weight
    from ir_ads_tpu_torch.ops.swin_block import window_block_reference
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    x = _rand(g, b, hp, wp, c)
    ln = (_rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05))
    wqkv, wproj = _channel_scaled(g, 3 * c, c), _channel_scaled(g, c, c)
    bqkv, bproj = _rand(g, 3 * c, std=0.02), _rand(g, c, std=0.02)
    bias = _rand(g, heads, n, n, std=30.0 if peaked else 1.0, dtype=torch.float32)
    args = [*ln, *quantize_weight(wqkv), bqkv, *quantize_weight(wproj), bproj, bias]
    region = shift_region_ids_on(hp, wp, ws, shift, x.device) if shift else None
    scale = (c // heads) ** -0.5
    rest = (region, scale, heads, ws, h_real, w_real, shift)

    def per_tensor():
        saved = k10.int8_linear
        k10.int8_linear = _int8_linear_per_tensor
        try:
            return k10.window_block_int8_reference(x, *args, *rest)
        finally:
            k10.int8_linear = saved

    def floated():
        return window_block_reference(x, *ln, wqkv.to(x.dtype), bqkv, wproj.to(x.dtype), bproj,
                                      bias, *rest)

    t = b * hp * wp
    run = lambda: k10.window_block_int8(x, *args, *rest)  # noqa: E731
    launches = (  # label, device kernel names, the product's (batches, M, N, K[, "s8"])
        ("LN1 + s8 rows", ("k10_ln1_kernel",), None),
        ("qkv s8 GEMM", ("K10QkvOut",), (1, t, 3 * c, c, "s8")),
        ("attention", ("int8_attn_mma_kernel", "window_attn_kernel"), None),
        ("attention s8 rows", ("k10_att_quant_kernel",), None),
        ("proj s8 GEMM", ("K10ProjAdd",), (1, t, c, c, "s8")))
    return dict(
        name="swin_block_int8",
        case=f"stage C={c} map {hp}x{wp} shift {shift}" + (" one-hot" if peaked else "")
        + _design(c, heads),
        run=run, plain=lambda: k10.window_block_int8_reference(x, *args, *rest),
        faulted=floated if peaked else per_tensor,
        per_launch=None if peaked else lambda: launch_times(g, run, "K10", launches),
        fault=("the float half-block (K1's function)" if peaked
               else "activations scaled per tensor, not per row"), base=x,
        # elementwise: two bf16 ulps, and one code step of the proj product;
        # the share of outputs apart is held to SWIN_SHARE
        library=None, atol=3e-2, rtol=2e-2, share_tol=SWIN_SHARE["swin_block_int8"],
        rel_tol=INT8_REL_TOL["peaked" if peaked else "swin_block_int8"],
        bytes=nbytes(x, *args, region) + nbytes(x),
        flops=(t * 8 * c * c, t * 4 * n * c), rate=(INT8_TENSOR_OPS, BF16_TENSOR_FLOPS),
    )


def check_block_tail_int8(g, rows, c):
    from ir_ads_tpu_torch.ops import block_tail_int8 as k11
    from ir_ads_tpu_torch.ops.int8 import quantize_weight

    hid, ca = 4 * c, c // 16
    x = _rand(g, rows, c)
    w1, w2 = _channel_scaled(g, hid, c), _channel_scaled(g, c, hid)
    ln = (_rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05))
    b1, b2 = _rand(g, hid, std=0.02), _rand(g, c, std=0.02)
    adapter = (_linear(g, ca, c), _rand(g, ca, std=0.02), _linear(g, c, ca),
               _rand(g, c, std=0.02))
    args = (*ln, *quantize_weight(w1), b1, *quantize_weight(w2), b2, *adapter)
    bad = (*ln, *_per_tensor(w1), b1, *_per_tensor(w2), b2, *adapter)
    run = lambda: k11.block_tail_int8(x, *args)  # noqa: E731
    launches = (  # label, device kernel names, the product's (batches, M, N, K[, "s8"])
        ("LN2 + s8 rows", ("tail8_ln2_kernel",), None),
        ("adapter up GEMM", ("Tail8AdapterUp",), (1, rows, ca, c)),
        ("adapter down GEMM", ("Tail8AdapterDown",), (1, rows, c, ca)),
        ("W1 s8 GEMM, max pass", ("Tail8Fc1Max",), (1, rows, hid, c, "s8")),
        ("W1 s8 GEMM, quantize pass", ("Tail8Fc1Quant",), (1, rows, hid, c, "s8")),
        ("W2 s8 GEMM", ("Tail8Fc2",), (1, rows, c, hid, "s8")))
    return dict(
        name="block_tail_int8", case=f"C={c} rows {rows}",
        run=run, plain=lambda: k11.block_tail_int8_reference(x, *args),
        per_launch=lambda: launch_times(g, run, "K11", launches),
        faulted=lambda: k11.block_tail_int8_reference(x, *bad),
        fault="weights scaled per tensor, not per channel", base=x,
        # as K10: two bf16 ulps, and one code step of the fc2 product
        library=None, atol=3e-2, rtol=2e-2, rel_tol=INT8_REL_TOL["block_tail_int8"],
        bytes=nbytes(x, *args) + nbytes(x),
        flops=(rows * 16 * c * c, rows * 4 * c * ca), rate=(INT8_TENSOR_OPS, BF16_TENSOR_FLOPS),
    )


def _s8(g, *shape):
    """Uniform s8 codes in [-127, 127], as the kernels' quantization makes."""
    return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)


def check_igemm(g, name, what, m, n, k):
    """The s8 GEMM of K10 and K11 (csrc/igemm.cuh, through its raw s32
    epilogue) at one of their products' (M, N, K), held equal to
    torch._int_mm bit for bit: an s8 product summed in s32 is exact in any
    order.  The planted fault drops the last 32 of the depth (one wgmma k
    step)."""
    from ir_ads_tpu_torch.ops.block_tail_int8 import igemm_s32

    a, w = _s8(g, m, k), _s8(g, n, k)
    int_mm = lambda: torch._int_mm(a, w.t())  # noqa: E731
    return dict(
        name=name, case=f"s8 GEMM {what} ({m}, {n}, {k}) = _int_mm",
        run=lambda: igemm_s32(a, w), plain=int_mm, library=int_mm,
        faulted=lambda: igemm_s32(a, w, k - 32), fault="the last 32 of k dropped", base=None,
        atol=0.0, rtol=0.0, rel_tol=0.0, share_tol=0.0,
        bytes=nbytes(a, w) + 4 * m * n, flops=2 * m * n * k, rate=INT8_TENSOR_OPS,
    )


def igemm_cases(g, images):
    """check_igemm at every s8 product of the r4i8 path's four stages: K10's
    qkv and proj on the padded map, K11's W1 and W2 on the real tokens."""
    cases = []
    for h, w, c, _ in STAGES:
        t10, t11 = images * -(-h // 12) * 12 * -(-w // 12) * 12, images * h * w
        cases += [functools.partial(check_igemm, g, "swin_block_int8", "qkv", t10, 3 * c, c),
                  functools.partial(check_igemm, g, "swin_block_int8", "proj", t10, c, c),
                  functools.partial(check_igemm, g, "block_tail_int8", "W1", t11, 4 * c, c),
                  functools.partial(check_igemm, g, "block_tail_int8", "W2", t11, c, 4 * c)]
    return cases


def check_tail_hidden(g, rows, c):
    """K11's two W1 passes compute the f32 hidden with one helper
    (csrc/block_tail_int8.cu's tail_hidden); the check entry also writes
    that hidden out.  The max pass's row max (atomicMax on the int bits)
    must equal amax |h| bit for bit, the scale fmax(max, 1e-12) / 127, and
    the quantize pass's codes rn(h / scale): then the two passes computed
    the same hidden.  The planted fault, the scale from one 64-column chunk
    of the row, must give other codes."""
    from ir_ads_tpu_torch.ops import block_tail_int8 as k11
    from ir_ads_tpu_torch.ops.int8 import quantize_weight

    hid = 4 * c
    x = _rand(g, rows, c)
    ln = (_rand(g, c, std=0.05, mean=1.0), _rand(g, c, std=0.05))
    w1_q, s1 = quantize_weight(_channel_scaled(g, hid, c))
    b1 = _rand(g, hid, std=0.02)
    _, _, rowmax, hq, sh, h = k11.block_tail_int8_hidden(x, *ln, w1_q, s1, b1)
    torch.cuda.synchronize()

    def codes(s):
        return torch.clamp(torch.round(h / s[:, None]), -127, 127).to(torch.int8)

    # true divisions by tensors (a tensor over a Python number is taken as a
    # product with its reciprocal)
    q127 = torch.full((rows,), 127.0, device="cuda")
    amax = h.abs().amax(dim=1)
    scale = torch.clamp(amax, min=1e-12) / q127
    chunk = torch.clamp(h[:, :64].abs().amax(dim=1), min=1e-12) / q127
    n_max, n_scale = int((rowmax != amax).sum()), int((sh != scale).sum())
    n_codes, n_fault = int((hq != codes(scale)).sum()), int((hq != codes(chunk)).sum())
    print(f"  block_tail_int8 C={c} rows {rows}: the W1 passes against their hidden written "
          f"out: row max {n_max}, scale {n_scale} of {rows} apart, codes {n_codes} of "
          f"{hq.numel()} apart (planted fault, the max of one 64-column chunk: {n_fault})",
          flush=True)
    if n_max or n_scale or n_codes:
        fail(f"block_tail_int8 C={c}: the max and quantize passes disagree with their hidden")
    if not n_fault:
        fail(f"block_tail_int8 C={c}: the hidden check cannot see a chunk's max")
    return dict(name="block_tail_int8", case=f"W1 passes against their hidden, C={c} rows {rows}",
                max_abs_err=0.0, rowmax_differ=n_max, scale_differ=n_scale,
                codes_differ=n_codes, fault_codes_differ=n_fault)


def _window_qkv_inputs(g, b, h_real, w_real, c, heads, shift):
    """Windowed qkv (B*nW, 144, 3C) of a stage's map padded to whole windows
    (what the module path's qkv linear hands K12), its bias and region."""
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    bn = b * (hp // ws) * (wp // ws)
    qkv = _rand(g, bn, n, 3 * c)
    bias = _rand(g, heads, n, n, dtype=torch.float32)
    region = shift_region_ids_on(hp, wp, ws, shift, qkv.device) if shift else None
    return qkv, bias, region, (c // heads) ** -0.5, bn


def _sdpa_mask(bias, region, bn, dtype):
    """The rel-pos bias and the -1e9 region mask folded into one float
    attention mask for ``bn`` windows (region row w % nW for window w)."""
    mask = bias.to(dtype)[None]
    if region is not None:
        neq = (region[:, :, None] != region[:, None, :]).repeat(bn // region.shape[0], 1, 1)
        mask = mask + torch.where(neq, -1e9, 0.0).to(dtype)[:, None]
    return mask.expand(bn, -1, -1, -1)


def _split_heads(wins, heads):
    """q, k, v (B nW, heads, N, d) split out of windowed qkv (B nW, N, 3C)
    (views, no copy)."""
    bn, n, c3 = wins.shape
    c = c3 // 3
    heads_of = lambda t: t.reshape(bn, n, heads, c // heads).transpose(1, 2)  # noqa: E731
    return [heads_of(wins[..., i * c:(i + 1) * c]) for i in range(3)]


def _sdpa_with_region(qkv, bias, region, scale, heads):
    """The library call: one scaled_dot_product_attention with the bias and
    the -1e9 region mask folded into its float mask (built outside the
    timing), on the heads split out of qkv (views, no copy)."""
    q, k, v = _split_heads(qkv, heads)
    mask = _sdpa_mask(bias, region, qkv.shape[0], qkv.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _sdpa_grad(heads_of, bias, region, scale, dout, leaves):
    """The library call of an autograd case: ``torch.autograd.grad`` of
    ``leaves`` (q, k and v, or the qkv they are views of, and the bias)
    through one scaled_dot_product_attention whose float mask is the bias
    (cast to q's dtype, so that its gradient flows) plus the -1e9 region
    mask (built outside the timing).  ``heads_of`` gives (q, k, v) of the
    leaves' copies; dout is the output's gradient, (B nW, heads, N, d)."""
    region_mask = None
    if region is not None:
        neq = (region[:, :, None] != region[:, None, :]).repeat(dout.shape[0] // region.shape[0],
                                                                1, 1)
        region_mask = torch.where(neq, -1e9, 0.0).to(dout.dtype)[:, None]

    def run():
        ins = [t.detach().requires_grad_() for t in leaves]
        q, k, v = heads_of(ins)
        mask = ins[-1].to(q.dtype)[None]
        if region_mask is not None:
            mask = mask + region_mask
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask.expand(
            q.shape[0], -1, -1, -1), scale=scale)
        return torch.autograd.grad(out, ins, dout)

    return run


def check_window_attention_qkv(g, b, h_real, w_real, c, heads, shift):
    """K12 at one stage's r2 / r1 shape (4 tiles: 560, 140, 48, 16
    windows).  Planted fault: on a shifted case the region mask left out,
    on an unshifted one the rel-pos bias."""
    from ir_ads_tpu_torch.ops import window_attention_qkv as k12

    qkv, bias, region, scale, bn = _window_qkv_inputs(g, b, h_real, w_real, c, heads, shift)
    if shift:
        fault = "region mask dropped"
        faulted = lambda: k12.window_attention_qkv_reference(  # noqa: E731
            qkv, bias, None, scale, heads)
    else:
        fault = "rel-pos bias dropped"
        faulted = lambda: k12.window_attention_qkv_reference(  # noqa: E731
            qkv, torch.zeros_like(bias), None, scale, heads)
    n = qkv.shape[1]
    return dict(
        name="window_attention_qkv", case=f"C={c} {bn} windows shift {shift}",
        run=lambda: k12.window_attention_qkv(qkv, bias, region, scale, heads),
        plain=lambda: k12.window_attention_qkv_reference(qkv, bias, region, scale, heads),
        faulted=faulted, fault=fault, base=None,
        library=_sdpa_with_region(qkv, bias, region, scale, heads),
        # the plain version's rounding points (q * scale, the probabilities,
        # the output), f32 sums of another order, so a rounding can flip by
        # one bf16 ulp (2^-8) inside and on the output; atol for outputs that
        # cancel to near zero; and at most ROUNDING_SHARE of the outputs apart
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(qkv, bias, region) + nbytes(qkv) // 3, flops=4 * bn * n * n * c,
        rate=BF16_TENSOR_FLOPS,
    )


def check_window_attention_qkv_grad(g, b, h_real, w_real, c, heads, shift):
    """K12 under autograd on the card: its output and the gradients of qkv
    and of the bias its backward takes (the plain version's vjp, recomputed)
    against the plain version's forward and ``torch.autograd.grad``.
    Planted fault: the plain vjp without the region mask."""
    from ir_ads_tpu_torch.ops import window_attention_qkv as k12

    qkv, bias, region, scale, bn = _window_qkv_inputs(g, b, h_real, w_real, c, heads, shift)
    dout = _rand(g, bn, qkv.shape[1], c)

    def through(fn, reg):
        leaves = [qkv.detach().requires_grad_(), bias.detach().requires_grad_()]
        out = fn(*leaves, reg, scale, heads)
        return (out.detach(), *torch.autograd.grad(out, leaves, dout))

    n = qkv.shape[1]
    return dict(
        name="window_attention_qkv", case=f"autograd C={c} {bn} windows shift {shift}",
        run=lambda: through(k12.window_attention_qkv, region),
        plain=lambda: through(k12.window_attention_qkv_reference, region),
        faulted=lambda: through(k12.window_attention_qkv_reference, None),
        fault="vjp without the region mask", base=None,
        library=_sdpa_grad(lambda ins: _split_heads(ins[0], heads), bias, region, scale,
                           dout.reshape(bn, n, heads, c // heads).transpose(1, 2),
                           (qkv, bias)),
        outputs=["out", "dqkv", "dbias"],
        # the output as above; the backward is the plain version's own vjp,
        # recomputed from the same inputs: equal but for the order of its
        # f32 sums, which a recompute does not change
        atol=[1e-2, 1e-6, 1e-6], rtol=[2e-2, 1e-6, 1e-6],
        bytes=nbytes(qkv, bias, region, dout) + nbytes(qkv) // 3 + nbytes(qkv, bias),
        flops=4 * bn * n * n * c * 3, rate=BF16_TENSOR_FLOPS,
    )


def check_window_block_v7(g, b, h, w, c, heads, shift, streams=1):
    """K13 at one stage of the v7_01 path: the real map padded and rolled
    as the block hands it over.  Composition (bit-equal at every real
    position): K1, un-roll and crop, K2 per stream.  Planted fault: on a
    shifted case the region mask left out, on an unshifted one the rel-pos
    bias."""
    from ir_ads_tpu_torch.models.backbones.swin import pad_and_roll, unroll_and_crop
    from ir_ads_tpu_torch.ops import block_tail as k2
    from ir_ads_tpu_torch.ops import swin_block as k1
    from ir_ads_tpu_torch.ops import swin_block_v7 as k13
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    xm = pad_and_roll(_rand(g, b, h, w, c), ws, shift).contiguous()
    hp, wp = xm.shape[1:3]
    attn, tail = _block_params(g, c, heads, streams)
    ca = tail[6].shape[-2]
    region = shift_region_ids_on(hp, wp, ws, shift, xm.device) if shift else None
    scale = (c // heads) ** -0.5
    geo = (scale, heads, ws, h, w, shift)
    bad_attn, bad_region = attn, None
    if shift:
        fault = "region mask dropped"
    else:
        fault, bad_attn = "rel-pos bias dropped", attn[:6] + (torch.zeros_like(attn[6]),)

    def composed():
        y = unroll_and_crop(k1.window_block(xm, *attn, region, *geo), h, w, shift)
        per = b // streams
        return torch.cat([
            k2.block_tail(y[i * per:(i + 1) * per].contiguous().reshape(-1, c), *tail[:6],
                          *(t[i] if streams > 1 else t for t in tail[6:]))
            for i in range(streams)]).reshape(b, h, w, c)

    t = b * hp * wp  # every position of the padded map runs the whole block
    hid, ts = tail[2].shape[0], t // streams
    run = lambda: k13.window_block_v7(xm, attn, tail, region, *geo)  # noqa: E731
    launches = (  # label, device kernel names, the product's (batches, M, N, K)
        ("LN1", ("v7_ln1_kernel",), None), ("qkv GEMM", ("V7QkvOut",), (1, t, 3 * c, c)),
        ("attention", ("v7_attn_mma_kernel", "v7_attn_kernel"), None),
        ("proj GEMM", ("V7ProjAdd",), (1, t, c, c)),
        ("adapter up GEMM", ("V7AdapterUp",), (streams, ts, ca, c)),
        ("adapter down GEMM", ("V7AdapterDown",), (streams, ts, c, ca)),
        ("LN2", ("v7_ln2_kernel",), None), ("fc1 GEMM", ("V7Fc1Out",), (1, t, hid, c)),
        ("fc2 GEMM", ("V7Fc2Out",), (1, t, c, hid)))
    return dict(
        name="swin_block_v7",
        case=f"C={c} map {hp}x{wp} shift {shift}" + (f" S={streams}" if streams > 1 else "")
        + _design(c, heads),
        run=run, plain=lambda: k13.window_block_v7_reference(xm, attn, tail, region, *geo),
        faulted=lambda: k13.window_block_v7_reference(xm, bad_attn, tail, bad_region, *geo),
        fault=fault, base=xm,
        composition=(lambda out: unroll_and_crop(out, h, w, shift), composed,
                     "K1, un-roll and crop, K2"),
        per_launch=lambda: launch_times(g, run, "K13", launches),
        # K1's then K2's: the same rounding points, f32 sums of another order;
        # the share of outputs apart is held to SWIN_SHARE
        library=None, atol=3e-2, rtol=2e-2, share_tol=SWIN_SHARE["swin_block_v7"],
        bytes=nbytes(xm, *attn, region, *tail) + nbytes(xm),
        flops=t * (24 * c * c + 4 * n * c + 4 * c * ca), rate=BF16_TENSOR_FLOPS,
    )


def check_window_block_full(g, b, h, w, c, heads, shift):
    """K14 at one stage of the v5 path, on the real map.  Composition
    (bit-equal): pad and roll, K1, un-roll and crop.  Planted fault: on a
    shifted case the roll left out (the region mask kept), on an unshifted
    one the rel-pos bias."""
    from ir_ads_tpu_torch.models.backbones.swin import pad_and_roll, unroll_and_crop
    from ir_ads_tpu_torch.ops import swin_block as k1
    from ir_ads_tpu_torch.ops import swin_block_full as k14
    from ir_ads_tpu_torch.ops.window_attention import shift_region_ids_on

    ws, n = 12, 144
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = _rand(g, b, h, w, c)
    attn, _ = _block_params(g, c, heads)
    region = shift_region_ids_on(hp, wp, ws, shift, x.device) if shift else None
    scale = (c // heads) ** -0.5
    bad_attn, bad_shift = attn, 0
    if shift:
        fault = "roll left out, mask kept"
    else:
        fault, bad_attn = "rel-pos bias dropped", attn[:6] + (torch.zeros_like(attn[6]),)
    t = b * h * w  # the real rows enter the GEMMs
    run = lambda: k14.window_block_full(x, *attn, region, scale, heads, ws, shift)  # noqa: E731
    launches = (  # label, device kernel names, the product's (batches, M, N, K)
        ("LN1", ("v5_ln1_kernel",), None), ("qkv GEMM", ("FullQkvOut",), (1, t, 3 * c, c)),
        ("attention", ("v5_attn_mma_kernel", "v5_attn_kernel"), None),
        ("proj GEMM", ("FullProjAdd",), (1, t, c, c)))
    return dict(
        name="swin_block_full", case=f"C={c} map {h}x{w} shift {shift}" + _design(c, heads),
        run=run,
        plain=lambda: k14.window_block_full_reference(x, *attn, region, scale, heads, ws, shift),
        faulted=lambda: k14.window_block_full_reference(x, *bad_attn, region, scale, heads, ws,
                                                        bad_shift),
        fault=fault, base=x,
        composition=(lambda out: out, lambda: unroll_and_crop(k1.window_block(
            pad_and_roll(x, ws, shift).contiguous(), *attn, region, scale, heads, ws, h, w,
            shift), h, w, shift), "pad and roll, K1, un-roll and crop"),
        per_launch=lambda: launch_times(g, run, "K14", launches),
        # K1's bars: the same rounding points, f32 sums of another order; the
        # share of outputs apart is held to SWIN_SHARE
        library=None, atol=3e-2, rtol=2e-2, share_tol=SWIN_SHARE["swin_block_full"],
        bytes=nbytes(x, *attn, region) + nbytes(x),
        # qkv and proj of the real tokens; every query of the padded map
        # attends to its window
        flops=t * 8 * c * c + b * hp * wp * 4 * n * c, rate=BF16_TENSOR_FLOPS,
    )


def check_window_attention_map(g, b, h, w, c, heads, shift):
    """K15 at one stage of the map path: the qkv map of the padded, rolled
    map.  Composition (bit-equal): window partition, K12, window reverse.
    Planted fault: the window reverse transposed (window (wy, wx) written
    to the grid's (wx, wy) order)."""
    from ir_ads_tpu_torch.ops import window_attention_map as k15
    from ir_ads_tpu_torch.ops import window_attention_qkv as k12
    from ir_ads_tpu_torch.ops.window_attention import (
        shift_region_ids_on, window_partition, window_reverse,
    )

    ws, n = 12, 144
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    nh, nw = hp // ws, wp // ws
    qkv = _rand(g, b, hp, wp, 3 * c)
    bias = _rand(g, heads, n, n, dtype=torch.float32)
    region = shift_region_ids_on(hp, wp, ws, shift, qkv.device) if shift else None
    scale = (c // heads) ** -0.5

    def transposed():
        out = k12.window_attention_qkv_reference(window_partition(qkv, ws), bias, region,
                                                 scale, heads)
        out = out.reshape(b, nh, nw, n, c).transpose(1, 2).reshape(b * nh * nw, n, c)
        return window_reverse(out, ws, hp, wp)

    mask = _sdpa_mask(bias, region, b * nh * nw, qkv.dtype)

    def library():
        # SDPA on the partitioned windows, with the partition and reverse
        # copies it needs (the float mask built outside the timing)
        out = F.scaled_dot_product_attention(
            *_split_heads(window_partition(qkv, ws), heads), attn_mask=mask, scale=scale)
        return window_reverse(out.transpose(1, 2).reshape(-1, n, c), ws, hp, wp)

    return dict(
        name="window_attention_map", case=f"C={c} map {hp}x{wp} shift {shift}",
        run=lambda: k15.window_attention_map(qkv, bias, region, scale, heads, ws),
        plain=lambda: k15.window_attention_map_reference(qkv, bias, region, scale, heads, ws),
        faulted=transposed, fault="window reverse transposed (wy, wx swapped)", base=None,
        composition=(lambda out: out, lambda: window_reverse(k12.window_attention_qkv(
            window_partition(qkv, ws), bias, region, scale, heads), ws, hp, wp),
            "window partition, K12, window reverse"),
        library=library,
        # K12's bars (the same device code on another layout)
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(qkv, bias, region) + nbytes(qkv) // 3,
        flops=4 * b * nh * nw * n * n * c, rate=BF16_TENSOR_FLOPS,
    )


def _dscf_inputs(g, b, level, clamped=False, searched=False):
    """A DSCF level's query plane, groups and keys, the keys' positions
    uniform in [-1, 1] (with ``clamped``, each coordinate -1 with
    probability 1/6 and +1 with probability 1/6: the served model clamps
    22-33 % of them there, and the sample then reaches the table's first
    and last rows and columns; with ``searched``, 16 keys' y coordinates
    and 16 others' x coordinates where K3's and K6's kernels search the
    four taps of that axis, ``dscf_rpe.searching_coordinates``) and the rpe
    table."""
    from ir_ads_tpu_torch.ops.dscf_rpe import hat_slopes, searching_coordinates

    h, w = 120 >> level, 160 >> level
    groups = 1 << level
    bg, hg, m = b * groups, 2, 600
    pos = (torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1)
    if clamped:
        at = torch.rand(bg, m, 2, generator=g, device="cuda")
        pos = torch.where(at < 1 / 6, -1.0, torch.where(at < 1 / 3, 1.0, pos))
    if searched:
        ay, ax = hat_slopes(119, 159, h, w)
        for axis, (size, slope, n) in enumerate(((119, ay, h), (159, ax, w))):
            hits = torch.from_numpy(searching_coordinates(size, slope, n, 16)).cuda()
            pos[0, 16 * axis:16 * axis + len(hits), axis] = hits
    table = _rand(g, groups, hg, 119, 159, std=0.5, dtype=torch.float32)
    return h, w, groups, bg, hg, m, pos, table


def _variant(clamped, searched):
    return (" clamped" if clamped else "") + (" searched" if searched else "")


def check_rpe(g, b, level, clamped=False, searched=False):
    """K3 (the rows bias, ``_rpe_rows_kernel``'s bf16 form).  Bar: bit for
    bit (atol 0): the kernel rounds the hat weights (computed in the TPU
    kernel's f32 order, no FMA), the table and u to bf16 where the plain
    version does, and each sum has at most two non-zero terms, each an
    exact bf16 x bf16 product, or where an outer tap has a weight searches
    the four taps as the dense product's non-zero terms (``searched``
    reaches that path).  Planted fault: the all-f32 form, which rounds only
    the output."""
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level, clamped, searched)
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

    return dict(
        name="dscf_rpe", case=f"level {level} plane {h}x{w} BG={bg}" + _variant(clamped, searched),
        run=lambda: k3.rpe_bias_rows(pos, table, h, w, torch.bfloat16),
        plain=lambda: k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16),
        faulted=lambda: k3.rpe_bias_f32(pos, table, h, w, "behmw").to(torch.bfloat16),
        fault="the all-f32 form (no bf16 rounding inside)", base=None,
        library=library, atol=0.0, rtol=0.0, rel_tol=0.0,
        bytes=nbytes(pos, table) + out_elems * 2, flops=out_elems * 20,
        rate=F32_FLOPS,
    )


def check_rpe_packed(g, b, level, clamped=False, searched=False):
    """K6 (the packed bias, ``_rpe_packed_kernel``): K3's function, bar and
    planted fault (see check_rpe)."""
    from ir_ads_tpu_torch.ops import dscf_rpe_packed as k6

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level, clamped, searched)
    out_elems = bg * hg * m * h * w
    return dict(
        name="dscf_rpe_packed",
        case=f"level {level} plane {h}x{w} BG={bg}" + _variant(clamped, searched),
        run=lambda: k6.rpe_bias_packed(pos, table, h, w, torch.bfloat16),
        plain=lambda: k6.rpe_bias_packed_reference(pos, table, h, w, torch.bfloat16),
        faulted=lambda: k6.rpe_bias_f32(pos, table, h, w, "bemhw").flatten(3).to(
            torch.bfloat16),
        fault="the all-f32 form (no bf16 rounding inside)", base=None,
        library=_rpe_library(h, w, groups, bg, pos, table),
        atol=0.0, rtol=0.0, rel_tol=0.0,
        bytes=nbytes(pos, table) + out_elems * 2, flops=out_elems * 20,
        rate=F32_FLOPS,
    )


# K4's two forms, K16 and K17 against their plain versions: the same
# rounding points, so they part only where an f32 ulp of the scores or of
# the max/sum order flips a bf16 rounding: 0.01 % to 0.22 % of the outputs
# on an H100 80GB HBM3 at 700 W.  The other rows form (the planted fault of
# K4's unpacked form and of K16) puts about 48 % of the outputs an ulp away
# on phase 3's random inputs and 4 % to 8 % on the served model's DSCF
# inputs, whose softmax is more peaked.  These cases are also held to a
# share of differing outputs, which their faults must fail.
ROUNDING_SHARE = 0.01
# The Swin block kernels K1, K5, K10, K13 and K14 cannot be held to it:
# their plain versions sum the qkv, proj and FFN products in cuBLAS's f32
# order, and the residual sums turn those f32 differences into bf16 flips on
# 0.40-2.49 % (K1), 13.1-23.8 % (K5), 2.8-4.6 % (K10), 2.2-7.4 % (K13) and
# 0.45-4.6 % (K14) of phase 3's outputs, the same shares (within 2.2e-4)
# with the first design's attention and with the tensor cores' (an H100
# 80GB HBM3 at 700 W; profile_port.py --shares prints them, with
# --port-dir for another checkout).  Each is held to a limit 1.25-1.6
# times its largest reading, so that a rise in what the kernel flips still
# fails; their planted faults put 16-99 % of the outputs apart (the same
# card), and fail the distance bar too.  The attention
# launches hold ROUNDING_SHARE themselves through K15's cases (MapRows, the
# device code of K1's, K10's and K13's); K14's bit-equality with pad, roll,
# K1, un-roll and crop holds RealMapTokens, which K5 runs too.
SWIN_SHARE = dict(swin_block=0.04, swin_block_v6=0.30, swin_block_int8=0.07,
                  swin_block_v7=0.10, swin_block_full=0.07)
JMAJOR_SHARE = 0.01  # K18's (check_rpe_jmajor)


def check_rows(g, b, level, packed=True, hc=8, fault=None):
    """K4 at one DSCF level's serving shape, heads of ``hc`` channels (8:
    Swin-B, 12: Swin-L, 10: the MiT's stage 2 of CMNeXt-B1..B5, 4 and 5:
    CMNeXt-B0's stages).  ``fault``: the planted fault of a head width that
    is not a whole plane, "channel dropped" (the head's last channel of v
    zero in the plain version) or "next head overwritten" (the plain
    output with each head's first channel overwritten by the previous
    head's last, as a store past the head would leave it)."""
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    gc = hg * hc
    q = _rand(g, bg, h * w, gc)
    k = _rand(g, bg, m, gc)
    v = _rand(g, bg, m, gc)
    # contiguous, as K3 writes it on the main path (the wrapper would copy
    # a strided view, 0.28 ms at level 0, inside the kernel's timing)
    bias = k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16).contiguous()
    scale = hc ** -0.5
    qh = q.reshape(bg, h * w, hg, hc).transpose(1, 2)
    kh = k.reshape(bg, m, hg, hc).transpose(1, 2)
    vh = v.reshape(bg, m, hg, hc).transpose(1, 2)
    mask = bias.permute(0, 1, 2, 4, 3).reshape(bg, hg, h * w, m).contiguous()
    flops = 4 * hc * bg * hg * h * w * m
    if fault == "channel dropped":
        v_bad = v.clone()
        v_bad.view(bg, m, hg, hc)[..., hc - 1] = 0
        fault = f"channel {hc - 1} of each head dropped"
        faulted = functools.partial(k4.dscf_rows_reference, q, k, v_bad, bias, scale, hg,
                                    packed)
    elif fault == "next head overwritten":
        def faulted():
            out = k4.dscf_rows_reference(q, k, v, bias, scale, hg, packed)
            heads = out.view(bg, h * w, hg, hc)
            heads[:, :, 1:, 0] = heads[:, :, :-1, hc - 1].clone()
            return out

        fault = "each head's first channel overwritten by the previous head's last"
    elif packed:
        fault = "rpe bias dropped"
        faulted = lambda: k4.dscf_rows_reference(  # noqa: E731
            q, k, v, torch.zeros_like(bias), scale, hg, True)
    else:
        fault = "the packed form (normalise, round, then P.V)"
        faulted = lambda: k4.dscf_rows_reference(q, k, v, bias, scale, hg, True)  # noqa: E731
    return dict(
        name="dscf_rows",
        case=f"level {level} plane {h}x{w} BG={bg}" + ("" if packed else " unpacked")
        + ("" if hc == 8 else f" hc={hc}"),
        run=lambda: k4.dscf_rows_attention(q, k, v, bias, scale, hg, packed),
        plain=lambda: k4.dscf_rows_reference(q, k, v, bias, scale, hg, packed),
        faulted=faulted, fault=fault, base=None,
        library=lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale),
        # the same rounding points in both; the f32 max/sum order differs,
        # flipping a rounding now and then
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(q, k, v, bias) + nbytes(q), flops=flops,
        rate=BF16_TENSOR_FLOPS, hc=hc,
    )


def _rpe_library(h, w, groups, bg, pos, table):
    """The library call of the rpe bias kernels with a (BG, hg, M, HW)
    layout: F.grid_sample of the table at every (key, query pixel) pair (the
    grid built outside the timing)."""
    qy = torch.arange(h, device="cuda") / (h - 1) * 2 - 1
    qx = torch.arange(w, device="cuda") / (w - 1) * 2 - 1
    qg = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1).reshape(1, 1, h * w, 2)
    grid = ((qg - pos[:, :, None]) * 0.5)[..., (1, 0)].contiguous()
    tb = table[torch.arange(bg, device="cuda") % groups].contiguous()
    return lambda: F.grid_sample(tb, grid, mode="bilinear", align_corners=True)


def check_rpe_jmajor(g, b, level, clamped=False):
    """K18 (the pallas2 bias, ``_rpe_kernel``'s f32 form).  Bar: one bf16
    ulp (rtol 2^-7), or 1e-5 where a sum cancels to about 0 (the terms are
    about 1: one side may get 0 exactly, the other an f32 remainder), and at
    most 1 % of the outputs differing: both sides round an f32 sum of two
    products once, and the plain version's cuBLAS dots may fuse a
    multiply-add where the kernel rounds the product.  Planted fault: K3's
    form (bf16 hat weights, table and u).  And bit for bit (the bf16 bits)
    against ``rpe_bias_jmajor_ordered``, the kernel's own sequence of
    roundings in torch elementwise ops."""
    from ir_ads_tpu_torch.ops import dscf_rpe_jmajor as k18
    from ir_ads_tpu_torch.ops.dscf_rpe import rpe_bias_bf16

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level, clamped)
    out_elems = bg * hg * m * h * w
    bf = torch.bfloat16
    return dict(
        name="dscf_rpe_jmajor",
        case=f"level {level} plane {h}x{w} BG={bg}" + (" clamped" if clamped else ""),
        run=lambda: k18.rpe_bias_jmajor(pos, table, h, w, bf),
        plain=lambda: k18.rpe_bias_jmajor_reference(pos, table, h, w, bf),
        faulted=lambda: rpe_bias_bf16(pos, table, h, w, "bemhw").to(bf),
        fault="K3's form (bf16 hat weights, table and u)", base=None,
        composition=(lambda out: out.view(torch.int16),
                     lambda: k18.rpe_bias_jmajor_ordered(pos, table, h, w, bf).view(torch.int16),
                     "rpe_bias_jmajor_ordered (bits)"),
        library=_rpe_library(h, w, groups, bg, pos, table),
        atol=1e-5, rtol=2.0 ** -7, share_tol=JMAJOR_SHARE,
        bytes=nbytes(pos, table) + out_elems * 2, flops=out_elems * 20,
        rate=F32_FLOPS,
    )


def _packed_bias(bias5, m, mp, pad=-1e9):
    """K18's (BG, hg, M, h, w) bias as K17 takes it: (BG, HW, hg*Mp), the
    keys past M padded with ``pad`` (DAttentionMM's pallas2 layout)."""
    bg, hg, _, h, w = bias5.shape
    packed = F.pad(bias5.permute(0, 3, 4, 1, 2).reshape(bg, h * w, hg, m), (0, mp - m),
                   value=pad)
    return packed.reshape(bg, h * w, hg * mp).contiguous()


def check_dscf_attention(g, b, level):
    """K17 (the pallas / pallas2 attention) on the packed bias K18 builds,
    Mp = 640.  Planted fault: the padded bias columns 0, not -1e9 (the zero
    keys then take a share of every softmax)."""
    from ir_ads_tpu_torch.ops import dscf_attention as k17
    from ir_ads_tpu_torch.ops import dscf_rpe_jmajor as k18

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    hw, mp, gc = h * w, 640, 16
    q = _rand(g, bg, hw, gc)
    k, v = (F.pad(_rand(g, bg, m, gc), (0, 0, 0, mp - m)) for _ in range(2))
    bias5 = k18.rpe_bias_jmajor(pos, table, h, w, torch.bfloat16)
    bias = _packed_bias(bias5, m, mp, k17.NEG_INF)
    bad = _packed_bias(bias5, m, mp, 0.0)
    del bias5
    scale = 8 ** -0.5
    heads_of = lambda t, n: t.reshape(bg, n, hg, 8).transpose(1, 2)  # noqa: E731
    qh, kh, vh = heads_of(q, hw), heads_of(k, mp), heads_of(v, mp)
    mask = bias.reshape(bg, hw, hg, mp).transpose(1, 2).contiguous()
    return dict(
        name="dscf_attention", case=f"level {level} plane {h}x{w} BG={bg} Mp={mp}",
        run=lambda: k17.dscf_attention(q, k, v, bias, scale, hg),
        plain=lambda: k17.dscf_attention_reference(q, k, v, bias, scale, hg),
        faulted=lambda: k17.dscf_attention_reference(q, k, v, bad, scale, hg),
        fault="padded bias columns 0, not -1e9", base=None,
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                       scale=scale),
        # K4's packed form: the same rounding points, another f32 max/sum order
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(q, k, v, bias) + nbytes(q), flops=4 * 8 * bg * hg * hw * mp,
        rate=BF16_TENSOR_FLOPS,
    )


# Beyond the Swin-B levels: the planes of the tiny test configurations
# (64x128 and 64x80 frames: 16x32 ... 2x4 and 16x20 ... 2x3 maps, odd and
# even widths), planes whose width is not a multiple of 8 or of 4, and key
# counts past the tensor-core design (more than 1024, where both take the
# thread-per-query design) up to K17's largest (Mp 3584).  K16's shapes lie
# in the reference's band domain (band_rows): the tiny planes, tiles over
# two and more image rows (w = 10, 5, 8 with h * w not a multiple of 16), a
# few keys (M = 50) and past 1024.
PACKED_ENVELOPE_K4 = ((16, 32, 64), (8, 16, 32), (4, 8, 16), (2, 4, 8), (16, 20, 40),
                      (4, 5, 10), (2, 3, 6), (4, 10, 600), (7, 9, 50), (5, 8, 2100))
PACKED_ENVELOPE_K17 = ((77, 128), (33, 384), (20, 896), (20, 3584))
# K4's unpacked form at the MiT's head widths: whole 8-pixel copies of the
# bias, an odd width (16-bit copies), the served M on a narrow plane, and
# more keys than the tensor-core design takes (the thread form)
ENVELOPE_WIDTHS = ((16, 20, 40), (7, 9, 50), (4, 10, 600), (5, 8, 2100))
ENVELOPE_K16 = ((16, 32, 64), (4, 8, 16), (2, 4, 8), (12, 10, 600), (8, 5, 50), (7, 8, 50),
                (5, 8, 2100))


def check_packed_envelope(g):
    """K4's two forms, K17 and K16 at the shapes of PACKED_ENVELOPE_* and
    ENVELOPE_K16, and K4's unpacked form at 4, 5 and 10 channels a head at
    those of ENVELOPE_WIDTHS, 2 groups of 2 heads, against their plain
    versions: K4's
    bar and the differing share (ROUNDING_SHARE); K16 also bit for bit
    against K3 followed by K4 unpacked on the same inputs (the table
    (2, 2, 2h - 1, 2w - 1), as the model sizes it)."""
    from ir_ads_tpu_torch.ops import dscf_attention as k17
    from ir_ads_tpu_torch.ops import dscf_fused as k16
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    scale, hg, bg = 8 ** -0.5, 2, 2
    cases = [(f"K4 {'packed' if packed else 'unpacked'} {h}x{w} M={m}",
              lambda h=h, w=w, m=m: (*(_rand(g, bg, n, 16) for n in (h * w, m, m)),
                                     _rand(g, bg, hg, h, m, w, std=0.5)),
              k4.dscf_rows_attention, k4.dscf_rows_reference, (scale, hg, packed), None)
             for packed in (True, False) for h, w, m in PACKED_ENVELOPE_K4]
    cases += [(f"K4 unpacked hc={hc} {h}x{w} M={m}",
               lambda h=h, w=w, m=m, hc=hc: (*(_rand(g, bg, n, hg * hc) for n in (h * w, m, m)),
                                             _rand(g, bg, hg, h, m, w, std=0.5)),
               k4.dscf_rows_attention, k4.dscf_rows_reference, (hc ** -0.5, hg, False), None)
              for hc in (4, 5, 10) for h, w, m in ENVELOPE_WIDTHS]
    cases += [(f"K17 HW={hw} Mp={mp}", lambda hw=hw, mp=mp: (
        *(_rand(g, bg, n, 16) for n in (hw, mp, mp)),
        _rand(g, bg, hw, hg * mp, std=0.5)), k17.dscf_attention,
        k17.dscf_attention_reference, (scale, hg), None) for hw, mp in PACKED_ENVELOPE_K17]

    def two_kernels(q, k, v, pos, table, h, w, scale, hg):
        bias = k3.rpe_bias_rows(pos, table, h, w, q.dtype)
        return k4.dscf_rows_attention(q, k, v, bias, scale, hg, False)

    cases += [(f"K16 {h}x{w} M={m}", lambda h=h, w=w, m=m: (
        *(_rand(g, bg, n, 16) for n in (h * w, m, m)),
        torch.rand(bg, m, 2, generator=g, device="cuda") * 2 - 1,
        _rand(g, 2, hg, 2 * h - 1, 2 * w - 1, std=0.5, dtype=torch.float32)),
        k16.dscf_fused_attention, k16.dscf_fused_reference, (h, w, scale, hg), two_kernels)
        for h, w, m in ENVELOPE_K16]
    for what, make, run, plain, rest, composed in cases:
        args = make()
        got, want = run(*args, *rest), plain(*args, *rest)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        share = float((got != want).float().mean())
        ok = bool((err <= 1e-2 + 2e-2 * want.float().abs()).all()) and share <= ROUNDING_SHARE
        differ = ""
        if composed is not None:
            n_differ = int((got != composed(*args, *rest)).sum())
            differ = f"; against K3 then K4 unpacked: {n_differ} differ"
            ok = ok and not n_differ
        print(f"  envelope        {what:<34} max_abs_err {float(err.max()):.3e} differ "
              f"{share:.4f} (tol atol 0.01 + rtol 0.02, share {ROUNDING_SHARE}){differ}",
              flush=True)
        if not ok:
            fail(f"{what} disagrees with its plain version")


def check_dscf_fused(g, b, level):
    """K16 (pallas4): against its plain version (K3's then K4's unpacked),
    and bit for bit against K3 followed by K4 with packed=False on the same
    inputs, which K3 followed by K4 in the packed form must not be.  Planted
    fault: the packed form (normalise before P.V)."""
    from ir_ads_tpu_torch.ops import dscf_fused as k16
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    gc = 16
    q, k, v = (_rand(g, bg, n, gc) for n in (h * w, m, m))
    scale = 8 ** -0.5
    bf = torch.bfloat16

    def two_kernels(packed):
        return lambda: k4.dscf_rows_attention(q, k, v, k3.rpe_bias_rows(pos, table, h, w, bf),
                                              scale, hg, packed)

    scores = bg * hg * h * w * m
    return dict(
        name="dscf_fused", case=f"level {level} plane {h}x{w} BG={bg}",
        run=lambda: k16.dscf_fused_attention(q, k, v, pos, table, h, w, scale, hg),
        plain=lambda: k16.dscf_fused_reference(q, k, v, pos, table, h, w, scale, hg),
        faulted=lambda: k4.dscf_rows_reference(
            q, k, v, k3.rpe_bias_rows_reference(pos, table, h, w, bf), scale, hg, True),
        fault="the packed form (normalise, round, then P.V)", base=None,
        composition=(lambda out: out, two_kernels(False), "K3 then K4 (packed=False)"),
        not_composition=(two_kernels(True), "K3 then K4 (packed=True)"),
        library=None,
        # K4's unpacked form on K3's bias: the same rounding points
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(q, k, v, pos, table) + nbytes(q),
        # the bias sample (f32, as K3's count) and the score and P.V dots
        flops=(scores * 20, scores * 32), rate=(F32_FLOPS, BF16_TENSOR_FLOPS),
    )


def check_patch_embed(g, b):
    """K19 at the flat r5 path's shape: one stream of a request, b flat
    480x640 frames (B, 480, 1920) bf16, the (48, 128) weight ~ N(0, 1/48),
    LayerNorm parameters f32 around 1 and 0, as the module holds them (the
    wrapper rounds them to bf16, as the Pallas kernel does).  Planted fault:
    the XLA form, whose LayerNorm scale and bias stay f32.  No one PyTorch
    call computes patchify + projection + LayerNorm: F.conv2d (kernel =
    stride = 4) then F.layer_norm on an NCHW copy is timed beside it for the
    record."""
    from ir_ads_tpu_torch.ops import patch_embed as k19

    h, w = IMAGE
    x = _rand(g, b, h, w * 3)
    wk2 = _rand(g, 48, 128, std=48 ** -0.5)
    bias = _rand(g, 128, std=0.02)
    ln_w = _rand(g, 128, std=0.05, mean=1.0, dtype=torch.float32)
    ln_b = _rand(g, 128, std=0.02, dtype=torch.float32)
    args = (x, wk2, bias, ln_w, ln_b, 4, 3)
    nchw = x.reshape(b, h, w, 3).permute(0, 3, 1, 2).contiguous()
    conv_w = wk2.t().reshape(128, 4, 4, 3).permute(0, 3, 1, 2).contiguous()
    ln_wb, ln_bb = ln_w.to(torch.bfloat16), ln_b.to(torch.bfloat16)

    def conv_then_norm():
        y = F.conv2d(nchw, conv_w, bias, stride=4)
        return F.layer_norm(y.permute(0, 2, 3, 1), (128,), ln_wb, ln_bb, 1e-5)

    pixels = b * (h // 4) * (w // 4)
    return dict(
        name="patch_embed", case=f"flat {b}x{h}x{w * 3}",
        run=lambda: k19.patch_embed(*args),
        plain=lambda: k19.patch_embed_reference(*args),
        faulted=lambda: k19.patch_embed_reference(*args, round_ln=False),
        fault="the XLA form (LayerNorm scale and bias in f32)", base=None,
        library=None, also=("conv2d + layer_norm (no single call)", conv_then_norm),
        # the same rounding points; the f32 sums of the 48 products and of
        # the LayerNorm's statistics run in another order, so an output near
        # a bf16 rounding boundary can flip by one ulp
        atol=1e-2, rtol=1e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(x, wk2, bias, ln_wb, ln_bb) + pixels * 128 * 2,
        flops=2 * pixels * 48 * 128, rate=BF16_TENSOR_FLOPS,
    )


def check_window_attention_v1(g, b, h_real, w_real, c, heads, shift):
    """K20 at one Swin-B stage of a 480x640 tile (b tiles: 560, 140, 48, 16
    windows, N 144, d 32), q, k and v apart.  Planted fault: on a shifted
    case the region mask left out, on an unshifted one the twin's form
    (q * bf16(scale) rounded to bf16)."""
    from ir_ads_tpu_torch.ops import window_attention_v1 as k20

    qkv, bias, region, scale, bn = _window_qkv_inputs(g, b, h_real, w_real, c, heads, shift)
    q, k, v = (t.contiguous() for t in _split_heads(qkv, heads))
    if shift:
        fault = "region mask dropped"
        faulted = lambda: k20.window_attention_v1_reference(  # noqa: E731
            q, k, v, bias, None, scale)
    else:
        fault = "the twin's form (q * bf16(scale) rounded)"
        faulted = lambda: k20.window_attention_v1_twin(  # noqa: E731
            q, k, v, bias, region, scale)
    n = qkv.shape[1]
    design = "tensor cores" if k20.tensor_core_design(q.dtype, n, c // heads) else "threads"
    return dict(
        name="window_attention_v1", case=f"C={c} {bn} windows shift {shift} ({design})",
        run=lambda: k20.window_attention_v1(q, k, v, bias, region, scale),
        plain=lambda: k20.window_attention_v1_reference(q, k, v, bias, region, scale),
        faulted=faulted, fault=fault, base=None,
        library=_sdpa_with_region(qkv, bias, region, scale, heads),
        # the same rounding points (q * scale kept f32, as three bf16 parts
        # on the tensor cores, the probabilities, the output), f32 sums of
        # another order: a rounding may flip by one ulp.  The twin's form,
        # which rounds q * bf16(scale), puts about a third of the outputs an
        # ulp away
        atol=1e-2, rtol=2e-2, share_tol=ROUNDING_SHARE,
        bytes=nbytes(q, k, v, bias, region) + nbytes(q), flops=4 * bn * n * n * c,
        rate=BF16_TENSOR_FLOPS,
    )


def check_window_attention_v1_envelope(g, b, dtype, d):
    """K20 outside the tensor-core design's shapes, which then takes the
    thread design: stage 2's shifted windows (48 of 144 tokens) at 512
    channels in f32 with d = 32, or in bf16 with d = 64 (8 heads).  Planted
    fault: the region mask dropped.  Bars: bf16 as the stage cases; f32 to
    f32 rounding (the sums' order), without a share of differing outputs,
    which f32 sums of another order move."""
    from ir_ads_tpu_torch.ops import window_attention_v1 as k20

    c, heads = 512, 512 // d
    qkv, bias, region, scale, bn = _window_qkv_inputs(g, b, 30, 40, c, heads, 6)
    qkv = qkv.to(dtype)
    q, k, v = (t.contiguous() for t in _split_heads(qkv, heads))
    n = qkv.shape[1]
    if k20.tensor_core_design(dtype, n, d):
        fail(f"K20's envelope case {dtype} d={d} lies inside the tensor-core design")
    bf = dtype == torch.bfloat16
    return dict(
        name="window_attention_v1",
        case=f"envelope {str(dtype)[6:]} d={d} {bn} windows shift 6 (threads)",
        run=lambda: k20.window_attention_v1(q, k, v, bias, region, scale),
        plain=lambda: k20.window_attention_v1_reference(q, k, v, bias, region, scale),
        faulted=lambda: k20.window_attention_v1_reference(q, k, v, bias, None, scale),
        fault="region mask dropped", base=None,
        library=_sdpa_with_region(qkv, bias, region, scale, heads),
        atol=1e-2 if bf else 1e-5, rtol=2e-2 if bf else 1e-5,
        **(dict(share_tol=ROUNDING_SHARE) if bf else {}),
        bytes=nbytes(q, k, v, bias, region) + nbytes(q), flops=4 * bn * n * n * c,
        rate=BF16_TENSOR_FLOPS if bf else F32_FLOPS,
    )


def check_window_attention_v1_grad(g, b, h_real, w_real, c, heads, shift):
    """K20 under autograd (``fused_window_attention``): its output against
    the plain version's, and the gradients of q, k, v and the bias its
    backward takes (the twin's vjp, recomputed) against
    ``torch.autograd.grad`` of the twin.  Planted fault: the twin's vjp
    without the region mask."""
    from ir_ads_tpu_torch.ops import window_attention_v1 as k20

    qkv, bias, region, scale, bn = _window_qkv_inputs(g, b, h_real, w_real, c, heads, shift)
    q, k, v = (t.contiguous() for t in _split_heads(qkv, heads))
    dout = _rand(g, *q.shape)

    def through(forward, backward, reg):
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = forward(*leaves, reg, scale)
        if backward is not forward:
            out = out.detach()
            grads = torch.autograd.grad(backward(*leaves, reg, scale), leaves, dout)
        else:
            grads = torch.autograd.grad(out, leaves, dout)
        return (out.detach(), *grads)

    n = qkv.shape[1]
    fused = k20.fused_window_attention
    return dict(
        name="window_attention_v1", case=f"autograd C={c} {bn} windows shift {shift}",
        run=lambda: through(fused, fused, region),
        plain=lambda: through(k20.window_attention_v1_reference, k20.window_attention_v1_twin,
                              region),
        faulted=lambda: through(k20.window_attention_v1_reference,
                                k20.window_attention_v1_twin, None),
        fault="vjp without the region mask", base=None,
        library=_sdpa_grad(lambda ins: ins[:3], bias, region, scale, dout, (q, k, v, bias)),
        outputs=["out", "dq", "dk", "dv", "dbias"],
        # the output as above; the backward is the twin's own vjp, recomputed
        # from the same inputs: equal but for the order of its f32 sums
        atol=[1e-2] + [1e-6] * 4, rtol=[2e-2] + [1e-6] * 4,
        bytes=nbytes(q, k, v, bias, region, dout) + nbytes(q, q, k, v, bias),
        flops=4 * bn * n * n * c * 3, rate=BF16_TENSOR_FLOPS,
    )


def _f32_scale():
    """Give every forward attention the f32 scale, the parent commit's form
    before the scale was rounded to q's dtype (``ops.layers.q_scale``);
    returns a function that restores the repaired form."""
    import importlib

    names = ("ops.swin_block", "ops.swin_block_v6", "ops.swin_block_int8",
             "ops.swin_block_v7", "ops.swin_block_full", "ops.window_attention",
             "ops.window_attention_qkv", "ops.window_attention_map", "ops.dscf_rows",
             "ops.dscf_fused", "ops.dscf_attention", "detection.transformer")
    mods = [importlib.import_module(f"ir_ads_tpu_torch.{n}") for n in names]
    saved = [m.q_scale for m in mods]
    for m in mods:
        m.q_scale = lambda scale, dtype: float(scale)
    return lambda: [setattr(m, "q_scale", f) for m, f in zip(mods, saved)]


def repair_record(g, images):
    """How far the parent's f32 scale moves K1 at stage 0 and K4 at level 0
    on phase 3's inputs: the share of differing outputs and the distance on
    what the kernel adds (information, no bar)."""
    out = {}
    for what, case in (
            ("K1 stage 0", check_window_block(g, images, 120, 160, 128, 4, 6,
                                              "region mask dropped")),
            ("K4 level 0", check_rows(g, images, 0))):
        new = case["run"]()
        restore = _f32_scale()
        try:
            old = case["run"]()
            torch.cuda.synchronize()
        finally:
            restore()
        share, rel = float((old != new).float().mean()), _rel(old, new, case["base"])
        print(f"  repair record, {what} ({case['case']}): the parent's f32 scale moves "
              f"{share:.4f} of the kernel's outputs, rel {rel:.3e} (information, no bar)",
              flush=True)
        out[what] = dict(share=share, rel=rel)
        del new, old, case
    torch.cuda.empty_cache()
    return out


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


def check_rows_bwd(g, b, level, hc=8):
    """K8 at one DSCF level's training shape, heads of ``hc`` channels (8:
    Swin-B, 12: Swin-L).  dq is a bf16 rounding of an
    f32 sum over 600 keys of bf16(dS * scale) products (rtol two ulps, atol
    5 % of rms); dk and dv are f32 sums over every query pixel of products
    of bf16-rounded factors whose rounding can flip (1 % of rms, rtol two
    ulps); dbias is dS itself in f32 (1e-3, the exp's and the sums' last
    bits)."""
    from ir_ads_tpu_torch.ops import dscf_rows_bwd as k8
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    h, w, groups, bg, hg, m, pos, table = _dscf_inputs(g, b, level)
    gc = hg * hc
    q = _rand(g, bg, h * w, gc)
    k = _rand(g, bg, m, gc)
    v = _rand(g, bg, m, gc)
    dout = _rand(g, bg, h * w, gc)
    # contiguous, as K3 writes it on the main path (the wrapper would copy a
    # strided view, 0.29 ms at level 0, inside the kernel's timing)
    bias = k3.rpe_bias_rows_reference(pos, table, h, w, torch.bfloat16).contiguous()
    scale = hc ** -0.5
    run = lambda: k8.dscf_rows_bwd(q, k, v, bias, dout, scale, hg)  # noqa: E731
    plain = lambda: k8.dscf_rows_bwd_reference(q, k, v, bias, dout, scale, hg)  # noqa: E731

    def faulted():
        dq, dk, dv, dbias = plain()
        return dq, dk, dv, dbias * scale

    heads_of = lambda t, n: t.reshape(bg, n, hg, hc).transpose(1, 2)  # noqa: E731
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
        name="dscf_rows_bwd",
        case=f"level {level} plane {h}x{w} BG={bg}" + ("" if hc == 8 else f" hc={hc}"),
        run=run, plain=plain, faulted=faulted, fault="dbias scaled by scale",
        base=None, library=library, outputs=["dq", "dk", "dv", "dbias"],
        atol=[0.05, 0.01, 0.01, 1e-3], rtol=[2e-2, 2e-2, 2e-2, 1e-3],
        atol_of_rms=True, share_report=("dq",),
        bytes=nbytes(q, k, v, bias, dout) + nbytes(q) + 2 * nbytes(k) * 2 + scores * 4,
        flops=scores * (8 * hc + 16), rate=BF16_TENSOR_FLOPS,
    )


def _without_half_pixel(loc, spatial_shapes):
    """Locations that make the plain version sample at loc * size instead
    of loc * size - 0.5: the planted fault 'no -0.5'."""
    norm = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=loc.device)
    return loc + 0.5 / norm[None, None, None, :, None, :]


def _border_padding(loc, spatial_shapes):
    """Locations clamped into each level's pixel centres: the plain version
    then keeps the weight of a corner outside the map on its clamped index
    (grid_sample's border padding), the planted fault 'zeros padding lost'."""
    size = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=loc.device)[None, None, None, :, None, :]
    return (torch.minimum((loc * size - 0.5).clamp(min=0.0), size - 1) + 0.5) / size


def check_msdeform(g, lq, dtype, fault):
    """K9 at the DINO encoder shape (every token a query, its reference its
    own position) or the decoder shape (2000 queries anywhere in the image):
    value (1, 20197, 8, 32), 4 levels x 4 points, locations = reference +
    offsets of a few pixels, so that part of the corners fall outside."""
    from ir_ads_tpu_torch.detection.transformer import make_encoder_reference_points
    from ir_ads_tpu_torch.ops import msdeform as k9

    shapes, heads, d, points = DET_LEVELS, 8, 32, 4
    levels = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = _rand(g, 1, s, heads, d, dtype=dtype)
    if lq == s:
        ref = torch.from_numpy(make_encoder_reference_points(shapes)).cuda()[None]
    else:
        ref = torch.rand(1, lq, 1, 2, generator=g, device="cuda").expand(-1, -1, levels, -1)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    reach = torch.arange(1, points + 1, device="cuda")[None, None, None, None, :, None]
    offsets = torch.randn(1, lq, heads, levels, points, 2, generator=g, device="cuda") * reach
    loc = (ref[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]).contiguous()
    att = torch.softmax(torch.randn(1, lq, heads, levels * points, generator=g, device="cuda"),
                        -1).reshape(1, lq, heads, levels, points).to(dtype)

    wgt = torch.stack(k9.corner_tables(shapes, loc, att)[1])
    read = int((wgt != 0).sum())  # corners this run's data reads
    outside = 1.0 - read / wgt.numel()
    del wgt
    bad_loc = (_without_half_pixel if fault == "no -0.5" else _border_padding)(loc, shapes)

    def grid_sample_form():
        """Four F.grid_sample calls and a weighted sum: for the record (no
        single PyTorch call computes the function)."""
        out, start = 0, 0
        grids = 2 * loc - 1
        for lvl, (h, w) in enumerate(shapes):
            v = value[0, start:start + h * w].permute(1, 2, 0).reshape(heads, d, h, w).float()
            start += h * w
            smp = F.grid_sample(v, grids[0, :, :, lvl].transpose(0, 1), mode="bilinear",
                                padding_mode="zeros", align_corners=False)  # (H, D, Lq, P)
            out = out + (smp * att[0, :, :, lvl].float().permute(1, 0, 2)[:, None]).sum(-1)
        return out.permute(2, 0, 1).reshape(1, lq, heads * d).to(dtype)

    f32 = dtype == torch.float32
    slots = lq * heads * levels * points
    return dict(
        name="msdeform",
        case=f"Lq={lq} {'f32' if f32 else 'bf16'} ({outside:.3f} of corners outside; "
             f"gathered {read * d * value.element_size() / 1e6:.0f} MB; "
             f"{DET_LAUNCHES // 2} launches per request)",
        run=lambda: k9.ms_deform_attn(value, shapes, loc, att),
        plain=lambda: k9.ms_deform_attn_plain(value, shapes, loc, att),
        faulted=lambda: k9.ms_deform_attn_plain(value, shapes, bad_loc, att),
        fault=fault, base=None, library=None,
        also=("four F.grid_sample + weighted sum", grid_sample_form),
        # f32: one function, sums of another order.  bf16: the same f32 sums
        # rounded once on store, so a sum near a rounding boundary lands one
        # bf16 ulp (2^-8 relative) apart; atol for sums that cancel
        atol=1e-5 if f32 else 2e-3, rtol=1e-5 if f32 else 1e-2,
        bytes=nbytes(value, loc, att) + lq * heads * d * value.element_size(),
        flops=slots * (4 * d * 2 + 40), rate=F32_FLOPS,
    )


def _rel(got, want, base):
    """||got - want|| / ||want - base|| in f32 (base None: zero)."""
    ref = want.float() if base is None else want.float() - base.float()
    return float((got.float() - want.float()).norm() / ref.norm())


def phase_kernels(seed: int, images: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s_det = sum(h * w for h, w in DET_LEVELS)
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
        # K3 at levels 0-2 (r5) and 3 (r4, r4i8, r2, v5, map), and on clamped
        # positions and positions that take the four-tap search at level 0;
        # K6 at level 3, also on clamped and searched positions
        *(functools.partial(check_rpe, g, images, level) for level in (0, 1, 2, 3)),
        functools.partial(check_rpe, g, images, 0, clamped=True),
        functools.partial(check_rpe, g, images, 0, searched=True),
        *(functools.partial(check_rows, g, images, level) for level in (0, 1, 2)),
        lambda: check_rpe_packed(g, images, 3),
        functools.partial(check_rpe_packed, g, images, 3, clamped=True),
        functools.partial(check_rpe_packed, g, images, 3, searched=True),
        # K6 at the legacy CMNeXt's stage 2 (phase 10): the 30x40 plane of
        # 4 groups, where w >= 32 takes the kernel's other store path
        *(functools.partial(check_rpe_packed, g, images, 2, clamped, searched)
          for clamped, searched in ((False, False), (True, False), (False, True))),
        # the training path: K1 again at stages 2-3; K7 at the four stages as
        # the adapter recipe runs it (attention parameters frozen: no ow, no
        # dbias) and once with every gradient wanted; K8 at levels 0-2
        lambda: check_window_block(g, TRAIN_BATCH, 30, 40, 512, 16, 6,
                                   "region mask dropped"),
        lambda: check_window_block(g, TRAIN_BATCH, 15, 20, 1024, 32, 6,
                                   "rel-pos bias dropped"),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 120, 160, 128, 4, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 60, 80, 256, 8, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 30, 40, 512, 16, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 15, 20, 1024, 32, 6, False, False),
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 60, 80, 256, 8, 6, True, True),
        # and once outside the tensor-core design (d = 16): its first design
        lambda: check_window_attn_bwd(g, TRAIN_BATCH, 60, 80, 256, 16, 6, False, False),
        *(functools.partial(check_rows_bwd, g, TRAIN_BATCH, level) for level in (0, 1, 2)),
        # the Swin-L paths (phase 9): K4 and K8 at 12 channels a head at DSCF
        # levels 0-2 (K4 packed there), K4's unpacked form at levels 0-3
        *(functools.partial(check_rows, g, images, level, True, 12) for level in (0, 1, 2)),
        *(functools.partial(check_rows, g, images, level, False, 12) for level in (0, 1, 2, 3)),
        *(functools.partial(check_rows_bwd, g, TRAIN_BATCH, level, 12) for level in (0, 1, 2)),
        # the legacy CMNeXt under r4, r4i8, r2, v5 and map (phase 10): K4's
        # unpacked form (level 3 at every MiT stage) at the MiT's head widths,
        # 10 at stage 2 of CMNeXt-B1..B5 (BG 16, 30x40, M 600) and CMNeXt-B0's
        # 4, 4, 5, 4 at its four stages; its 8 at the other stages of B1-B5 is
        # the unpacked form at levels 0-3 below, and K3 at the MiT's stage-0
        # plane (g 1, 120x160) is check_rpe's level 0 above
        functools.partial(check_rows, g, images, 2, False, 10, "channel dropped"),
        functools.partial(check_rows, g, images, 2, False, 10, "next head overwritten"),
        functools.partial(check_rows, g, images, 0, False, 4, "channel dropped"),
        functools.partial(check_rows, g, images, 1, False, 4, "next head overwritten"),
        functools.partial(check_rows, g, images, 2, False, 5, "next head overwritten"),
        functools.partial(check_rows, g, images, 3, False, 4, "channel dropped"),
        # the detection path: K9 as the encoder's self-attention and the
        # decoder's cross-attention run it (bf16), and once each in f32
        lambda: check_msdeform(g, s_det, torch.bfloat16, "no -0.5"),
        lambda: check_msdeform(g, DET_QUERIES, torch.bfloat16, "zeros padding lost"),
        lambda: check_msdeform(g, s_det, torch.float32, "zeros padding lost"),
        lambda: check_msdeform(g, DET_QUERIES, torch.float32, "no -0.5"),
        # the r4i8 path: K10 and K11 at the four stages, then their s8 GEMM
        # at each product's shape
        *int8_cases(g, images),
        *igemm_cases(g, images),
        # the r2 and r1 paths: K12 at the four stages, shifted and not, and
        # once under autograd
        *(functools.partial(check_window_attention_qkv, g, images, h, w, c, heads, shift)
          for h, w, c, heads in STAGES for shift in (0, 6)),
        lambda: check_window_attention_qkv_grad(g, images, 30, 40, 512, 16, 6),
        # the block variants: K13 at the v7_01 path's stages 0-1 (and once
        # with adapters stacked over two streams), K14 (v5) and K15 (map) at
        # the four stages, shifted and not, each also against the
        # composition of kernels it replaces
        *(functools.partial(check_window_block_v7, g, images, h, w, c, heads, shift)
          for h, w, c, heads in STAGES[:2] for shift in (0, 6)),
        functools.partial(check_window_block_v7, g, images, *STAGES[1], 6, streams=2),
        *(functools.partial(check_window_block_full, g, images, h, w, c, heads, shift)
          for h, w, c, heads in STAGES for shift in (0, 6)),
        *(functools.partial(check_window_attention_map, g, images, h, w, c, heads, shift)
          for h, w, c, heads in STAGES for shift in (0, 6)),
        # the DSCF variants: K18 (pallas2) and K17 (pallas, pallas2) at levels
        # 0 and 3, K16 (pallas4) at levels 0-2; K4's unpacked form at level 3
        # (r4, r4i8, r2, v5, map) and at levels 0-2, where K16 is held
        # against K3 followed by it
        *(functools.partial(check_rpe_jmajor, g, images, level, clamped)
          for clamped in (False, True) for level in (0, 1, 2, 3)),
        *(functools.partial(check_dscf_attention, g, images, level) for level in (0, 3)),
        *(functools.partial(check_dscf_fused, g, images, level) for level in (0, 1, 2)),
        *(functools.partial(check_rows, g, images, level, packed=False)
          for level in (0, 1, 2, 3)),
        # the flat r5 path: K19 on one stream of a request; K20 (v1, which
        # no model path runs) at the four stages, shifted and not, and once
        # under autograd
        functools.partial(check_patch_embed, g, images),
        *(functools.partial(check_window_attention_v1, g, images, h, w, c, heads, shift)
          for h, w, c, heads in STAGES for shift in (0, 6)),
        functools.partial(check_window_attention_v1_envelope, g, images, torch.bfloat16, 64),
        functools.partial(check_window_attention_v1_envelope, g, images, torch.float32, 32),
        lambda: check_window_attention_v1_grad(g, images, 30, 40, 512, 16, 6),
        # the Swin block kernels' attention outside the tensor-core design
        # (d = 64), where they take the first design by shape: K1, K10 and
        # K13 on the padded, rolled map (window_attn_kernel and its copies),
        # K5 and K14 on the real map (real_map_window_attention)
        lambda: check_window_block(g, images, 30, 40, 512, 8, 6, "region mask dropped"),
        lambda: check_window_block_v6(g, images, 30, 40, 512, 8, 6,
                                      "roll left out, mask kept"),
        functools.partial(check_window_block_int8, g, images, 30, 40, 512, 8, 6),
        functools.partial(check_window_block_v7, g, images, 60, 80, 256, 4, 6),
        functools.partial(check_window_block_full, g, images, 30, 40, 512, 8, 6),
    ]
    rows = [hold(make()) for make in cases]
    rows += [check_tail_hidden(g, images * h * w, c) for h, w, c, _ in STAGES]
    check_packed_envelope(g)
    return rows


# the four Swin stages of a 480x640 tile: real map, channels, heads
STAGES = ((120, 160, 128, 4), (60, 80, 256, 8), (30, 40, 512, 16), (15, 20, 1024, 32))


def int8_cases(g, images):
    """K10 and K11 at the r4i8 path's four stages (480x640 tiles: maps
    120x160 down to 15x20; K10 on the map padded to whole windows)."""
    return [
        *(functools.partial(check_window_block_int8, g, images, h, w, c, heads, 6 * (i != 1))
          for i, (h, w, c, heads) in enumerate(STAGES)),
        functools.partial(check_window_block_int8, g, images, *STAGES[2][:2], 512, 16, 6,
                          peaked=True),
        *(functools.partial(check_block_tail_int8, g, images * h * w, c)
          for h, w, c, _ in STAGES),
    ]


def hold(case):
    """Hold one case's kernel against its plain version (and its planted
    fault); print the errors and the times; return the kernel table's row.
    With ``share_tol`` the share of differing outputs is barred too, and the
    fault must fail one of the bars; with ``composition`` the kernel must be
    bit-equal to the kernels it replaces, and with ``not_composition`` not
    to a composition that rounds otherwise."""
    also = case.pop("also", None)
    composition = case.pop("composition", None)
    not_composition = case.pop("not_composition", None)
    run, plain, library = case.pop("run"), case.pop("plain"), case.pop("library")
    faulted, base = case.pop("faulted"), case.pop("base")
    names = case.pop("outputs", ["out"])
    per_launch = case.pop("per_launch", None)
    of_rms = case.pop("atol_of_rms", False)
    rel_tol = case.pop("rel_tol", REL_TOL)
    share_tol = case.pop("share_tol", None)
    share_report = case.pop("share_report", ())
    as_list = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
    atols, rtols = as_list(case["atol"]), as_list(case["rtol"])
    got, want = as_list(run()), as_list(plain())
    torch.cuda.synchronize()
    bad = as_list(faulted())
    finite, elem_ok, max_err, rel, fault_rel, parts = True, True, 0.0, 0.0, 0.0, []
    share, fault_share = 0.0, 0.0
    for name, gt, wt, bd, atol, rtol in zip(names, got, want, bad, atols, rtols):
        err = (gt.float() - wt.float()).abs()
        tol = atol * (_rms(wt) if of_rms else 1.0) + rtol * wt.float().abs()
        finite = finite and bool(torch.isfinite(gt.float()).all())
        elem_ok = elem_ok and bool((err <= tol).all())
        r, fr = _rel(gt, wt, base), _rel(bd, wt, base)
        sh, fsh = float((gt != wt).float().mean()), float((bd != wt).float().mean())
        parts.append(f"{name} max_abs_err {float(err.max()):.3e} rel {r:.3e}"
                     + (f" differ {sh:.4f}" if share_tol is not None else "")
                     + (f" differ {sh:.4f} (ROUNDING_SHARE {ROUNDING_SHARE}, reported)"
                        if name in share_report else ""))
        if name in share_report:
            case[f"{name}_share"] = sh
        max_err, rel, fault_rel = max(max_err, float(err.max())), max(rel, r), max(fault_rel, fr)
        share, fault_share = max(share, sh), max(fault_share, fsh)
        del err, tol
    composed, composed_ms = "", None
    if composition is not None:
        # the kernel against the composition of kernels it replaces: bit-equal
        view, compose, what = composition
        mine, theirs = view(got[0]), compose()
        torch.cuda.synchronize()
        differ = int((mine != theirs).sum())
        composed = f"; against {what}: {differ} of {mine.numel()} elements differ"
        case["composition_differ"] = differ
        if differ:
            print(f"  {case['name']:<15} {case['case']:<34}{composed}", flush=True)
            fail(f"{case['name']} ({case['case']}) is not bit-equal to {what}")
        if not_composition is not None:
            other, other_what = not_composition
            n_other = int((mine != other()).sum())
            composed += f", against {other_what}: {n_other}"
            case["not_composition_differ"] = n_other
            if not n_other:
                fail(f"{case['name']} ({case['case']}): the bit-equality cannot tell "
                     f"{what} from {other_what}")
        composed_ms = time_ms(compose)
        composed += f" (the composition {composed_ms:.4f} ms)"
        del mine, theirs
    del got, want, bad
    ms = time_ms(run)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    lib_ms = time_ms(library) if library else None
    also_ms = f"; {also[0]} {time_ms(also[1], iters=3, warmup=1):.4f} ms" if also else ""
    b_ms, b_by = bound_ms(case["bytes"], case["flops"], case["rate"])
    share_txt = (f"; differing share tol {share_tol}, fault's {fault_share:.4f}"
                 if share_tol is not None else "")
    print(
        f"  {case['name']:<15} {case['case']:<34} " + "; ".join(parts) +
        f" (tol atol {case['atol']}{' x rms' if of_rms else ''} + rtol {case['rtol']}; "
        f"rel tol {rel_tol}{share_txt}; planted fault '{case['fault']}': {fault_rel:.3e}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {'%.4f' % lib_ms if lib_ms is not None else 'n/a'} ms "
        f"bound {b_ms:.4f} ms ({b_by}){also_ms}{composed}",
        flush=True,
    )
    share_ok = share_tol is None or share <= share_tol
    if not (finite and elem_ok and rel <= rel_tol and share_ok):
        fail(f"{case['name']} ({case['case']}) disagrees with its plain version")
    if fault_rel <= rel_tol and (share_tol is None or fault_share <= share_tol):
        fail(f"{case['name']} ({case['case']}): the planted fault "
             f"'{case['fault']}' passes the bar, which is too loose")
    row = dict(case, max_abs_err=max_err, rel_err=rel, fault_rel_err=fault_rel, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               composition_ms=composed_ms)
    if share_tol is not None:
        row.update(share=share, fault_share=fault_share, share_tol=share_tol)
    if per_launch is not None:
        row["launch_ms"] = per_launch()
    del run, plain, library, faulted, base, case, also, composition, not_composition, per_launch
    torch.cuda.empty_cache()
    return row


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
# r4i8's kernel path against its all-plain path: both quantize and sum in s8
# exactly, and differ where a bf16 rounding flips (as under r4) and then moves
# an s8 code by one step, which every later block's per-row scales carry on:
# mean 1.244e-2, worst 2.427e-2, labels 0.9696 (an H100 at 700 W; r5: 6.8e-3
# and 0.982).  The float path is not much further: r5's logits on the same
# weights and frames lie 1.78e-2 from r4i8's, labels 0.951.  So the bars sit
# between the two, mean 1.6e-2 and labels 0.96, and the phase prints where
# r5 falls against them; a K10 without its region mask (every shifted block
# of both streams, 1.08e-1) must fail them too.
LOGIT_TOL_I8 = dict(rel_mean=1.6e-2, rel_max=0.06, label_agree=0.96)


def _ops_modules():
    from ir_ads_tpu_torch.ops import (
        block_tail, block_tail_int8, dscf_attention, dscf_fused, dscf_rows, dscf_rows_bwd,
        dscf_rpe, dscf_rpe_jmajor, dscf_rpe_packed, msdeform, msdeform_bwd, patch_embed,
        swin_block, swin_block_full, swin_block_int8, swin_block_v6, swin_block_v7,
        window_attention_map, window_attention_qkv, window_attention_v1, window_attn_bwd,
    )

    return (swin_block, block_tail, swin_block_v6, dscf_rpe, dscf_rows,
            dscf_rpe_packed, window_attn_bwd, dscf_rows_bwd, msdeform, swin_block_int8,
            block_tail_int8, window_attention_qkv, swin_block_v7, swin_block_full,
            window_attention_map, dscf_fused, dscf_attention, dscf_rpe_jmajor, patch_embed,
            window_attention_v1, msdeform_bwd)


# the kernels of each DSCF branch (``DAttentionMM.branch``); the einsum
# branch's bias is K6 where ``bias_kernel`` says so
DSCF_BRANCH_KERNELS = {"pallas3": ("dscf_rpe", "dscf_rows"), "pallas4": ("dscf_fused",),
                       "pallas": ("dscf_attention",),
                       "pallas2": ("dscf_rpe_jmajor", "dscf_attention"), "xla": ()}


def expected_launches(model, image=IMAGE):
    """Launches of each kernel in one forward of an ``image`` tile (480x640
    unless given; both sides multiples of 32), from the model's dispatch: every block of a stage runs K1 + K2 (pallas4), K10 +
    K11 (pallas4 under int8), K5 (pallas6), K13 (pallas7), K14 + K2
    (pallas5), or its module path and K2 (pallas: with K12; pallas_map: with
    K15; xla: with no attention kernel); every DSCF level the kernels of the
    branch it takes for the n = (H/32) x (W/32) offsets a field of every
    level (15 x 20 at 480x640, where 2n % 8 == 0): K3 + K4 (pallas3), K16 (pallas4), K17 (pallas), K18 +
    K17 (pallas2), or the einsum attention, its bias by K6 where the
    dispatch takes the packed kernel for a plane of at most 2048 pixels; the
    two streams run in turn, or under ``dual_batch`` through one launch a
    block but K2's and K11's, which run once a stream; K19 embeds each
    stream's flat frames where the model's patch embedding takes it
    (``patch_embed="pallas"``)."""
    n = dict.fromkeys((m.KERNEL.name for m in _ops_modules()), 0)
    for k in ("window_attn_bwd", "dscf_rows_bwd", "msdeform"):
        del n[k]
    if not hasattr(model.backbone, "stages"):
        return _legacy_launches(model, image, n)
    if model.backbone.patch_embed.impl == "pallas":  # K19, one launch a stream
        n["patch_embed"] += 2
    per_block = {"pallas6": ("swin_block_v6",), "pallas4": ("swin_block", "block_tail"),
                 "pallas7": ("swin_block_v7",), "pallas5": ("swin_block_full", "block_tail"),
                 "pallas": ("window_attention_qkv", "block_tail"),
                 "pallas_map": ("window_attention_map", "block_tail"), "xla": ("block_tail",)}
    once = model.backbone.dual_batch
    for stage in model.backbone.stages:
        for blk in stage.blocks:
            names = (("swin_block_int8", "block_tail_int8") if blk.int8
                     else per_block[blk.attn_impl])
            for k in names:
                n[k] += 1 if once and k not in ("block_tail", "block_tail_int8") else 2
    offsets = (image[0] // 32) * (image[1] // 32)
    for level, dm in enumerate(model.backbone.DeformMPGBlocks):
        da = dm.deform_atten
        names = DSCF_BRANCH_KERNELS[da.branch(offsets)]
        if not names and da.bias_kernel(image[0] // 4 >> level, image[1] // 4 >> level):
            names = ("dscf_rpe_packed",)
        for k in names:
            n[k] += 1
    return n


def _legacy_launches(model, image, n):
    """``expected_launches`` of a legacy model: no Swin block; the MiT's
    DSCF at every stage on the stage's plane (the image / 4 halved by each
    later patch embedding, rounding up), with n = hk x wk offsets a field
    (the offset head's 9x9 convolution of stride 8, 4, 2, 1, padding 4):
    K3 + K4 where the dispatch takes pallas3 and 2n % 8 == 0, else the
    einsum attention, its bias by K6 where the dispatch takes the packed
    kernel for at most 2048 pixels; CMX none."""
    h, w = -(-image[0] // 4), -(-image[1] // 4)
    for i, dm in enumerate(getattr(model.backbone, "DeformMPGBlocks", ())):
        if i:
            h, w = -(-h // 2), -(-w // 2)
        da, s = dm.deform_atten, 8 >> i
        offsets = ((h - 1) // s + 1) * ((w - 1) // s + 1)
        names = DSCF_BRANCH_KERNELS[da.branch(offsets)]
        if not names and da.bias_kernel(h, w):
            names = ("dscf_rpe_packed",)
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


def _window_attention_qkv_no_region(qkv, bias, region, scale, heads):
    """K12's plain version with the planted fault: no shift-region mask."""
    from ir_ads_tpu_torch.ops.window_attention_qkv import window_attention_qkv_reference

    return window_attention_qkv_reference(qkv, bias, None, scale, heads)


def _window_block_int8_no_region(x, ln_w, ln_b, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj,
                                 bias, region, *rest):
    """K10's plain version with K1's planted fault: no shift-region mask."""
    from ir_ads_tpu_torch.ops.swin_block_int8 import window_block_int8_reference

    return window_block_int8_reference(x, ln_w, ln_b, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                                       bproj, bias, None, *rest)


def _plain_path(**faults):
    """Point the backbone at the plain versions (on CUDA tensors), with any
    of them replaced by ``faults``, and return a function that restores the
    kernels."""
    from ir_ads_tpu_torch.models.backbones import swin
    from ir_ads_tpu_torch.ops import (
        block_tail, block_tail_int8, dscf_attention, dscf_fused, dscf_rows, dscf_rpe,
        dscf_rpe_jmajor, dscf_rpe_packed, swin_block, swin_block_full, swin_block_int8,
        swin_block_v6, swin_block_v7, window_attention_map, window_attention_qkv,
    )

    swap = {
        "window_attention_qkv": window_attention_qkv.window_attention_qkv_reference,
        "window_attention_map": window_attention_map.window_attention_map_reference,
        "window_block_full": swin_block_full.window_block_full_reference,
        "window_block_v7": swin_block_v7.window_block_v7_reference,
        "window_block": swin_block.window_block_reference,
        "block_tail": block_tail.block_tail_reference,
        "window_block_v6": swin_block_v6.window_block_v6_reference,
        "window_block_int8": swin_block_int8.window_block_int8_reference,
        "block_tail_int8": block_tail_int8.block_tail_int8_reference,
        "rpe_bias_rows": lambda pos, table, h, w, dt: dscf_rpe.rpe_bias_rows_reference(
            pos.float(), table.float(), h, w, dt),
        "rpe_bias_packed": lambda pos, table, h, w, dt: (
            dscf_rpe_packed.rpe_bias_packed_reference(pos.float(), table.float(), h, w, dt)),
        "dscf_rows_attention": dscf_rows.dscf_rows_reference,
        "dscf_fused_attention": lambda q, k, v, pos, table, *rest: (
            dscf_fused.dscf_fused_reference(q, k, v, pos.float(), table.float(), *rest)),
        "dscf_attention": dscf_attention.dscf_attention_reference,
        "rpe_bias_jmajor": lambda pos, table, h, w, dt: (
            dscf_rpe_jmajor.rpe_bias_jmajor_reference(pos.float(), table.float(), h, w, dt)),
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


R5_LAUNCHES = {"swin_block": 8, "block_tail": 8, "swin_block_v6": 40, "dscf_rpe": 3,
               "dscf_rows": 3, "dscf_rpe_packed": 1}
# r4i8: K10 + K11 at the 24 blocks of both streams, K3 + K4 at the 4 levels
R4I8_LAUNCHES = {"swin_block_int8": 48, "block_tail_int8": 48, "dscf_rpe": 4, "dscf_rows": 4}
# the module path: K12 (r2, r1) and K2 at the 24 blocks of both streams;
# K3 + K4 at the 4 levels under r2, the einsum DSCF with its XLA-form bias
# (no kernel) under r1 and xla
MODULE_LAUNCHES = {
    "r2": {"window_attention_qkv": 48, "block_tail": 48, "dscf_rpe": 4, "dscf_rows": 4},
    "r1": {"window_attention_qkv": 48, "block_tail": 48},
    "xla": {"block_tail": 48},
}


def _plain_request(pred, frames, **faults):
    """The first request through ``pred`` with the plain versions (and
    ``faults``) in place of the kernels."""
    restore = _plain_path(**faults)
    try:
        out = pred(*frames[0])
        torch.cuda.synchronize()
    finally:
        restore()
    return out


def _compare(got, got_labels, want, want_labels, what, tol):
    err = (got - want).abs()
    rel_mean = float(err.mean() / want.abs().mean())
    rel_max = float(err.max() / want.abs().max())
    agree = float((got_labels == want_labels).float().mean())
    print(f"  {what} vs plain versions on the card: mean |err| / mean |ref| "
          f"{rel_mean:.3e} (tol {tol['rel_mean']}), max |err| / max |ref| "
          f"{rel_max:.3e} (tol {tol['rel_max']}), labels agree "
          f"{agree:.4f} (tol {tol['label_agree']})", flush=True)
    return (rel_mean <= tol["rel_mean"] and rel_max <= tol["rel_max"]
            and agree >= tol["label_agree"])


def _served(pred, frames, requests, batch, want_per_request, what):
    """Serve ``frames`` with every launch count at 0 first; check the
    dispatch's launches per request, the launches, shapes and finiteness.
    Returns (latencies, outputs, launches)."""
    _warm_up(pred, frames)
    torch.cuda.reset_peak_memory_stats()  # phase 3 allocated more than serving does
    kernels = _reset_launches()
    lat, outs = _serve(pred, frames)
    launches = {k.name: k.launches for k in kernels}
    per_request = {k: v for k, v in expected_launches(pred.model).items() if v}
    if per_request != want_per_request:
        fail(f"the {what} predictor's dispatch gives {per_request} launches per request, "
             f"not {want_per_request}")
    for name, n in launches.items():
        if n != per_request.get(name, 0) * requests:
            fail(f"{name} launched {n} times on the {what} path, expected "
                 f"{per_request.get(name, 0)} per request x {requests}")
    for logits, labels in outs:
        if logits.shape != (batch, *IMAGE, NUM_CLASSES) or labels.shape != (batch, *IMAGE):
            fail(f"output shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail("non-finite logits")
    return lat, outs, launches


def _request_frames(seed, requests, batch):
    """The served requests' uint8 RGB and depth frames, from the seed."""
    g = torch.Generator().manual_seed(seed + 1)
    return [tuple(torch.randint(0, 256, (batch, *IMAGE, 3), generator=g, dtype=torch.uint8)
                  for _ in range(2)) for _ in range(requests)]


def phase_serve(seed: int, requests: int, batch: int, card_line: str):
    from ir_ads_tpu_torch.serve import SemSegPredictor

    t0 = time.time()
    pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                           image_size=IMAGE)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  model: Swin-B CMNeXt, {n_params / 1e6:.1f} M parameters, bf16, "
          f"r5 dispatch, built in {time.time() - t0:.1f} s", flush=True)
    frames = _request_frames(seed, requests, batch)
    lat, outs, launches = _served(pred, frames, requests, batch, R5_LAUNCHES, "r5")

    want = _plain_request(pred, frames)
    if not _compare(*outs[0], *want, "kernel path", LOGIT_TOL):
        fail("kernel path disagrees with the plain path end to end")
    # the same bar must see a fault in one piece of one kernel's function
    if _compare(*_plain_request(pred, frames, window_block=_window_block_no_region), *want,
                "planted fault (K1 without the shift-region mask)", LOGIT_TOL):
        fail("a K1 without its shift-region mask passes the end-to-end bar")
    if _compare(*_plain_request(pred, frames, window_block_v6=_window_block_v6_no_region),
                *want, "planted fault (K5 without the shift-region mask)", LOGIT_TOL):
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
                 frames_per_s=batch * 1e3 / p50,
                 parent_f32_scale=_parent_scale(pred, frames, outs[0][0], "r5"))

    # for the record: the same weights and requests under r4 (no check)
    ref5, labels5 = outs[0]
    del pred, outs, want
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
                       frames_per_s=batch * 1e3 / p50_4, rel_mean_vs_r5=diff,
                       parent_k4_level3=_parent_level3(pred4, frames, outs4[0][0], "r4"))
    refs = {"r5": (ref5, labels5), "r4": outs4[0]}
    del pred4, outs4
    torch.cuda.empty_cache()

    # r4i8, the w8a8 path (K10 + K11, K3 + K4, int8 DSCF and head products):
    # the same weights (quantized from f32 before the cast) and requests
    pred8 = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                            image_size=IMAGE, dispatch="r4i8")
    lat8, outs8, launches8 = _served(pred8, frames, requests, batch, R4I8_LAUNCHES, "r4i8")
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    want8 = _plain_request(pred8, frames)
    if not _compare(*outs8[0], *want8, "r4i8 kernel path", LOGIT_TOL_I8):
        fail("the r4i8 kernel path disagrees with its plain path end to end")
    if _compare(*_plain_request(pred8, frames, window_block_int8=_window_block_int8_no_region),
                *want8, "planted fault (K10 without the shift-region mask)", LOGIT_TOL_I8):
        fail("a K10 without its shift-region mask passes the end-to-end bar")
    _compare(ref5, labels5, *want8, "r5, the float path (information, no bar)", LOGIT_TOL_I8)
    p50_8 = _p50(lat8)
    logits8, labels8 = outs8[0]
    vs5 = float((logits8 - ref5).abs().mean() / ref5.abs().mean())
    agree5 = float((labels8 == labels5).float().mean())
    print(f"  r4i8: latency ms {['%.1f' % v for v in lat8]} p50 {p50_8:.1f}, "
          f"{batch * 1e3 / p50_8:.2f} frames/s (r5 {p50:.1f} ms, {batch * 1e3 / p50:.2f} "
          f"frames/s), peak memory {peak8:.2f} GiB; against r5 on the same weights and frames "
          f"(information, no bar): mean |diff| / mean |r5| {vs5:.3e}, labels agree "
          f"{agree5:.4f} [{card_line}]", flush=True)
    print(f"  launches on the r4i8 path ({requests} requests): {launches8}", flush=True)
    serve["r4i8"] = dict(latency_ms=lat8, p50_ms=p50_8, frames_per_s=batch * 1e3 / p50_8,
                         peak_memory_gib=peak8, rel_mean_vs_r5=vs5, label_agree_vs_r5=agree5,
                         parent_k4_level3=_parent_level3(pred8, frames, logits8, "r4i8"))
    del pred8, outs8, want8
    torch.cuda.empty_cache()
    module_launches = phase_serve_module_path(seed, frames, requests, batch, refs, serve,
                                              card_line)
    module_launches.update(phase_serve_variants(seed, frames, requests, batch, refs, serve,
                                                card_line))
    module_launches.update(phase_serve_dscf(seed, frames, requests, batch, refs, serve,
                                            card_line))
    module_launches.update(phase_serve_flat(seed, frames, requests, batch, refs, serve,
                                            card_line))
    return launches, launches8, module_launches, serve


def phase_serve_module_path(seed, frames, requests, batch, refs, serve, card_line):
    """The same weights and requests under the bench's module-path sets:
    r2 (K12 + K2 at every block, K3 + K4 at every level), r1 (K12 + K2, the
    einsum DSCF) and xla (``window_attention`` + K2, the einsum DSCF), each
    with its launches and its logits against its own all-plain path; a K12
    without its region mask must fail r2's bar.  Returns the launches of
    each dispatch's requests; adds r2's first request to ``refs``."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    out = {}
    ref5 = refs["r5"][0]
    ref2 = None
    for dispatch in ("r2", "r1", "xla"):
        pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                               image_size=IMAGE, dispatch=dispatch)
        lat, outs, launches = _served(pred, frames, requests, batch,
                                      MODULE_LAUNCHES[dispatch], dispatch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = _plain_request(pred, frames)
        if not _compare(*outs[0], *want, f"{dispatch} kernel path", LOGIT_TOL):
            fail(f"the {dispatch} kernel path disagrees with its plain path end to end")
        if dispatch == "r2" and _compare(
                *_plain_request(pred, frames, window_attention_qkv=_window_attention_qkv_no_region),
                *want, "planted fault (K12 without the shift-region mask)", LOGIT_TOL):
            fail("a K12 without its shift-region mask passes the end-to-end bar")
        logits, labels = outs[0]
        if ref2 is None:
            ref2, refs["r2"] = logits, outs[0]
        p50 = _p50(lat)
        vs5 = float((logits - ref5).abs().mean() / ref5.abs().mean())
        vs2 = float((logits - ref2).abs().mean() / ref2.abs().mean())
        print(f"  {dispatch}: latency ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, "
              f"{batch * 1e3 / p50:.2f} frames/s, peak memory {peak:.2f} GiB; logits "
              f"(information, no bar) mean |diff| / mean |ref| vs r2 {vs2:.3e}, vs r5 "
              f"{vs5:.3e} [{card_line}]", flush=True)
        print(f"  launches on the {dispatch} path ({requests} requests): {launches}",
              flush=True)
        serve[dispatch] = dict(latency_ms=lat, p50_ms=p50, frames_per_s=batch * 1e3 / p50,
                               peak_memory_gib=peak, rel_mean_vs_r2=vs2, rel_mean_vs_r5=vs5)
        if dispatch == "r2":
            serve[dispatch]["parent_k4_level3"] = _parent_level3(pred, frames, logits, "r2")
        out[dispatch] = launches
        del pred, outs, want, logits, labels
        torch.cuda.empty_cache()
    return out


# the block variants: v7_01 is r5 with K13 in place of K1 + K2 at stages
# 0-1; v5 is r4 with K14 in place of K1 (K2 stays); map is r2 with K15 on the
# qkv map in place of K12 on its windows
VARIANT_LAUNCHES = {
    "v7_01": {"swin_block_v7": 8, "swin_block_v6": 40, "dscf_rpe": 3, "dscf_rows": 3,
              "dscf_rpe_packed": 1},
    "v5": {"swin_block_full": 48, "block_tail": 48, "dscf_rpe": 4, "dscf_rows": 4},
    "map": {"window_attention_map": 48, "block_tail": 48, "dscf_rpe": 4, "dscf_rows": 4},
}
# the dispatch each variant replaces kernels of, and whether its logits must
# equal that dispatch's bit for bit (K13 and K14 are bit-equal to the
# compositions they replace; map's qkv and proj products are cuBLAS calls on
# the map where r2 makes them on the windows: the same shapes, rows in
# another order)
VARIANT_OF = {"v7_01": ("r5", True), "v5": ("r4", True), "map": ("r2", False)}


def phase_serve_variants(seed, frames, requests, batch, refs, serve, card_line):
    """The same weights and requests under the block variants v7_01, v5 and
    map: launches per request, logits against each one's own all-plain path
    (LOGIT_TOL), then against the dispatch it varies (``VARIANT_OF``).
    Returns the launches of each dispatch's requests."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    out = {}
    for dispatch in ("v7_01", "v5", "map"):
        pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                               image_size=IMAGE, dispatch=dispatch)
        lat, outs, launches = _served(pred, frames, requests, batch,
                                      VARIANT_LAUNCHES[dispatch], dispatch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = _plain_request(pred, frames)
        if not _compare(*outs[0], *want, f"{dispatch} kernel path", LOGIT_TOL):
            fail(f"the {dispatch} kernel path disagrees with its plain path end to end")
        logits, labels = outs[0]
        base, exact = VARIANT_OF[dispatch]
        ref, ref_labels = refs[base]
        differ = int((logits != ref).sum())
        vs = float((logits - ref).abs().mean() / ref.abs().mean())
        worst = float((logits - ref).abs().max() / ref.abs().max())
        agree = float((labels == ref_labels).float().mean())
        print(f"  {dispatch} against {base} on the same weights and frames: {differ} of "
              f"{logits.numel()} logits differ (mean |diff| / mean |{base}| {vs:.3e}, max "
              f"{worst:.3e}, labels agree {agree:.4f})"
              + ("; bit-equal required" if exact else "; no bar"), flush=True)
        if exact and differ:
            fail(f"the {dispatch} logits are not bit-equal to {base}'s")
        p50 = _p50(lat)
        print(f"  {dispatch}: latency ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, "
              f"{batch * 1e3 / p50:.2f} frames/s, peak memory {peak:.2f} GiB [{card_line}]",
              flush=True)
        print(f"  launches on the {dispatch} path ({requests} requests): {launches}",
              flush=True)
        del outs, want
        turns = _in_turns(seed, base, dispatch, pred, frames, requests, batch, card_line)
        serve[dispatch] = dict(latency_ms=lat, p50_ms=p50, frames_per_s=batch * 1e3 / p50,
                               peak_memory_gib=peak, logits_differ_vs=[base, differ],
                               rel_mean_vs=[base, vs], label_agree_vs=[base, agree], **turns)
        if dispatch in ("v5", "map"):
            serve[dispatch]["parent_k4_level3"] = _parent_level3(pred, frames, logits, dispatch)
        out[dispatch] = launches
        del pred, logits, labels
        torch.cuda.empty_cache()
    return out


def _in_turns(seed, base, dispatch, pred, frames, requests, batch, card_line):
    """``dispatch`` (served by ``pred``) and the dispatch it varies in turns
    (base, variant, variant, base, ...), both built now: calls and requests
    spread more than the two differ.  Prints and returns the p50s."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    pred_base = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                                image_size=IMAGE, dispatch=base)
    _warm_up(pred_base, frames)
    turns = {base: [], dispatch: []}
    for i in range(2 * requests):
        order = ((base, pred_base), (dispatch, pred))
        for name, p in (order if i % 2 == 0 else order[::-1]):
            turns[name] += _serve(p, frames[i % requests:][:1])[0]
    p_var, p_base = _p50(turns[dispatch]), _p50(turns[base])
    print(f"  in turns, {2 * requests} requests each: {dispatch} p50 {p_var:.1f} ms "
          f"({batch * 1e3 / p_var:.2f} frames/s), {base} p50 {p_base:.1f} ms "
          f"({batch * 1e3 / p_base:.2f} frames/s), ratio {p_var / p_base:.3f} "
          f"[{card_line}]", flush=True)
    del pred_base
    torch.cuda.empty_cache()
    return dict(in_turns_ms=turns, in_turns_p50_ms={dispatch: p_var, base: p_base})


def _parent_level3(pred, frames, logits, what):
    """The first request again with K4 in the packed form at level 3 too
    (the parent commit's K4, before the repair); prints and returns how far
    this dispatch's logits moved: [differing logits, mean |diff| / mean
    |logits|]."""
    from ir_ads_tpu_torch.models.backbones import swin

    rows = swin.dscf_rows_attention
    swin.dscf_rows_attention = lambda *a: rows(*a[:6], True)  # noqa: E731
    try:
        old = pred(*frames[0])[0]
        torch.cuda.synchronize()
    finally:
        swin.dscf_rows_attention = rows
    differ = int((old != logits).sum())
    rel = float((old - logits).abs().mean() / logits.abs().mean())
    print(f"  {what}: K4's packed form at level 3 (the parent's) moves {differ} of "
          f"{logits.numel()} logits, mean |diff| / mean |logits| {rel:.3e} "
          f"(information, no bar)", flush=True)
    return [differ, rel]


# the DSCF variants on r5's blocks (K1 + K2 at stages 0-1, K5 at 2-3): K16 at
# levels 0-2 and r5's K6 + einsum at level 3 (dscf_pallas4), K17 at every
# level (dscf_pallas), K18 + K17 at every level (dscf_pallas2)
R5_BLOCK_LAUNCHES = {"swin_block": 8, "block_tail": 8, "swin_block_v6": 40}
DSCF_LAUNCHES = {
    "dscf_pallas4": {**R5_BLOCK_LAUNCHES, "dscf_fused": 3, "dscf_rpe_packed": 1},
    "dscf_pallas": {**R5_BLOCK_LAUNCHES, "dscf_attention": 4},
    "dscf_pallas2": {**R5_BLOCK_LAUNCHES, "dscf_rpe_jmajor": 4, "dscf_attention": 4},
}


def _dscf_launch_checks(dispatch):
    """(kernel, the name through which DAttentionMM calls its wrapper, the
    plain version, the planted fault, the share bar) for each kernel the
    DSCF variant adds: phase 3's faults (K16 in the packed form, K17 with
    the padded bias columns 0, K18 in K3's form) and bars."""
    from ir_ads_tpu_torch.ops import dscf_attention as k17
    from ir_ads_tpu_torch.ops import dscf_fused as k16
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3
    from ir_ads_tpu_torch.ops import dscf_rpe_jmajor as k18

    def fused_plain(q, k, v, pos, table, h, w, scale, hg, packed=False):
        bias = k3.rpe_bias_rows_reference(pos.float(), table.float(), h, w, q.dtype)
        return k4.dscf_rows_reference(q, k, v, bias, scale, hg, packed)

    def attention_zero_pad(q, k, v, bias, scale, hg):
        return k17.dscf_attention_reference(q, k, v, torch.where(bias < -1e8, 0.0, bias).to(
            bias.dtype), scale, hg)

    def jmajor_plain(pos, table, h, w, dt):
        return k18.rpe_bias_jmajor_reference(pos.float(), table.float(), h, w, dt)

    def jmajor_k3_form(pos, table, h, w, dt):
        return k3.rpe_bias_bf16(pos.float(), table.float(), h, w, "bemhw").to(dt)

    k16_check = ("dscf_fused", "dscf_fused_attention", fused_plain,
                 functools.partial(fused_plain, packed=True), ROUNDING_SHARE)
    k17_check = ("dscf_attention", "dscf_attention", k17.dscf_attention_reference,
                 attention_zero_pad, ROUNDING_SHARE)
    k18_check = ("dscf_rpe_jmajor", "rpe_bias_jmajor", jmajor_plain, jmajor_k3_form,
                 JMAJOR_SHARE)
    return {"dscf_pallas4": [k16_check], "dscf_pallas": [k17_check],
            "dscf_pallas2": [k18_check, k17_check]}[dispatch]


def _checked_request(pred, frames, checks, module=None):
    """The first request with each wrapper of ``checks`` replaced by one
    that launches the kernel, runs its plain version and its planted fault
    on the same inputs and logs (kernel, shape, rel, share, fault rel,
    fault share); hands on the kernel's output.  The wrappers are names of
    ``module``, the backbone's module unless given."""
    if module is None:
        from ir_ads_tpu_torch.models.backbones import swin as module

    log, saved = [], {}
    for name, attr, plain, faulted, _ in checks:
        saved[attr] = kernel = getattr(module, attr)

        def run(*args, name=name, kernel=kernel, plain=plain, faulted=faulted):
            got = kernel(*args)
            want, bad = plain(*args), faulted(*args)
            log.append((name, tuple(got.shape), _rel(got, want, None),
                        float((got != want).float().mean()), _rel(bad, want, None),
                        float((bad != want).float().mean()), got.numel()))
            return got

        setattr(module, attr, run)
    try:
        pred(*frames[0])
        torch.cuda.synchronize()
    finally:
        for attr, f in saved.items():
            setattr(module, attr, f)
    return log


# The logits against the all-plain path cannot see the DSCF variants'
# kernels: the trunk's bf16 flips put the two paths 7.4e-3 apart (mean
# |diff| / mean |logits|), while K17 without its rpe bias at all moves them
# 4.8e-3 (an H100 80GB HBM3 at 700 W), and levels 0-2 enter the model times
# deform_weight, 1e-3 as the reference initialises it.  So each variant's
# kernels are also held end to end behind the same trunk: the kernel path
# against the path with the same trunk kernels and the variant's kernels'
# plain versions, where the trunk's flips cancel and only the variant's
# kernels part the two.  A planted fault in those plain versions must fail
# this bar; the faults that round otherwise are printed with no bar, since
# what they move is of the order of what the kernels' own roundings do.
# Measured: the kernels alone 2.9e-7 (dscf_pallas4) and 3.6e-5 (dscf_pallas)
# mean, labels 0.9999-1.0, while K16 without its rpe bias lies 1.4e-3 away,
# labels 0.9951; the worst logit moves 3e-3 to 7e-3 either way, so the worst
# logit is held only to LOGIT_TOL's bar.
DSCF_ISO_TOL = dict(rel_mean=2e-4, rel_max=LOGIT_TOL["rel_max"], label_agree=0.999)


def _dscf_swaps(dispatch):
    """The names through which DAttentionMM reaches the variant's kernels
    and their plain versions; then (what, replacements, required) for each
    planted fault: required ones must fail DSCF_ISO_TOL."""
    from ir_ads_tpu_torch.ops import dscf_attention as k17
    from ir_ads_tpu_torch.ops import dscf_rpe_jmajor as k18

    checks = {c[1]: c for c in _dscf_launch_checks(dispatch)}
    plain = {attr: c[2] for attr, c in checks.items()}
    named = [(f"{c[0]}: phase 3's planted fault", {attr: c[3]}, c[0] == "dscf_attention")
             for attr, c in checks.items()]
    if dispatch == "dscf_pallas4":
        fused = plain["dscf_fused_attention"]
        return plain, named + [("K16 without its rpe bias", {
            "dscf_fused_attention": lambda q, k, v, pos, table, *rest: fused(
                q, k, v, pos, torch.zeros_like(table), *rest)}, True)]
    extra = [("K17 without its rpe bias (the -1e9 padding kept)", {
        **plain, "dscf_attention": lambda q, k, v, bias, *rest: k17.dscf_attention_reference(
            q, k, v, torch.where(bias < -1e8, bias, 0.0).to(bias.dtype), *rest)},
        dispatch == "dscf_pallas")]
    if dispatch == "dscf_pallas2":
        extra.append(("K18 sampling at (x, y) for (y, x)", {
            **plain, "rpe_bias_jmajor": lambda pos, table, h, w, dt: (
                k18.rpe_bias_jmajor_reference(pos.float()[..., (1, 0)], table.float(), h, w,
                                              dt))}, True))
    return plain, [(what, {**plain, **swap}, req) for what, swap, req in named] + extra


def _swapped_request(pred, frames, swap, module=None):
    """The first request with the names in ``swap`` of ``module`` (the
    backbone's module unless given) replaced."""
    if module is None:
        from ir_ads_tpu_torch.models.backbones import swin as module

    saved = {k: getattr(module, k) for k in swap}
    for k, f in swap.items():
        setattr(module, k, f)
    try:
        out = pred(*frames[0])
        torch.cuda.synchronize()
    finally:
        for k, f in saved.items():
            setattr(module, k, f)
    return out


def phase_serve_dscf(seed, frames, requests, batch, refs, serve, card_line):
    """The same weights and requests under the DSCF variants dscf_pallas4,
    dscf_pallas and dscf_pallas2: launches per request (DSCF_LAUNCHES); each
    launch of K16, K17 and K18 in one request against its plain version on
    its own inputs (phase 3's bars; phase 3's planted faults must fail them
    over the request's outputs of the kernel); the logits against the dispatch's all-plain path (LOGIT_TOL),
    where the variant's kernel without its rpe bias must fail for
    dscf_pallas and dscf_pallas2 (under dscf_pallas4, K16 runs at levels 0-2
    only, whose attention enters the model times deform_weight, 1e-3 as the
    reference initialises it: its distance is printed with no bar); p50,
    frames/s and peak memory, in turns with r5, and the distance from r5
    (no bar).  Returns the launches of each dispatch's requests."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    out = {}
    ref5, labels5 = refs["r5"]
    for dispatch in ("dscf_pallas4", "dscf_pallas", "dscf_pallas2"):
        pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                               image_size=IMAGE, dispatch=dispatch)
        lat, outs, launches = _served(pred, frames, requests, batch,
                                      DSCF_LAUNCHES[dispatch], dispatch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        checks = _dscf_launch_checks(dispatch)
        bars = {c[0]: c[4] for c in checks}
        log = _checked_request(pred, frames, checks)
        for name, shape, rel, share, fault_rel, fault_share, _ in log:
            print(f"  {dispatch} launch {name} {shape}: rel {rel:.3e} (tol {REL_TOL}), "
                  f"differ {share:.4f} (tol {bars[name]}); planted fault: rel "
                  f"{fault_rel:.3e}, differ {fault_share:.4f}", flush=True)
            if not (rel <= REL_TOL and share <= bars[name]):
                fail(f"a {name} launch on the {dispatch} path disagrees with its plain version")
        for name in bars:  # the fault over all of the request's outputs of the kernel
            mine = [e for e in log if e[0] == name]
            size = sum(e[6] for e in mine)
            share = sum(e[5] * e[6] for e in mine) / size
            print(f"  {dispatch}: planted fault of {name} over its {len(mine)} launches: "
                  f"differ {share:.4f} (tol {bars[name]})", flush=True)
            if max(e[4] for e in mine) <= REL_TOL and share <= bars[name]:
                fail(f"the planted fault of {name} passes its bar on the {dispatch} path")
        want_launches = sum(DSCF_LAUNCHES[dispatch][c[0]] for c in checks)
        if len(log) != want_launches:
            fail(f"{len(log)} launches checked on the {dispatch} path, expected {want_launches}")
        want = _plain_request(pred, frames)
        if not _compare(*outs[0], *want, f"{dispatch} kernel path", LOGIT_TOL):
            fail(f"the {dispatch} kernel path disagrees with its plain path end to end")
        plain, faults = _dscf_swaps(dispatch)
        iso = _swapped_request(pred, frames, plain)
        if not _compare(*outs[0], *iso, f"{dispatch} kernel path, the variant's kernels alone",
                        DSCF_ISO_TOL):
            fail(f"the {dispatch} kernels disagree end to end with their plain versions")
        for what, swap, required in faults:
            seen = _compare(*_swapped_request(pred, frames, swap), *iso,
                            f"planted fault ({what})"
                            + ("" if required else ", information"), DSCF_ISO_TOL)
            if seen and required:
                fail(f"{what} passes the {dispatch} end-to-end bar")
        del iso
        logits, labels = outs[0]
        vs5 = float((logits - ref5).abs().mean() / ref5.abs().mean())
        agree5 = float((labels == labels5).float().mean())
        p50 = _p50(lat)
        print(f"  {dispatch}: latency ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, "
              f"{batch * 1e3 / p50:.2f} frames/s, peak memory {peak:.2f} GiB; against r5 "
              f"(information, no bar): mean |diff| / mean |r5| {vs5:.3e}, labels agree "
              f"{agree5:.4f} [{card_line}]", flush=True)
        print(f"  launches on the {dispatch} path ({requests} requests): {launches}",
              flush=True)
        del outs, want, logits, labels
        turns = _in_turns(seed, "r5", dispatch, pred, frames, requests, batch, card_line)
        serve[dispatch] = dict(latency_ms=lat, p50_ms=p50, frames_per_s=batch * 1e3 / p50,
                               peak_memory_gib=peak, rel_mean_vs_r5=vs5,
                               label_agree_vs_r5=agree5,
                               launch_checks=[list(e) for e in log], **turns)
        out[dispatch] = launches
        del pred
        torch.cuda.empty_cache()
    return out


def _parent_scale(pred, frames, logits, what):
    """The first request again with the f32 scale in every forward attention
    (the parent commit's form, before the repair); prints and returns how
    far this path's logits moved: [differing logits, mean |diff| / mean
    |logits|]."""
    restore = _f32_scale()
    try:
        old = pred(*frames[0])[0]
        torch.cuda.synchronize()
    finally:
        restore()
    differ = int((old != logits).sum())
    rel = float((old - logits).abs().mean() / logits.abs().mean())
    print(f"  {what}: the parent's f32 attention scale moves {differ} of {logits.numel()} "
          f"logits, mean |diff| / mean |logits| {rel:.3e} (information, no bar)", flush=True)
    return [differ, rel]


# The flat r5 path: the request's frames enter the model as (B, H, W*3)
# rows.  With patch_embed="xla" the patch embedding is NHWC's bit for bit, so
# the logits must be r5's; with "pallas" K19 embeds each stream once a
# request and every other kernel runs as under r5.  K19's own roundings are
# held behind the same trunk: the kernel path against the same path with
# K19 alone plain.  The logits cannot tell K19 from its planted fault (the
# XLA form, f32 LayerNorm parameters): 24 bf16 blocks carry any difference
# in the embedding, a few flipped ulps or a quarter of the values, to the
# same distance (measured on an H100 80GB HBM3 at 700 W, mean |diff| / mean
# |ref|: embedding 4e-8 against the fault's 1.3e-3; stage 0's output 4.5e-4
# to 4.8e-4 against 5.4e-3 to 5.7e-3; level 0 of the fused pyramid 2.2e-3
# against 8.2e-3; logits 6.6e-3 against 7.7e-3).  So the bar sits at the
# output of stage 0 (its two blocks, both streams), and the logits'
# distances are printed with no bar.
FLAT_LAUNCHES = {"r5_flat": R5_LAUNCHES, "r5_flat_patch": {**R5_LAUNCHES, "patch_embed": 2}}
STAGE0_ISO_TOL = 2e-3


def _stage0_request(pred, frames, swap, module):
    """The first request with the names in ``swap`` of ``module``
    replaced: stage 0's output of both streams in f32, and the logits."""
    seen = []
    hook = pred.model.backbone.stages[0].register_forward_hook(
        lambda mod, args, out: seen.append(out[1].float()))
    try:
        logits = _swapped_request(pred, frames, swap, module)[0]
    finally:
        hook.remove()
    return seen, logits


def phase_serve_flat(seed, frames, requests, batch, refs, serve, card_line):
    """The same weights and requests on flat frames under r5: with the XLA
    patch embedding (logits bit-equal to r5's), then with K19
    (``patch_embed="pallas"``): launches per request (FLAT_LAUNCHES), each
    K19 launch of one request against its plain version on its own inputs
    (ROUNDING_SHARE; the XLA form must fail it), stage 0's output against
    the same path with K19 alone plain (STAGE0_ISO_TOL; the XLA form must
    fail it; the logits' distances printed), p50, frames/s and peak memory
    in turns with r5, the distance from r5 (no bar).  Returns the launches
    of each path's requests."""
    from ir_ads_tpu_torch.ops import layers
    from ir_ads_tpu_torch.ops import patch_embed as k19
    from ir_ads_tpu_torch.serve import SemSegPredictor

    out = {}
    ref5, labels5 = refs["r5"]
    for what, impl in (("r5_flat", "xla"), ("r5_flat_patch", "pallas")):
        pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                               image_size=IMAGE, flat_input=True, patch_embed=impl)
        lat, outs, launches = _served(pred, frames, requests, batch, FLAT_LAUNCHES[what], what)
        peak = torch.cuda.max_memory_allocated() / 2**30
        logits, labels = outs[0]
        differ = int((logits != ref5).sum())
        vs5 = float((logits - ref5).abs().mean() / ref5.abs().mean())
        agree5 = float((labels == labels5).float().mean())
        print(f"  {what} against r5 on NHWC frames, the same weights and requests: {differ} "
              f"of {logits.numel()} logits differ (mean |diff| / mean |r5| {vs5:.3e}, labels "
              f"agree {agree5:.4f})" + ("; bit-equal required" if impl == "xla" else
                                        "; no bar"), flush=True)
        if impl == "xla" and differ:
            fail("the flat r5 path with the XLA patch embedding is not r5 bit for bit")
        entry = dict(peak_memory_gib=peak, logits_differ_vs_r5=differ, rel_mean_vs_r5=vs5,
                     label_agree_vs_r5=agree5)
        if impl == "pallas":
            check = ("patch_embed", "patch_embed", k19.patch_embed_reference,
                     functools.partial(k19.patch_embed_reference, round_ln=False),
                     ROUNDING_SHARE)
            log = _checked_request(pred, frames, [check], layers)
            for name, shape, rel, share, fault_rel, fault_share, _ in log:
                print(f"  {what} launch {name} {shape}: rel {rel:.3e} (tol {REL_TOL}), differ "
                      f"{share:.4f} (tol {ROUNDING_SHARE}); planted fault (the XLA form): rel "
                      f"{fault_rel:.3e}, differ {fault_share:.4f}", flush=True)
                if not (rel <= REL_TOL and share <= ROUNDING_SHARE):
                    fail(f"a K19 launch on the {what} path disagrees with its plain version")
                if fault_rel <= REL_TOL and fault_share <= ROUNDING_SHARE:
                    fail(f"the XLA form of K19 passes its launch bar on the {what} path")
            if len(log) != FLAT_LAUNCHES[what]["patch_embed"]:
                fail(f"{len(log)} K19 launches checked on the {what} path")
            mine = _stage0_request(pred, frames, {}, layers)
            iso = _stage0_request(pred, frames, {"patch_embed": check[2]}, layers)
            bad = _stage0_request(pred, frames, {"patch_embed": check[3]}, layers)
            mean_rel = lambda x, y: float((x - y).abs().mean() / y.abs().mean())  # noqa: E731
            stage0 = [max(mean_rel(x, y) for x, y in zip(run[0], iso[0])) for run in (mine, bad)]
            end = [mean_rel(run[1], iso[1]) for run in (mine, bad)]
            print(f"  {what} against the same path with K19 alone plain, mean |diff| / mean "
                  f"|ref| at stage 0's output (both streams): kernel {stage0[0]:.3e}, planted "
                  f"fault (the XLA form) {stage0[1]:.3e} (tol {STAGE0_ISO_TOL}); logits "
                  f"(information, no bar): kernel {end[0]:.3e}, fault {end[1]:.3e}", flush=True)
            if stage0[0] > STAGE0_ISO_TOL:
                fail(f"K19 disagrees with its plain version behind stage 0 on the {what} path")
            if stage0[1] <= STAGE0_ISO_TOL:
                fail(f"K19 in the XLA form passes the {what} stage-0 bar")
            entry.update(stage0_rel_vs_k19_plain=stage0, logits_rel_vs_k19_plain=end,
                         parent_f32_scale=_parent_scale(pred, frames, logits, what),
                         launch_checks=[list(e) for e in log])
            del mine, iso, bad
        p50 = _p50(lat)
        print(f"  {what}: latency ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, "
              f"{batch * 1e3 / p50:.2f} frames/s, peak memory {peak:.2f} GiB [{card_line}]",
              flush=True)
        print(f"  launches on the {what} path ({requests} requests): {launches}", flush=True)
        del outs, logits, labels
        if impl == "pallas":
            entry.update(_in_turns(seed, "r5", what, pred, frames, requests, batch, card_line))
        serve[what] = dict(latency_ms=lat, p50_ms=p50, frames_per_s=batch * 1e3 / p50, **entry)
        out[what] = launches
        del pred
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 5: training steps through the port's entry point
# --------------------------------------------------------------------------

# launches per training step under the ``train`` dispatch: every block of
# both streams runs K1 forward and K7 backward (24 x 2), every DSCF level
# 0-2 runs K3, K4 and K8, level 3 runs K6; the eval kernels do not run
TRAIN_LAUNCHES = {"swin_block": 48, "window_attn_bwd": 48, "dscf_rpe": 3,
                  "dscf_rows": 3, "dscf_rows_bwd": 3, "dscf_rpe_packed": 1,
                  "block_tail": 0, "swin_block_v6": 0, "msdeform": 0,
                  "swin_block_int8": 0, "block_tail_int8": 0, "window_attention_qkv": 0,
                  "swin_block_v7": 0, "swin_block_full": 0, "window_attention_map": 0,
                  "dscf_fused": 0, "dscf_attention": 0, "dscf_rpe_jmajor": 0,
                  "patch_embed": 0, "window_attention_v1": 0, "msdeform_bwd": 0}

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
        dscf_rows, dscf_rows_bwd, dscf_rpe, dscf_rpe_packed, swin_block, window_attention_qkv,
        window_attn_bwd,
    )

    return {
        "window_attention_qkv": (window_attention_qkv, "_forward",
                                 window_attention_qkv.window_attention_qkv_reference),
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


def _rows_f32_inside(q, k, v, bias, scale, hg, packed):
    """K4's plain version as the control: no rounding inside."""
    from ir_ads_tpu_torch.ops.dscf_rows import dscf_rows_reference

    return dscf_rows_reference(q.float(), k.float(), v.float(), bias.float(),
                               scale, hg, packed).to(q.dtype)


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


def gradient_run(seed: int, dtype, batch, backbone="SwinTransformer-B", rates=False,
                 **backbone_kwargs):
    """A trainer with every stochastic rate at 0 (with ``rates``, the
    recipe's) and a function that runs one forward and backward on
    ``batch`` with the train path swapped as ``_swap_train_path`` says, and
    returns the loss and the gradient of every parameter group as one f32
    vector.  Each run draws from the same generator, the next step's."""
    from ir_ads_tpu_torch.train import SemSegTrainer
    from ir_ads_tpu_torch.training.train_state import compute_loss

    if rates:
        tr = SemSegTrainer(device="cuda", dtype=dtype, seed=seed, num_classes=NUM_CLASSES,
                           backbone=backbone, backbone_kwargs=backbone_kwargs)
    else:
        tr = SemSegTrainer(device="cuda", dtype=dtype, seed=seed, num_classes=NUM_CLASSES,
                           head_drop=0.0, mmst_mask=False, backbone=backbone,
                           backbone_kwargs=dict(drop_path_rate=0.0, adapter_drop=0.0,
                                                **backbone_kwargs))
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


# --------------------------------------------------------------------------
# phase 6: detection requests through the port's entry point
# --------------------------------------------------------------------------

# Kernel path against plain path, both bf16.  Launch by launch, on the
# launch's own inputs, K9 and its plain version differ by single bf16
# roundings (phase 3's bar, REL_TOL, on the launch's output).  Through the six
# encoder layers those flips spread: the encoder memory and the proposal
# scores agree to a few 1e-3 of their size on average (``memory``,
# ``scores``: mean |diff| / mean |ref|).  What follows is a selection: top
# 2000 of 20197 tokens by a bf16 score, where a score that moves by one ulp
# changes the set and shifts every later query's rank, then argmax classes
# and a greedy NMS.  So the selected tokens (with a floor on the share in
# common) and the kept boxes are reported as shares that agree.  What follows
# the selection is held to a tolerance with the selection taken out: the
# kernel path is run once more on the plain path's selected tokens, and its
# last layer's class logits and boxes are held against the plain path's
# (``logits``, ``boxes``: mean |diff| / mean |ref|).  The planted fault (a
# plain version that samples at loc * size, without the -0.5) must fail the
# launch bar when it sits in one decoder layer, the memory bar when it sits
# in every layer, and the logits bar when it sits in the decoder layers alone
# behind the same memory and selection.
DET_TOL = dict(call_rel=REL_TOL, memory=2e-2, scores=2e-2, tokens=0.95, logits=2e-2,
               boxes=2e-2)
DET_ENC_LAUNCHES = 6
DET_LAUNCHES = 12  # 6 encoder self-attentions + 6 decoder cross-attentions


def _plain_without_half_pixel(value, spatial_shapes, locations, weights):
    """K9's plain version with the planted fault 'no -0.5'."""
    from ir_ads_tpu_torch.ops.msdeform import ms_deform_attn_plain

    return ms_deform_attn_plain(
        value, spatial_shapes, _without_half_pixel(locations.float(), spatial_shapes), weights)


def phase_detect(seed: int, requests: int, card_line: str):
    from ir_ads_tpu_torch.detection import msdeform_attn as det_attn
    from ir_ads_tpu_torch.detection import transformer as det_tr
    from ir_ads_tpu_torch.detection.box_ops import box_iou
    from ir_ads_tpu_torch.ops.msdeform import ms_deform_attn_plain
    from ir_ads_tpu_torch.serve import DetPredictor

    t0 = time.time()
    pred = DetPredictor(device="cuda", seed=seed, num_classes=DET_CLASSES,
                        num_queries=DET_QUERIES, topk=DET_TOPK)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  model: DINO-R50 deformable-mask detector, {n_params / 1e6:.1f} M parameters, "
          f"bf16, 6 + 6 layers, {DET_QUERIES} queries, built in {time.time() - t0:.1f} s",
          flush=True)
    g = torch.Generator().manual_seed(seed + 3)
    images = [torch.randint(0, 256, (1, *DET_IMAGE, 3), generator=g, dtype=torch.uint8)
              for _ in range(requests + 1)]
    pred(images[0])  # warm-up (allocator, cuDNN and cuBLAS handles), not timed
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    lat, outs = [], []
    for img in images[1:]:
        t = time.perf_counter()
        outs.append(pred(img))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, n in launches.items():
        want = DET_LAUNCHES * requests if name == "msdeform" else 0
        if n != want:
            fail(f"{name} launched {n} times in {requests} detection requests, expected {want}")
    k = DET_TOPK
    for s, xyxy, keep, cls_ids, order in outs:
        shapes = (tuple(s.shape), tuple(xyxy.shape), tuple(keep.shape), tuple(cls_ids.shape),
                  tuple(order.shape))
        if shapes != ((1, k), (1, k, 4), (1, k), (1, DET_QUERIES), (1, k)):
            fail(f"detection output shapes {shapes}")
        if not bool(torch.isfinite(s).all() and torch.isfinite(xyxy).all()):
            fail("non-finite detection scores or boxes")
        if not bool((s[:, :-1] >= s[:, 1:]).all()) or not bool(keep[:, 0].all()):
            fail("detection scores are not sorted or the best box is suppressed")
        if int(cls_ids.min()) < 0 or int(cls_ids.max()) >= DET_CLASSES:
            fail("class ids out of range")
        if sorted(order[0].tolist()) != list(range(k)):
            fail("order is not a permutation of the top-k")

    model, img = pred.model, images[1].cuda()

    # the post-processing's share of a request (ranking, top-k, NMS on the host)
    with torch.no_grad():
        t = time.perf_counter()
        out = model(img, want_masks=True)
        torch.cuda.synchronize()
        t_model = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        pred.postprocess(out)
        torch.cuda.synchronize()
        t_post = (time.perf_counter() - t) * 1e3
    del out

    def forward(sample=None, tokens=None):
        """One forward with the module's sampling function replaced by
        ``sample`` (the wrapper, K9, when None) and, where ``tokens`` is
        given, those token indices in the place of the transformer's own
        top-k: what the checks read, never the mask stacks."""
        saved = det_attn.ms_deform_attn, det_tr.top_k
        det_attn.ms_deform_attn = sample or saved[0]
        if tokens is not None:
            det_tr.top_k = lambda scores, k: (torch.gather(scores, 1, tokens), tokens)
        seen = {}
        hook = model.transformer.register_forward_hook(
            lambda mod, args, out: seen.update(out))
        try:
            with torch.no_grad():
                res = pred.postprocess(model(img, want_masks=True))
            torch.cuda.synchronize()
        finally:
            hook.remove()
            det_attn.ms_deform_attn, det_tr.top_k = saved
        return dict(memory=seen["memory"], scores=seen["enc_scores"], tokens=seen["topk_idx"],
                    logits=seen["pred_logits"][-1], pred_boxes=seen["pred_boxes"][-1],
                    boxes=res[1], keep=res[2])

    def faulted(launches):
        """The plain version, without the -0.5 at those launches of a forward."""
        n = iter(range(DET_LAUNCHES))

        def sample(value, spatial_shapes, locations, weights):
            fn = _plain_without_half_pixel if next(n) in launches else ms_deform_attn_plain
            return fn(value, spatial_shapes, locations, weights)

        return sample

    # (a) every launch of one request against its plain version on its inputs
    def launch_check(what, fault_at=None):
        log = []

        def both(value, spatial_shapes, locations, weights):
            got = kernel(value, spatial_shapes, locations, weights)
            plain = _plain_without_half_pixel if len(log) == fault_at else ms_deform_attn_plain
            want = plain(value, spatial_shapes, locations, weights)
            log.append((locations.shape[1], _rel(got, want, None),
                        float((got.float() - want.float()).abs().max())))
            return got

        kernel = det_attn.ms_deform_attn
        forward(sample=both)
        worst = max(log, key=lambda e: e[1])
        print(f"  {what}: {len(log)} launches inside the request against their plain versions "
              f"on the same inputs, ||diff|| / ||ref|| worst {worst[1]:.3e} (Lq {worst[0]}, max "
              f"abs err {worst[2]:.3e}), by launch {['%.1e' % e[1] for e in log]} "
              f"(tol {DET_TOL['call_rel']})", flush=True)
        if len(log) != DET_LAUNCHES:
            fail(f"{len(log)} launches were checked inside the request")
        return worst[1], worst[1] <= DET_TOL["call_rel"]

    call_rel, ok = launch_check("kernel path")
    if not ok:
        fail("K9 disagrees with its plain version inside the detection request")
    if launch_check("planted fault (plain K9 without the -0.5 in decoder layer 2)",
                    fault_at=8)[1]:
        fail("a K9 plain version without the -0.5 in one decoder layer passes the launch bar")

    # (b) before the selection, against the all-plain path; then the selections
    got, want = forward(), forward(sample=ms_deform_attn_plain)
    mean_rel = lambda x, y: float((x.float() - y.float()).abs().mean()  # noqa: E731
                                  / y.float().abs().mean())

    def compare(a, what):
        valid = torch.isfinite(want["scores"])
        mem = mean_rel(a["memory"], want["memory"])
        sc = mean_rel(a["scores"][valid], want["scores"][valid])
        tokens = len(set(a["tokens"][0].tolist()) & set(want["tokens"][0].tolist())) / DET_QUERIES
        same_rank = float((a["tokens"] == want["tokens"]).float().mean())
        ka, kw = a["boxes"][0][a["keep"][0]], want["boxes"][0][want["keep"][0]]
        boxes = float((box_iou(ka, kw)[0].amax(1) > 0.9).float().mean())
        print(f"  {what} vs the all-plain path on the card: encoder memory mean |diff| / mean "
              f"|ref| {mem:.3e} (tol {DET_TOL['memory']}), proposal scores {sc:.3e} (tol "
              f"{DET_TOL['scores']}); selected tokens in common {tokens:.4f} (floor "
              f"{DET_TOL['tokens']}), at the same rank {same_rank:.4f}; kept boxes "
              f"{len(ka)} vs {len(kw)}, with a plain-path box at IoU > 0.9: {boxes:.4f}",
              flush=True)
        return (dict(memory=mem, scores=sc, tokens_common=tokens, tokens_same_rank=same_rank,
                     kept=len(ka), kept_plain=len(kw), boxes_matched=boxes),
                mem <= DET_TOL["memory"] and sc <= DET_TOL["scores"]
                and tokens >= DET_TOL["tokens"])

    agree, ok = compare(got, "kernel path")
    if not ok:
        fail("the kernel path's encoder memory or proposals disagree with the plain path")
    if compare(forward(sample=faulted(range(DET_LAUNCHES))),
               "planted fault (plain K9 without the -0.5)")[1]:
        fail("a K9 without the -0.5 passes the encoder bars")

    # for the record: the parent's f32 scale in MultiheadAttention, the
    # decoder's self-attention (the encoder attends by K9), no bar
    restore = _f32_scale()
    try:
        old = forward()
    finally:
        restore()
    valid = torch.isfinite(got["scores"])
    parent_scale = dict(memory=mean_rel(old["memory"], got["memory"]),
                        scores=mean_rel(old["scores"][valid], got["scores"][valid]),
                        same_tokens=bool(torch.equal(old["tokens"], got["tokens"])),
                        logits=mean_rel(old["logits"], got["logits"]),
                        boxes=mean_rel(old["pred_boxes"], got["pred_boxes"]))
    print(f"  the parent's f32 attention scale (information, no bar), mean |diff| / mean |ref|: "
          f"encoder memory {parent_scale['memory']:.3e}, proposal scores "
          f"{parent_scale['scores']:.3e}, the same selected tokens "
          f"{parent_scale['same_tokens']}; last decoder layer's class logits "
          f"{parent_scale['logits']:.3e}, boxes {parent_scale['boxes']:.3e}", flush=True)
    del old

    # (c) after the selection, on the plain path's selected tokens
    def compare_forced(a, what):
        if not torch.equal(a["tokens"], want["tokens"]):
            fail(f"{what}: the forced selection was not taken")
        lg = mean_rel(a["logits"], want["logits"])
        bx = mean_rel(a["pred_boxes"], want["pred_boxes"])
        cls = float((a["logits"].argmax(-1) == want["logits"].argmax(-1)).float().mean())
        print(f"  {what} on the plain path's {DET_QUERIES} selected tokens, last decoder "
              f"layer vs the all-plain path: class logits mean |diff| / mean |ref| {lg:.3e} "
              f"(tol {DET_TOL['logits']}), boxes {bx:.3e} (tol {DET_TOL['boxes']}), same "
              f"best class {cls:.4f}", flush=True)
        return (dict(logits=lg, boxes=bx, same_class=cls),
                lg <= DET_TOL["logits"] and bx <= DET_TOL["boxes"])

    forced, ok = compare_forced(forward(tokens=want["tokens"]), "kernel path")
    if not ok:
        fail("the kernel path's decoder output disagrees with the plain path's on the "
             "same selected tokens")
    agree["forced_selection"] = forced
    if compare_forced(
            forward(sample=faulted(range(DET_ENC_LAUNCHES, DET_LAUNCHES)),
                    tokens=want["tokens"]),
            "planted fault (plain K9 without the -0.5 in the decoder layers)")[1]:
        fail("a K9 without the -0.5 in the decoder passes the decoder-output bars")
    del got, want

    p50 = _p50(lat)
    print(f"  {requests} requests x 1 image {DET_IMAGE[0]}x{DET_IMAGE[1]} after a warm-up, latency "
          f"ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, {1e3 / p50:.2f} images/s; one more "
          f"request apart: model {t_model:.1f} ms, post-processing {t_post:.1f} ms "
          f"({t_post / (t_model + t_post):.3f} of the request); peak memory {peak:.2f} GiB; "
          f"kept boxes per request {[int(o[2].sum()) for o in outs]} [{card_line}]", flush=True)
    print(f"  launches on the detection path ({requests} requests): {launches}", flush=True)
    return launches, dict(latency_ms=lat, p50_ms=p50, images_per_s=1e3 / p50,
                          model_ms=t_model, postprocess_ms=t_post, peak_memory_gib=peak,
                          launch_rel_err=call_rel, agreement=agree,
                          parent_f32_scale=parent_scale)


# --------------------------------------------------------------------------
# phase 7: evaluate through the port's val_mm entry point
# --------------------------------------------------------------------------

EVAL_IMAGES = 4
EVAL_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)  # configs/nyu_rgbd.yaml EVAL.MSF.SCALES
SLIDING_TILE = (384, 384)  # configs/deepcrack_rgb.yaml's EVAL.SLIDING tile
# Launches per forward of one MSF scale under r5 (a batch of 2: the image and
# its flip), from the maps each scale gives (480x640 scaled, each side
# rounded up to a multiple of 32): K1 + K2 at the 4 blocks of stages 0-1 and
# K5 at the 20 of stages 2-3, both streams; the DSCF has 2n = 160, 360, 600
# keys at scales 0.5-1.0 (2n % 8 == 0: K3 + K4 at levels 0-2) and 950, 1380,
# 1890 at 1.25-1.75 (the einsum at every level); K6 gives the einsum's bias
# on planes of at most 2048 pixels: level 3 at every scale, level 2 (38x50)
# at 1.25 too, while level 2 at 1.5 (46x60) takes the XLA form.
EVAL_LAUNCHES = {
    **{s: {**R5_BLOCK_LAUNCHES, "dscf_rpe": 3, "dscf_rows": 3, "dscf_rpe_packed": 1}
       for s in (0.5, 0.75, 1.0)},
    1.25: {**R5_BLOCK_LAUNCHES, "dscf_rpe_packed": 2},
    1.5: {**R5_BLOCK_LAUNCHES, "dscf_rpe_packed": 1},
    1.75: {**R5_BLOCK_LAUNCHES, "dscf_rpe_packed": 1},
}
# The MSF probabilities (the sum over six scales and two flips of f32
# softmaxes, 0 to 12 a class) of one image, the kernel path against the
# all-plain path on the card: the bar is LOGIT_TOL's kind, set from the
# readings of an H100 80GB HBM3 at 700 W.  Kernel path: mean |diff| / mean
# |ref| 1.824e-3, max |diff| / max |ref| 8.05e-3, labels agree 0.9875 (the
# trunk's bf16 flips, as in phase 4).  K5 without its shift-region mask:
# 3.297e-2, 0.115, 0.7727.  The bars sit between, each about 5x the kernel
# path's reading and under the fault's.
EVAL_PROB_TOL = dict(rel_mean=1e-2, rel_max=4e-2, label_agree=0.97)


def eval_config(mode: str) -> dict:
    """configs/nyu_rgbd.yaml's EVAL section (480x640, batch 1, MSF at six
    scales with flip) and model (Swin-B CMNeXt, bf16), written out here so
    that no YAML reader is needed, on the Synthetic dataset at 480x640 with
    40 classes, ``EVAL_IMAGES`` val images; ``mode`` "msf", "single-scale"
    or "sliding" (configs/deepcrack_rgb.yaml's EVAL.SLIDING: a 384x384 tile,
    overlap 1/3, flip)."""
    from ir_ads_tpu_torch.utils.config import DEFAULTS, _merge

    return _merge(DEFAULTS, {
        "DATASET": {"NAME": "Synthetic", "ROOT": "", "IGNORE_LABEL": 255,
                    "MODALS": ["img", "depth"],
                    "KWARGS": {"image_size": list(IMAGE), "num_classes": NUM_CLASSES,
                               "length": EVAL_IMAGES}},
        "TRAIN": {"AMP": True},
        "EVAL": {"MODEL_PATH": "", "IMAGE_SIZE": list(IMAGE), "BATCH_SIZE": 1,
                 "MSF": {"ENABLE": mode == "msf", "FLIP": True,
                         "SCALES": list(EVAL_SCALES)},
                 "SLIDING": {"ENABLE": mode == "sliding", "TILE_SIZE": list(SLIDING_TILE),
                             "OVERLAP": 1.0 / 3.0, "FLIP": True}},
    })


def _counted_eval(seed: int, mode: str, cfg=None):
    """``val_mm.main`` on the card (the ``eval_config`` of ``mode``, or
    ``cfg``) with every launch count at 0 first; its eval forward wrapped to
    record, per call, the input's shape, each kernel's launches and whether
    the logits are finite.  Returns (the entry point's result, the calls,
    the launches, the model)."""
    from ir_ads_tpu_torch import val_mm
    from ir_ads_tpu_torch.evaluation import semseg_eval

    calls, seen = [], {}

    def counting(model, device_norm=False):
        seen["model"] = model
        forward = semseg_eval.make_forward_fn(model, device_norm)

        def run(rgb, dte):
            before = {k.name: k.launches for k in kernels}
            out = forward(rgb, dte)
            calls.append((tuple(rgb.shape), {k.name: k.launches - before[k.name]
                                             for k in kernels if k.launches > before[k.name]},
                          torch.isfinite(out).all()))
            return out
        return run

    val_mm.make_forward_fn = counting
    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    try:
        result = val_mm.main(cfg or eval_config(mode), device="cuda", dispatch="r5",
                             seed=seed)
    finally:
        val_mm.make_forward_fn = semseg_eval.make_forward_fn
    launches = {k.name: k.launches for k in kernels}
    return result, calls, launches, seen["model"]


def _check_calls(calls, model, want_shapes, what):
    """Each call's launches against the dispatch's for its input size, and
    its logits finite; returns the launches summed over the calls."""
    if [c[0] for c in calls] != want_shapes:
        fail(f"{what}: the eval forward took {[c[0] for c in calls]}, not {want_shapes}")
    total = {}
    for shape, got, finite in calls:
        want = {k: v for k, v in expected_launches(model, shape[1:3]).items() if v}
        if got != want:
            fail(f"{what}: a forward of {shape} launched {got}, expected {want}")
        if not bool(finite):
            fail(f"{what}: non-finite logits at {shape}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def _eval_launch_checks():
    """(kernel, the name through which the backbone calls its wrapper, the
    plain version behind the wrapper's roundings, the planted fault, the
    share bar or None, whether the kernel adds to its first input, the
    element bar (atol, rtol)) for the six kernels of r5's eval forward, with
    phase 3's bars: the distance on what the kernel adds (REL_TOL), each
    element within atol x rms(plain) + rtol |plain|, and the share apart: K1
    and K5 their SWIN_SHARE limits, K4 ROUNDING_SHARE, K3 and K6 bit for
    bit, K2 none.  Phase 3 draws unit-scale inputs, where atol x rms is its
    atol; the served activations are not unit-scale (the residual stream
    grows through the stages), so the absolute part scales with the
    output's rms, as phase 3's gradient cases hold theirs (``atol_of_rms``):
    with a plain atol, K5's launches at the MSF scales reach 1.75 times the
    bar on outputs near zero beside large ones, one-ulp flips of the
    trunk's f32 sums (an H100 80GB HBM3 at 700 W)."""
    from ir_ads_tpu_torch.ops import dscf_rows as k4
    from ir_ads_tpu_torch.ops import dscf_rpe as k3
    from ir_ads_tpu_torch.ops import dscf_rpe_packed as k6
    from ir_ads_tpu_torch.ops.block_tail import block_tail_reference
    from ir_ads_tpu_torch.ops.swin_block_v6 import window_block_v6_reference

    def tail(x, *p, adapter_scale=0.5):
        return block_tail_reference(x, *(t.to(x.dtype) for t in p), adapter_scale=adapter_scale)

    def v6(x, attn, tail_p, region, *rest, adapter_scale=0.5):
        attn = tuple(t.to(x.dtype) for t in attn[:6]) + (attn[6].float(),)
        return window_block_v6_reference(x, attn, tuple(t.to(x.dtype) for t in tail_p),
                                         region, *rest, adapter_scale=adapter_scale)

    def no_bias(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *rest):
        return _block_forward_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                    torch.zeros_like(bias), *rest)

    def rows(pos, table, h, w, dt):
        return k3.rpe_bias_rows_reference(pos.float(), table.float(), h, w, dt)

    def packed(pos, table, h, w, dt):
        return k6.rpe_bias_packed_reference(pos.float(), table.float(), h, w, dt)

    def rows_f32(pos, table, h, w, dt):
        return k3.rpe_bias_f32(pos.float(), table.float(), h, w, "behmw").to(dt)

    def packed_f32(pos, table, h, w, dt):
        return k3.rpe_bias_f32(pos.float(), table.float(), h, w, "bemhw").flatten(3).to(dt)

    def attend_no_bias(q, k, v, bias, *rest):
        return k4.dscf_rows_reference(q, k, v, torch.zeros_like(bias), *rest)

    return [
        ("swin_block", "window_block", _block_forward_plain, no_bias,
         SWIN_SHARE["swin_block"], True, (3e-2, 2e-2)),
        ("block_tail", "block_tail", tail, functools.partial(tail, adapter_scale=0.0),
         None, True, (3e-2, 2e-2)),
        ("swin_block_v6", "window_block_v6", v6, functools.partial(v6, adapter_scale=0.0),
         SWIN_SHARE["swin_block_v6"], True, (3e-2, 2e-2)),
        ("dscf_rpe", "rpe_bias_rows", rows, rows_f32, 0.0, False, (0.0, 0.0)),
        ("dscf_rows", "dscf_rows_attention", k4.dscf_rows_reference, attend_no_bias,
         ROUNDING_SHARE, False, (1e-2, 2e-2)),
        ("dscf_rpe_packed", "rpe_bias_packed", packed, packed_f32, 0.0, False, (0.0, 0.0)),
    ]


EVAL_FAULTS = dict(swin_block="rel-pos bias dropped", block_tail="adapter dropped",
                   swin_block_v6="adapter dropped", dscf_rpe="the all-f32 form",
                   dscf_rows="rpe bias dropped", dscf_rpe_packed="the all-f32 form")


def _held_launches(run, what, tag, names=None):
    """Run ``run()`` with each launch of the six kernels of r5's forward (or
    of those in ``names``) held against its plain version and its planted
    fault on its own inputs (``_eval_launch_checks``' bars); ``tag()`` names
    the launch's place (an MSF scale, a request).  Fails if a launch misses
    its bar or a fault passes it over all of them.  Returns the log [(tag, kernel,
    shape, rel, share, fault rel, fault share, size, the largest |got -
    plain| / (atol x rms(plain) + rtol |plain|))]."""
    from ir_ads_tpu_torch.models.backbones import swin

    log, saved = [], {}
    checks = [c for c in _eval_launch_checks() if names is None or c[0] in names]
    for name, attr, plain, faulted, _, residual, (atol, rtol) in checks:
        saved[attr] = kernel = getattr(swin, attr)

        def held(*args, name=name, kernel=kernel, plain=plain, faulted=faulted,
                 residual=residual, atol=atol, rtol=rtol):
            got = kernel(*args)
            want, bad = plain(*args), faulted(*args)
            base = args[0] if residual else None
            err = (got.float() - want.float()).abs()
            elem = (float((err / (atol * _rms(want) + rtol * want.float().abs())).max())
                    if atol else (math.inf if bool(err.max() > 0) else 0.0))
            log.append((tag(), name, tuple(got.shape), _rel(got, want, base),
                        float((got != want).float().mean()), _rel(bad, want, base),
                        float((bad != want).float().mean()), got.numel(), elem))
            return got

        setattr(swin, attr, held)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for attr, f in saved.items():
            setattr(swin, attr, f)
    bars = {c[0]: c[4] for c in checks}
    for name in bars:
        mine = [e for e in log if e[1] == name]
        if not mine:
            fail(f"{name} did not launch in {what}")
        worst = max(mine, key=lambda e: e[3])
        share = max(e[4] for e in mine)
        size = sum(e[7] for e in mine)
        fault_share = sum(e[6] * e[7] for e in mine) / size
        fault_rel = max(e[5] for e in mine)
        rel_tol = 0.0 if bars[name] == 0.0 else REL_TOL
        elem = max(e[8] for e in mine)
        tags = sorted({e[0] for e in mine}, key=str)
        print(f"  {name}: {len(mine)} launches in {what}" + (f" at {tags}" if tags != [None]
                                                              else "")
              + f": worst rel {worst[3]:.3e} ({worst[0]}, "
              f"{worst[2]}; tol {rel_tol}), largest share apart {share:.4f} (tol "
              f"{bars[name]}), largest element error over its bar {elem:.3f} (tol 1); "
              f"planted fault '{EVAL_FAULTS[name]}': worst rel {fault_rel:.3e}, share "
              f"{fault_share:.4f}", flush=True)
        bad = [e for e in mine if e[3] > rel_tol or e[8] > 1.0
               or (bars[name] is not None and e[4] > bars[name])]
        if bad:
            fail(f"{len(bad)} {name} launches of {what} disagree with their plain "
                 f"versions, first at {bad[0][0]} {bad[0][2]}")
        if fault_rel <= rel_tol and (bars[name] is None or fault_share <= bars[name]):
            fail(f"the planted fault of {name} passes its bar over {what}")
    return log


def _held_msf(forward, rgb, dte):
    """One image's MSF with each launch of the six kernels held against its
    plain version and its planted fault on its own inputs
    (``_held_launches``, tagged by scale)."""
    from ir_ads_tpu_torch.evaluation.semseg_eval import msf_logits

    sizes, scale = iter(EVAL_SCALES), {}

    def scaled(r, d):
        scale["s"] = next(sizes)
        return forward(r, d)

    return _held_launches(lambda: msf_logits(scaled, rgb, dte, EVAL_SCALES),
                          "the MSF image", lambda: scale["s"])


def phase_eval(seed: int, card_line: str):
    """Phase 7 (module docstring).  Returns (launches summed over the three
    modes' runs, the record)."""
    from ir_ads_tpu_torch.evaluation.semseg_eval import align32, make_forward_fn, msf_logits
    from ir_ads_tpu_torch.data.datasets import Synthetic
    from ir_ads_tpu_torch.data.augmentations import get_val_augmentation

    record, total = {}, {}
    for mode in ("msf", "single-scale", "sliding"):
        result, calls, launches, model = _counted_eval(seed, mode)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if mode == "msf":
            per_image = [(2, align32(s * IMAGE[0]), align32(s * IMAGE[1]), 3)
                         for s in EVAL_SCALES]
            for s, shape in zip(EVAL_SCALES, per_image):
                want = {k: v for k, v in expected_launches(model, shape[1:3]).items() if v}
                if want != EVAL_LAUNCHES[s]:
                    fail(f"scale {s}: r5 gives {want} launches, not {EVAL_LAUNCHES[s]}")
            shapes = per_image * EVAL_IMAGES
        elif mode == "sliding":
            shapes = [(8, *SLIDING_TILE, 3)] * EVAL_IMAGES  # 2 x 2 tiles, flip
        else:
            shapes = [(1, *IMAGE, 3)] * EVAL_IMAGES
        summed = _check_calls(calls, model, shapes, mode)
        if {k: v for k, v in launches.items() if v} != summed:
            fail(f"{mode}: the kernels launched {launches}, the forwards {summed}")
        lat = [t * 1e3 for t in result["latency_s"]]
        p50 = _p50(lat[1:])  # the first image warms up
        print(f"  {mode}: {EVAL_IMAGES} images of 480x640 RGB-D, mIoU {result['miou']} mF1 "
              f"{result['mf1']} mAcc {result['macc']} (random weights, 40 classes); ms per "
              f"image {['%.1f' % v for v in lat]}, p50 after the first {p50:.1f}, "
              f"{1e3 / p50:.3f} images/s; peak memory {peak:.2f} GiB [{card_line}]",
              flush=True)
        print(f"  launches on the {mode} path ({EVAL_IMAGES} images): "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        record[mode] = dict(miou=result["miou"], mf1=result["mf1"], macc=result["macc"],
                            latency_ms=lat, p50_ms=p50, images_per_s=1e3 / p50,
                            peak_memory_gib=peak, launches=launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if mode != "msf":
            del model
            torch.cuda.empty_cache()
            continue

        # one image: every launch held, then the probabilities end to end
        ds = Synthetic("", "val", get_val_augmentation(IMAGE), ["img", "depth"],
                       length=EVAL_IMAGES, image_size=IMAGE, num_classes=NUM_CLASSES)
        sample, _ = ds[0]
        rgb = torch.from_numpy(sample["img"])[None].cuda()
        dte = torch.from_numpy(sample["depth"])[None].cuda()
        forward = make_forward_fn(model)
        log = _held_msf(forward, rgb, dte)
        got = msf_logits(forward, rgb, dte, EVAL_SCALES)
        restore = _plain_path()
        try:
            want = msf_logits(forward, rgb, dte, EVAL_SCALES)
        finally:
            restore()
        ok = _compare(got, got.argmax(-1), want, want.argmax(-1), "MSF probabilities",
                      EVAL_PROB_TOL)
        restore = _plain_path(window_block_v6=_window_block_v6_no_region)
        try:
            bad = msf_logits(forward, rgb, dte, EVAL_SCALES)
        finally:
            restore()
        seen = not _compare(bad, bad.argmax(-1), want, want.argmax(-1),
                            "planted fault (K5 without the shift-region mask)", EVAL_PROB_TOL)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        record["msf"].update(
            launches_held=len(log), label_agree_vs_plain=agree,
            prob_rel_mean=float((got - want).abs().mean() / want.abs().mean()),
            prob_rel_max=float((got - want).abs().max() / want.abs().max()))
        if not ok:
            fail("the MSF probabilities disagree with the all-plain path")
        if not seen:
            fail("a K5 without its shift-region mask passes the MSF probability bar")
        del model, forward, got, want, bad
        torch.cuda.empty_cache()
    # the eval path reads no image file, config file or checkpoint here
    reached = [m for m in ("PIL", "cv2", "yaml", "msgpack") if m in sys.modules]
    if reached:
        fail(f"the eval phase imported {reached}")
    return total, record


# --------------------------------------------------------------------------
# phase 8: train through the port's train_mm entry point
# --------------------------------------------------------------------------

TRAIN_MM_CONFIG = "ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_train.yaml"
# one training step with BACKBONE_KWARGS.drop_rate > 0: K12 in place of K1 at
# the 24 blocks of both streams (its backward is the plain version's vjp:
# no K7), the DSCF as under drop_rate 0
DROP_LAUNCHES = {**dict.fromkeys(TRAIN_LAUNCHES, 0), "window_attention_qkv": 48,
                 "dscf_rpe": 3, "dscf_rows": 3, "dscf_rows_bwd": 3, "dscf_rpe_packed": 1}
# The resume bar.  A run resumed from latest/ after epoch 2 takes its fifth
# step; two uninterrupted runs of the same config take theirs.  Each run's
# fifth update (its trainable parameters after the step less before it) is
# compared with the first uninterrupted run's, ||u - u_B|| / ||u_B||.  The
# card's runs are not bit-equal (the upsample backward sums with atomics):
# their parameters drift apart over four steps by 0.545 of an update, so
# the bar holds the update, and the second uninterrupted run sets the
# noise.  Readings on an H100 80GB HBM3 at 700 W (my card run): the second
# uninterrupted run 0.2025, the resumed run 0.1994, the planted fault (a
# resume with fresh AdamW moments) 1.730.  The bar is 3x the noise and
# 2.9x under the fault.
RESUME_TOL = dict(rel=0.6)


class _Stop(Exception):
    """Ends a driven run after a given number of steps (not a failure)."""


def train_mm_config(path=TRAIN_MM_CONFIG, **sections) -> dict:
    """The card's training config (``path``), ``sections`` merged over it."""
    from ir_ads_tpu_torch.utils.config import _merge, load_config

    return _merge(load_config(path), sections)


def _driven_train_mm(cfg, save_dir, seed, stop_at=None):
    """``train_mm.main`` on the card with every launch count at 0 first; each
    step's launches and milliseconds (to a synchronize on each side) and
    each gate's launches recorded; with ``stop_at``, the run ends before the
    step of that index.  Returns (the result or None, steps, gates, the
    launches, the ``TrainState``, the trainable parameters before each
    step)."""
    from ir_ads_tpu_torch import train_mm
    from ir_ads_tpu_torch.training.train_state import TrainState

    steps, gates, seen, before_step = [], [], {}, {}
    take = TrainState.train_step
    gate = train_mm.eval_gate

    def step(self, batch):
        seen["state"] = self
        if stop_at is not None and self.step == stop_at:
            raise _Stop
        before_step[self.step] = _trainable(self)
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = take(self, batch)
        torch.cuda.synchronize()
        steps.append((self.step - 1, {k.name: k.launches - before[k.name] for k in kernels},
                      (time.perf_counter() - t) * 1e3))
        return out

    def counted_gate(*args, **kw):
        before = {k.name: k.launches for k in kernels}
        miou = gate(*args, **kw)
        gates.append({k.name: k.launches - before[k.name] for k in kernels
                      if k.launches > before[k.name]})
        return miou

    TrainState.train_step, train_mm.eval_gate = step, counted_gate
    kernels = _reset_launches()
    result = None
    try:
        result = train_mm.main(cfg, save_dir, device="cuda", seed=seed)
    except _Stop:
        pass
    finally:
        TrainState.train_step, train_mm.eval_gate = take, gate
    launches = {k.name: k.launches for k in kernels}
    state = result["state"] if result else seen["state"]
    return result, steps, gates, launches, state, before_step


def _trainable(state):
    return torch.cat([p.detach().flatten().float()
                      for p in state.model.parameters() if p.requires_grad])


def _drop_grad_run(seed, cfg, batch):
    """The state of ``cfg`` (drop_rate > 0) and a function that runs one
    forward and backward on ``batch`` with the train path swapped as
    ``_swap_train_path`` says, each run drawing from the same step's
    generator, and returns the loss and each parameter group's gradient."""
    from ir_ads_tpu_torch.train import build_model_and_state
    from ir_ads_tpu_torch.training.train_state import compute_loss

    state = build_model_and_state(cfg, NUM_CLASSES, iters_per_epoch=2, device="cuda",
                                  seed=seed)
    params = dict(state.model.named_parameters())
    data = state.batch(*batch)

    def run(plain=(), **replaced):
        restore = _swap_train_path(plain, **replaced)
        try:
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss, _ = compute_loss(state.model, data, state.loss_fn, state.generator(),
                                   state.ignore_label)
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
            fail("non-finite gradients on the drop_rate path")
        return float(loss.detach()), grads

    return state, data, run


def _qkv_f32_inside(qkv, bias, region, scale, heads):
    """K12's plain version as the control: no rounding inside."""
    from ir_ads_tpu_torch.ops.window_attention_qkv import window_attention_qkv_reference

    return window_attention_qkv_reference(qkv.float(), bias.float(), region, scale,
                                          heads).to(qkv.dtype)


def _qkv_no_region_at_stage3(qkv, bias, region, scale, heads):
    """K12's plain version with a planted fault: no shift-region mask at
    stage 3 (C = 1024) alone."""
    from ir_ads_tpu_torch.ops.window_attention_qkv import window_attention_qkv_reference

    keep = qkv.shape[-1] != 3 * 1024
    return window_attention_qkv_reference(qkv, bias, region if keep else None, scale, heads)


def phase_drop_rate(seed: int, card_line: str):
    """One training step of the card's config with drop_rate 0.1 (every other
    stochastic piece of the recipe on): the gradients of the kernel path
    (K12 at every block, K3, K4, K6 forward, K8 backward) against the
    all-plain path drawing the same masks, at GRAD_TOL (loss; each group no
    further than noise_ratio times the control, the plain path with f32
    inside K12 and K4); K12 without its region mask at stage 3 must fail;
    then the step itself, its launches counted.  Returns (the launches, the
    record)."""
    cfg = train_mm_config(MODEL={"BACKBONE_KWARGS": {"drop_rate": 0.1}})
    batch = _train_batches(seed, TRAIN_BATCH, 1)[0]
    state, data, run = _drop_grad_run(seed, cfg, batch)
    plain = FORWARD + BACKWARD + ("window_attention_qkv",)
    loss_k, grads_k = run()
    loss_p, grads_p = run(plain)
    loss_c, grads_c = run(plain, window_attention_qkv=_qkv_f32_inside, **CONTROL)
    noise = group_rel(grads_c, grads_p)

    def bar(grads, what):
        rels = group_rel(grads, grads_p)
        ratio = {k: rels[k] / noise[k] for k in rels}
        worst = max(ratio, key=ratio.get)
        print(f"  drop_rate 0.1, {what} vs all plain versions: gradient ||diff|| / ||ref|| "
              f"over {len(rels)} parameter groups, worst against the control "
              f"{ratio[worst]:.3f} x ({worst}: {rels[worst]:.3e}, control "
              f"{noise[worst]:.3e}; tol {GRAD_TOL['noise_ratio']} x)", flush=True)
        return rels, ratio[worst] <= GRAD_TOL["noise_ratio"]

    dloss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  drop_rate 0.1, kernel path vs all plain versions: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {dloss:.2e}, tol {GRAD_TOL['loss']}; control {loss_c:.6f})",
          flush=True)
    if dloss > GRAD_TOL["loss"]:
        fail("drop_rate 0.1: the loss on the kernel path disagrees with the plain path")
    rels, ok = bar(grads_k, "kernel path")
    if not ok:
        fail("drop_rate 0.1: the kernel path's gradients are further from the plain "
             "path's than a change of rounding explains")
    fault = run(plain, window_attention_qkv=_qkv_no_region_at_stage3)[1]
    if bar(fault, "planted fault (K12 without the shift-region mask at stage 3)")[1]:
        fail("a K12 without its shift-region mask at stage 3 passes the drop_rate bar")
    del grads_k, grads_p, grads_c, fault
    kernels = _reset_launches()
    m = state.train_step(data)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    if launches != DROP_LAUNCHES:
        fail(f"a drop_rate 0.1 step launched {launches}, expected {DROP_LAUNCHES}")
    if not all(bool(torch.isfinite(v)) for v in m.values()):
        fail(f"drop_rate 0.1: non-finite loss {m}")
    print(f"  drop_rate 0.1: one step, loss {float(m['loss']):.4f}, launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card_line}]", flush=True)
    del state, data, run
    torch.cuda.empty_cache()
    return launches, dict(loss_rel=dloss, group_rel=rels, control_rel=noise)


def _host_batch_ms(cfg):
    """The host's ms for a train batch from the loader (its threads at work,
    mean over an epoch) and for one sample in one thread (mean of the
    epoch's samples): what the device waits for if the loader falls behind."""
    from ir_ads_tpu_torch.data.augmentations import get_train_augmentation
    from ir_ads_tpu_torch.data.datasets import dataset_kwargs, get_dataset
    from ir_ads_tpu_torch.data.loader import DataLoader

    ds_cfg = cfg["DATASET"]
    ds = get_dataset(ds_cfg["NAME"])(
        ds_cfg["ROOT"], "train", get_train_augmentation(cfg["TRAIN"]["IMAGE_SIZE"]),
        ds_cfg["MODALS"], **dataset_kwargs(ds_cfg, "train"))
    loader = DataLoader(ds, cfg["TRAIN"]["BATCH_SIZE"], shuffle=True)
    t = time.perf_counter()
    n = sum(1 for _ in loader)
    per_batch = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    return per_batch, (time.perf_counter() - t) * 1e3 / len(ds)


def _resume_check(path, tmp, seed, stored_epoch, steps_per_epoch, card_line):
    """The run of config ``path`` that wrote ``tmp``/a/latest after epoch
    ``stored_epoch``, resumed from there for one step, against two
    uninterrupted runs (``RESUME_TOL``; a resume with fresh AdamW moments
    must fail).  Returns the distances."""
    from ir_ads_tpu_torch import train_mm

    cfg3 = train_mm_config(path, TRAIN={"EPOCHS": stored_epoch + 1})
    n = stored_epoch * steps_per_epoch  # the stored step: the next is the one compared
    updates = {}
    for name in ("B", "C"):
        _, _, _, _, st, before = _driven_train_mm(cfg3, f"{tmp}/{name}", seed, n + 1)
        updates[name] = _trainable(st) - before[n]
        del st, before
    load = train_mm.load_checkpoint

    def fresh_moments(directory, state):
        manifest = load(directory, state)
        state.optimizer.state.clear()
        return manifest

    resumed = {}
    for name, loader in (("resumed", load), ("fault", fresh_moments)):
        train_mm.load_checkpoint = loader
        try:
            res = _driven_train_mm(train_mm_config(path, TRAIN={"EPOCHS": stored_epoch + 1},
                                                   MODEL={"RESUME": f"{tmp}/a/latest"}),
                                   f"{tmp}/{name}", seed, n + 1)
        finally:
            train_mm.load_checkpoint = load
        first = res[1][0][0]
        if first != n:
            fail(f"the {name} run took step {first} first, not the stored step {n}")
        resumed[name] = _trainable(res[4]) - res[5][n]
        del res
    ref = updates["B"]
    rel = {name: float((u - ref).norm() / ref.norm())
           for name, u in (("uninterrupted C", updates["C"]),
                           ("resumed", resumed["resumed"]),
                           ("fault: fresh AdamW moments", resumed["fault"]))}
    print(f"  resume of {path} at epoch {stored_epoch}, step {n}: the step's update of the "
          f"trainable parameters against uninterrupted run B's, ||u - u_B|| / ||u_B||: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (tol {RESUME_TOL['rel']}) [{card_line}]", flush=True)
    if rel["resumed"] > RESUME_TOL["rel"]:
        fail("the resumed run's step disagrees with the uninterrupted runs'")
    if rel["fault: fresh AdamW moments"] <= RESUME_TOL["rel"]:
        fail("a resume with fresh AdamW moments passes the resume bar")
    torch.cuda.empty_cache()
    return rel


def phase_train_mm(seed: int, card_line: str):
    """Phase 8 (module docstring).  Returns (the launches of the driven run
    and of the drop_rate step, the record)."""
    import tempfile

    from ir_ads_tpu_torch.utils.checkpoint import load_weights
    from ir_ads_tpu_torch.utils.jax_params import from_flax

    cfg = train_mm_config()
    n_val = cfg["DATASET"]["VAL_KWARGS"]["length"]
    batch = cfg["TRAIN"]["BATCH_SIZE"]
    tmp = tempfile.mkdtemp(prefix="train_mm_")
    try:
        result, steps, gates, launches, state, _ = _driven_train_mm(cfg, f"{tmp}/a", seed)
        epochs = result["epochs"]
        for e in epochs:
            if not (math.isfinite(e["loss"]) and e["miou"] is not None
                    and math.isfinite(e["miou"])):
                fail(f"train_mm epoch {e['epoch']}: loss {e['loss']}, mIoU {e['miou']}")
        for i, got, _ in steps:
            if got != TRAIN_LAUNCHES:
                fail(f"train_mm step {i} launched {got}, expected {TRAIN_LAUNCHES}")
        want_gate = {k: v * n_val for k, v in EVAL_LAUNCHES[1.0].items()}
        if len(gates) != len(epochs) or any(g != want_gate for g in gates):
            fail(f"train_mm's gates launched {gates}, expected {want_gate} each")
        for sub in ("best", "latest"):
            for f in ("weights.msgpack", "train_state.msgpack", "manifest.json"):
                if not os.path.isfile(f"{tmp}/a/{sub}/{f}"):
                    fail(f"train_mm wrote no {sub}/{f}")
        live = state.model.state_dict()
        back = from_flax(load_weights(f"{tmp}/a/latest"))
        if set(back) != set(live) or not all(torch.equal(back[k], t.cpu())
                                             for k, t in live.items()):
            fail("latest/ does not read back as the live state dict bit for bit")
        ms = [t for _, _, t in steps]
        p50 = _p50(ms[1:])  # the first step warms up
        record = dict(
            epochs=epochs, step_ms=ms, p50_step_ms=p50, images_per_s=batch * 1e3 / p50,
            gate_seconds=[e["gate_seconds"] for e in epochs],
            checkpoint_bytes=[e["checkpoint_bytes"] for e in epochs],
            checkpoint_seconds=[e["checkpoint_seconds"] for e in epochs],
            best_miou=result["best_miou"])
        print(f"  train_mm: {len(epochs)} epochs of {epochs[0]['steps']} steps x {batch} "
              f"frames {IMAGE[0]}x{IMAGE[1]}, losses {['%.4f' % e['loss'] for e in epochs]}, "
              f"gate mIoU {[e['miou'] for e in epochs]} (random weights, 40 classes); epoch s "
              f"{['%.2f' % e['seconds'] for e in epochs]} [{card_line}]", flush=True)
        print(f"  train_mm: step ms {['%.1f' % v for v in ms]}, p50 after the first "
              f"{p50:.1f}, {batch * 1e3 / p50:.2f} images/s; gate s "
              f"{['%.2f' % e['gate_seconds'] for e in epochs]} ({n_val} images, "
              f"single-scale, r5) [{card_line}]", flush=True)
        print(f"  train_mm: checkpoints {[e['checkpoint_bytes'] for e in epochs]} bytes an "
              f"epoch (best/ and latest/), written in "
              f"{['%.2f' % e['checkpoint_seconds'] for e in epochs]} s [{card_line}]",
              flush=True)
        print(f"  launches on the train_mm path: { {k: v for k, v in launches.items() if v} }",
              flush=True)
        with open(f"{tmp}/a/latest/manifest.json") as f:
            stored = json.load(f)
        record["host_batch_ms"], record["host_sample_ms"] = _host_batch_ms(cfg)
        size = "x".join(map(str, cfg["DATASET"]["KWARGS"]["image_size"]))
        print(f"  host: a batch of {batch} train samples (Synthetic {size} RGB-D through the "
              f"train augmentation, collated) {record['host_batch_ms']:.1f} ms with the "
              f"loader's threads, one sample {record['host_sample_ms']:.1f} ms in one thread, "
              f"against a step's p50 {p50:.1f} ms [{card_line}]", flush=True)
        del state, live, back, result

        record["resume_rel"] = _resume_check(TRAIN_MM_CONFIG, tmp, seed, stored["epoch"],
                                             epochs[0]["steps"], card_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels_drop, drop = phase_drop_rate(seed, card_line)
    record["drop_rate"] = drop
    total = {k: launches[k] + kernels_drop[k] for k in launches}
    return total, record

# --------------------------------------------------------------------------
# phase 9: Swin-L (serving, training with remat) and dual_batch
# --------------------------------------------------------------------------

SWIN_L = "SwinTransformer-L"
# remat: every block's forward runs again in the backward (48 + 48 K1)
SWIN_L_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, "swin_block": 96}
# dual_batch: K1 and K5 once a block on both streams, K2 once a stream
DUAL_LAUNCHES = {"swin_block": 4, "block_tail": 8, "swin_block_v6": 20, "dscf_rpe": 3,
                 "dscf_rows": 3, "dscf_rpe_packed": 1}
DUAL_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, "swin_block": 24, "window_attn_bwd": 24}
# The remat step against the step without remat, the same masks drawn: the
# forwards are the same functions on the same inputs, so only the backward's
# run-to-run order (PyTorch's atomics, K8's dk and dv; about 1 % of a
# group's norm, phase 5) parts them; GRAD_TOL's bwd_group_rel.  A
# recomputation that draws new masks moves the blocks' gradients by the
# masks' share.
REMAT_TOL = dict(group_rel=GRAD_TOL["bwd_group_rel"])


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _control_bar(grads, grads_p, noise, what):
    """Every group's gradient no further from ``grads_p`` than
    ``noise_ratio`` times the control is (phase 5's forward bar)."""
    rels = group_rel(grads, grads_p)
    ratio = {k: rels[k] / noise[k] for k in rels}
    worst = max(ratio, key=ratio.get)
    print(f"  {what}: gradient ||diff|| / ||ref|| over {len(rels)} parameter groups, "
          f"worst against the control {ratio[worst]:.3f} x ({worst}: {rels[worst]:.3e}, "
          f"control {noise[worst]:.3e}; tol {GRAD_TOL['noise_ratio']} x)", flush=True)
    return ratio, ratio[worst] <= GRAD_TOL["noise_ratio"]


def phase_swin_l_serve(seed, frames, requests, batch, card_line):
    from ir_ads_tpu_torch.serve import SemSegPredictor

    t0 = time.time()
    pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                           image_size=IMAGE, backbone=SWIN_L)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  model: Swin-L CMNeXt, {n_params / 1e6:.1f} M parameters, bf16, r5 dispatch, "
          f"built in {time.time() - t0:.1f} s", flush=True)
    lat, outs, launches = _served(pred, frames, requests, batch, R5_LAUNCHES, "Swin-L r5")
    peak = torch.cuda.max_memory_allocated() / 2**30
    held = _held_launches(lambda: pred(*frames[0]), "one Swin-L request", lambda: None)
    want = _plain_request(pred, frames)
    if not _compare(*outs[0], *want, "Swin-L kernel path", LOGIT_TOL):
        fail("the Swin-L kernel path disagrees with the plain path end to end")
    if _compare(*_plain_request(pred, frames, window_block_v6=_window_block_v6_no_region),
                *want, "Swin-L planted fault (K5 without the shift-region mask)", LOGIT_TOL):
        fail("a K5 without its shift-region mask passes the Swin-L end-to-end bar")
    p50 = _p50(lat)
    print(f"  Swin-L r5: {requests} requests x {batch} frames 480x640 RGB-D, flip, latency "
          f"ms {['%.1f' % v for v in lat]} p50 {p50:.1f}, {batch * 1e3 / p50:.2f} frames/s, "
          f"peak memory {peak:.2f} GiB [{card_line}]", flush=True)
    print(f"  launches on the Swin-L r5 path ({requests} requests): {launches}", flush=True)
    record = dict(params_m=n_params / 1e6, latency_ms=lat, p50_ms=p50,
                  frames_per_s=batch * 1e3 / p50, peak_memory_gib=peak,
                  launches_held=len(held))
    del pred, outs, want
    torch.cuda.empty_cache()
    return launches, record


def phase_swin_l_train(seed, card_line):
    from ir_ads_tpu_torch.models.backbones import swin

    batches = _train_batches(seed, TRAIN_BATCH, 3)
    record, total = {}, {}
    t0 = time.time()
    tr, run = gradient_run(seed, torch.bfloat16, batches[0], backbone=SWIN_L)
    n_all = sum(p.numel() for p in tr.model.parameters())
    n_train = sum(p.numel() for p in tr.model.parameters() if p.requires_grad)
    print(f"  model: Swin-L CMNeXt under the train dispatch, remat on every block, "
          f"{n_train / 1e6:.2f} M of {n_all / 1e6:.1f} M parameters trainable, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    kernels = _reset_launches()
    loss_k, grads_k = run()
    once = {k.name: k.launches for k in kernels}
    if once != SWIN_L_TRAIN_LAUNCHES:
        fail(f"a Swin-L forward and backward launched {once}, expected {SWIN_L_TRAIN_LAUNCHES}")
    _add(total, once)

    # backward kernels: K7 and K8 (12 channels a head) behind the same forward
    _, grads_pb = run(BACKWARD)
    for what, grads in (("kernel path", grads_k),
                        ("planted fault (K8 with dbias scaled by scale)",
                         run(BACKWARD, dscf_rows_bwd=_rows_bwd_scaled_dbias)[1])):
        rels = group_rel(grads, grads_pb)
        worst = max(rels, key=rels.get)
        ok = rels[worst] <= GRAD_TOL["bwd_group_rel"]
        print(f"  Swin-L {what} vs the plain K7 and K8 behind the same forward: worst group "
              f"{rels[worst]:.3e} ({worst}; tol {GRAD_TOL['bwd_group_rel']})", flush=True)
        if what == "kernel path":
            record["backward_worst_rel"] = rels[worst]
            if not ok:
                fail("K7 or K8 disagrees with its plain version inside the Swin-L step")
        elif ok:
            fail("a K8 whose dbias is scaled passes the Swin-L gradient bar")
    del grads_pb

    # forward kernels through the step: the all-plain path and the control
    loss_p, grads_p = run(FORWARD + BACKWARD)
    loss_c, grads_c = run(FORWARD + BACKWARD, **CONTROL)
    noise = group_rel(grads_c, grads_p)
    dloss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  Swin-L kernel path vs all plain versions: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {dloss:.2e}, tol {GRAD_TOL['loss']}; control {loss_c:.6f})", flush=True)
    if dloss > GRAD_TOL["loss"]:
        fail("the Swin-L training loss on the kernel path disagrees with the plain path")
    ratio, ok = _control_bar(grads_k, grads_p, noise, "Swin-L kernel path vs all plain "
                             "versions")
    if not ok:
        fail("the Swin-L kernel path's gradients are further from the plain path's than a "
             "change of rounding explains")
    stage3_fault = functools.partial(_block_forward_plain, no_region_at=(1536,))
    if _control_bar(run(FORWARD + BACKWARD, swin_block=stage3_fault)[1], grads_p, noise,
                    "Swin-L planted fault (K1 without the region mask at stage 3)")[1]:
        fail("a K1 without its shift-region mask at stage 3 passes the Swin-L gradient bar")
    record.update(loss_rel=dloss, worst_vs_control=max(ratio.values()))
    del tr, run, grads_k, grads_p, grads_c
    torch.cuda.empty_cache()

    # remat replays the masks: the recipe's rates, the same generator
    tr, run = gradient_run(seed, torch.bfloat16, batches[0], backbone=SWIN_L, rates=True)
    stages = tr.model.backbone.stages
    peaks, grads = {}, {}
    for remat in (True, False):
        for s_ in stages:
            s_.use_remat = remat
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        grads[remat] = run()[1]
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
    for s_ in stages:
        s_.use_remat = True
    replay = swin.ReplayedDraws.__call__
    swin.ReplayedDraws.__call__ = lambda self: self.generator
    try:
        grads["fault"] = run()[1]
    finally:
        swin.ReplayedDraws.__call__ = replay
    rels = {}
    for what, key in (("remat", True), ("planted fault (the draws not replayed)", "fault")):
        r = group_rel(grads[key], grads[False])
        worst = max(r, key=r.get)
        rels[key] = r[worst]
        print(f"  Swin-L recipe step, {what} vs no remat, the same masks: worst group "
              f"{r[worst]:.3e} ({worst}), median {sorted(r.values())[len(r) // 2]:.3e} (tol "
              f"{REMAT_TOL['group_rel']})", flush=True)
    if rels[True] > REMAT_TOL["group_rel"]:
        fail("the Swin-L step with remat disagrees with the step without it")
    if rels["fault"] <= REMAT_TOL["group_rel"]:
        fail("a recomputation that does not replay the draws passes the remat bar")
    print(f"  Swin-L forward and backward at batch {TRAIN_BATCH}: peak memory "
          f"{peaks[True]:.2f} GiB with remat, {peaks[False]:.2f} GiB without [{card_line}]",
          flush=True)
    record.update(remat_worst_rel=rels[True], fault_worst_rel=rels["fault"],
                  peak_memory_gib_remat=peaks[True], peak_memory_gib_no_remat=peaks[False])
    del grads

    # the recipe's steps, timed
    tr.step(*batches[0])  # warm-up (allocator, cuBLAS handles, AdamW state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    ms, metrics = [], []
    for b in batches[1:]:
        t = time.perf_counter()
        metrics.append(tr.step(*b))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    if launches != {k: v * len(ms) for k, v in SWIN_L_TRAIN_LAUNCHES.items()}:
        fail(f"{len(ms)} Swin-L recipe steps launched {launches}")
    _add(total, launches)
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        fail(f"non-finite Swin-L loss {metrics}")
    p50 = _p50(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  Swin-L recipe: {len(ms)} steps x {TRAIN_BATCH} frames 480x640 RGB-D after a "
          f"warm-up step, loss {['%.4f' % m['loss'] for m in metrics]}, step ms "
          f"{['%.1f' % v for v in ms]} p50 {p50:.1f}, {TRAIN_BATCH * 1e3 / p50:.2f} images/s, "
          f"peak memory {peak:.2f} GiB [{card_line}]", flush=True)
    record.update(step_ms=ms, p50_ms=p50, images_per_s=TRAIN_BATCH * 1e3 / p50,
                  peak_memory_gib=peak, losses=metrics)
    del tr, run
    torch.cuda.empty_cache()
    return total, record


def phase_dual(seed, frames, requests, batch, card_line):
    from ir_ads_tpu_torch.serve import SemSegPredictor

    total, record = {}, {}
    dual = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                           image_size=IMAGE, backbone_kwargs=dict(dual_batch=True))
    lat_d, outs_d, launches = _served(dual, frames, requests, batch, DUAL_LAUNCHES, "dual r5")
    _add(total, launches)
    turns = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                            image_size=IMAGE)
    _warm_up(turns, frames)
    lat_t, outs_t = _serve(turns, frames)
    lat_d2, _ = _serve(dual, frames)  # in turns: dual, r5, dual
    differ = int((outs_d[0][0] != outs_t[0][0]).sum())
    print(f"  dual r5 logits vs r5's (streams in turn), the same weights and frames: "
          f"{differ} of {outs_t[0][0].numel()} elements differ", flush=True)
    if differ and not _compare(*outs_d[0], *outs_t[0], "dual r5 vs r5", LOGIT_TOL):
        fail("the dual r5 logits disagree with r5's")
    p50_d, p50_t = _p50(lat_d + lat_d2), _p50(lat_t)
    print(f"  Swin-B dual r5: latency ms {['%.1f' % v for v in lat_d + lat_d2]} p50 "
          f"{p50_d:.1f}, {batch * 1e3 / p50_d:.2f} frames/s; r5 in between: p50 {p50_t:.1f}, "
          f"{batch * 1e3 / p50_t:.2f} frames/s [{card_line}]", flush=True)
    print(f"  launches on the dual r5 path ({requests} requests): {launches}", flush=True)
    record.update(logits_differ=differ, p50_ms=p50_d, frames_per_s=batch * 1e3 / p50_d,
                  r5_p50_ms=p50_t, r5_frames_per_s=batch * 1e3 / p50_t)
    del dual, turns, outs_d, outs_t
    torch.cuda.empty_cache()

    # one dual training step against the streams-in-turn step
    batches = _train_batches(seed, TRAIN_BATCH, 1)
    tr, run = gradient_run(seed, torch.bfloat16, batches[0], dual_batch=True)
    kernels = _reset_launches()
    loss_d, grads_d = run()
    once = {k.name: k.launches for k in kernels}
    if once != DUAL_TRAIN_LAUNCHES:
        fail(f"a dual forward and backward launched {once}, expected {DUAL_TRAIN_LAUNCHES}")
    _add(total, once)
    loss_p, grads_p = run(FORWARD + BACKWARD)
    _, grads_c = run(FORWARD + BACKWARD, **CONTROL)
    noise = group_rel(grads_c, grads_p)
    del tr, run, grads_c
    torch.cuda.empty_cache()
    tr, run = gradient_run(seed, torch.bfloat16, batches[0])
    loss_t, grads_t = run()
    del tr, run
    torch.cuda.empty_cache()
    dloss = abs(loss_t - loss_d) / abs(loss_d)
    print(f"  dual step vs the streams-in-turn step: loss {loss_t:.6f} vs {loss_d:.6f} (rel "
          f"{dloss:.2e}, tol {GRAD_TOL['loss']})", flush=True)
    ratio, ok = _control_bar(grads_t, grads_d, noise,
                             "streams-in-turn kernel path vs the dual kernel path")
    if dloss > GRAD_TOL["loss"] or not ok:
        fail("the dual training step disagrees with the streams-in-turn step")
    record.update(train_loss_rel=dloss, train_worst_vs_control=max(ratio.values()))
    return total, record


def phase_swin_l_dual(seed, requests, batch, card_line):
    """Phase 9 (module docstring).  Returns (the launches of its driven
    paths, summed, the record)."""
    frames = _request_frames(seed, requests, batch)
    total = {}
    launches, serve_l = phase_swin_l_serve(seed, frames, requests, batch, card_line)
    _add(total, launches)
    launches, train_l = phase_swin_l_train(seed, card_line)
    _add(total, launches)
    launches, dual = phase_dual(seed, frames, requests, batch, card_line)
    _add(total, launches)
    return total, dict(swin_l_serve=serve_l, swin_l_train=train_l, dual=dual)


# --------------------------------------------------------------------------
# phase 10: the legacy semseg family (CMNeXt-B2, CMX-B2)
# --------------------------------------------------------------------------

CMNEXT_B2, CMX_B2 = "CMNeXt-B2", "CMX-B2"
LEGACY_CONFIG = "ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_cmnext_b2.yaml"
LEGACY_EVAL_IMAGES = 2
# CMNeXt-B2 under r5 at 480x640: the einsum DSCF at every stage, its bias by
# K6 at stages 2-3 (30x40 and 15x20 planes), in the XLA form at stages 0-1
# (120x160, 60x80); CMX-B2 runs no kernel of the port
# CMNeXt-B2 under r4 and r4i8 at 480x640: n = 15 x 20 offsets a field at
# every stage (2n % 8 == 0), so every stage takes the rows path, K3 + K4's
# unpacked form at 8, 8, 10 and 8 channels a head; r4i8 also runs the DSCF
# projections and the head in s8 (torch._int_mm)
LEGACY_ROWS = ("r4", "r4i8")
LEGACY_LAUNCHES = {(CMNEXT_B2, "r5"): {"dscf_rpe_packed": 2}, (CMX_B2, "r5"): {},
                   **{(CMNEXT_B2, d): {"dscf_rpe": 4, "dscf_rows": 4} for d in LEGACY_ROWS}}
# The requests' logits against the all-plain path: LOGIT_TOL, and bit for
# bit, for K6 is its plain version bit for bit and the rest of the path is
# the same PyTorch on the same card (0 of 24,576,000 logits apart on an H100
# 80GB HBM3 at 700 W).  LOGIT_TOL alone cannot see a fault in K6 there: a K6
# sampling at (x, y) moved the logits 1.06e-2 mean, 2.16e-2 max, labels
# 0.9934, for the bias of stages 2-3 reaches the head through two of its four
# levels, at H/16 and H/32.  Planted faults: that one, and K6's all-f32 form.
#
# One frame in f32 on the card against the same model on the host CPU: the
# CPU tests' bar.  Under "xla": K6 stores bf16 only, and r5 differs from xla
# by K6 alone, which the bf16 requests hold bit for bit
CARD_CPU_TOL = dict(atol=2e-3, rtol=1e-3)


def _rpe_packed_swapped(pos, table, h, w, dt):
    """K6's plain version with a planted fault: each key's bias sampled at
    (x, y) in place of (y, x)."""
    from ir_ads_tpu_torch.ops import dscf_rpe_packed as k6

    return k6.rpe_bias_packed_reference(pos.flip(-1).float(), table.float(), h, w, dt)


def _rpe_packed_f32(pos, table, h, w, dt):
    """K6's all-f32 form (phase 3's planted fault: only the output rounded)."""
    from ir_ads_tpu_torch.ops import dscf_rpe as k3

    return k3.rpe_bias_f32(pos.float(), table.float(), h, w, "bemhw").flatten(3).to(dt)


def _busy(fn):
    """``fn()`` under torch.profiler, as profile_port.py profiles a part: (wall
    ms, the summed device time of its kernels and copies in ms, the idle
    share 1 - busy / wall), busy and idle None where the profiler saw no
    device time."""
    from profile_port import profiled

    part = profiled(fn)[1]
    wall, busy = part["wall_ms"], part["device_busy_ms"]
    return (wall, busy, part["idle_share"]) if busy > 0 else (wall, None, None)


def _card_vs_cpu(backbone, seed, rgb, dep, what):
    """One frame's f32 fused-head logits of ``backbone`` (the xla dispatch,
    weights from ``seed``) on the card against the same model on the host
    CPU, at ``CARD_CPU_TOL``.  Returns (max |diff|, the largest |diff| over
    its bar, the CPU's max |logit|, the CPU's seconds)."""
    import copy

    from ir_ads_tpu_torch.data.augmentations import IMAGENET_MEAN, IMAGENET_STD
    from ir_ads_tpu_torch.models import build_model

    cpu = build_model("CMNeXt", backbone, NUM_CLASSES, dispatch="xla", seed=seed,
                      upsample_logits=False)
    card = copy.deepcopy(cpu).cuda()
    x_rgb = ((rgb[:1].float() / 255.0 - torch.as_tensor(IMAGENET_MEAN)) /
             torch.as_tensor(IMAGENET_STD)).float()
    x_dep = dep[:1].float() / 255.0
    with torch.no_grad():
        t = time.time()
        want = cpu.forward_fused(x_rgb, x_dep)
        cpu_s = time.time() - t
        got = card.forward_fused(x_rgb.cuda(), x_dep.cuda()).cpu()
    err = (got - want).abs()
    worst = float((err / (CARD_CPU_TOL["atol"] + CARD_CPU_TOL["rtol"] * want.abs())).max())
    print(f"  {what} f32 on the card vs the host CPU (xla dispatch, one frame, logits "
          f"{tuple(want.shape)}): max |diff| {float(err.max()):.3e}, largest |diff| over "
          f"atol {CARD_CPU_TOL['atol']} + rtol {CARD_CPU_TOL['rtol']} |cpu| {worst:.3f} "
          f"(tol 1), max |logit| {float(want.abs().max()):.3f}; CPU forward {cpu_s:.1f} s",
          flush=True)
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        fail(f"the {what} logits on the card disagree with the host CPU's")
    del card, cpu
    torch.cuda.empty_cache()
    return float(err.max()), worst, float(want.abs().max()), cpu_s


def _rows_no_bias(q, k, v, bias, *rest):
    """K4's plain version with a planted fault: the rpe bias dropped."""
    from ir_ads_tpu_torch.ops import dscf_rows as k4

    return k4.dscf_rows_reference(q, k, v, torch.zeros_like(bias), *rest)


def phase_legacy_rows(pred, backbone, dispatch, frames, outs, record):
    """CMNeXt-B2 under r4 or r4i8 (module docstring, phase 10): each K3 and
    K4 launch of one request held against its plain version, the logits
    against the all-plain path at ``LOGIT_TOL`` (under r4 a K4 without its
    rpe bias must fail it)."""
    held = _held_launches(lambda: pred(*frames[0]), f"one {backbone} {dispatch} request",
                          lambda: None, names=("dscf_rpe", "dscf_rows"))
    want = _plain_request(pred, frames)
    if not _compare(*outs[0], *want, f"{backbone} {dispatch} kernel path", LOGIT_TOL):
        fail(f"the {backbone} {dispatch} kernel path disagrees with the plain path end to end")
    record.update(launches_held=len(held), logits_rel_mean_vs_plain=float(
        (outs[0][0] - want[0]).abs().mean() / want[0].abs().mean()))
    if dispatch == "r4":
        bad = _plain_request(pred, frames, dscf_rows_attention=_rows_no_bias)
        if _compare(*bad, *want, f"{backbone} planted fault (K4 without its rpe bias)",
                    LOGIT_TOL):
            fail(f"K4 without its rpe bias passes the {backbone} end-to-end bar")
        record["fault_rel_mean (K4 without its rpe bias)"] = float(
            (bad[0] - want[0]).abs().mean() / want[0].abs().mean())


def phase_legacy_serve(seed, backbone, frames, requests, batch, card_line, dispatch="r5"):
    """One legacy model behind ``SemSegPredictor`` under ``dispatch`` (module
    docstring, phase 10).  Returns (launches, the record)."""
    from ir_ads_tpu_torch.serve import SemSegPredictor

    t0 = time.time()
    pred = SemSegPredictor(device="cuda", seed=seed, num_classes=NUM_CLASSES,
                           image_size=IMAGE, backbone=backbone, dispatch=dispatch)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  model: {backbone}, {n_params / 1e6:.1f} M parameters, bf16, {dispatch} "
          f"dispatch, built in {time.time() - t0:.1f} s", flush=True)
    per_request = LEGACY_LAUNCHES[(backbone, dispatch)]
    lat, outs, launches = _served(pred, frames, requests, batch, per_request,
                                  f"{backbone} {dispatch}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy, idle = _busy(lambda: pred(*frames[0]))
    record = dict(params_m=n_params / 1e6, latency_ms=lat, p50_ms=_p50(lat),
                  frames_per_s=batch * 1e3 / _p50(lat), peak_memory_gib=peak,
                  profiled_wall_ms=wall, device_busy_ms=busy, idle_share=idle)
    if dispatch in LEGACY_ROWS:
        phase_legacy_rows(pred, backbone, dispatch, frames, outs, record)
    elif per_request:
        held = _held_launches(lambda: pred(*frames[0]), f"one {backbone} request",
                              lambda: None, names=("dscf_rpe_packed",))
        want = _plain_request(pred, frames)
        ok = _compare(*outs[0], *want, f"{backbone} kernel path", LOGIT_TOL)
        differ = int((outs[0][0] != want[0]).sum())
        print(f"  {backbone} kernel path vs plain path: {differ} of {want[0].numel()} "
              "logits differ (bar 0)", flush=True)
        if not ok or differ:
            fail(f"the {backbone} kernel path disagrees with the plain path end to end")
        record.update(launches_held=len(held), logits_differ_vs_plain=differ)
        for what, fault in (("K6 sampling at (x, y)", _rpe_packed_swapped),
                            ("K6's all-f32 form", _rpe_packed_f32)):
            bad = _plain_request(pred, frames, rpe_bias_packed=fault)
            _compare(*bad, *want, f"{backbone} planted fault ({what}; LOGIT_TOL read, the "
                     "bar is bit equality)", LOGIT_TOL)
            n_bad = int((bad[0] != want[0]).sum())
            print(f"  {backbone} planted fault ({what}): {n_bad} logits differ", flush=True)
            if not n_bad:
                fail(f"{what} passes the {backbone} end-to-end bar")
            record[f"fault_rel_mean ({what})"] = float(
                (bad[0] - want[0]).abs().mean() / want[0].abs().mean())
    busy_s = "not measured" if busy is None else f"{busy:.2f} ms, idle share {idle:.3f}"
    print(f"  {backbone} {dispatch}: {requests} requests x {batch} frames 480x640 RGB-D, "
          f"flip, latency ms {['%.1f' % v for v in lat]} p50 {_p50(lat):.1f}, "
          f"{batch * 1e3 / _p50(lat):.2f} frames/s, peak memory {peak:.2f} GiB; one "
          f"profiled request: wall {wall:.2f} ms, device busy {busy_s} [{card_line}]",
          flush=True)
    print(f"  launches on the {backbone} {dispatch} path ({requests} requests): "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    del pred, outs
    torch.cuda.empty_cache()
    if dispatch == "r5":
        record["card_vs_cpu"] = dict(zip(("max_abs_diff", "worst_over_bar", "max_abs_logit",
                                          "cpu_s"),
                                         _card_vs_cpu(backbone, seed, *frames[0], backbone)))
    return launches, record


def phase_legacy_eval(seed, card_line):
    """val_mm with LEGACY_CONFIG on ``LEGACY_EVAL_IMAGES`` images (module
    docstring, phase 10).  Returns (launches, the record)."""
    from ir_ads_tpu_torch.evaluation.semseg_eval import align32
    from ir_ads_tpu_torch.utils.config import _merge, load_config

    cfg = _merge(load_config(LEGACY_CONFIG),
                 {"DATASET": {"KWARGS": {"length": LEGACY_EVAL_IMAGES}}})
    if cfg["MODEL"]["BACKBONE"] != CMNEXT_B2 or not cfg["EVAL"]["MSF"]["ENABLE"]:
        fail(f"{LEGACY_CONFIG} is not CMNeXt-B2 with MSF")
    scales = tuple(cfg["EVAL"]["MSF"]["SCALES"])
    result, calls, launches, model = _counted_eval(seed, "msf", cfg)
    peak = torch.cuda.max_memory_allocated() / 2**30
    shapes = [(2, align32(s * IMAGE[0]), align32(s * IMAGE[1]), 3)
              for s in scales] * LEGACY_EVAL_IMAGES
    per_scale = {s: expected_launches(model, sh[1:3]).get("dscf_rpe_packed", 0)
                 for s, sh in zip(scales, shapes)}
    summed = _check_calls(calls, model, shapes, "CMNeXt-B2 msf")
    if {k: v for k, v in launches.items() if v} != summed:
        fail(f"CMNeXt-B2 msf: the kernels launched {launches}, the forwards {summed}")
    # the largest DSCF score tensor: stage 0 at the last scale, the image and
    # its flip, 2 heads, every query pixel against 2n keys, f32
    h0, w0 = align32(scales[-1] * IMAGE[0]) // 4, align32(scales[-1] * IMAGE[1]) // 4
    n = ((h0 + 8 - 9) // 8 + 1) * ((w0 + 8 - 9) // 8 + 1)
    scores_gib = 2 * 2 * h0 * w0 * 2 * n * 4 / 2**30
    lat = [t * 1e3 for t in result["latency_s"]]
    p50 = _p50(lat[1:])  # the first image warms up
    print(f"  val_mm --cfg {LEGACY_CONFIG}: {LEGACY_EVAL_IMAGES} images of 480x640 RGB-D, "
          f"MSF at {list(scales)} with flip, mIoU {result['miou']} (random weights); ms per "
          f"image {['%.1f' % v for v in lat]}, {1e3 / p50:.3f} images/s after the first; "
          f"peak memory {peak:.2f} GiB, of which the f32 scores of stage 0 at scale "
          f"{scales[-1]} ({h0}x{w0} queries x {2 * n} keys x 2 heads x 2 images) are "
          f"{scores_gib:.2f} GiB [{card_line}]", flush=True)
    print(f"  K6 launches per MSF scale: {per_scale}; on the eval path "
          f"({LEGACY_EVAL_IMAGES} images): { {k: v for k, v in launches.items() if v} }",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, dict(miou=result["miou"], latency_ms=lat, p50_ms=p50,
                          images_per_s=1e3 / p50, peak_memory_gib=peak,
                          stage0_scores_gib=scores_gib, k6_per_scale=per_scale)


def phase_legacy(seed, requests, batch, card_line):
    """Phase 10 (module docstring).  Returns (the launches of its driven
    paths, summed, the record)."""
    frames = _request_frames(seed, requests, batch)
    total, record = {}, {}
    for backbone, dispatch in LEGACY_LAUNCHES:
        launches, record[f"{backbone} {dispatch}"] = phase_legacy_serve(
            seed, backbone, frames, requests, batch, card_line, dispatch)
        _add(total, launches)
    launches, record["val_mm"] = phase_legacy_eval(seed, card_line)
    _add(total, launches)
    return total, record


# --------------------------------------------------------------------------
# phase 11: the legacy family trained (CMNeXt-B2, CMX-B2)
# --------------------------------------------------------------------------

LEGACY_TRAIN_CONFIG = "ir_ads_tpu_torch/configs/nyu_rgbd_synthetic_cmnext_b2_train.yaml"
LEGACY_TRAIN_STEPS = 3
# The train dispatch on a legacy model: the einsum DSCF at every MiT stage,
# its bias by K6 at stages 2-3 (30x40 and 15x20: 2 launches a step, in the
# forward; the backward goes through its f32 twin), no other kernel; CMX-B2
# runs none.  The gate is r5's single-scale forward: K6 2 an image.
LEGACY_TRAIN_LAUNCHES = {CMNEXT_B2: {"dscf_rpe_packed": 2}, CMX_B2: {}}
# CMNeXt-B2's first step (the recipe's drop-path, dropout and adapter
# dropout on, drawn from the step's generator) against the same step with
# K6's plain version in its place: K6 is its plain version bit for bit, so
# the two differ only by what a second run of the kernel path differs by
# (PyTorch's backward sums with atomics).  Bars: the loss within
# GRAD_TOL's 2e-3 relative, and the step's update of the trainable
# parameters, ||u - u_plain|| / ||u_plain||, no further than
# ``noise_ratio`` times the second kernel run's (or equal, where the runs
# are bit-equal).
LEGACY_STEP_TOL = dict(loss=GRAD_TOL["loss"], noise_ratio=GRAD_TOL["noise_ratio"])


def _legacy_first_step(seed, backbone, batch, plain=False):
    """A fresh ``SemSegTrainer``'s first step on ``batch`` (with ``plain``,
    K6's plain version in the kernel's place).  Returns (loss, the update of
    the trainable parameters as one vector)."""
    from ir_ads_tpu_torch.train import SemSegTrainer

    tr = SemSegTrainer(device="cuda", dtype=torch.bfloat16, seed=seed,
                       num_classes=NUM_CLASSES, backbone=backbone)
    before = _trainable(tr.state)
    restore = _swap_train_path(plain=("dscf_rpe_packed",)) if plain else (lambda: None)
    try:
        loss = tr.step(*batch)["loss"]
    finally:
        restore()
    update = _trainable(tr.state) - before
    del tr
    torch.cuda.empty_cache()
    return loss, update


def phase_legacy_steps(seed, backbone, card_line):
    """``LEGACY_TRAIN_STEPS`` steps of ``SemSegTrainer`` (module docstring,
    phase 11).  Returns (launches, the record)."""
    from ir_ads_tpu_torch.train import SemSegTrainer

    batches = _train_batches(seed, TRAIN_BATCH, LEGACY_TRAIN_STEPS)
    tr = SemSegTrainer(device="cuda", dtype=torch.bfloat16, seed=seed,
                       num_classes=NUM_CLASSES, backbone=backbone)
    n_trained = sum(p.numel() for p in tr.model.parameters() if p.requires_grad)
    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    losses, ms, per_step = [], [], []
    for b in batches:
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(tr.step(*b)["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k.name: k.launches - before[k.name] for k in kernels
                         if k.launches > before[k.name]})
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del tr
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses):
        fail(f"{backbone}: a training step's loss is not finite: {losses}")
    if any(got != LEGACY_TRAIN_LAUNCHES[backbone] for got in per_step):
        fail(f"{backbone} training steps launched {per_step}, expected "
             f"{LEGACY_TRAIN_LAUNCHES[backbone]} each")
    p50 = _p50(ms[1:])  # the first step warms up
    print(f"  {backbone} SemSegTrainer: {LEGACY_TRAIN_STEPS} steps x {TRAIN_BATCH} frames "
          f"{IMAGE[0]}x{IMAGE[1]}, bf16 on f32 masters, {n_trained / 1e6:.2f} M trainable "
          f"(adapter-only), losses {['%.4f' % v for v in losses]}, step ms "
          f"{['%.1f' % v for v in ms]} p50 after the first {p50:.1f}, "
          f"{TRAIN_BATCH * 1e3 / p50:.2f} images/s, peak memory {peak:.2f} GiB; launches a "
          f"step {per_step[0]} [{card_line}]", flush=True)
    record = dict(losses=losses, step_ms=ms, p50_step_ms=p50,
                  images_per_s=TRAIN_BATCH * 1e3 / p50, peak_memory_gib=peak,
                  trainable_m=n_trained / 1e6, launches_per_step=per_step[0])
    if not LEGACY_TRAIN_LAUNCHES[backbone]:
        print(f"  {backbone}: no kernel of the port on its training path, so no plain path "
              "to hold it against", flush=True)
        return launches, record
    kernel = _legacy_first_step(seed, backbone, batches[0])
    again = _legacy_first_step(seed, backbone, batches[0])
    plain = _legacy_first_step(seed, backbone, batches[0], plain=True)

    def rel(u):
        return float((u - plain[1]).norm() / plain[1].norm())

    loss_rel = abs(kernel[0] - plain[0]) / abs(plain[0])
    noise, dist = float((again[1] - kernel[1]).norm() / plain[1].norm()), rel(kernel[1])
    print(f"  {backbone} first step against the all-plain path (K6's plain version): loss "
          f"{kernel[0]:.6f} vs {plain[0]:.6f}, rel {loss_rel:.3e} (tol "
          f"{LEGACY_STEP_TOL['loss']}); the update of the trainable parameters "
          f"||u - u_plain|| / ||u_plain|| {dist:.3e}, a second kernel run's distance from "
          f"the first {noise:.3e} (tol {LEGACY_STEP_TOL['noise_ratio']} x that, or 0) "
          f"[{card_line}]", flush=True)
    if loss_rel > LEGACY_STEP_TOL["loss"] or dist > LEGACY_STEP_TOL["noise_ratio"] * noise:
        fail(f"{backbone}'s first training step disagrees with the all-plain path")
    record.update(first_step_loss_rel=loss_rel, first_step_update_rel=dist,
                  first_step_noise_rel=noise)
    return launches, record


def phase_legacy_train_mm(seed, card_line):
    """``train_mm.main`` on LEGACY_TRAIN_CONFIG, then the resume (module
    docstring, phase 11).  Returns (launches, the record)."""
    import tempfile

    from ir_ads_tpu_torch.utils.checkpoint import load_weights
    from ir_ads_tpu_torch.utils.jax_params import from_flax

    cfg = train_mm_config(LEGACY_TRAIN_CONFIG)
    n_val = cfg["DATASET"]["VAL_KWARGS"]["length"]
    want_step = LEGACY_TRAIN_LAUNCHES[cfg["MODEL"]["BACKBONE"]]
    want_gate = {"dscf_rpe_packed": LEGACY_LAUNCHES[(CMNEXT_B2, "r5")]["dscf_rpe_packed"]
                 * n_val}
    tmp = tempfile.mkdtemp(prefix="train_mm_legacy_")
    try:
        result, steps, gates, launches, state, _ = _driven_train_mm(cfg, f"{tmp}/a", seed)
        epochs = result["epochs"]
        for e in epochs:
            if not (math.isfinite(e["loss"]) and e["miou"] is not None
                    and math.isfinite(e["miou"])):
                fail(f"legacy train_mm epoch {e['epoch']}: loss {e['loss']}, mIoU {e['miou']}")
        per_step = [{k: v for k, v in got.items() if v} for _, got, _ in steps]
        if any(got != want_step for got in per_step):
            fail(f"legacy train_mm steps launched {per_step}, expected {want_step} each")
        if len(gates) != len(epochs) or any(g != want_gate for g in gates):
            fail(f"legacy train_mm's gates launched {gates}, expected {want_gate} each")
        live = state.model.state_dict()
        back = from_flax(load_weights(f"{tmp}/a/latest"))
        if set(back) != set(live) or not all(torch.equal(back[k], t.cpu())
                                             for k, t in live.items()):
            fail("the legacy latest/ does not read back as the live state dict bit for bit")
        ms = [t for _, _, t in steps]
        print(f"  train_mm --cfg {LEGACY_TRAIN_CONFIG}: {len(epochs)} epochs of "
              f"{epochs[0]['steps']} steps, losses {['%.4f' % e['loss'] for e in epochs]}, "
              f"gate mIoU {[e['miou'] for e in epochs]} (random weights), step ms "
              f"{['%.1f' % v for v in ms]}, gate s "
              f"{['%.2f' % e['gate_seconds'] for e in epochs]}, checkpoints "
              f"{[e['checkpoint_bytes'] for e in epochs]} bytes [{card_line}]", flush=True)
        with open(f"{tmp}/a/latest/manifest.json") as f:
            stored = json.load(f)
        del state, live, back, result
        record = dict(epochs=epochs, step_ms=ms,
                      resume_rel=_resume_check(LEGACY_TRAIN_CONFIG, tmp, seed,
                                               stored["epoch"], epochs[0]["steps"],
                                               card_line))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, record


def phase_legacy_train(seed, card_line):
    """Phase 11 (module docstring).  Returns (the launches of its driven
    paths, summed, the record)."""
    total, record = {}, {}
    for backbone in (CMNEXT_B2, CMX_B2):
        launches, record[backbone] = phase_legacy_steps(seed, backbone, card_line)
        _add(total, launches)
    launches, record["train_mm"] = phase_legacy_train_mm(seed, card_line)
    _add(total, launches)
    return total, record


# --------------------------------------------------------------------------
# phase 12: DINO-R50 training, K9 under autograd with its backward kernel
# --------------------------------------------------------------------------

DET_TRAIN_IMAGE = (512, 512)   # train_net's default --image-size
DET_TRAIN_BATCH = 4            # train_net's default --batch-size
DET_TRAIN_LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))
DET_TRAIN_MAX_GT, DET_TRAIN_DN = 20, 100
DET_TRAIN_DN_QUERIES = 200     # 2 * max_gt * (dn 100 // max_gt 20 = 5 groups)
# a step: the teacher's 12 forward launches and the student's 12, whose 12
# backward launches K9's backward takes
DET_TRAIN_LAUNCHES = {"msdeform": 24, "msdeform_bwd": 12}
DET_TRAIN_STEPS = 3            # timed, after one warm-up step
# K9's backward against its plain version: bf16 outputs (dvalue summed in
# f32 by atomics in a varying order, then one rounding; dweights one
# rounding) may land one bf16 ulp apart, so their element bar is 1e-2 x rms
# + 1e-2 relative; dlocations stays f32 (dot products of the same bf16
# values in another order): 1e-3 x rms + 1e-3.  f32: 1e-4 both.  Each
# output's ||diff|| / ||ref|| <= K9_BWD_REL.
K9_BWD_REL = 1e-2
# The first step against the all-plain path, both taking the kernel path's
# proposal selections and assignments (a near-tie there would otherwise
# pick other queries): the loss within 2e-3 relative, and the update of
# every parameter no further from the kernel path's than 2x a second kernel
# run's (which differs by the backward's atomics), as phase 11 holds the
# legacy step; a backward that keeps the out-of-bounds value term in
# dlocations must fail that.  The all-plain path's K9 forward is its plain
# version in the kernel's order of work (``ms_deform_attn_ordered``, the
# kernel's bits): K9's plain version sums in another order, one bf16 ulp
# apart on some outputs, and Adam's first update is about lr * sign(g), so
# each flipped near-zero gradient moves the update by 2 lr: that path lies
# about 6x as far as the atomics do (PERF.md).  The clipped gradient Adam
# takes is linear in those roundings: both all-plain paths, in the kernel's
# order and in the plain version's own, hold it within 2e-2 of the kernel
# path's (a few bf16 ulps) over every parameter and over the
# sampling_offsets leaves alone (where dlocations enters the parameters),
# and the out-of-bounds fault must lie beyond that in one of the two.
DET_STEP_TOL = dict(loss=2e-3, noise_ratio=2.0, grad=2e-2, launch_rel=REL_TOL)


def _k9_inputs(g, lq, dtype, b=DET_TRAIN_BATCH, shapes=DET_TRAIN_LEVELS):
    """K9's inputs at the training step's shapes (as ``check_msdeform``
    draws them at serving's): value (B, 5440, 8, 32), the encoder's own
    positions or the decoder's references, offsets of a few pixels."""
    from ir_ads_tpu_torch.detection.transformer import make_encoder_reference_points

    heads, d, points, levels = 8, 32, 4, len(shapes)
    s = sum(h * w for h, w in shapes)
    value = _rand(g, b, s, heads, d, dtype=dtype)
    if lq == s:
        ref = torch.from_numpy(make_encoder_reference_points(shapes)).cuda()[None].expand(
            b, -1, -1, -1)
    else:
        ref = torch.rand(b, lq, 1, 2, generator=g, device="cuda").expand(-1, -1, levels, -1)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    reach = torch.arange(1, points + 1, device="cuda")[None, None, None, None, :, None]
    offsets = torch.randn(b, lq, heads, levels, points, 2, generator=g, device="cuda") * reach
    loc = (ref[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]).contiguous()
    att = torch.softmax(torch.randn(b, lq, heads, levels * points, generator=g, device="cuda"),
                        -1).reshape(b, lq, heads, levels, points).to(dtype)
    gout = _rand(g, b, lq, heads * d, dtype=dtype)
    return value, loc, att, gout


def _bwd_oob_kept(value, spatial_shapes, locations, weights, grad_out):
    """K9's plain backward with the planted fault 'the out-of-bounds value
    term kept in dlocations': a corner outside its level adds its clamped
    neighbour's dot product to the location gradient."""
    from ir_ads_tpu_torch.ops.msdeform import corner_terms
    from ir_ads_tpu_torch.ops.msdeform_bwd import corner_derivatives, ms_deform_attn_bwd_plain

    dvalue, _, datt = ms_deform_attn_bwd_plain(value, spatial_shapes, locations, weights,
                                               grad_out)
    b, s, heads, d = value.shape
    lq = locations.shape[1]
    g = grad_out.reshape(b, lq, heads, 1, d).float()
    rows = value.permute(0, 2, 1, 3).reshape(b * heads * s, d)
    base = ((torch.arange(b, device=value.device)[:, None] * heads
             + torch.arange(heads, device=value.device)[None, :]) * s)[:, None, :, None]
    dloc = torch.zeros(locations.shape, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        a = weights[:, :, :, lvl].float()
        tx = ty = 0.0
        corners, fx, fy = corner_terms(h, w, locations[:, :, :, lvl].float())
        for (idx, _, _), ddx, ddy in zip(corners, *corner_derivatives(fx, fy)):
            flat = (idx + start + base).reshape(-1)
            dot = (rows.index_select(0, flat).reshape(*idx.shape, d).float() * g).sum(-1)
            tx, ty = tx + ddx * dot, ty + ddy * dot
        dloc[:, :, :, lvl, :, 0] = tx * (a * w)
        dloc[:, :, :, lvl, :, 1] = ty * (a * h)
        start += h * w
    return dvalue, dloc, datt


def _bwd_without_half_pixel(value, spatial_shapes, locations, weights, grad_out):
    """K9's plain backward with the planted fault 'no -0.5'."""
    from ir_ads_tpu_torch.ops.msdeform_bwd import ms_deform_attn_bwd_plain

    return ms_deform_attn_bwd_plain(
        value, spatial_shapes, _without_half_pixel(locations.float(), spatial_shapes),
        weights, grad_out)


def check_msdeform_bwd(g, lq, dtype, fault):
    """K9's backward at the DINO-R50 training step's encoder (Lq = 5440) or
    decoder (Lq = 2200: 2000 queries and 200 CDN queries) shape, batch 4."""
    from ir_ads_tpu_torch.ops import msdeform_bwd as kb
    from ir_ads_tpu_torch.ops.msdeform import corner_tables

    shapes = DET_TRAIN_LEVELS
    value, loc, att, gout = _k9_inputs(g, lq, dtype)
    b, s, heads, d = value.shape
    levels, points = len(shapes), loc.shape[4]
    wgt = torch.stack(corner_tables(shapes, loc, att)[1])
    read = int((wgt != 0).sum())  # corners this run's data reads (and scatters into)
    outside = 1.0 - read / wgt.numel()
    del wgt
    bad = _bwd_oob_kept if fault == "out-of-bounds value term kept" else _bwd_without_half_pixel

    # the library call: autograd through four F.grid_sample and the weighted
    # sum, in f32; its graph is built once and only the backward is timed
    vf, grids, af = (value.float().requires_grad_(), (2 * loc - 1).requires_grad_(),
                     att.float().requires_grad_())
    out, start = 0, 0
    for lvl, (h, w) in enumerate(shapes):
        v = vf[:, start:start + h * w].permute(0, 2, 3, 1).reshape(b * heads, d, h, w)
        start += h * w
        gl = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * heads, lq, points, 2)
        smp = F.grid_sample(v, gl, mode="bilinear", padding_mode="zeros",
                            align_corners=False)  # (B*H, D, Lq, P)
        a = af[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * heads, 1, lq, points)
        out = out + (smp * a).sum(-1)
    gl_out = gout.float().reshape(b, lq, heads, d).permute(0, 2, 3, 1).reshape(b * heads, d, lq)

    def library():
        return torch.autograd.grad(out, (vf, grids, af), gl_out, retain_graph=True)

    f32 = dtype == torch.float32
    tol_b, tol_l = (1e-4, 1e-4) if f32 else (1e-2, 1e-3)
    return dict(
        name="msdeform_bwd",
        case=f"Lq={lq} {'f32' if f32 else 'bf16'} B={b} ({outside:.3f} of corners outside; "
             f"{read * d * 2 / 1e6:.0f} M gathered and scattered values; "
             f"{DET_TRAIN_LAUNCHES['msdeform_bwd']} launches per step)",
        run=lambda: kb.ms_deform_attn_bwd(value, shapes, loc, att, gout),
        plain=lambda: kb.ms_deform_attn_bwd_plain(value, shapes, loc, att, gout),
        faulted=lambda: bad(value, shapes, loc, att, gout),
        fault=fault, base=None, library=library,
        outputs=["dvalue", "dlocations", "dweights"], atol_of_rms=True,
        atol=[tol_b, tol_l, tol_b], rtol=[tol_b, tol_l, tol_b], rel_tol=K9_BWD_REL,
        bytes=(nbytes(value, loc, att, gout) + nbytes(value, att)
               + loc.numel() * 4),
        flops=lq * b * heads * levels * points * (4 * d * 4 + 60), rate=F32_FLOPS,
    )


def _det_train_batch(seed, n=DET_TRAIN_BATCH, image=DET_TRAIN_IMAGE,
                     max_gt=DET_TRAIN_MAX_GT, mask=128):
    """(strong, weak, labels, boxes, valid, masks) on the card: raw 0-255
    images, 8 to 20 GT boxes an image, their box masks at 128 x 128 (the
    mapper's mask size)."""
    g = torch.Generator().manual_seed(seed)
    strong = torch.randint(0, 256, (n, *image, 3), generator=g).float()
    weak = torch.randint(0, 256, (n, *image, 3), generator=g).float()
    labels = torch.randint(0, DET_CLASSES, (n, max_gt), generator=g)
    counts = torch.randint(8, max_gt + 1, (n,), generator=g)
    valid = torch.arange(max_gt)[None] < counts[:, None]
    cxcy = torch.rand(n, max_gt, 2, generator=g) * 0.7 + 0.15
    wh = torch.rand(n, max_gt, 2, generator=g) * 0.25 + 0.05
    boxes = torch.cat([cxcy, wh], -1) * valid[..., None]
    grid = (torch.arange(mask) + 0.5) / mask
    inside = ((grid[None, None, None, :] - boxes[..., 0, None, None]).abs()
              < boxes[..., 2, None, None] / 2) & (
        (grid[None, None, :, None] - boxes[..., 1, None, None]).abs()
        < boxes[..., 3, None, None] / 2)
    masks = (inside & valid[..., None, None]).float()
    return [t.cuda() for t in (strong, weak, labels, boxes, valid, masks)]


def _det_trainer(seed):
    """A full-width DINO-R50 trainer, every weight drawn from ``seed``
    (``serve.init_random_``, as DetPredictor draws them), bf16 compute over
    f32 masters."""
    from ir_ads_tpu_torch.detection.dino import DINODetector
    from ir_ads_tpu_torch.detection.train import DetTrainState
    from ir_ads_tpu_torch.serve import init_random_

    model = DINODetector(num_classes=DET_CLASSES, num_queries=DET_QUERIES,
                         dn_number=DET_TRAIN_DN, max_gt=DET_TRAIN_MAX_GT)
    init_random_(model, seed)
    return DetTrainState.create(model.cuda(), dtype=torch.bfloat16, seed=seed)


@contextlib.contextmanager
def _k9_swapped(fwd=None, bwd=None):
    """K9's forward (``msdeform._forward``, every launch under autograd or
    not) replaced by ``fwd`` and its backward (``ms_deform_attn_bwd``) by
    ``bwd`` while the block runs; None keeps the kernel."""
    from ir_ads_tpu_torch.ops import msdeform as k9
    from ir_ads_tpu_torch.ops import msdeform_bwd as kb

    saved = k9._forward, kb.ms_deform_attn_bwd
    k9._forward, kb.ms_deform_attn_bwd = fwd or saved[0], bwd or saved[1]
    try:
        yield saved
    finally:
        k9._forward, kb.ms_deform_attn_bwd = saved


class _Replay:
    """Records the proposal selections (``transformer.top_k``) and the
    assignments (``criterion.hungarian_match``) of one step, or replays
    them in the same order in another."""

    def __init__(self):
        from ir_ads_tpu_torch.detection import criterion, transformer

        self.mods, self.tape, self.at = (transformer, criterion), [], None

    def __enter__(self):
        tr, crit = self.mods
        self.saved = tr.top_k, crit.hungarian_match

        def wrap(fn):
            def run(*args, **kw):
                if self.at is None:
                    out = fn(*args, **kw)
                    self.tape.append(out)
                    return out
                out = self.tape[self.at]
                self.at += 1
                return out
            return run

        tr.top_k, crit.hungarian_match = (wrap(f) for f in self.saved)
        return self

    def replay(self):
        """Replay the tape from its start."""
        self.at = 0

    def __exit__(self, *exc):
        tr, crit = self.mods
        tr.top_k, crit.hungarian_match = self.saved


def _first_det_step(seed, batch, fwd=None, bwd=None):
    """A fresh trainer's first step on ``batch``, K9's forward and backward
    swapped for ``fwd`` and ``bwd`` (``_k9_swapped``).  Returns (loss, the
    update of every parameter as one vector, the clipped gradient Adam
    took, as one vector, the mask of the sampling_offsets leaves in it)."""
    state = _det_trainer(seed)
    before = torch.cat([v.detach().flatten() for v in state.params.values()])
    offsets = torch.cat([torch.full((v.numel(),), "sampling_offsets" in k, device=v.device)
                         for k, v in state.params.items()])
    grads, adam_step = [], state.opt.step

    def step(*args, **kw):
        grads.append(torch.cat([v.grad.flatten() for v in state.params.values()]))
        return adam_step(*args, **kw)

    state.opt.step = step
    with _k9_swapped(fwd, bwd):
        loss = float(state.train_step(batch)["loss"])
    update = torch.cat([v.detach().flatten() for v in state.params.values()]) - before
    del state, before
    torch.cuda.empty_cache()
    return loss, update, grads[0], offsets


def _checked_det_step(state, batch):
    """One step with every K9 launch, forward and backward, held against
    its plain version on its own inputs.  Returns the relative errors of
    the forward launches and, per output, of the backward launches."""
    from ir_ads_tpu_torch.ops import msdeform as k9
    from ir_ads_tpu_torch.ops import msdeform_bwd as kb

    fwd_log, bwd_log, kernels = [], [], []

    def fwd(value, spatial_shapes, locations, weights):
        got = kernels[0][0](value, spatial_shapes, locations, weights)
        want = k9.ms_deform_attn_plain(value, spatial_shapes, locations, weights)
        fwd_log.append(_rel(got, want, None))
        return got

    def bwd(value, spatial_shapes, locations, weights, grad_out):
        got = kernels[0][1](value, spatial_shapes, locations, weights, grad_out)
        want = kb.ms_deform_attn_bwd_plain(value, spatial_shapes, locations, weights, grad_out)
        bwd_log.append(tuple(_rel(a, b, None) for a, b in zip(got, want)))
        return got

    with _k9_swapped(fwd, bwd) as saved:
        kernels.append(saved)
        state.train_step(batch)
    torch.cuda.synchronize()
    return fwd_log, bwd_log


def phase_det_train_step(seed, card_line):
    """(b) one full-width step: launches, 1 + 3 steps' p50, peak memory, the
    auction's iterations and share of the step, every K9 launch held, and
    the first step against the all-plain path."""
    from ir_ads_tpu_torch.detection import matcher

    batches = [_det_train_batch(seed + i) for i in range(DET_TRAIN_STEPS + 1)]
    t0 = time.time()
    state = _det_trainer(seed)
    n_params = sum(v.numel() for v in state.params.values())
    print(f"  model: DINO-R50 deformable-mask detector at configs/detection/dino_r50.py's "
          f"width, {n_params / 1e6:.1f} M parameters (f32 masters, bf16 compute), 6 + 6 "
          f"layers, {DET_QUERIES} queries + {DET_TRAIN_DN_QUERIES} CDN, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    auction_ms, auction_iters = [], []
    saved_auction = matcher.auction_match

    def timed_auction(cost, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, iters = matcher.auction_solve(cost, *a, **kw)
        torch.cuda.synchronize()
        auction_ms.append((time.perf_counter() - t) * 1e3)
        auction_iters.append(max(iters))
        return out

    matcher.auction_match = timed_auction
    torch.cuda.reset_peak_memory_stats()
    kernels = _reset_launches()
    losses, ms, per_step, auctions, auction_share = [], [], [], [], []
    try:
        for b in batches:
            before = {k.name: k.launches for k in kernels}
            auction_ms.clear()
            auction_iters.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = state.train_step(b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            per_step.append({k.name: k.launches - before[k.name] for k in kernels
                             if k.launches > before[k.name]})
            auctions.append(list(auction_iters))
            auction_share.append(sum(auction_ms) / ms[-1])
    finally:
        matcher.auction_match = saved_auction
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses):
        fail(f"a DINO training step's loss is not finite: {losses}")
    if any(p != DET_TRAIN_LAUNCHES for p in per_step):
        fail(f"the DINO training steps launched {per_step}, expected {DET_TRAIN_LAUNCHES} each")
    p50 = _p50(ms[1:])
    print(f"  {DET_TRAIN_STEPS + 1} steps x {DET_TRAIN_BATCH} images {DET_TRAIN_IMAGE[0]}x"
          f"{DET_TRAIN_IMAGE[1]} (the first warms up): losses {['%.4f' % v for v in losses]}, "
          f"step ms {['%.1f' % v for v in ms]}, p50 of the last {DET_TRAIN_STEPS} {p50:.1f}, "
          f"{DET_TRAIN_BATCH * 1e3 / p50:.2f} images/s, peak memory {peak:.2f} GiB; launches "
          f"a step {per_step[0]}; auction solves a step {len(auctions[-1])} (7 set criteria "
          f"at (Q, G) = ({DET_QUERIES}, {DET_TRAIN_MAX_GT}), the consistency at ({DET_QUERIES}, "
          f"{DET_QUERIES})), iterations by solve {auctions[1:]}, their share of the step "
          f"{['%.3f' % v for v in auction_share]} [{card_line}]", flush=True)

    fwd_log, bwd_log = _checked_det_step(state, batches[0])
    worst_f = max(fwd_log)
    worst_b = [max(e[i] for e in bwd_log) for i in range(3)]
    print(f"  every K9 launch of a step against its plain version on its own inputs: forward "
          f"{len(fwd_log)} launches, ||diff|| / ||ref|| worst {worst_f:.3e} (tol "
          f"{DET_STEP_TOL['launch_rel']}); backward {len(bwd_log)} launches, worst dvalue "
          f"{worst_b[0]:.3e}, dlocations {worst_b[1]:.3e}, dweights {worst_b[2]:.3e} (tol "
          f"{K9_BWD_REL})", flush=True)
    if len(fwd_log) != DET_TRAIN_LAUNCHES["msdeform"] or \
            len(bwd_log) != DET_TRAIN_LAUNCHES["msdeform_bwd"]:
        fail(f"{len(fwd_log)} forward and {len(bwd_log)} backward K9 launches were checked "
             "inside the step")
    if worst_f > DET_STEP_TOL["launch_rel"] or max(worst_b) > K9_BWD_REL:
        fail("K9 or its backward disagrees with its plain version inside the training step")
    del state
    torch.cuda.empty_cache()

    from ir_ads_tpu_torch.ops.msdeform import ms_deform_attn_ordered, ms_deform_attn_plain
    from ir_ads_tpu_torch.ops.msdeform_bwd import ms_deform_attn_bwd_plain

    runs = dict(kernel={}, again={},
                plain=dict(fwd=ms_deform_attn_ordered, bwd=ms_deform_attn_bwd_plain),
                fault=dict(bwd=_bwd_oob_kept),
                plain_sums=dict(fwd=ms_deform_attn_plain, bwd=ms_deform_attn_bwd_plain))
    with _Replay() as tape:
        for i, (name, swap) in enumerate(runs.items()):
            if i:
                tape.replay()
            runs[name] = _first_det_step(seed, batches[0], **swap)
    u = {k: v[1] for k, v in runs.items()}
    ref = float(u["plain"].norm())
    dist = lambda a, b: float((u[a] - u[b]).norm()) / ref  # noqa: E731
    loss_rel = abs(runs["kernel"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    noise, plain_dist = dist("again", "kernel"), dist("plain", "kernel")
    fault_dist, sums_dist = dist("fault", "kernel"), dist("plain_sums", "kernel")
    ratio = DET_STEP_TOL["noise_ratio"]
    print(f"  first step, the kernel path's {len(tape.tape)} selections and assignments "
          f"replayed in each run; distances ||u - u_kernel|| / ||u_plain|| of the update of "
          f"every parameter: a second kernel run {noise:.3e}; the all-plain path (K9's plain "
          f"forward in the kernel's order, its plain backward) {plain_dist:.3e} (tol {ratio} "
          f"x the second run's, or 0); planted fault (the out-of-bounds value term kept in "
          f"dlocations) {fault_dist:.3e}; for the record, K9's plain version summing in its "
          f"own order {sums_dist:.3e}; loss {runs['kernel'][0]:.6f} vs the all-plain "
          f"{runs['plain'][0]:.6f}, rel {loss_rel:.3e} (tol {DET_STEP_TOL['loss']}) "
          f"[{card_line}]", flush=True)

    g, offsets = {k: v[2] for k, v in runs.items()}, runs["kernel"][3]

    def gdist(name, part):
        want = g["kernel"] if part is None else g["kernel"][part]
        got = g[name] if part is None else g[name][part]
        return float((got - want).norm()) / float(want.norm())

    grad = {k: (gdist(k, None), gdist(k, offsets))
            for k in ("again", "plain", "plain_sums", "fault")}
    tol_g = DET_STEP_TOL["grad"]
    print("  first step, the clipped gradient Adam takes, ||g - g_kernel|| / ||g_kernel|| "
          "over every parameter / over the sampling_offsets leaves alone: "
          + "; ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in grad.items())
          + f" (tol {tol_g} for both plain paths; the fault must lie beyond it)", flush=True)
    if loss_rel > DET_STEP_TOL["loss"] or plain_dist > ratio * noise:
        fail("the DINO training step disagrees with the all-plain path")
    if max(grad["plain"] + grad["plain_sums"]) > tol_g:
        fail("the DINO training step's gradient disagrees with the all-plain path's")
    if fault_dist <= ratio * noise:
        fail("a K9 backward keeping the out-of-bounds value term passes the update bar")
    if max(grad["fault"]) <= tol_g:
        fail("a K9 backward keeping the out-of-bounds value term passes the gradient bar")
    return launches, dict(losses=losses, step_ms=ms, p50_step_ms=p50,
                          images_per_s=DET_TRAIN_BATCH * 1e3 / p50, peak_memory_gib=peak,
                          launches_per_step=per_step[0], auction_iters=auctions,
                          auction_share=auction_share, launch_rel_fwd=worst_f,
                          launch_rel_bwd=worst_b, first_step_loss_rel=loss_rel,
                          first_step_noise_rel=noise, first_step_plain_rel=plain_dist,
                          first_step_fault_rel=fault_dist, first_step_plain_sums_rel=sums_dist,
                          first_step_grad_rel=grad,
                          params_m=n_params / 1e6)


DET_NET_FLAGS = ("--num-queries", "2000", "--batch-size", "4", "--max-iter", "4",
                 "--eval-period", "4")
DET_NET_IMAGES = 8


def phase_det_train_net(seed, card_line):
    """(c) ``train_net.main`` on a synthetic COCO set of 8 images at 512 x
    512 (20 classes) written by the port's ``make_synthetic_coco``: 4
    steps, the EMA weights' COCO eval at step 4, the weights written and
    read back, the final eval."""
    import tempfile

    from ir_ads_tpu_torch import train_net
    from ir_ads_tpu_torch.utils.checkpoint import load_dino_weights

    tmp = tempfile.mkdtemp(prefix="det_train_net_", dir=os.path.dirname(os.path.abspath(
        __file__)))
    try:
        ann, images = train_net.make_synthetic_coco(os.path.join(tmp, "coco"),
                                                    n_images=DET_NET_IMAGES, size=512,
                                                    n_classes=DET_CLASSES, seed=seed)
        out = os.path.join(tmp, "out")
        kernels = _reset_launches()
        t = time.time()
        stats = train_net.main(["--train-json", ann, "--train-root", images, "--val-json", ann,
                                "--val-root", images, *DET_NET_FLAGS, "--output", out,
                                "--seed", str(seed)])
        wall = time.time() - t
        launches = {k.name: k.launches for k in kernels}
        want = {"msdeform": 4 * DET_TRAIN_LAUNCHES["msdeform"]
                + 2 * DET_NET_IMAGES * DET_LAUNCHES, "msdeform_bwd": 4 * 12}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            fail(f"train_net launched {got}, expected {want}")
        read = {n: load_dino_weights(os.path.join(out, n))
                for n in ("weights.msgpack", "ema_weights.msgpack")}
        n = {k: len(v) for k, v in read.items()}
        if not all(all(bool(torch.isfinite(t).all()) for t in sd.values())
                   for sd in read.values()):
            fail("train_net wrote non-finite weights")
        if not stats or not all(math.isfinite(stats[k]) for k in ("AP", "AP50", "AR@100")):
            fail(f"train_net's eval gave {stats}")
        with open(os.path.join(out, "train.log")) as f:
            log = f.read()
        if log.count("eval: AP=") != 2 or "iter 4/4" not in log:
            fail("train_net's log lacks its step or its two evals")
        print(f"  train_net.main {' '.join(DET_NET_FLAGS)} on {DET_NET_IMAGES} synthetic "
              f"images 512x512, {DET_CLASSES} classes: {wall:.1f} s (4 steps, the EMA eval at "
              f"step 4, weights written, the final eval); launches {got}; weights read back "
              f"({n['weights.msgpack']} and {n['ema_weights.msgpack']} tensors); final eval "
              f"AP {stats['AP']:.4f} AP50 {stats['AP50']:.4f} AR@100 {stats['AR@100']:.4f} "
              f"[{card_line}]", flush=True)
        return launches, dict(wall_s=wall, launches=got, stats=stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_det_train(seed, card_line):
    """Phase 12: (a) K9's backward alone, (b) the full-width step, (c) the
    entry point.  Returns (the backward's kernel rows, launches, record)."""
    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    s = sum(h * w for h, w in DET_TRAIN_LEVELS)
    lq_dec = DET_QUERIES + DET_TRAIN_DN_QUERIES
    rows = [hold(check_msdeform_bwd(g, lq, dt, fault)) for lq, dt, fault in (
        (s, torch.bfloat16, "out-of-bounds value term kept"),
        (lq_dec, torch.bfloat16, "no -0.5"),
        (s, torch.float32, "no -0.5"),
        (lq_dec, torch.float32, "out-of-bounds value term kept"))]
    t_a = time.time() - t0
    step_launches, step = phase_det_train_step(seed, card_line)
    t_b = time.time() - t0 - t_a
    net_launches, net = phase_det_train_net(seed, card_line)
    total = dict(step_launches)
    _add(total, net_launches)
    print(f"  phase 12: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {net['wall_s']:.1f} s",
          flush=True)
    return rows, total, dict(step=step, train_net=net,
                             backward=[{k: r[k] for k in ("case", "rel_err", "fault",
                                                          "fault_rel_err", "ms", "plain_ms",
                                                          "library_ms", "bound_ms")}
                                       for r in rows])


# --------------------------------------------------------------------------
# phase 13: the anomaly stack (train_ad) and the LVIS evaluator
# --------------------------------------------------------------------------

# the JAX driver's defaults (train_ad.py:103-119); the cuts: --epochs 30 -> 1,
# --steps_per_epoch 20 -> 8
AD_FLAGS = ("--backbone", "resnet18", "--img_size", "448", "--batch_size", "48", "--lr", "2e-4",
            "--nAnomaly", "10", "--lightsb", "--sb_potentials", "10")
AD_CUTS = ("--epochs", "1", "--steps_per_epoch", "8")
AD_BATCH, AD_STEPS = 48, 8
AD_TREE = dict(train_good=64, test_good=16, defects=("crack", "hole", "scratch"),
               per_defect=10, size=1024)
AD_GROUPS = ("features.stem", "features.res2", "features.res3", "features.res4",
             "features.res5", "score_head")
# one f32 deviation step on the card against the same step on the host CPU
# (the loss relative, each group's gradient distance over its norm); set
# from three card runs' readings, 4.659e-3 at most in each (the loss equal):
# f32's own distance from the f64 step (3.70e-3 the card's, 3.85e-3 the
# host's), printed beside it; card run to run 1.2e-5
AD_STEP_TOL = dict(loss=1e-5, group=2e-2)
# LightSB on the card against the host CPU: max |card - cpu| over max |cpu|;
# readings 1.5e-7 (log C) to 1.82e-4 (the diagonal drift, where the host's
# f32 lies 1.51e-4 from the f64 result and the card's 3.14e-5: the drift's
# two terms cancel), the f64 distances printed beside them
SB_CARD_TOL = 1e-3
SB_DIM, SB_N, SB_BATCH, SB_STEPS = 512, 10, 128, 10
LVIS_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@300")
LVIS_NET_FLAGS = ("--num-queries", "2000", "--batch-size", "4", "--max-iter", "2",
                  "--evaluator", "lvis")


def _mvtec_tree(root, seed):
    """An MVTec-AD class tree of 1024x1024 RGB PNGs (``AD_TREE``): smooth
    random textures with pixel noise; a defect image carries a dark stroke.
    Returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    size = AD_TREE["size"]
    jobs = [("train", "good", i) for i in range(AD_TREE["train_good"])]
    jobs += [("test", "good", i) for i in range(AD_TREE["test_good"])]
    jobs += [("test", d, i) for d in AD_TREE["defects"] for i in range(AD_TREE["per_defect"])]

    def write(k):
        split, cl, i = jobs[k]
        rng = np.random.RandomState([seed, k])
        base = Image.fromarray(rng.randint(0, 256, (32, 32, 3), dtype=np.uint8))
        img = np.asarray(base.resize((size, size), Image.BICUBIC), np.int16)
        img = img + rng.randint(-8, 9, img.shape)
        if cl != "good":
            y, x = rng.randint(size // 16, size - size // 16, 2)
            img[y: y + size // 85 + 1, x: x + rng.randint(size // 16, size // 4)] //= 4
        d = os.path.join(root, "widget", split, cl)
        os.makedirs(d, exist_ok=True)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:03d}.png"), compress_level=1)

    t = time.time()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(jobs))))
    return time.time() - t


@contextlib.contextmanager
def _instrumented_train_ad():
    """While the block runs, each call of ``train_ad``'s ``train_step``
    (synchronised), ``evaluate``, ``fit_lightsb``, ``auroc`` and ``build``
    is recorded as (seconds, result), and each batch of
    ``balanced_batches`` by its host seconds."""
    from ir_ads_tpu_torch import train_ad

    names = ("train_step", "evaluate", "fit_lightsb", "auroc", "build")
    saved = {k: getattr(train_ad, k) for k in names + ("balanced_batches",)}
    rec = {k: [] for k in saved}

    def recorded(name):
        def run(*a, **kw):
            if name == "train_step":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = saved[name](*a, **kw)
            if name == "train_step":
                torch.cuda.synchronize()
            rec[name].append((time.perf_counter() - t, out))
            return out
        return run

    def balanced_batches(*a, **kw):
        it = saved["balanced_batches"](*a, **kw)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            rec["balanced_batches"].append(time.perf_counter() - t)
            yield batch

    for k in names:
        setattr(train_ad, k, recorded(k))
    train_ad.balanced_batches = balanced_batches
    try:
        yield rec
    finally:
        for k, f in saved.items():
            setattr(train_ad, k, f)


def phase_anomaly_train(seed, root, card_line):
    """(a) ``train_ad.main`` on the card at the JAX driver's defaults
    (``AD_FLAGS``) with ``AD_CUTS``; no hand-written kernel launches."""
    from ir_ads_tpu_torch import train_ad
    from ir_ads_tpu_torch.utils.checkpoint import load_anomaly_weights

    out = os.path.join(root, "out")
    argv = ["--dataset_root", root, "--classname", "widget", *AD_FLAGS, *AD_CUTS,
            "--output", out, "--seed", str(seed)]
    kernels = _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with _instrumented_train_ad() as rec:
        roc = train_ad.main(argv)
    wall = time.time() - t
    launches = {k.name: k.launches for k in kernels if k.launches}
    if launches:
        fail(f"train_ad launched hand-written kernels: {launches}")
    step_ms = [1e3 * dt for dt, _ in rec["train_step"]]
    batch_ms = [1e3 * dt for dt in rec["balanced_batches"]]
    (eval_s, (scores, _, _)), (feats_s, _) = rec["evaluate"]
    (fit_s, (_, _, objective)), = rec["fit_lightsb"]
    rocs = dict(zip(("deviation", "lightsb", "combined"), (r for _, r in rec["auroc"])))
    if len(step_ms) != AD_STEPS or rocs["deviation"] != roc or len(rocs) != 3 or not all(
            math.isfinite(v) for v in (*rocs.values(), objective)):
        fail(f"train_ad ran {len(step_ms)} steps; AUROCs {rocs}, LightSB objective {objective}")
    path = os.path.join(out, "widget_weights.msgpack")
    sd = load_anomaly_weights(path)
    want = rec["build"][0][1][0].state_dict()
    if set(sd) != set(want) or not all(torch.equal(sd[k], want[k].cpu()) for k in want):
        fail("the weights file does not read back as the trained model")
    step = _p50(step_ms)
    res = dict(wall_s=wall, step_ms=step_ms, step_p50_ms=step, images_per_s=AD_BATCH * 1e3 / step,
               end_to_end_images_per_s=AD_BATCH * AD_STEPS * 1e3 / (sum(step_ms) + sum(batch_ms)),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, batch_ms=batch_ms,
               batch_p50_ms=_p50(batch_ms), eval_s=eval_s, train_features_s=feats_s, fit_s=fit_s,
               fit_objective=objective, auroc=rocs, distinct_test_scores=len(set(scores.tolist())),
               weights_bytes=os.path.getsize(path))
    print(f"  (a) train_ad.main {' '.join(AD_FLAGS)} {' '.join(AD_CUTS)} (cut from --epochs 30 "
          f"--steps_per_epoch 20): {wall:.1f} s; step p50 {step:.2f} ms ({res['images_per_s']:.1f} "
          f"images/s on the device; {res['end_to_end_images_per_s']:.1f} with the loader), "
          f"peak {res['peak_gib']:.2f} GiB; balanced_batches host {res['batch_p50_ms']:.1f} ms "
          f"a batch (p50); eval pass {res['eval_s']:.2f} s, training features "
          f"{res['train_features_s']:.2f} s, LightSB fit {res['fit_s']:.2f} s (final objective "
          f"{res['fit_objective']:.4f}); AUROC deviation {rocs['deviation']:.4f} LightSB "
          f"{rocs['lightsb']:.4f} combined {rocs['combined']:.4f} ({res['distinct_test_scores']} "
          f"distinct test scores of {len(scores)}); no kernel launched; weights "
          f"read back ({res['weights_bytes']} bytes) [{card_line}]", flush=True)
    return res


def _deviation_grads(sd, imgs, labels, device, bn_eval=False, dtype=torch.float32):
    """One deviation step's loss and gradients (``train_ad.train_step``;
    ``bn_eval``: the planted fault, the trunk's BatchNorm in eval mode)."""
    from ir_ads_tpu_torch import train_ad
    from ir_ads_tpu_torch.anomaly import AnomalyScoreNet, deviation_loss

    model = AnomalyScoreNet("resnet18")
    model.load_state_dict(sd)
    model.to(device, dtype)
    x, y = imgs.to(device, dtype), labels.to(device)
    if bn_eval:
        model.train()
        model.features.eval()
        loss = deviation_loss(model(x)[0], (y > 0).float())
        loss.backward()
        loss = loss.detach()
    else:
        loss = train_ad.train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), x, y)
    return float(loss), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def _group_distances(grads, want):
    out = {}
    for g in AD_GROUPS:
        names = [n for n in want if n.startswith(g + ".")]
        d = sum(float(((grads[n] - want[n]) ** 2).sum()) for n in names)
        out[g] = math.sqrt(d / sum(float((want[n] ** 2).sum()) for n in names))
    return out


def phase_anomaly_step(seed, root, card_line):
    """(b) One deviation step on the card against the same step on the host
    CPU: the same weights and batch (the first of ``balanced_batches`` at
    448 x 448, batch 48), f32, TF32 off.  Bars ``AD_STEP_TOL``; a second
    card run reads cuDNN's run-to-run noise; the trunk's BatchNorm in eval
    mode must fail."""
    from ir_ads_tpu_torch.anomaly import AnomalyScoreNet
    from ir_ads_tpu_torch.anomaly.data import ADConfig, MVTecAD, balanced_batches

    ds = MVTecAD(ADConfig(root, "widget", n_anomaly=10, img_size=448), train=True)
    imgs, labels = next(balanced_batches(ds, AD_BATCH, 1, seed=10))
    imgs, labels = torch.from_numpy(imgs), torch.from_numpy(labels)
    sd = AnomalyScoreNet("resnet18", generator=torch.Generator().manual_seed(seed)).state_dict()
    t = time.time()
    loss_cpu, g_cpu = _deviation_grads(sd, imgs, labels, "cpu")
    cpu_s = time.time() - t
    runs = [_deviation_grads(sd, imgs, labels, "cuda") for _ in range(2)]
    loss_f, g_f = _deviation_grads(sd, imgs, labels, "cuda", bn_eval=True)
    _, g_64 = _deviation_grads(sd, imgs, labels, "cpu", dtype=torch.float64)
    res = dict(cpu_s=cpu_s, loss_cpu=loss_cpu, runs=[], tol=AD_STEP_TOL,
               f64=dict(card=_group_distances(runs[0][1], g_64),
                        cpu=_group_distances(g_cpu, g_64)))
    for loss, g in runs:
        res["runs"].append(dict(loss_rel=abs(loss - loss_cpu) / abs(loss_cpu),
                                group_rel=_group_distances(g, g_cpu)))
    res["card_noise"] = _group_distances(runs[1][1], runs[0][1])
    res["fault"] = dict(loss_rel=abs(loss_f - loss_cpu) / abs(loss_cpu),
                        group_rel=_group_distances(g_f, g_cpu))

    def within(r):
        return (r["loss_rel"] <= AD_STEP_TOL["loss"]
                and max(r["group_rel"].values()) <= AD_STEP_TOL["group"])

    worst = max(max(r["group_rel"].values()) for r in res["runs"])
    print(f"  (b) one deviation step, {AD_BATCH} x 448 x 448, f32: card against the host CPU "
          f"({cpu_s:.1f} s there): loss {[r['loss_rel'] for r in res['runs']]}, group gradients "
          f"at most {worst:.3e} (bar {AD_STEP_TOL}; card run to run at most "
          f"{max(res['card_noise'].values()):.3e}; from the f64 step on the host: the card "
          f"{max(res['f64']['card'].values()):.3e}, the host's f32 "
          f"{max(res['f64']['cpu'].values()):.3e}); BatchNorm in eval mode: loss "
          f"{res['fault']['loss_rel']:.3e}, groups at least "
          f"{min(res['fault']['group_rel'].values()):.3e} [{card_line}]", flush=True)
    for r in res["runs"]:
        if not within(r):
            fail(f"the deviation step on the card misses the host CPU's: {r}")
    if within(res["fault"]):
        fail(f"the step with the trunk's BatchNorm in eval mode passes the bar: {res['fault']}")
    return res


def _sb_outputs(params, eps, x, t, noise, drift=None):
    """get_log_C, get_log_potential, get_drift and a ``SB_STEPS``-step
    Euler-Maruyama rollout on ``noise`` (``drift`` in place of
    ``sb.get_drift`` where given: the planted fault)."""
    from ir_ads_tpu_torch.anomaly import sb

    saved = sb.get_drift
    sb.get_drift = drift or saved
    try:
        with torch.no_grad():
            return dict(log_C=sb.get_log_C(params, eps, x),
                        log_potential=sb.get_log_potential(params, eps, x),
                        drift=sb.get_drift(params, eps, x, t),
                        euler_maruyama=sb.sample_euler_maruyama(params, eps, x, noise))
    finally:
        sb.get_drift = saved


def _drift_without_grad(params, eps, x, t):
    return -x / (1 - t[:, None])


def phase_lightsb(seed, card_line):
    """(c) LightSB on the card against the host CPU at dim 512, 10
    potentials, batch 128, epsilon 1 (``fit_lightsb``'s), diagonal and
    rotated: each output to ``SB_CARD_TOL``; the drift without its
    epsilon * gradient term must fail."""
    from ir_ads_tpu_torch.anomaly import LightSBParams

    g = torch.Generator().manual_seed(seed + 13)
    res = {}
    for rotated in (False, True):
        p = LightSBParams(
            log_alpha_raw=torch.randn(SB_N, generator=g) * 0.1,
            r=torch.randn(SB_N, SB_DIM, generator=g),
            S_log_diag=torch.randn(SB_N, SB_DIM, generator=g) * 0.3 - 1.0,
            S_rot_raw=torch.randn(SB_N, SB_DIM, SB_DIM, generator=g) if rotated else None)
        x = torch.randn(SB_BATCH, SB_DIM, generator=g)
        t = torch.rand(SB_BATCH, generator=g) * 0.9
        noise = torch.randn(SB_STEPS, SB_BATCH, SB_DIM, generator=g)
        cpu = _sb_outputs(p, 1.0, x, t, noise)
        exact = _sb_outputs(LightSBParams(*(None if a is None else a.double() for a in p)), 1.0,
                            x.double(), t.double(), noise.double())
        pc = LightSBParams(*(None if a is None else a.cuda() for a in p))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = _sb_outputs(pc, 1.0, x.cuda(), t.cuda(), noise.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fault = _sb_outputs(pc, 1.0, x.cuda(), t.cuda(), noise.cuda(), _drift_without_grad)

        def rel(a, b):
            return float((a.cpu().double() - b.double()).abs().max() / b.abs().max())

        got = {k: rel(card[k], cpu[k]) for k in cpu}
        bad = {k: rel(fault[k], cpu[k]) for k in ("drift", "euler_maruyama")}
        f64 = {k: (rel(card[k], exact[k]), rel(cpu[k], exact[k])) for k in cpu}
        kind = "rotated" if rotated else "diagonal"
        res[kind] = dict(rel=got, fault=bad, f64_card_cpu=f64, card_ms=ms)
        print(f"  (c) LightSB {kind}, dim {SB_DIM}, n {SB_N}, batch {SB_BATCH}: card against the "
              f"host CPU {got} (bar {SB_CARD_TOL}); from the f64 result on the host (card, host "
              f"f32) {f64}; the drift without its gradient term {bad}; the four on the card "
              f"{ms:.1f} ms [{card_line}]", flush=True)
    for kind, r in res.items():
        if max(r["rel"].values()) > SB_CARD_TOL:
            fail(f"LightSB {kind} on the card misses the host CPU's: {r['rel']}")
        if min(r["fault"].values()) <= SB_CARD_TOL:
            fail(f"LightSB {kind}: the drift without its gradient term passes the bar: "
                 f"{r['fault']}")
    return res


def _with_every_size(ann_path):
    """The synthetic COCO set's boxes are 10-40 px, so no GT is large (96^2
    and over) and APl would be NaN: every third box (and its polygon) is
    scaled 6x about its corner, clipped to the image."""
    with open(ann_path) as f:
        coco = json.load(f)
    size = {im["id"]: (im["width"], im["height"]) for im in coco["images"]}
    for i, a in enumerate(coco["annotations"]):
        if i % 3:
            continue
        x, y, w, h = a["bbox"]
        iw, ih = size[a["image_id"]]
        w, h = min(6 * w, iw - x), min(6 * h, ih - y)
        a["bbox"], a["area"] = [x, y, w, h], w * h
        a["segmentation"] = [[x, y, x + w, y, x + w, y + h, x, y + h]]
    with open(ann_path, "w") as f:
        json.dump(coco, f)


def phase_lvis(seed, card_line):
    """(d) ``train_net.main --evaluator lvis`` on phase 12 (c)'s synthetic
    set (8 images 512 x 512, 20 classes) with every size bucket given GT:
    two steps, then the EMA weights' LVIS evaluation; the LVIS keys finite,
    K9's launches as counted."""
    import tempfile

    from ir_ads_tpu_torch import train_net

    tmp = tempfile.mkdtemp(prefix="det_lvis_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ann, images = train_net.make_synthetic_coco(os.path.join(tmp, "coco"),
                                                    n_images=DET_NET_IMAGES, size=512,
                                                    n_classes=DET_CLASSES, seed=seed)
        _with_every_size(ann)
        kernels = _reset_launches()
        t = time.time()
        stats = train_net.main(["--train-json", ann, "--train-root", images, "--val-json", ann,
                                "--val-root", images, *LVIS_NET_FLAGS, "--output",
                                os.path.join(tmp, "out"), "--seed", str(seed)])
        wall = time.time() - t
        launches = {k.name: k.launches for k in kernels}
        got = {k: v for k, v in launches.items() if v}
        want = {"msdeform": 2 * DET_TRAIN_LAUNCHES["msdeform"] + DET_NET_IMAGES * DET_LAUNCHES,
                "msdeform_bwd": 2 * DET_TRAIN_LAUNCHES["msdeform_bwd"]}
        if got != want:
            fail(f"train_net --evaluator lvis launched {got}, expected {want}")
        if not stats or set(stats) != set(LVIS_KEYS) or not all(
                math.isfinite(stats[k]) for k in LVIS_KEYS):
            fail(f"train_net --evaluator lvis gave {stats}")
        print(f"  (d) train_net.main {' '.join(LVIS_NET_FLAGS)} on {DET_NET_IMAGES} synthetic "
              f"images 512x512 (every third box 6x): {wall:.1f} s; launches {got}; "
              + " ".join(f"{k} {stats[k]:.4f}" for k in LVIS_KEYS) + f" [{card_line}]",
              flush=True)
        return launches, dict(wall_s=wall, launches=got, stats=stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_anomaly(seed, card_line):
    """Phase 13: (a) ``train_ad`` end to end, (b) its step against the host
    CPU, (c) LightSB against the host CPU, (d) the LVIS evaluation.  Returns
    (phase 13's launches, record)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="mvtec_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        tree_s = _mvtec_tree(root, seed)
        print(f"  MVTec-AD tree: {AD_TREE} written in {tree_s:.1f} s", flush=True)
        t0 = time.time()
        train = phase_anomaly_train(seed, root, card_line)
        t_a = time.time() - t0
        step = phase_anomaly_step(seed, root, card_line)
        t_b = time.time() - t0 - t_a
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t1 = time.time()
    lightsb = phase_lightsb(seed, card_line)
    t_c = time.time() - t1
    launches, lvis = phase_lvis(seed, card_line)
    print(f"  phase 13: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s, (d) "
          f"{lvis['wall_s']:.1f} s", flush=True)
    return launches, dict(tree_s=tree_s, train_ad=train, step=step, lightsb=lightsb, lvis=lvis,
                          cuts=dict(epochs="30 -> 1", steps_per_epoch="20 -> 8"))


def kernel_table(rows, launches, launches_i8, module_launches, train_launches, det_launches,
                 eval_launches, train_mm_launches, phase9_launches, legacy_launches,
                 legacy_train_launches, det_train_launches, anomaly_launches):
    """One entry per kernel; ``launches`` sums the main paths' runs (the
    serving requests under r5, r4i8, r2, r1, xla, v7_01, v5, map,
    dscf_pallas4, dscf_pallas and dscf_pallas2, r5 on flat frames with the
    XLA patch embedding and with K19, the training steps, the detection
    requests, the three eval modes' images, the training entry point's
    run with its gates and its drop_rate step, phase 9's Swin-L and dual
    paths, phase 10's legacy requests (r5, r4, r4i8) and MSF images, and
    phase 11's legacy training steps and train_mm runs, phase 12's DINO
    training steps and train_net run, and phase 13's (train_ad launches
    none; its LVIS run K9 and K9's backward), each counted from 0; K20
    runs on none of them)."""
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
            launches=(launches[k.name] + launches_i8[k.name] + train_launches[k.name]
                      + det_launches[k.name] + eval_launches.get(k.name, 0)
                      + train_mm_launches[k.name] + phase9_launches.get(k.name, 0)
                      + legacy_launches.get(k.name, 0)
                      + legacy_train_launches.get(k.name, 0)
                      + det_train_launches.get(k.name, 0)
                      + anomaly_launches.get(k.name, 0)
                      + sum(m[k.name] for m in module_launches.values())),
            launches_serve=launches[k.name], launches_serve_r4i8=launches_i8[k.name],
            **{f"launches_serve_{d}": m[k.name] for d, m in module_launches.items()},
            launches_train=train_launches[k.name],
            launches_detect=det_launches[k.name],
            launches_eval=eval_launches.get(k.name, 0),
            launches_train_mm=train_mm_launches[k.name],
            launches_swin_l_dual=phase9_launches.get(k.name, 0),
            launches_legacy=legacy_launches.get(k.name, 0),
            launches_legacy_train=legacy_train_launches.get(k.name, 0),
            launches_det_train=det_train_launches.get(k.name, 0),
            launches_anomaly_lvis=anomaly_launches.get(k.name, 0),
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"],
            cases=[{key: c[key] for key in (
                "case", "max_abs_err", "rel_err", "fault", "fault_rel_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "composition_ms",
                "share", "fault_share", "composition_differ", "not_composition_differ",
                "dq_share", "launch_ms", "rowmax_differ", "scale_differ", "codes_differ",
                "fault_codes_differ", "hc")
                if key in c}
                   for c in cases],
        ))
        widths = sorted({c["hc"] for c in cases if "hc" in c})
        if widths:  # K4's channels a head, each held at a served shape
            out[-1]["head_widths"] = widths
        # the device kernels of a sequence timed by launch (K1, K2, K5, K10, K11,
        # K13, K14)
        names = [ln["kernel"] for c in cases for ln in c.get("launch_ms", ())]
        if names:
            out[-1]["device_kernels"] = sorted(set(names))
    return out


T_START = time.time()


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

    print("phase 3: kernels against their plain versions (main-path shapes)", flush=True)
    rows = phase_kernels(args.seed, 2 * args.batch)
    repair = repair_record(torch.Generator(device="cuda").manual_seed(args.seed + 5),
                           2 * args.batch)
    print("phase 4: serving", flush=True)
    launches, launches_i8, module_launches, serve = phase_serve(
        args.seed, args.requests, args.batch, card_line)
    print("phase 5: training", flush=True)
    train_launches, train = phase_train(args.seed, card_line)
    print("phase 6: detection", flush=True)
    det_launches, detect = phase_detect(args.seed, args.requests, card_line)
    print("phase 7: evaluate", flush=True)
    eval_launches, evaluate = phase_eval(args.seed, card_line)
    print("phase 8: train_mm", flush=True)
    train_mm_launches, train_mm = phase_train_mm(args.seed, card_line)
    print("phase 9: Swin-L and dual_batch", flush=True)
    phase9_launches, swin_l_dual = phase_swin_l_dual(args.seed, args.requests, args.batch,
                                                     card_line)
    print("phase 10: the legacy family (CMNeXt-B2, CMX-B2)", flush=True)
    legacy_launches, legacy = phase_legacy(args.seed, args.requests, args.batch, card_line)
    print("phase 11: the legacy family trained (CMNeXt-B2, CMX-B2)", flush=True)
    legacy_train_launches, legacy_train = phase_legacy_train(args.seed, card_line)
    print("phase 12: DINO-R50 training (K9 under autograd, its backward kernel)", flush=True)
    bwd_rows, det_train_launches, det_train = phase_det_train(args.seed, card_line)
    print("phase 13: the anomaly stack (train_ad, LightSB) and the LVIS evaluator", flush=True)
    anomaly_launches, anomaly = phase_anomaly(args.seed, card_line)

    print(json.dumps({"kernels": kernel_table(rows + bwd_rows, launches, launches_i8,
                                              module_launches, train_launches, det_launches,
                                              eval_launches, train_mm_launches,
                                              phase9_launches, legacy_launches,
                                              legacy_train_launches, det_train_launches,
                                              anomaly_launches),
                      "serve": serve, "train": train, "detect": detect, "evaluate": evaluate,
                      "train_mm": train_mm, "swin_l_dual": swin_l_dual, "legacy": legacy,
                      "legacy_train": legacy_train, "det_train": det_train, "anomaly": anomaly,
                      "repair": repair,
                      "card": card_line, "wall_s": time.time() - T_START}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
