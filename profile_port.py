#!/usr/bin/env python3
"""Where the time goes on the GPU: one request of the port's predictor, or
one step of its trainer, under torch.profiler.

    python3 profile_port.py [--seed 0] [--batch 2] [--dispatch r5]
    python3 profile_port.py --train [--seed 0] [--batch 4]

Serving: builds the full-size predictor (Swin-B CMNeXt, 480x640 RGB-D, flip,
bf16, weights from --seed) under the given kernel dispatch (r5, the default,
or r4), serves one warm-up request, then one profiled request.
Training (--train): builds the full-size trainer (the ``train`` dispatch, f32
masters, bf16 compute, the shipped adapter-only AdamW recipe), takes two
warm-up steps, then profiles one step in three parts: forward with the loss,
backward, optimizer update.
Prints, for each part, its wall time, the summed device time of its kernels,
the device idle share (1 - busy / wall; kernels run on one stream, so their
sum is the busy time), and device time by kernel, the port's own kernels
marked.  The last line is the same as JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

PORT_KERNELS = ("ln_qkv_kernel", "window_attn_kernel", "proj_add_kernel",  # K1
                "block_tail_kernel",                                         # K2
                "v6_ln_qkv_kernel", "v6_attn_kernel", "proj_tail_kernel",    # K5
                "rpe_rows_kernel", "dscf_rows_kernel", "rpe_packed_kernel",  # K3 K4 K6
                "window_attn_bwd_kernel", "dscf_rows_bwd_kernel")            # K7 K8


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


def profiled(fn):
    """Run ``fn`` under the profiler up to a synchronize; returns its result
    and the part's summary."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for evt in prof.key_averages():
        us = device_us(evt)
        # kernels and copies only: a record_function range mirrored on the
        # device (AdamW's "Optimizer.step") spans its kernels and is no work
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.key):
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    port = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    return out, dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                     port_kernels_ms=port,
                     top=[{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:25]])


def show(what: str, part: dict) -> None:
    print(f"{what}: wall {part['wall_ms']:.2f} ms, device busy "
          f"{part['device_busy_ms']:.2f} ms, idle share {part['idle_share']:.3f}; "
          f"port kernels {part['port_kernels_ms']:.2f} ms "
          f"({part['port_kernels_ms'] / part['device_busy_ms']:.3f} of busy)")
    for row in part["top"]:
        mark = "*" if any(k in row["name"] for k in PORT_KERNELS) else " "
        print(f" {mark} {row['ms']:9.3f} ms  x{row['count']:<5d} {row['name'][:100]}")


def profile_request(args) -> dict:
    from ir_ads_tpu_torch.serve import SemSegPredictor

    pred = SemSegPredictor(device="cuda", seed=args.seed, dispatch=args.dispatch)
    g = torch.Generator().manual_seed(args.seed + 1)
    rgb, dep = (torch.randint(0, 256, (args.batch, 480, 640, 3), generator=g,
                              dtype=torch.uint8) for _ in range(2))
    pred(rgb, dep)
    torch.cuda.synchronize()
    _, part = profiled(lambda: pred(rgb, dep))
    show(f"{torch.cuda.get_device_name(0)}; {args.dispatch}; request of "
         f"{args.batch} frames", part)
    return dict(part, dispatch=args.dispatch)


def profile_step(args) -> dict:
    from ir_ads_tpu_torch.train import SemSegTrainer
    from ir_ads_tpu_torch.training.optim import set_lr
    from ir_ads_tpu_torch.training.train_state import compute_loss

    tr = SemSegTrainer(device="cuda", seed=args.seed)
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
        tr.model, batch, tr.loss_fn, tr.generator, tr.ignore_label))
    _, bwd = profiled(loss.backward)
    set_lr(tr.optimizer, tr.schedule(tr.steps))
    _, upd = profiled(tr.optimizer.step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = f"{torch.cuda.get_device_name(0)}; train; step of {args.batch} frames"
    for what, part in (("forward + loss", fwd), ("backward", bwd), ("optimizer", upd)):
        show(f"{card}; {what}", part)
    busy = sum(p["device_busy_ms"] for p in (fwd, bwd, upd))
    wall = sum(p["wall_ms"] for p in (fwd, bwd, upd))
    print(f"{card}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}, peak memory {peak:.2f} GiB")
    return dict(dispatch="train", batch=args.batch, wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall, peak_memory_gib=peak, forward=fwd,
                backward=bwd, optimizer=upd)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per request (default 2) or per step (default 4)")
    ap.add_argument("--dispatch", default="r5", choices=("r5", "r4"))
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of one request")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: CUDA is not available")
    if args.batch is None:
        args.batch = 4 if args.train else 2
    print(json.dumps(profile_step(args) if args.train else profile_request(args)))


if __name__ == "__main__":
    main()
