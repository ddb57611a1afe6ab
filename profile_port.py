#!/usr/bin/env python3
"""Where one request's time goes on the GPU: the port's predictor under
torch.profiler.

    python3 profile_port.py [--seed 0] [--batch 2] [--dispatch r5]

Builds the full-size predictor (Swin-B CMNeXt, 480x640 RGB-D, flip, bf16,
weights from --seed) under the given kernel dispatch (r5, the default, or
r4), serves one warm-up request, then one profiled request.
Prints the request's wall time, the summed device time of its kernels, the
device idle share (1 - busy / wall; kernels run on one stream, so their sum
is the busy time), and device time by kernel, the port's own kernels marked.
The last line is the same as JSON.  Needs a CUDA device.
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
                "rpe_rows_kernel", "dscf_rows_kernel", "rpe_packed_kernel")  # K3 K4 K6


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dispatch", default="r5", choices=("r5", "r4"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: CUDA is not available")

    from ir_ads_tpu_torch.serve import SemSegPredictor

    pred = SemSegPredictor(device="cuda", seed=args.seed, dispatch=args.dispatch)
    g = torch.Generator().manual_seed(args.seed + 1)
    rgb, dep = (torch.randint(0, 256, (args.batch, 480, 640, 3), generator=g,
                              dtype=torch.uint8) for _ in range(2))
    pred(rgb, dep)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred(rgb, dep)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    rows = []
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    port = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    print(f"{torch.cuda.get_device_name(0)}; {args.dispatch}; request of {args.batch} frames: "
          f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; port kernels {port:.2f} ms "
          f"({port / busy:.3f} of busy)")
    for name, ms, count in rows[:25]:
        mark = "*" if any(k in name for k in PORT_KERNELS) else " "
        print(f" {mark} {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    print(json.dumps({
        "dispatch": args.dispatch, "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "port_kernels_ms": port,
        "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:25]],
    }))


if __name__ == "__main__":
    main()
