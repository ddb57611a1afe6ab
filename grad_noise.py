#!/usr/bin/env python3
"""How far apart are the gradients of two bf16 training steps that compute
the same function?  One NVIDIA GPU, the full-size CMNeXt Swin-B, batch 4 of
480x640 frames drawn from --seed, every stochastic rate at 0.

    python3 grad_noise.py [--seed 0]

It runs one forward and backward on each of these paths and prints, for
every parameter group (a group's gradients as one vector), the distance
||a - b|| / ||b|| between pairs of them:

  kernel     the kernel path (K1, K3, K4, K6 forward; K7, K8 backward)
  plain      every kernel replaced by its plain PyTorch version
  f32        the plain path with f32 compute (another trainer, same weights)
  only X     the kernel path with the one forward kernel X made plain
  control    the plain path with f32 inside K1's and K4's plain versions:
             the same functions of the same bf16 inputs, fewer roundings
  fault      the plain path with K1's shift-region mask left out, at every
             stage and at stage 3 alone

Columns: each path run twice against itself (what PyTorch's own atomics
do); kernel and plain against f32; kernel, control and the faults against
plain; the single swaps against kernel.  It explains the bars of
``chip_smoke.py`` phase 5 (a), whose helpers it uses: the forward kernels
cannot be held to the plain path by a fixed gradient tolerance, because a
change of rounding alone moves some groups' gradients by their whole size.
The losses are printed first.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = cs.card()
    print(card_line, flush=True)

    batch = cs._train_batches(args.seed, cs.TRAIN_BATCH, 1)[0]
    every = cs.FORWARD + cs.BACKWARD
    fault = lambda *at: functools.partial(  # noqa: E731
        cs._block_forward_plain, no_region_at=at)

    tr, run = cs.gradient_run(args.seed, torch.bfloat16, batch)
    paths = {
        "kernel": run(), "kernel again": run(),
        "plain": run(every), "plain again": run(every),
        "control": run(every, **cs.CONTROL),
        "fault": run(every, swin_block=fault(128, 256, 512, 1024)),
        "fault3": run(every, swin_block=fault(1024)),
    }
    for name in cs.FORWARD:
        paths[f"only {name}"] = run((name,))
    del tr, run
    torch.cuda.empty_cache()
    tr, run = cs.gradient_run(args.seed, torch.float32, batch)
    paths["f32"] = run(every)
    del tr, run

    print("loss: " + ", ".join(f"{k} {v[0]:.6f}" for k, v in paths.items()), flush=True)
    pairs = [("kernel again", "kernel"), ("plain again", "plain"),
             ("kernel", "f32"), ("plain", "f32"),
             ("kernel", "plain"), ("control", "plain"),
             ("fault", "plain"), ("fault3", "plain")]
    pairs += [(f"only {name}", "kernel") for name in cs.FORWARD]
    heads = ["k/k", "p/p", "k/f32", "p/f32", "k/p", "ctl/p", "flt/p", "flt3/p",
             "K1/k", "K3/k", "K4/k", "K6/k"]
    table = {h: cs.group_rel(paths[a][1], paths[b][1]) for h, (a, b) in zip(heads, pairs)}
    groups = list(table["k/p"])
    print(f"{'group':<28}" + "".join(f"{h:>9}" for h in heads))
    for g in groups:
        print(f"{g:<28}" + "".join(f"{table[h][g]:>9.4f}" for h in heads))
    med = lambda r: sorted(r.values())[len(r) // 2]  # noqa: E731
    print(f"{'median':<28}" + "".join(f"{med(table[h]):>9.4f}" for h in heads))
    print(json.dumps({"card": card_line, "loss": {k: v[0] for k, v in paths.items()},
                      "group_rel": table}))


if __name__ == "__main__":
    main()
