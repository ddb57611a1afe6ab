"""PreciseBN: BatchNorm statistics recomputed over N batches.  Counterpart
of ir_ads_tpu/models/projects/precise_bn.py (detectron2 hooks.PreciseBN,
fvcore's update_bn_stats).

Each ``ops.layers.FlaxBatchNorm2d`` of the model gets the uniform average of
the statistics of every batch seen: the batch mean E[x] and flax's biased
variance E[x^2] - E[x]^2, which the module computes in train mode.  Its
momentum is set to 1 for those forwards, so that its running statistics are
the batch's, and restored after.  The reference averages the momentum
updates from the original statistics and inverts the update, which gives
the same average up to f32 rounding.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.ops.layers import FlaxBatchNorm2d


@torch.no_grad()
def recompute_bn_stats(model: nn.Module, batches: Iterable[Tuple], *,
                       num_iters: int = 200) -> nn.Module:
    """Run ``model(*batch)`` in train mode on up to ``num_iters`` batches and
    set every FlaxBatchNorm2d's running mean and variance to the average of
    the batches' statistics; the model's mode and momenta are restored.
    Returns ``model``; without batches or BatchNorms it is unchanged."""
    bns = [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]
    if not bns:
        return model
    saved = [(bn.momentum, bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    sums = [[torch.zeros_like(bn.running_mean, dtype=torch.float32),
             torch.zeros_like(bn.running_var, dtype=torch.float32)] for bn in bns]
    training, seen = model.training, 0
    model.train()
    try:
        for bn in bns:
            bn.momentum = 1.0
        for i, batch in enumerate(batches):
            if i >= num_iters:
                break
            model(*batch)
            for bn, acc in zip(bns, sums):
                acc[0] += bn.running_mean.float()
                acc[1] += bn.running_var.float()
            seen += 1
    finally:
        model.train(training)
        for bn, (m, mean, var) in zip(bns, saved):
            bn.momentum = m
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
    if seen:
        for bn, (mean, var) in zip(bns, sums):
            bn.running_mean.copy_(mean / seen)
            bn.running_var.copy_(var / seen)
    return model
