"""The IR-ADS training step.  Counterpart of
ir_ads_tpu/training/train_state.py:

  * three-head loss: CE(fused) + 0.01 * CE(rgb, masked) + 0.01 * CE(dte,
    masked), where the masked labels set the pixels that the fused head
    already predicts correctly to ignore (MMST self-training on the fused
    model's errors);
  * BatchNorm running statistics are updated in place by the forward;
  * the optimizer step uses ``schedule(step)``, the step counted from 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.training.optim import Schedule, set_lr


def compute_loss(
    model: nn.Module,
    batch: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # rgb, dte, label
    loss_fn: Callable,
    generator: Optional[torch.Generator] = None,
    ignore_label: int = 255,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in the model's current mode; returns (loss, loss_main)."""
    rgb, dte, label = batch
    y, y_rgb, y_dte = model(rgb, dte, generator)
    pred = y.argmax(dim=-1)
    # pixels the fused head got right are ignored in the aux losses
    mask_lbl = torch.where(pred == label, torch.full_like(label, ignore_label), label)
    loss_main = loss_fn(y, label, ignore_label)
    loss_rgb = loss_fn(y_rgb, mask_lbl, ignore_label)
    loss_dte = loss_fn(y_dte, mask_lbl, ignore_label)
    return loss_main + aux_weight * (loss_rgb + loss_dte), loss_main


def train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Schedule,
    step: int,
    batch: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    loss_fn: Callable,
    generator: Optional[torch.Generator] = None,
    ignore_label: int = 255,
    aux_weight: float = 0.01,
) -> Dict[str, torch.Tensor]:
    """One update of the model's trainable parameters.  Returns the metrics
    as tensors on the model's device (no host read-back here)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, loss_main = compute_loss(model, batch, loss_fn, generator, ignore_label,
                                   aux_weight)
    loss.backward()
    set_lr(optimizer, schedule(step))
    optimizer.step()
    return {"loss": loss.detach(), "loss_main": loss_main.detach()}
