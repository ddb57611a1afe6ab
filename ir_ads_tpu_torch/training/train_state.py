"""The IR-ADS training step.  Counterpart of
ir_ads_tpu/training/train_state.py:

  * three-head loss: CE(fused) + 0.01 * CE(rgb, masked) + 0.01 * CE(dte,
    masked), where the masked labels set the pixels that the fused head
    already predicts correctly to ignore (MMST self-training on the fused
    model's errors);
  * BatchNorm running statistics are updated in place by the forward;
  * the optimizer step uses ``schedule(step)``, the step counted from 0.

``TrainState`` holds what a run carries from step to step: the model (its
f32 master parameters and its ``FlaxBatchNorm2d`` statistics), the
optimizer, the step and the recipe the optimizer was built from (which
``utils.checkpoint`` needs to write optax's state tree).  Its randomness is
keyed by the step, as the JAX step folds ``state.step`` into a fixed key:
each step's dropout, drop-path and modality mask draw from a generator
seeded from ``(seed, step)``, so a run resumed at step n draws what an
uninterrupted one draws there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
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


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: one 64-bit word of numpy's
    ``SeedSequence([seed, step])``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


@dataclass
class TrainState:
    """A training run's state; ``train_step(batch)`` makes one update."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    loss_fn: Callable
    optimizer_name: str = "adamw"
    train_type: str = "all"
    grad_clip_norm: Optional[float] = None
    seed: int = 3407
    step: int = 0
    ignore_label: int = 255
    dtype: torch.dtype = torch.float32  # the compute dtype; parameters stay f32

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def generator(self, step: Optional[int] = None) -> torch.Generator:
        """A generator on the model's device seeded for ``step`` (default:
        the step about to be taken)."""
        step = self.step if step is None else step
        return torch.Generator(device=self.device).manual_seed(step_seed(self.seed, step))

    def batch(self, rgb, dte, label) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Frames in the compute dtype and labels as int64, on the model's
        device."""
        device = self.device
        rgb = torch.as_tensor(rgb, device=device).to(self.dtype)
        dte = torch.as_tensor(dte, device=device).to(self.dtype)
        return rgb, dte, torch.as_tensor(label, device=device).long()

    def train_step(self, batch: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One update on a ``batch()``; returns the metrics as tensors."""
        metrics = train_step(self.model, self.optimizer, self.schedule, self.step, batch,
                             self.loss_fn, self.generator(), self.ignore_label)
        self.step += 1
        return metrics
