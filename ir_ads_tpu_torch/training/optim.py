"""Optimizers and LR schedules.  Counterpart of ir_ads_tpu/training/optim.py.

``TRAIN_TYPE: Adapter`` trains only the parameters whose name contains
adapter / extra_patch_embed / head / mpg (case-insensitive; ``mpg`` matches
``MPGBlocks`` and ``DeformMPGBlocks``).  Where the JAX package masks the
optimizer and tells its backward kernel through a process-global variable,
``freeze_`` sets ``requires_grad`` on the parameters themselves: autograd
then computes no gradient for a frozen parameter, and the window-attention
backward reads ``needs_input_grad`` to skip what only those gradients need.

A schedule is a function of the step, counted from 0: the first update uses
``schedule(0)``.

``grad_clip_norm`` clips as optax's ``clip_by_global_norm`` does inside the
JAX package's mask: the global norm is taken over the optimizer's
(trainable) parameters only, and where it reaches the bound each gradient
becomes ``(g / norm) * max_norm``, in that order and with no epsilon
(``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``,
another function).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

ADAPTER_PATTERNS = ("adapter", "extra_patch_embed", "head", "mpg")

Schedule = Callable[[int], float]


def adapter_mask(names: Iterable[str]) -> Dict[str, bool]:
    """name -> True where the parameter trains under adapter-only finetuning."""
    return {n: any(pat in n.lower() for pat in ADAPTER_PATTERNS) for n in names}


def freeze_(model: nn.Module, train_type: str = "all") -> None:
    """Set ``requires_grad`` for ``train_type``: everything for ``"all"``, the
    ``adapter_mask`` set for a type that contains ``"Adapter"``."""
    names = [n for n, _ in model.named_parameters()]
    mask = adapter_mask(names) if "Adapter" in train_type else dict.fromkeys(names, True)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])


def warmup_poly_schedule(
    base_lr: float,
    max_iter: int,
    power: float = 0.9,
    warmup_iter: int = 0,
    warmup_ratio: float = 0.1,
) -> Schedule:
    """WarmupPolyLR with linear warmup."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_iter:
            ratio = warmup_ratio + (1.0 - warmup_ratio) * step / max(warmup_iter, 1)
        else:
            real = (step - warmup_iter) / max(max_iter - warmup_iter, 1)
            ratio = max(1.0 - real, 0.0) ** power
        return base_lr * max(ratio, 0.0)

    return schedule


def warmup_cosine_schedule(
    base_lr: float,
    max_iter: int,
    eta_ratio: float = 0.0,
    warmup_iter: int = 0,
    warmup_ratio: float = 0.1,
) -> Schedule:
    """Cosine decay with exponential warmup."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_iter:
            ratio = warmup_ratio ** (1.0 - step / max(warmup_iter, 1))
        else:
            real_max = max(max_iter - warmup_iter, 1)
            ratio = eta_ratio + (1 - eta_ratio) * (1 + math.cos(math.pi * step / real_max)) / 2
        return base_lr * ratio

    return schedule


SCHEDULES = {
    "warmuppolylr": warmup_poly_schedule,
    "warmupcosinelr": warmup_cosine_schedule,
}


def get_schedule(name: str, **kw) -> Schedule:
    if name not in SCHEDULES:
        raise ValueError(f"Unknown schedule {name!r}")
    return SCHEDULES[name](**kw)


def _groups(model: nn.Module, weight_decay: float) -> Tuple[dict, dict]:
    """Trainable parameters: matrices and filters decay, the rest (norms,
    biases, per-channel weights: ndim <= 1) do not."""
    params = [p for p in model.parameters() if p.requires_grad]
    return (dict(params=[p for p in params if p.ndim > 1], weight_decay=weight_decay),
            dict(params=[p for p in params if p.ndim <= 1], weight_decay=0.0))


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place and without a host read: ``g`` where the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    below = norm < max_norm
    for g in grads:
        g.copy_(torch.where(below, g, (g / norm.to(g.dtype)) * max_norm))


def get_optimizer(
    name: str,
    model: nn.Module,
    schedule: Schedule,
    weight_decay: float = 0.01,
    train_type: str = "all",
    grad_clip_norm: Optional[float] = None,
) -> torch.optim.Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on ndim > 1) or SGD
    (momentum 0.9, decay added to every gradient) over the parameters that
    ``train_type`` leaves trainable; ``freeze_`` is applied first.  The
    learning rate is ``schedule(0)`` until ``set_lr`` moves it.  With
    ``grad_clip_norm`` every ``step`` first clips the gradients of those
    parameters (``clip_by_global_norm_``)."""
    freeze_(model, train_type)
    lr = schedule(0)
    if name == "adamw":
        opt = torch.optim.AdamW(_groups(model, weight_decay), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)
    elif name == "sgd":
        params = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    if grad_clip_norm is not None:
        def clip(optimizer, args, kwargs):
            clip_by_global_norm_([p for g in optimizer.param_groups for p in g["params"]],
                                 grad_clip_norm)

        opt.register_step_pre_hook(clip)
    return opt


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
