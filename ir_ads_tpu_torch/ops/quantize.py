"""EMA vector quantizer: counterpart of ir_ads_tpu/ops/quantize.py (the
reference's utils/quantize.py, which it ships unused).

The codebook and its EMA accumulators are an explicit ``VQState``;
``vq_update`` returns the codes, the quantized input and the new state.
Dead codes (EMA count below a threshold) jump to input vectors whose
indices the caller draws (``vq_draws`` from a ``torch.Generator``), so that
the reference's draws can be given.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class VQState(NamedTuple):
    codebook: torch.Tensor  # (K, D)
    ema_count: torch.Tensor  # (K,)
    ema_sum: torch.Tensor  # (K, D)


def vq_init(generator: torch.Generator, num_codes: int, dim: int) -> VQState:
    cb = torch.randn((num_codes, dim), generator=generator, device=generator.device) * 0.1
    return VQState(cb, torch.zeros(num_codes, device=cb.device), cb.clone())


def vq_lookup(state: VQState, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (codes (...,), quantized (..., D)), the gradient
    straight through to x."""
    flat = x.reshape(-1, x.shape[-1])
    d = ((flat ** 2).sum(-1, keepdim=True) - 2 * flat @ state.codebook.T
         + (state.codebook ** 2).sum(-1)[None])
    codes = d.argmin(-1)
    quant = state.codebook[codes].reshape(x.shape)
    return codes.reshape(x.shape[:-1]), x + (quant - x).detach()


def vq_draws(generator: torch.Generator, num_codes: int, n: int) -> torch.Tensor:
    """For each code the index of the input vector it takes if it is dead:
    (K,) uniform in [0, n)."""
    return torch.randint(0, n, (num_codes,), generator=generator, device=generator.device)


def vq_update(state: VQState, x: torch.Tensor, rand_idx: torch.Tensor, decay: float = 0.99,
              eps: float = 1e-5, dead_threshold: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor, VQState]:
    """One training step: lookup, EMA codebook update, dead codes moved to
    ``flat[rand_idx]`` (``vq_draws``).  Returns (codes, quantized, state)."""
    k = state.codebook.shape[0]
    flat = x.reshape(-1, x.shape[-1])
    codes, quant = vq_lookup(state, x)
    onehot = F.one_hot(codes.reshape(-1), k).to(flat.dtype)
    ema_count = state.ema_count * decay + onehot.sum(0) * (1 - decay)
    ema_sum = state.ema_sum * decay + (onehot.T @ flat) * (1 - decay)
    n = ema_count.sum()
    stable = (ema_count + eps) / (n + k * eps) * n
    codebook = ema_sum / stable[:, None]

    dead = ema_count < dead_threshold * (1 - decay)
    picked = flat[rand_idx.long()]
    codebook = torch.where(dead[:, None], picked, codebook)
    ema_sum = torch.where(dead[:, None], picked, ema_sum)
    ema_count = torch.where(dead, torch.ones_like(ema_count), ema_count)
    return codes, quant, VQState(codebook, ema_count, ema_sum)
