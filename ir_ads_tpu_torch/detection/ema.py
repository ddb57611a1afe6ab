"""EMA teacher state: counterpart of ir_ads_tpu/detection/ema.py.  The
teacher is a second set of parameters run through the same module
(``torch.func.functional_call``), not a module flag."""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def ema_init(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, decay: float = 0.999) -> Params:
    """e * decay + p * (1 - decay), leaf by leaf, in the EMA's dtype."""
    return {k: e * decay + params[k].to(e.dtype) * (1.0 - decay)
            for k, e in ema_params.items()}
