"""Model registry: ``build_model`` (counterpart of
ir_ads_tpu/models/__init__.py's) builds the dual-stream Swin CMNeXt under a
kernel ``dispatch``, with its weights: a state_dict (``utils.jax_params.
from_flax`` of a JAX checkpoint) or, without one, drawn from ``seed``.  The
int8 sites of an int8 dispatch are quantized from the f32 weights, then the
model is cast to ``dtype`` (None keeps f32) as flax computes
(``serve.cast_model_``).  The legacy MiT and CMX backbones are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ir_ads_tpu_torch.models.cmnext import BACKBONES, CMNeXt
from ir_ads_tpu_torch.ops.int8 import quantize_int8_

LEGACY = ("CMNeXt", "CMX")


def build_model(name: str, backbone: str, num_classes: int,
                dtype: Optional[torch.dtype] = None,
                backbone_kwargs: Optional[dict] = None, dispatch: str = "r5",
                state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                **kw) -> CMNeXt:
    """``kw`` goes to ``CMNeXt`` (``head_dims``, ``upsample_logits``,
    ``patch_embed``, ...).  Returns the model on the CPU, in eval mode."""
    from ir_ads_tpu_torch.serve import cast_model_, init_random_  # serve imports this module

    if backbone.split("-")[0] in LEGACY:
        raise NotImplementedError(
            f"backbone {backbone!r}: the MiT and CMX legacy models are not ported yet "
            "(ROADMAP Queue 1 item 4)")
    if name != "CMNeXt" or backbone not in BACKBONES:
        raise ValueError(f"unknown model {name!r} / backbone {backbone!r}: the port has "
                         f"CMNeXt with {list(BACKBONES)}")
    model = CMNeXt(backbone=backbone, num_classes=num_classes,
                   backbone_kwargs=backbone_kwargs, dispatch=dispatch, **kw)
    if state_dict is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(state_dict)
    quantize_int8_(model, dtype)
    if dtype is not None:
        cast_model_(model, dtype)
    return model.eval()


MODELS = {"CMNeXt": CMNeXt}

__all__ = ["CMNeXt", "MODELS", "build_model"]
