"""Model registry: ``build_model`` (counterpart of
ir_ads_tpu/models/__init__.py's) builds the dual-stream Swin CMNeXt, or a
legacy model (``CMNeXtLegacy``: CMNeXt-B0..B5 on the MiT dual stream, or
CMX-B0..B5), under a kernel ``dispatch``, with its weights: a state_dict
(``utils.jax_params.from_flax`` of a JAX checkpoint) or, without one, drawn
from ``seed``.  The int8 sites of an int8 dispatch are quantized from the
f32 weights, then the model is cast to ``dtype`` (None keeps f32) as flax
computes (``serve.cast_model_``).

The legacy models take ``LEGACY_DISPATCH``: ``"r5"`` (the MiT DSCF's
einsum bias by K6 on planes of at most ``RPE3_PLANE_MAX`` pixels, as the
JAX package computes under ``IR_ADS_DSCF_ATTN=...,xla`` with
``IR_ADS_DSCF_RPE3=pallas``) or ``"xla"`` (the XLA-form bias everywhere).
The other dispatches, the ``train`` dispatch among them, and the Swin
options (``backbone_kwargs``, ``patch_embed``, ``head_dims``, ``use_remat``)
raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.cmx import CMX
from ir_ads_tpu_torch.models.backbones.mit import MiTDualStream
from ir_ads_tpu_torch.models.cmnext import BACKBONES, CMNeXt
from ir_ads_tpu_torch.models.heads.segformer import SegFormerHead
from ir_ads_tpu_torch.ops.int8 import quantize_int8_
from ir_ads_tpu_torch.ops.layers import resize_bilinear

LEGACY = ("CMNeXt", "CMX")
# dispatch -> the MiT DSCF's rpe3 (models/backbones/swin.py DSCF_RPE3)
LEGACY_DISPATCH = {"r5": "pallas", "xla": "xla"}


def is_legacy(backbone: str) -> bool:
    return backbone.split("-")[0] in LEGACY


def refuse_legacy_training(backbone: str) -> None:
    """Raise for a legacy backbone: the trainers take the Swin CMNeXt only."""
    if is_legacy(backbone):
        raise NotImplementedError(
            f"backbone {backbone!r}: the legacy models are ported for eval only; their "
            "training (BatchNorm statistics, drop-path) is ROADMAP Queue 1 item 4")


class CMNeXtLegacy(nn.Module):
    """Single-head legacy model: the MiT dual stream (``"CMNeXt-Bx"``) or CMX
    (``"CMX-Bx"``), decoded by one SegFormer head of embed 256.  ``forward``
    returns the fused logits three times, as the JAX model does, so that the
    Swin CMNeXt's entry points take it; ``forward_fused`` returns them once.
    ``upsample_logits``: the logits at the input's size (bilinear,
    align_corners=False), else at the head's H/4.  Eval only: train mode
    raises."""

    def __init__(self, backbone: str = "CMNeXt-B2", num_classes: int = 25,
                 dispatch: str = "r5", upsample_logits: bool = True):
        super().__init__()
        family, _, variant = backbone.partition("-")
        if family not in LEGACY:
            raise ValueError(f"unknown legacy backbone {backbone!r}")
        if dispatch not in LEGACY_DISPATCH:
            raise NotImplementedError(
                f"dispatch {dispatch!r}: the legacy models take {list(LEGACY_DISPATCH)}; "
                "the MiT DSCF under r4, r4i8, r2, v5 and map (K3 + K4 at 10 channels a "
                "head) is ROADMAP Queue 1 item 4")
        self.name, self.dispatch = backbone, dispatch
        if family == "CMNeXt":
            self.backbone = MiTDualStream(variant, rpe3=LEGACY_DISPATCH[dispatch])
        else:
            self.backbone = CMX(variant)
        self.decode_head = SegFormerHead(self.backbone.num_features, 256, num_classes)
        self.upsample_logits = upsample_logits

    def train(self, mode: bool = True) -> "CMNeXtLegacy":
        if mode:
            refuse_legacy_training(self.name)
        return super().train(False)

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor):
        y = self.forward_fused(x_rgb, x_dte)
        return y, y, y

    def forward_fused(self, x_rgb: torch.Tensor, x_dte: torch.Tensor) -> torch.Tensor:
        y = self.decode_head(self.backbone(x_rgb, x_dte))
        return resize_bilinear(y, x_rgb.shape[1:3]) if self.upsample_logits else y


def _legacy(backbone: str, num_classes: int, backbone_kwargs: Optional[dict],
            dispatch: str, upsample_logits: bool = True, **kw) -> CMNeXtLegacy:
    """The legacy model, refusing the Swin CMNeXt's options by name."""
    if dispatch == "train":
        refuse_legacy_training(backbone)
    for key, value in {**(backbone_kwargs or {}), **kw}.items():
        if key == "patch_embed" and value == "xla":
            continue  # the entry points' default; the MiT embeds are convolutions
        raise ValueError(f"{key}={value!r}: the legacy model {backbone!r} has no such "
                         "option (its backbone takes no kwargs, its patch embeddings are "
                         "convolutions and its head is one SegFormer head of embed 256)")
    return CMNeXtLegacy(backbone, num_classes, dispatch, upsample_logits)


def build_model(name: str, backbone: str, num_classes: int,
                dtype: Optional[torch.dtype] = None,
                backbone_kwargs: Optional[dict] = None, dispatch: str = "r5",
                state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                **kw) -> nn.Module:
    """``kw`` goes to ``CMNeXt`` (``head_dims``, ``upsample_logits``,
    ``patch_embed``, ...); a legacy model takes ``upsample_logits`` only.
    Returns the model on the CPU, in eval mode."""
    from ir_ads_tpu_torch.serve import cast_model_, init_random_  # serve imports this module

    if is_legacy(backbone):
        model = _legacy(backbone, num_classes, backbone_kwargs, dispatch, **kw)
    elif name != "CMNeXt" or backbone not in BACKBONES:
        raise ValueError(f"unknown model {name!r} / backbone {backbone!r}: the port has "
                         f"CMNeXt with {list(BACKBONES)} and the legacy CMNeXt-B0..B5 and "
                         "CMX-B0..B5")
    else:
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


MODELS = {"CMNeXt": CMNeXt, "CMNeXtLegacy": CMNeXtLegacy}

__all__ = ["CMNeXt", "CMNeXtLegacy", "MODELS", "build_model"]
