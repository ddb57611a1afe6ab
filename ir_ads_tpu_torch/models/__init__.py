"""Model registry: ``build_model`` (counterpart of
ir_ads_tpu/models/__init__.py's) builds the dual-stream Swin CMNeXt, or a
legacy model (``CMNeXtLegacy``: CMNeXt-B0..B5 on the MiT dual stream, or
CMX-B0..B5), under a kernel ``dispatch``, with its weights: a state_dict
(``utils.jax_params.from_flax`` of a JAX checkpoint) or, without one, drawn
from ``seed``.  The int8 sites of an int8 dispatch are quantized from the
f32 weights, then the model is cast to ``dtype`` (None keeps f32) as flax
computes (``serve.cast_model_``).

A legacy model reads from the dispatch what the JAX environment it stands
for gives such a model (``legacy_dispatch``): its MiT DSCF (every stage at
level 3) takes the dispatch's level-3 attention with its ``rpe3``, and its
int8 sites are those of ``IR_ADS_INT8=1``, the DSCF projections and the
head's composed projection (the MiT's own linears stay float).  So r4,
r4i8, r2, v5 and map run K3 + K4 at every stage, dscf_pallas K17 at every
stage (the bias in the XLA form) and dscf_pallas2 K18 + K17, at the MiT's
8, 8, 10, 8 channels a head (4, 4, 5, 4 on CMNeXt-B0); r1 is xla, v7_01
and dscf_pallas4 are r5, and ``train`` is the einsum DSCF (K6 under
autograd at stages 2-3) with drop-path, the adapters' and the head's
dropout and train-mode BatchNorms.  The Swin options (``backbone_kwargs``,
``patch_embed``, ``head_dims``, ``use_remat``) raise by name.  There is no
MMST modality mask (the JAX ``build_model`` drops ``mmst_mask``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ir_ads_tpu_torch.models.backbones.cmx import CMX
from ir_ads_tpu_torch.models.backbones.mit import MiTDualStream
from ir_ads_tpu_torch.models.backbones.swin import DISPATCH
from ir_ads_tpu_torch.models.cmnext import BACKBONES, CMNeXt
from ir_ads_tpu_torch.models.heads.segformer import SegFormerHead
from ir_ads_tpu_torch.ops.int8 import quantize_int8_
from ir_ads_tpu_torch.ops.layers import resize_bilinear

LEGACY = ("CMNeXt", "CMX")
HEAD_DROP = 0.1  # the JAX SegFormerHead's dropout before the classifier


def is_legacy(backbone: str) -> bool:
    return backbone.split("-")[0] in LEGACY


def legacy_dispatch(dispatch: str) -> Tuple[str, bool, str]:
    """(the MiT DSCF's attention, int8, rpe3) of a legacy model under
    ``dispatch``: the dispatch's level-3 DSCF entry, int8 flag and einsum
    bias."""
    if dispatch not in DISPATCH:
        raise NotImplementedError(f"dispatch {dispatch!r}: the port has {list(DISPATCH)}")
    _, dscf_attn, _, int8, rpe3 = DISPATCH[dispatch]
    return dscf_attn[3], int8, rpe3


class CMNeXtLegacy(nn.Module):
    """Single-head legacy model: the MiT dual stream (``"CMNeXt-Bx"``) or CMX
    (``"CMX-Bx"``), decoded by one SegFormer head of embed 256.  ``forward``
    returns the fused logits three times, as the JAX model does, so that the
    Swin CMNeXt's entry points take it (the loss then takes them three
    times, and their gradients add as JAX's do); ``forward_fused`` returns
    them once.  ``upsample_logits``: the logits at the input's size
    (bilinear, align_corners=False), else at the head's H/4.  Train mode is
    the ``train`` dispatch's: there drop-path (the JAX backbones' rate
    0.1), the adapters' dropout (0.1, CMNeXt only) and the head's
    (``head_drop``) draw from ``forward``'s ``generator``."""

    def __init__(self, backbone: str = "CMNeXt-B2", num_classes: int = 25,
                 dispatch: str = "r5", upsample_logits: bool = True,
                 head_drop: float = HEAD_DROP):
        super().__init__()
        family, _, variant = backbone.partition("-")
        if family not in LEGACY:
            raise ValueError(f"unknown legacy backbone {backbone!r}")
        dscf_attn, int8, rpe3 = legacy_dispatch(dispatch)
        self.name, self.dispatch = backbone, dispatch
        if family == "CMNeXt":
            self.backbone = MiTDualStream(variant, dscf_attn, int8, rpe3)
        else:
            self.backbone = CMX(variant)
        self.decode_head = SegFormerHead(self.backbone.num_features, 256, num_classes, int8)
        self.upsample_logits = upsample_logits
        self.head_drop = float(head_drop)

    def train(self, mode: bool = True) -> "CMNeXtLegacy":
        if mode and self.dispatch != "train":
            raise NotImplementedError(
                f"{self.name} under dispatch {self.dispatch!r} is an eval model: build it "
                "with dispatch='train' to train it")
        return super().train(mode)

    def forward(self, x_rgb: torch.Tensor, x_dte: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        feats = self.backbone(x_rgb, x_dte, generator)
        drop = self.head_drop if self.training else 0.0
        y = self._upsample(self.decode_head(feats, drop, generator), x_rgb)
        return y, y, y

    def forward_fused(self, x_rgb: torch.Tensor, x_dte: torch.Tensor) -> torch.Tensor:
        return self._upsample(self.decode_head(self.backbone(x_rgb, x_dte)), x_rgb)

    def _upsample(self, y: torch.Tensor, x_rgb: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(y, x_rgb.shape[1:3]) if self.upsample_logits else y


def refuse_swin_options(backbone: str, backbone_kwargs: Optional[dict], **kw) -> None:
    """Raise by name on an option of the Swin CMNeXt given to a legacy model."""
    for key, value in {**(backbone_kwargs or {}), **kw}.items():
        if key == "patch_embed" and value == "xla":
            continue  # the entry points' default; the MiT embeds are convolutions
        raise ValueError(f"{key}={value!r}: the legacy model {backbone!r} has no such "
                         "option (its backbone takes no kwargs, its patch embeddings are "
                         "convolutions and its head is one SegFormer head of embed 256)")


def _legacy(backbone: str, num_classes: int, backbone_kwargs: Optional[dict],
            dispatch: str, upsample_logits: bool = True, **kw) -> CMNeXtLegacy:
    refuse_swin_options(backbone, backbone_kwargs, **kw)
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
