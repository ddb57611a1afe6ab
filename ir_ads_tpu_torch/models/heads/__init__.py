"""Decode heads: counterpart of ir_ads_tpu/models/heads/__init__.py.
``HEADS`` names the nine heads; each is built from its levels' channel
counts, ``HEADS[name](in_dims, num_classes=...)``."""

from ir_ads_tpu_torch.models.heads.align_heads import FaPNHead, LawinHead, SFHead
from ir_ads_tpu_torch.models.heads.extra_heads import (
    CondHead, FCNHead, FPNHead, LightHamHead, UPerHead,
)
from ir_ads_tpu_torch.models.heads.segformer import SegFormerHead

HEADS = {
    "SegFormerHead": SegFormerHead,
    "UPerHead": UPerHead,
    "LightHamHead": LightHamHead,
    "FPNHead": FPNHead,
    "FCNHead": FCNHead,
    "CondHead": CondHead,
    "SFHead": SFHead,
    "FaPNHead": FaPNHead,
    "LawinHead": LawinHead,
}

__all__ = [*HEADS, "HEADS"]
