"""detectron2 ``projects/`` trunks: counterpart of the part of
ir_ads_tpu/models/projects/ that the alternative backbones build on
(ViTDet with SimpleFeaturePyramid, MViTv2)."""

from ir_ads_tpu_torch.models.projects.mvit import MViT
from ir_ads_tpu_torch.models.projects.vitdet import SimpleFeaturePyramid, ViTDet

__all__ = ["MViT", "SimpleFeaturePyramid", "ViTDet"]
