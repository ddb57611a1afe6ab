"""detectron2 ``projects/``: counterpart of ir_ads_tpu/models/projects/
(DeepLab, Panoptic-DeepLab, ViTDet, MViTv2, TridentNet, TensorMask,
PointSup, PointRend, DensePose, PreciseBN), NHWC, the flax modules' names."""

from ir_ads_tpu_torch.models.projects.deeplab import (
    ASPP,
    DeepLabV3Head,
    DeepLabV3PlusHead,
    deeplab_ce_loss,
)
from ir_ads_tpu_torch.models.projects.densepose import DensePoseChartHead, densepose_losses
from ir_ads_tpu_torch.models.projects.mvit import MViT
from ir_ads_tpu_torch.models.projects.panoptic_deeplab import (
    PanopticDeepLabInsEmbedHead,
    PanopticDeepLabSemSegHead,
    get_panoptic_segmentation,
    panoptic_deeplab_losses,
)
from ir_ads_tpu_torch.models.projects.pointsup import (
    get_point_coords_wrt_box,
    point_sup_mask_loss,
)
from ir_ads_tpu_torch.models.projects.precise_bn import recompute_bn_stats
from ir_ads_tpu_torch.models.projects.tensormask import SwapAlign2Nat, swap_align2nat
from ir_ads_tpu_torch.models.projects.tridentnet import TridentBottleneck, TridentConv
from ir_ads_tpu_torch.models.projects.vitdet import SimpleFeaturePyramid, ViTDet

__all__ = [
    "ASPP",
    "DeepLabV3Head",
    "DeepLabV3PlusHead",
    "deeplab_ce_loss",
    "DensePoseChartHead",
    "densepose_losses",
    "MViT",
    "PanopticDeepLabInsEmbedHead",
    "PanopticDeepLabSemSegHead",
    "get_panoptic_segmentation",
    "panoptic_deeplab_losses",
    "get_point_coords_wrt_box",
    "point_sup_mask_loss",
    "recompute_bn_stats",
    "SwapAlign2Nat",
    "swap_align2nat",
    "TridentBottleneck",
    "TridentConv",
    "SimpleFeaturePyramid",
    "ViTDet",
]
