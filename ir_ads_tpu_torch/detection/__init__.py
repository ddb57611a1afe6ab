"""The detection stack: counterpart of ir_ads_tpu/detection/ (the vCLR
deformable-mask DINO, and detectron2's RetinaNet, FCOS and Faster / Mask /
Keypoint R-CNN).

Layout: public functions and modules take and return what the JAX package's
do, feature maps as NHWC (B, H, W, C) and tokens as (B, N, C); a convolution
permutes to NCHW inside (a channels-last view, no copy) and back.
The DINO detector's parameters carry the reference checkpoint's names (the
left-hand names of ir_ads_tpu/utils/torch_import.import_dino_state_dict);
the meta-architectures' carry the flax modules' names.  The compute dtype is
the dense and convolution parameters' dtype (normalisations keep theirs in
f32 and compute as flax does, ``ops.layers``): an f32 tensor that meets a layer (a sine embedding, a
reference point) is cast to it, as a flax layer with ``dtype`` set casts its
input; reference points, proposals and boxes stay f32 throughout.
LayerNorm and GroupNorm use eps 1e-6 (flax's default, which the JAX modules
keep), BatchNorm 1e-5.
"""

from ir_ads_tpu_torch.detection.box_ops import (
    box_cxcywh_to_xyxy,
    box_iou,
    box_xyxy_to_cxcywh,
    generalized_box_iou,
    masks_to_boxes,
)
from ir_ads_tpu_torch.detection.dino import DINODetector, nms_topk
from ir_ads_tpu_torch.detection.ema import ema_init, ema_update
from ir_ads_tpu_torch.detection.matcher import dynamic_k_match, hungarian_match, match_cost
from ir_ads_tpu_torch.detection.meta_arch import (
    FCOS,
    FPN,
    FasterRCNN,
    KeypointRCNN,
    MaskRCNN,
    RetinaNet,
)
from ir_ads_tpu_torch.detection.msdeform_attn import MSDeformAttention
from ir_ads_tpu_torch.detection.transformer import DINOTransformer
from ir_ads_tpu_torch.ops.msdeform import ms_deform_attn

__all__ = [
    "DINODetector", "DINOTransformer", "FCOS", "FPN", "FasterRCNN",
    "KeypointRCNN", "MaskRCNN",
    "MSDeformAttention", "RetinaNet", "box_cxcywh_to_xyxy", "box_iou",
    "box_xyxy_to_cxcywh", "dynamic_k_match", "ema_init", "ema_update",
    "generalized_box_iou", "hungarian_match", "masks_to_boxes",
    "match_cost", "ms_deform_attn", "nms_topk",
]
