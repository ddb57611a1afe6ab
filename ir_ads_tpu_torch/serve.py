"""The port's serving entry points: ``SemSegPredictor`` (batched RGB-D
semantic segmentation) and ``DetPredictor`` (open-set detection).

``SemSegPredictor``:

Counterpart of ``infer_mm.SemSeg`` (input normalisation) together with the
bench predictor (sliding window, tile = image, overlap 1/3, horizontal-flip
ensemble, fused-head logits at H/4 upsampled once).  Runs on the GPU unless
the caller passes ``device="cpu"``, under the ``r5`` kernel dispatch unless
the caller passes another of models/backbones/swin.py's ``DISPATCH``: ``"r4"``,
``"r4i8"`` (w8a8, its weights quantized from the f32 ones before the cast to
the compute dtype), the module-path sets ``"r2"``, ``"r1"`` and ``"xla"``, the
block variants ``"v7_01"``, ``"v5"`` and ``"map"``, or the DSCF variants
``"dscf_pallas4"``, ``"dscf_pallas"`` and ``"dscf_pallas2"``.  With
``flat_input=True`` the normalised frames enter the model as flat (B, H, W*3)
rows, the bench's host-side reshape (``IR_ADS_FLAT_INPUT=1``), and
``patch_embed`` chooses the patch embedding's flat path: ``"xla"`` (the
default, NHWC's output bit for bit), ``"xla2"`` or ``"pallas"`` (K19, flat
input only).

``DetPredictor``: counterpart of ``train_net.evaluate_detector``'s ``_infer``
around the vCLR deformable-mask DINO detector (``configs/detection/
dino_r50.py``): forward, sigmoid class scores, mask-scored ranking, top-k and
class-agnostic NMS.  Runs on the GPU, with the deformable-attention kernel,
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.data.augmentations import IMAGENET_MEAN, IMAGENET_STD
from ir_ads_tpu_torch.detection.dino import DINODetector, nms_topk
from ir_ads_tpu_torch.evaluation.semseg_eval import make_forward_fn, make_sliding_window_fn
from ir_ads_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
from ir_ads_tpu_torch.ops.int8 import PREFIX

# tensors read in f32 whatever the compute dtype: the rel-pos bias tables the
# TPU kernels take in f32, and the detector's pixel statistics
F32_PARAMS = ("relative_position_bias_table", "rpe_table")
F32_BUFFERS = ("pixel_mean", "pixel_std")
# flax normalises in f32 with f32 scale, bias and statistics (``_normalize``)
NORMS = (torch.nn.LayerNorm, torch.nn.BatchNorm2d, torch.nn.GroupNorm, FrozenBatchNorm2d)


def init_random_(model: torch.nn.Module, seed: int) -> None:
    """Deterministic random weights (the repository holds no checkpoint):
    linear and convolution weights ~ N(0, 1/fan_in), so that every block's
    branch is as large as its input and a check of the logits sees every
    kernel; rel-pos bias tables ~ N(0, 1); biases and BN means small,
    LayerNorm/GroupNorm/BN scales (a frozen BN's are buffers) and combiner
    weights around 1."""
    g = torch.Generator().manual_seed(seed)
    norms = (torch.nn.LayerNorm, torch.nn.BatchNorm2d, torch.nn.GroupNorm,
             FrozenBatchNorm2d)
    with torch.no_grad():
        for mod in model.modules():
            norm = isinstance(mod, norms)
            leaves = list(mod.named_parameters(recurse=False))
            if isinstance(mod, FrozenBatchNorm2d):  # its affine is two buffers
                leaves += [(k, getattr(mod, k)) for k in ("weight", "bias")]
            for leaf, p in leaves:
                noise = torch.randn(p.shape, generator=g)
                if norm and leaf == "weight":
                    p.copy_(1.0 + 0.05 * noise)
                elif leaf in ("weight", "in_proj_weight") and p.ndim in (2, 4):
                    p.copy_(noise / np.sqrt(p[0].numel()))  # linear, conv: 1/fan_in
                elif leaf in F32_PARAMS:
                    p.copy_(noise)
                elif leaf.startswith("tfts_gamma") or leaf == "identity_weight":
                    p.copy_(1.0 + 0.02 * noise)
                elif leaf == "deform_weight":
                    p.mul_(1.0 + 0.02 * noise)
                else:
                    p.copy_(0.02 * noise)
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            elif name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)


def f32_tensors(model: torch.nn.Module) -> set:
    """ids of the parameters and buffers that stay f32 in a bf16 model, as
    flax keeps them: every normalisation's, and those a module composes in
    f32 before one rounding (``composed_in_f32``, the SegFormer head's)."""
    keep = set()
    for mod in model.modules():
        subs = [mod] if isinstance(mod, NORMS) else []
        if hasattr(mod, "composed_in_f32"):
            subs += mod.composed_in_f32()
        for sub in subs:
            keep.update(id(t) for t in (*sub.parameters(), *sub.buffers()))
    return keep


def cast_model_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Compute dtype for every floating parameter and buffer that flax
    rounds where it meets a layer (``promote_dtype``) or casts explicitly;
    f32 stay the ``f32_tensors``, the bias tables, the pixel statistics and
    the int8 dispatch's quantized weights and scales (``int8_*`` buffers)."""
    keep = f32_tensors(model)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.is_floating_point() and name not in F32_PARAMS and id(p) not in keep:
                p.data = p.data.to(dtype)
        for name, buf in mod.named_buffers(recurse=False):
            if (buf.is_floating_point() and not name.startswith(PREFIX)
                    and name not in F32_BUFFERS and id(buf) not in keep):
                setattr(mod, name, buf.to(dtype))


def weights_from(model_path: str) -> dict:
    """A JAX checkpoint (weights.msgpack, or its directory) as the port's
    state_dict."""
    from ir_ads_tpu_torch.utils.checkpoint import load_weights
    from ir_ads_tpu_torch.utils.jax_params import from_flax

    return from_flax(load_weights(model_path))


class SemSegPredictor:
    """Sliding-window flip-ensembled CMNeXt predictor.

    ``predictor(rgb, depth)`` takes (B, H, W, 3) uint8 or [0, 255] float
    frames (depth as a 3-channel image) and returns (logits (B, H, W, K)
    f32, labels (B, H, W) int64).  Weights: ``state_dict`` (the port's
    names, e.g. ``utils.jax_params.from_flax`` of a JAX tree), else
    ``model_path`` (a JAX checkpoint's weights.msgpack, or its directory,
    read by ``utils.checkpoint.load_weights``), else drawn from ``seed``.
    The model runs the backbone and the fused head only
    (``semseg_eval.make_forward_fn``, the eval forward ``val_mm`` runs).
    ``backbone``: ``"SwinTransformer-B"`` or ``"SwinTransformer-L"``
    (``backbone_kwargs`` may set ``dual_batch``; ``head_dims`` defaults to
    (512, 256)), or a legacy model, ``"CMNeXt-B0"``..``"CMNeXt-B5"`` (the
    MiT dual stream, under every dispatch: ``models.legacy_dispatch``) or ``"CMX-B0"``..
    ``"CMX-B5"`` (``models.CMNeXtLegacy``), which takes none of
    ``backbone_kwargs``, ``head_dims``, ``flat_input`` and a
    ``patch_embed`` other than ``"xla"``.
    """

    def __init__(
        self,
        device: str = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        num_classes: int = 40,
        image_size: Tuple[int, int] = (480, 640),
        backbone_kwargs: Optional[dict] = None,
        head_dims: Optional[Tuple[int, int]] = None,
        dispatch: str = "r5",
        flat_input: bool = False,
        patch_embed: str = "xla",
        state_dict: Optional[dict] = None,
        model_path: str = "",
        backbone: str = "SwinTransformer-B",
    ):
        from ir_ads_tpu_torch.models import build_model, is_legacy

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SemSegPredictor: CUDA is not available "
                               "(pass device='cpu' to run the plain versions)")
        if patch_embed == "pallas" and not flat_input:
            raise ValueError("SemSegPredictor: patch_embed='pallas' (K19) takes flat input: "
                             "pass flat_input=True")
        if flat_input and is_legacy(backbone):
            raise ValueError(f"SemSegPredictor: flat_input has no counterpart in the legacy "
                             f"model {backbone!r}, whose patch embeddings are convolutions")
        self.dtype = dtype
        self.flat_input = flat_input
        if state_dict is None and model_path:
            state_dict = weights_from(model_path)
        # the int8 sites of an int8 dispatch are quantized from f32, then cast
        kw = {} if head_dims is None else dict(head_dims=head_dims)
        model = build_model("CMNeXt", backbone, num_classes, dtype,
                            backbone_kwargs, dispatch, state_dict, seed,
                            upsample_logits=False, patch_embed=patch_embed, **kw)
        self.model = model.to(self.device)
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._predict = make_sliding_window_fn(
            make_forward_fn(self.model), image_size, image_size,
            num_classes, overlap=1.0 / 3.0, flip=True,
        )

    def normalize(self, rgb, depth):
        rgb = torch.as_tensor(rgb, device=self.device).float()
        depth = torch.as_tensor(depth, device=self.device).float()
        rgb = (rgb / 255.0 - self.mean) / self.std
        depth = depth / 255.0
        if self.flat_input:  # (B, H, W, 3) -> (B, H, W*3), a view
            rgb, depth = rgb.flatten(2), depth.flatten(2)
        return rgb.to(self.dtype), depth.to(self.dtype)

    @torch.no_grad()
    def __call__(self, rgb, depth):
        logits = self._predict(*self.normalize(rgb, depth))
        return logits, logits.argmax(dim=-1)


class DetPredictor:
    """vCLR deformable-mask DINO detector behind its inference post-processing.

    ``predictor(images)`` takes (B, H, W, 3) uint8 or [0, 255] float RGB and
    returns ``(scores (B, k), boxes_xyxy (B, k, 4) normalised, keep (B, k),
    class_ids (B, Q), order (B, k))``: the top-k queries by
    sqrt(class score x mask score), their boxes, the NMS keep mask, every
    query's best class, and the kept boxes' order (best first, suppressed
    ones last); with ``want_masks=True`` also the last layer's mask logits
    (B, Q, h0, w0).
    """

    def __init__(
        self,
        device: str = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        num_classes: int = 20,
        num_queries: int = 2000,
        topk: int = 300,
        iou_thresh: float = 0.7,
        model_kwargs: Optional[dict] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetPredictor: CUDA is not available "
                               "(pass device='cpu' to run the plain versions)")
        self.topk, self.iou_thresh = topk, iou_thresh
        model = DINODetector(num_classes=num_classes, num_queries=num_queries,
                             **(model_kwargs or {}))
        # no checkpoint in the repository yet.  Every weight is drawn, the
        # zero-initialised sampling_offsets and attention_weights included:
        # at their init every query samples one pattern with uniform weights
        # and a check of the output would barely see the sampling kernel
        init_random_(model, seed)
        cast_model_(model, dtype)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images, want_masks: bool = False):
        images = torch.as_tensor(images, device=self.device)
        out = self.model(images, want_masks=True)  # the ranking needs the masks
        return self.postprocess(out, want_masks)

    def postprocess(self, out, want_masks: bool = False):
        return det_postprocess(out, self.topk, self.iou_thresh, want_masks)


def det_postprocess(out, topk: int = 300, iou_thresh: float = 0.7, want_masks: bool = False):
    """``DetPredictor``'s post-processing of an eval forward's dict (the last
    layer's logits, boxes and mask logits)."""
    logits = out["pred_logits"][-1].float()
    boxes = out["pred_boxes"][-1]
    masks = out["pred_masks"][-1]  # (B, Q, h0, w0) logits, f32
    scores = logits.sigmoid()
    # mask-scored ranking: sqrt(class score x mean foreground probability)
    mask_fg = (masks > 0).float()
    mask_score = (mask_fg * masks.float().sigmoid()).sum((-2, -1)) / (
        mask_fg.sum((-2, -1)) + 1e-10)
    cls_scores = torch.sqrt(scores.amax(-1) * mask_score.clamp(min=1e-6))
    cls_ids = scores.argmax(-1)
    s, xyxy, keep = nms_topk(cls_scores, boxes, topk=min(topk, boxes.shape[1]),
                             iou_thresh=iou_thresh)
    order = torch.argsort(-torch.where(keep, s, -torch.ones_like(s)), dim=1, stable=True)
    result = (s, xyxy, keep, cls_ids, order)
    return result + (masks,) if want_masks else result
