"""Detection training: counterpart of ir_ads_tpu/detection/train.py.

The vCLR teacher-student step: the student on the strong view with CDN
denoising, Hungarian losses on every decoder layer and the encoder stage,
CDN losses and point-sampled mask losses; the EMA teacher on the weak view
under ``no_grad``; the consistency loss between Hungarian-matched student
queries and the teacher's confident detections; AdamW at 2e-4 x {0.1
backbone, 0.1 sampling_offsets, 1 rest}, weight decay 1e-4 on every leaf,
after ``clip_by_global_norm(0.1)`` over all gradients; EMA decay 0.999.

``DetTrainState`` holds the f32 master parameters by name (every flax
``params`` leaf: the frozen BatchNorms' scale and bias train, as they do in
the JAX package; only their statistics are frozen), the statistics, the EMA
copy and the optimizer.  The model runs through
``torch.func.functional_call`` on the parameters cast to the compute dtype
(normalisations keep theirs in f32, as ``serve.cast_model_`` casts a served
model), so the gradient of each cast reaches its f32 master.  Randomness is
keyed by the step: the CDN draws and the mask losses' point draws of step n
come from a generator seeded from ``(seed, n)``, in that order; a caller
may pass the draws instead (``StepDraws``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ir_ads_tpu_torch.detection.cdn import Draws, cdn_groups
from ir_ads_tpu_torch.detection.criterion import (
    PointDraws, consistency_loss, dn_criterion, mask_point_draws, set_criterion,
)
from ir_ads_tpu_torch.detection.dino import DINODetector, split_dn
from ir_ads_tpu_torch.detection.ema import ema_init, ema_update
from ir_ads_tpu_torch.training.optim import clip_by_global_norm_
from ir_ads_tpu_torch.training.train_state import step_seed

Tensors = Dict[str, torch.Tensor]
STATISTICS = ("running_mean", "running_var", "num_batches_tracked")
MASK_POINTS = 12544


@dataclass
class StepDraws:
    """One step's random draws: the CDN draws (``cdn.cdn_draws``) and one
    pair of point draws per mask loss, the decoder layers' then the encoder
    stage's (``criterion.mask_point_draws``)."""

    cdn: Optional[Draws]
    points: List[PointDraws]


def detection_losses(
    outputs: Dict,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    gt_masks: Optional[torch.Tensor],
    point_draws: Sequence[Optional[PointDraws]],
    mask_loss_points: int = MASK_POINTS,
) -> Tensors:
    """Per-layer, encoder-stage and CDN losses of a train forward (the JAX
    package's loop form), keyed ``{loss}_{layer}`` and ``{loss}_enc``."""
    n_dn, n_groups = outputs["n_dn"], outputs["n_groups"]
    n_layers = outputs["pred_logits"].shape[0]
    use_masks = gt_masks is not None
    mask_kw = dict(gt_masks=gt_masks, num_points=mask_loss_points, seg_feat=outputs["seg_feat"],
                   seg_hw=outputs["seg_hw"])
    losses: Tensors = {}
    for lvl in range(n_layers):
        logits, boxes = outputs["pred_logits"][lvl], outputs["pred_boxes"][lvl]
        embeds = outputs["pred_mask_embeds"][lvl]
        if n_dn > 0:
            dn_logits, logits = split_dn(logits, n_dn)
            dn_boxes, boxes = split_dn(boxes, n_dn)
            embeds = embeds[:, n_dn:]
            for k, v in dn_criterion(dn_logits, dn_boxes, gt_labels, gt_boxes, gt_valid,
                                     n_groups).items():
                losses[f"{k}_{lvl}"] = v
        for k, v in set_criterion(logits, boxes, gt_labels, gt_boxes, gt_valid,
                                  mask_draws=point_draws[lvl],
                                  mask_embeds=embeds if use_masks else None,
                                  **mask_kw).items():
            losses[f"{k}_{lvl}"] = v
    enc = set_criterion(outputs["enc_logits"], outputs["enc_boxes"], gt_labels, gt_boxes,
                        gt_valid, mask_draws=point_draws[n_layers],
                        mask_embeds=outputs["enc_mask_embed"] if use_masks else None,
                        **mask_kw)
    for k, v in enc.items():
        losses[f"{k}_enc"] = v
    return losses


def param_group(name: str) -> str:
    """The optimizer group of a parameter (the JAX package's path labels)."""
    if "backbone" in name.lower():
        return "backbone"
    if "sampling_offsets" in name:
        return "offsets"
    return "rest"


LR_MULT = {"backbone": 0.1, "offsets": 0.1, "rest": 1.0}
WEIGHT_DECAY, CLIP_NORM = 1e-4, 0.1


def detection_optimizer(params: Tensors, base_lr: float = 2e-4) -> torch.optim.AdamW:
    """AdamW over the parameter groups of the JAX ``detection_optimizer``:
    ``base_lr`` x ``LR_MULT`` of the group, b1 0.9, b2 0.999, eps 1e-8, the
    decay on every leaf as optax's ``adamw`` applies it (torch's decoupled
    decay is the same update).  The caller clips the gradients first
    (``training.optim.clip_by_global_norm_``, ``CLIP_NORM``) and gives a
    parameter without a gradient a zero one, as optax updates every leaf."""
    groups = {g: [] for g in LR_MULT}
    for name, p in params.items():
        groups[param_group(name)].append(p)
    return torch.optim.AdamW(
        [dict(params=ps, lr=base_lr * LR_MULT[g]) for g, ps in groups.items() if ps],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)


def split_state(model: torch.nn.Module) -> Tuple[Tensors, Tensors]:
    """(parameters, statistics) of a detector's state_dict, f32 copies: the
    parameters are the flax ``params`` leaves (the frozen BatchNorms'
    weight and bias among them), the statistics the ``batch_stats``."""
    params, stats = {}, {}
    for k, v in model.state_dict().items():
        (stats if k.rsplit(".", 1)[-1] in STATISTICS else params)[k] = v.detach().clone()
    return params, stats


def f32_names(model: torch.nn.Module) -> set:
    """Names of the state that a bf16 model keeps in f32 (``serve.cast_model_``)."""
    from ir_ads_tpu_torch.serve import F32_PARAMS, f32_tensors

    keep = f32_tensors(model)
    return {k for k, v in model.state_dict(keep_vars=True).items()
            if id(v) in keep or k.rsplit(".", 1)[-1] in F32_PARAMS}


@dataclass
class DetTrainState:
    """A detection run's state; ``train_step(batch)`` makes one update."""

    model: DINODetector
    params: Tensors  # f32 leaves that take gradients
    stats: Tensors
    ema_params: Tensors
    opt: torch.optim.AdamW
    seed: int = 3407
    step: int = 0
    dtype: torch.dtype = torch.float32  # the compute dtype; parameters stay f32
    ema_decay: float = 0.999
    use_teacher: bool = True
    keep_f32: set = field(default_factory=set)

    @classmethod
    def create(cls, model: DINODetector, dtype: torch.dtype = torch.float32,
               seed: int = 3407, base_lr: float = 2e-4, **kw) -> "DetTrainState":
        params, stats = split_state(model)
        params = {k: v.float().requires_grad_() for k, v in params.items()}
        return cls(model=model, params=params, stats=stats, ema_params=ema_init(params),
                   opt=detection_optimizer(params, base_lr), seed=seed, dtype=dtype,
                   keep_f32=f32_names(model), **kw)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def generator(self, step: Optional[int] = None) -> torch.Generator:
        step = self.step if step is None else step
        return torch.Generator(device=self.device).manual_seed(step_seed(self.seed, step))

    def draws(self, batch: int) -> StepDraws:
        """Step ``self.step``'s draws from its generator."""
        g = self.generator()
        m = self.model
        cdn = None
        if m.dn_number > 0:
            cdn = m.cdn_draws(g, batch, cdn_groups(m.dn_number, m.max_gt))
        points = [mask_point_draws(g, batch * m.max_gt, MASK_POINTS)
                  for _ in range(m.num_decoder_layers + 1)]
        return StepDraws(cdn, points)

    def variables(self, params: Tensors) -> Tensors:
        """The module's tensors for a forward: parameters in the compute
        dtype (the f32 ones kept), the statistics as they are."""
        cast = {k: v if k in self.keep_f32 else v.to(self.dtype) for k, v in params.items()}
        return {**cast, **self.stats}

    def teacher(self, weak: torch.Tensor) -> Dict:
        """The EMA teacher's eval forward, without the mask stack."""
        self.model.eval()
        with torch.no_grad():
            return functional_call(self.model, self.variables(self.ema_params), (weak,),
                                   dict(want_masks=False))

    def losses(self, params: Tensors, batch: Sequence[torch.Tensor], draws: StepDraws,
               teacher_out: Optional[Dict]) -> Tuple[torch.Tensor, Tensors]:
        """The student's train forward (which moves the segmentation map's
        running statistics) and its losses."""
        strong, _, labels, boxes, valid, masks = batch
        self.model.train()
        out = functional_call(self.model, self.variables(params), (strong, labels, boxes, valid),
                              dict(cdn_draws=draws.cdn))
        losses = detection_losses(out, labels, boxes, valid, masks, draws.points)
        if teacher_out is not None:  # the teacher's detections scored over 0.5
            t_scores = teacher_out["pred_logits"][-1].float().sigmoid().amax(-1)
            n_dn = out["n_dn"]
            losses["loss_consistency"] = consistency_loss(
                out["pred_queries"][-1][:, n_dn:], teacher_out["pred_queries"][-1],
                teacher_out["pred_boxes"][-1], out["pred_boxes"][-1][:, n_dn:],
                t_scores > 0.5)
        return sum(losses.values()), losses

    def train_step(self, batch: Sequence[torch.Tensor],
                   draws: Optional[StepDraws] = None) -> Tensors:
        """One update on (strong, weak, labels, boxes, valid, masks), each a
        tensor on the state's device (images (B, H, W, 3) 0..255).  Returns
        the metrics as tensors ({"loss", each loss})."""
        if draws is None:
            draws = self.draws(batch[0].shape[0])
        teacher_out = self.teacher(batch[1]) if self.use_teacher else None
        total, losses = self.losses(self.params, batch, draws, teacher_out)
        self.apply_gradients(torch.autograd.grad(total, list(self.params.values()),
                                                 allow_unused=True))
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    def apply_gradients(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Clip, update, move the EMA; ``grads`` in ``params``' order."""
        for p, g in zip(self.params.values(), grads):
            p.grad = torch.zeros_like(p) if g is None else g
        clip_by_global_norm_(self.params.values(), CLIP_NORM)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.ema_params = ema_update(self.ema_params, self.params, self.ema_decay)
        self.step += 1

    def state_dict(self, ema: bool = False) -> Tensors:
        """Parameters (or the EMA's) and statistics under the module's names."""
        params = self.ema_params if ema else self.params
        return {**{k: v.detach() for k, v in params.items()}, **self.stats}
