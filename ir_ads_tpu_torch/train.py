"""RGB-D semantic-segmentation trainer: the port's training entry point.

Counterpart of ``train_mm.build_model_and_state`` and the step loop of
``train_mm.main`` (without the data loader, the evaluation gate and the
checkpoints): CMNeXt under the ``train`` kernel dispatch, f32 master
parameters with bf16 compute, the recipe of configs/nyu_rgbd.yaml
(CrossEntropy, AdamW lr 4e-4 wd 0.01, ``TRAIN_TYPE: Adapter``, warmuppolylr
with 10 warmup epochs of 400).  Runs on the GPU unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.serve import init_random_
from ir_ads_tpu_torch.training.losses import get_loss
from ir_ads_tpu_torch.training.optim import get_optimizer, get_schedule
from ir_ads_tpu_torch.training.train_state import train_step

# configs/nyu_rgbd.yaml: LOSS, OPTIMIZER, SCHEDULER, TRAIN.EPOCHS and
# TRAIN_TYPE; NYUDepthv2 has 795 training images, 198 steps of batch 4 an epoch
RECIPE = dict(loss="CrossEntropy", optimizer="adamw", lr=4e-4, weight_decay=0.01,
              train_type="Adapter", schedule="warmuppolylr", epochs=400,
              iters_per_epoch=198, warmup_epochs=10, warmup_ratio=0.1, power=0.9,
              ignore_label=255)


class SemSegTrainer:
    """``trainer.step(rgb, dte, label)`` takes normalised (B, H, W, 3) float
    frames (depth as a 3-channel image) and (B, H, W) integer labels (255 =
    ignore), makes one update by ``RECIPE`` and returns ``{"loss",
    "loss_main"}`` as floats.  Dropout, drop-path and the modality mask draw
    from one generator seeded with ``seed``; weights are drawn from ``seed``
    too (the repository holds no checkpoint) unless ``state_dict`` is given."""

    def __init__(
        self,
        device: str = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        num_classes: int = 40,
        backbone_kwargs: Optional[dict] = None,
        head_dims: Tuple[int, int] = (512, 256),
        head_drop: float = 0.1,
        mmst_mask: bool = True,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SemSegTrainer: CUDA is not available "
                               "(pass device='cpu' to run the plain versions)")
        self.dtype = dtype
        r = RECIPE
        self.ignore_label = r["ignore_label"]
        model = CMNeXt(num_classes=num_classes, backbone_kwargs=backbone_kwargs,
                       head_dims=head_dims, upsample_logits=True, dispatch="train",
                       head_drop=head_drop, mmst_mask=mmst_mask)
        if state_dict is None:
            init_random_(model, seed)
        else:
            model.load_state_dict(state_dict)
        # parameters stay f32 (the optimizer's master copy); modules cast at use
        self.model = model.to(self.device).train()
        self.loss_fn = get_loss(r["loss"])
        self.schedule = get_schedule(
            r["schedule"], base_lr=r["lr"], power=r["power"],
            max_iter=(r["epochs"] + 1) * r["iters_per_epoch"],
            warmup_iter=r["iters_per_epoch"] * r["warmup_epochs"],
            warmup_ratio=r["warmup_ratio"])
        self.optimizer = get_optimizer(r["optimizer"], self.model, self.schedule,
                                       r["weight_decay"], r["train_type"])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0

    def batch(self, rgb, dte, label):
        rgb = torch.as_tensor(rgb, device=self.device).to(self.dtype)
        dte = torch.as_tensor(dte, device=self.device).to(self.dtype)
        return rgb, dte, torch.as_tensor(label, device=self.device).long()

    def step(self, rgb, dte, label) -> Dict[str, float]:
        metrics = train_step(self.model, self.optimizer, self.schedule, self.steps,
                             self.batch(rgb, dte, label), self.loss_fn,
                             self.generator, self.ignore_label)
        self.steps += 1
        return {k: float(v) for k, v in metrics.items()}
