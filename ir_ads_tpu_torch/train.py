"""The model and the training state from a config, and ``SemSegTrainer``.

``build_model_and_state`` is the counterpart of
``train_mm.build_model_and_state``: CMNeXt under the ``train`` kernel
dispatch with f32 master parameters (bf16 compute when ``TRAIN.AMP``), the
config's ``MODEL``, ``OPTIMIZER``, ``SCHEDULER`` and ``LOSS``, the schedule
over ``(EPOCHS + 1) * iters_per_epoch`` steps with ``WARMUP`` epochs of
warmup.  The trainable set is the parameters' ``requires_grad``
(``optim.freeze_``), which the window-attention backward reads; nothing is
passed through the environment.  Runs on the GPU unless the caller passes
``device="cpu"``.

``SemSegTrainer`` is the same state behind a step API, on ``RECIPE``:
configs/nyu_rgbd.yaml's training sections.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.training.losses import get_loss
from ir_ads_tpu_torch.training.optim import get_optimizer, get_schedule
from ir_ads_tpu_torch.training.train_state import TrainState

# configs/nyu_rgbd.yaml: TRAIN, LOSS, OPTIMIZER, SCHEDULER (AdamW lr 4e-4 wd
# 0.01, TRAIN_TYPE Adapter, warmuppolylr with 10 warmup epochs of 400);
# NYUDepthv2 has 795 training images, 198 steps of batch 4 an epoch
RECIPE = {
    "DATASET": {"IGNORE_LABEL": 255},
    "TRAIN": {"EPOCHS": 400, "BATCH_SIZE": 4, "AMP": True},
    "LOSS": {"NAME": "CrossEntropy"},
    "OPTIMIZER": {"NAME": "adamw", "LR": 4e-4, "WEIGHT_DECAY": 0.01, "TRAIN_TYPE": "Adapter"},
    "SCHEDULER": {"NAME": "warmuppolylr", "POWER": 0.9, "WARMUP": 10, "WARMUP_RATIO": 0.1},
}
RECIPE_ITERS_PER_EPOCH = 198


def _require_device(device: str, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available (pass device='cpu' to run the "
                           "plain versions)")
    return device


def build_state(model: torch.nn.Module, cfg: Dict, iters_per_epoch: int,
                seed: int = 3407) -> TrainState:
    """The training state of ``model`` (f32, on its device, any mode) by the
    config's ``OPTIMIZER``, ``SCHEDULER``, ``LOSS`` and ``TRAIN``."""
    optim_cfg, sched_cfg = cfg["OPTIMIZER"], cfg["SCHEDULER"]
    train_cfg = cfg["TRAIN"]
    schedule = get_schedule(
        sched_cfg["NAME"],
        base_lr=optim_cfg["LR"],
        max_iter=int((train_cfg["EPOCHS"] + 1) * iters_per_epoch),
        power=sched_cfg.get("POWER", 0.9),
        warmup_iter=iters_per_epoch * sched_cfg.get("WARMUP", 10),
        warmup_ratio=sched_cfg.get("WARMUP_RATIO", 0.1),
    )
    train_type = optim_cfg.get("TRAIN_TYPE", "all")
    optimizer = get_optimizer(optim_cfg["NAME"], model, schedule,
                              optim_cfg.get("WEIGHT_DECAY", 0.01), train_type)
    return TrainState(model.train(), optimizer, schedule, get_loss(cfg["LOSS"]["NAME"]),
                      optimizer_name=optim_cfg["NAME"], train_type=train_type, seed=seed,
                      ignore_label=cfg["DATASET"]["IGNORE_LABEL"],
                      dtype=torch.bfloat16 if train_cfg.get("AMP", True) else torch.float32)


def build_model_and_state(cfg: Dict, num_classes: int, iters_per_epoch: int,
                          device: str = "cuda", seed: int = 3407) -> TrainState:
    """The config's model under the ``train`` dispatch on ``device``, its
    weights drawn from ``seed`` (the repository holds no checkpoint), and
    its training state; the step generators are seeded from ``seed`` too."""
    from ir_ads_tpu_torch.models import build_model

    device = _require_device(device, "train")
    model_cfg = cfg["MODEL"]
    model = build_model(model_cfg.get("NAME", "CMNeXt"), model_cfg["BACKBONE"], num_classes,
                        None, model_cfg.get("BACKBONE_KWARGS"), "train", seed=seed,
                        upsample_logits=True)
    return build_state(model.to(device), cfg, iters_per_epoch, seed)


class SemSegTrainer:
    """``trainer.step(rgb, dte, label)`` takes normalised (B, H, W, 3) float
    frames (depth as a 3-channel image) and (B, H, W) integer labels (255 =
    ignore), makes one update by ``RECIPE`` and returns ``{"loss",
    "loss_main"}`` as floats.  Dropout, drop-path and the modality mask of
    step n draw from a generator seeded from ``(seed, n)``; weights are drawn
    from ``seed`` too (the repository holds no checkpoint) unless
    ``state_dict`` is given.  ``dtype`` is the compute dtype; parameters
    stay f32.  ``backbone``: ``"SwinTransformer-B"`` or
    ``"SwinTransformer-L"`` (block remat on, as the JAX package runs it)."""

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
        backbone: str = "SwinTransformer-B",
    ):
        from ir_ads_tpu_torch.serve import init_random_

        device = _require_device(device, "SemSegTrainer")
        model = CMNeXt(backbone=backbone, num_classes=num_classes,
                       backbone_kwargs=backbone_kwargs,
                       head_dims=head_dims, upsample_logits=True, dispatch="train",
                       head_drop=head_drop, mmst_mask=mmst_mask)
        if state_dict is None:
            init_random_(model, seed)
        else:
            model.load_state_dict(state_dict)
        self.state = build_state(model.to(device), RECIPE, RECIPE_ITERS_PER_EPOCH, seed)
        self.state.dtype = dtype
        self.device, self.dtype = device, dtype
        self.model, self.optimizer = self.state.model, self.state.optimizer
        self.schedule, self.loss_fn = self.state.schedule, self.state.loss_fn
        self.ignore_label = self.state.ignore_label

    @property
    def steps(self) -> int:
        return self.state.step

    @property
    def generator(self) -> torch.Generator:
        """The generator of the next step."""
        return self.state.generator()

    def batch(self, rgb, dte, label):
        return self.state.batch(rgb, dte, label)

    def step(self, rgb, dte, label) -> Dict[str, float]:
        metrics = self.state.train_step(self.batch(rgb, dte, label))
        return {k: float(v) for k, v in metrics.items()}
