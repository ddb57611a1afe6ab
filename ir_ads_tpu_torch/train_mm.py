"""Segmentation training entry point: the port's counterpart of train_mm.py.

    python -m ir_ads_tpu_torch.train_mm --cfg configs/nyu_rgbd.yaml [--device cuda] [--seed 3407]

Trains the config's model on its dataset's train split, as the JAX
train_mm.py does step for step: the train and val augmentations, the loader
(shuffled by epoch, ``drop_last``), the model and its training state from
``MODEL``, ``OPTIMIZER``, ``SCHEDULER`` and ``LOSS`` with ``len(trainset) //
BATCH_SIZE`` steps an epoch (``train.build_model_and_state``), resume from
``IR_ADS_RESUME`` (``tools/launch.py`` sets it on a requeue) or
``MODEL.RESUME``, then epochs whose mean loss and images/s go to
``scalars.jsonl``, the eval gate (single-scale mIoU on the val split) after
the epochs that ``EVAL_START`` and ``EVAL_INTERVAL`` pick and after the
last, ``best/`` on a better mIoU and ``latest/`` after every epoch.  The
checkpoints are the JAX package's (``utils.checkpoint``): either package
resumes or evaluates the other's.  Output goes to ``SAVE_DIR/<dataset>_
<backbone>_<modals>``: ``train.log``, ``scalars.jsonl``, ``best/``,
``latest/``.

The training step runs the ``train`` kernel dispatch (K1 forward with K7
backward at every block, K3, K4 and K8 at DSCF levels 0-2, K6 at level 3;
K12 in place of K1 with ``BACKBONE_KWARGS.drop_rate > 0``); the gate runs
the trained weights through the ``r5`` dispatch in the compute dtype, as
the JAX package's eval inside training resolves its kernels.  Runs on the
GPU unless ``--device cpu`` is given.  As val_mm.py, ``DATASET.KWARGS``
(and ``VAL_KWARGS``) go to the dataset's constructor, and ``--workers``
chooses the loader's threads or processes.  The JAX driver's mesh is
multi-device and not ported: this driver trains on one device.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ir_ads_tpu_torch.data.augmentations import get_train_augmentation, get_val_augmentation
from ir_ads_tpu_torch.data.datasets import dataset_kwargs, get_dataset
from ir_ads_tpu_torch.data.loader import DataLoader, prefetch_to_device
from ir_ads_tpu_torch.evaluation.semseg_eval import evaluate, make_forward_fn
from ir_ads_tpu_torch.train import build_model_and_state
from ir_ads_tpu_torch.training.metrics import Metrics
from ir_ads_tpu_torch.training.train_state import TrainState
from ir_ads_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ir_ads_tpu_torch.utils.config import load_config
from ir_ads_tpu_torch.utils.logging import ScalarWriter, get_logger, log_to_file
from ir_ads_tpu_torch.val_mm import build_eval_model


def save_dir_of(cfg: Dict) -> Path:
    """SAVE_DIR/<dataset>_<backbone>_<first letter of each modality>."""
    modals = "".join(m[0] for m in cfg["DATASET"]["MODALS"])
    return Path(cfg["SAVE_DIR"]) / "_".join(
        [cfg["DATASET"]["NAME"], cfg["MODEL"]["BACKBONE"], modals])


def eval_gate(cfg: Dict, state: TrainState, valloader, n_classes: int) -> float:
    """Single-scale mIoU of the state's weights under ``r5`` (a model built
    for the gate and freed after it)."""
    device = state.device
    model = build_eval_model(cfg, n_classes, str(device), "r5",
                             state_dict=state.model.state_dict())
    forward = make_forward_fn(model)
    metrics = Metrics(n_classes, cfg["DATASET"]["IGNORE_LABEL"], device=device)

    def batches():
        for b in prefetch_to_device(iter(valloader), device):
            yield b[0], b[1 % (len(b) - 1)], b[-1]

    evaluate(forward, batches(), metrics, msf=False)
    _, miou = metrics.compute_iou()
    del model, forward
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return miou


def main(cfg: Dict, save_dir: Optional[Path] = None, device: str = "cuda", seed: int = 3407,
         workers: str = "thread") -> Dict:
    """Train; returns {"best_miou", "best_epoch", "epochs" (per epoch: loss,
    images/s, seconds, mIoU or None, the gate's seconds, the checkpoints'
    bytes and seconds), "state" (the ``TrainState``)}.  ``MODEL.BACKBONE``
    may name a legacy model (CMNeXt-B0..B5, CMX-B0..B5)."""
    save_dir = Path(save_dir) if save_dir is not None else save_dir_of(cfg)
    save_dir.mkdir(parents=True, exist_ok=True)
    with log_to_file(get_logger(), save_dir / "train.log") as logger:
        return _train(cfg, save_dir, device, seed, workers, logger)


def _train(cfg, save_dir, device, seed, workers, logger) -> Dict:
    writer = ScalarWriter(str(save_dir))
    train_cfg, eval_cfg = cfg["TRAIN"], cfg["EVAL"]
    ds_cfg, model_cfg = cfg["DATASET"], cfg["MODEL"]
    ds_cls = get_dataset(ds_cfg["NAME"])
    traintf = get_train_augmentation(train_cfg["IMAGE_SIZE"], seg_fill=ds_cfg["IGNORE_LABEL"])
    valtf = get_val_augmentation(eval_cfg["IMAGE_SIZE"])
    trainset = ds_cls(ds_cfg["ROOT"], "train", traintf, ds_cfg["MODALS"],
                      **dataset_kwargs(ds_cfg, "train"))
    valset = ds_cls(ds_cfg["ROOT"], "val", valtf, ds_cfg["MODALS"],
                    **dataset_kwargs(ds_cfg, "val"))
    logger.info(f"train {len(trainset)} / val {len(valset)} images")

    batch_size = train_cfg["BATCH_SIZE"]
    iters_per_epoch = max(len(trainset) // batch_size, 1)
    state = build_model_and_state(cfg, trainset.n_classes, iters_per_epoch, device, seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f"model {model_cfg['BACKBONE']}: {n_params / 1e6:.1f}M params on "
                f"{state.device}")

    best_miou, best_epoch, start_epoch = 0.0, 0, 0
    # IR_ADS_RESUME: set by tools/launch.py on auto-requeue
    resume = os.environ.get("IR_ADS_RESUME", "") or model_cfg.get("RESUME", "")
    if resume and os.path.isdir(resume):
        manifest = load_checkpoint(resume, state)
        best_miou = manifest.get("best_miou", 0.0)
        start_epoch = best_epoch = manifest.get("epoch", 0)
        logger.info(f"resumed from {resume} @ epoch {start_epoch}, best {best_miou}")

    loader = DataLoader(trainset, batch_size, shuffle=True, drop_last=True, workers=workers)
    valloader = DataLoader(valset, eval_cfg["BATCH_SIZE"], shuffle=False, drop_last=False,
                           workers=workers)
    extra = {"config": {k: v for k, v in cfg.items() if not k.startswith("_")}}
    epochs = train_cfg["EPOCHS"]
    history: List[Dict] = []
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        t0, losses = time.time(), []
        for batch in prefetch_to_device(iter(loader), state.device):
            rgb, dte, label = batch[0], batch[1 % (len(batch) - 1)], batch[-1]
            losses.append(state.train_step(state.batch(rgb, dte, label))["loss"])
        train_loss = sum(float(v) for v in losses) / max(len(losses), 1)  # waits for the steps
        seconds = time.time() - t0
        ips = len(losses) * batch_size / seconds
        writer.add_scalar("train/loss", train_loss, epoch)
        writer.add_scalar("train/img_per_sec", ips, epoch)
        logger.info(f"epoch {epoch + 1}/{epochs} loss {train_loss:.4f} ({ips:.1f} img/s)")
        record = dict(epoch=epoch + 1, loss=train_loss, images_per_s=ips, seconds=seconds,
                      steps=len(losses), miou=None, gate_seconds=None, checkpoint_bytes=0,
                      checkpoint_seconds=0.0)

        do_eval = ((epoch + 1) % train_cfg["EVAL_INTERVAL"] == 0
                   and (epoch + 1) > train_cfg["EVAL_START"]) or (epoch + 1) == epochs
        if do_eval:
            t = time.time()
            miou = eval_gate(cfg, state, valloader, trainset.n_classes)
            record.update(miou=miou, gate_seconds=time.time() - t)
            writer.add_scalar("val/mIoU", miou, epoch)
            logger.info(f"epoch {epoch + 1} mIoU {miou} (best {best_miou})")
            if miou > best_miou:
                best_miou, best_epoch = miou, epoch + 1
                t = time.time()
                record["checkpoint_bytes"] += save_checkpoint(
                    str(save_dir / "best"), state, best_miou, best_epoch, extra=extra)
                record["checkpoint_seconds"] += time.time() - t
                logger.info(f"saved best checkpoint to {save_dir / 'best'}")
        # a rolling full checkpoint for requeue and resume
        t = time.time()
        record["checkpoint_bytes"] += save_checkpoint(
            str(save_dir / "latest"), state, best_miou, epoch + 1, extra=extra)
        record["checkpoint_seconds"] += time.time() - t
        history.append(record)

    writer.close()
    logger.info(f"done. best mIoU {best_miou} @ epoch {best_epoch}")
    return dict(best_miou=best_miou, best_epoch=best_epoch, epochs=history, state=state)


def cli(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", type=str, default="configs/nyu_rgbd.yaml")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=3407)
    ap.add_argument("--workers", choices=("thread", "process"), default="thread")
    args = ap.parse_args(argv)
    return main(load_config(args.cfg), None, args.device, args.seed, args.workers)


if __name__ == "__main__":
    cli()
