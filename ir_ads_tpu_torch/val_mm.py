"""Segmentation evaluation entry point: the port's counterpart of val_mm.py.

    python -m ir_ads_tpu_torch.val_mm --cfg configs/nyu_rgbd.yaml [--dispatch r5] [--device cuda]

Evaluates the config's model on its dataset's val split in one of three
modes: multi-scale + flip (``EVAL.MSF.ENABLE``), sliding window
(``EVAL.SLIDING.ENABLE``: tile, overlap, flip) or single-scale.  Prints the
mIoU / mF1 / mAcc line and the images/s line, and writes the per-class
report next to ``EVAL.MODEL_PATH`` when one is given.  Weights come from
``EVAL.MODEL_PATH`` (a JAX checkpoint's weights.msgpack, or its directory)
or, without one, are drawn from ``--seed``.  ``EVAL.CACHE_DIR`` serves the
val split from a decode-once ``RawCache`` with the normalisation on the
device.  ``TRAIN.AMP`` chooses bf16 (the default) or f32.

Beyond the JAX val_mm.py: ``DATASET.KWARGS`` goes to the dataset's constructor
(``Synthetic``'s ``image_size``, ``num_classes``, ``length``), with
``DATASET.VAL_KWARGS`` over it (``datasets.dataset_kwargs``); ``--workers``
chooses the loader's threads or processes.  ``EVAL.SPATIAL_SHARD`` is
multi-device and not ported.

Under r5 (and every dispatch whose einsum DSCF takes K6) the einsum
branch's rpe bias comes from the packed kernel, where the JAX package's
default r5 leaves it to XLA (ROADMAP Queue 3 item 1); the log says so.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from ir_ads_tpu_torch.data.augmentations import (
    get_val_augmentation, get_val_augmentation_device_norm,
)
from ir_ads_tpu_torch.data.cache import RawCache
from ir_ads_tpu_torch.data.datasets import dataset_kwargs, get_dataset
from ir_ads_tpu_torch.data.loader import DataLoader
from ir_ads_tpu_torch.evaluation.semseg_eval import (
    evaluate, make_forward_fn, make_sliding_window_fn,
)
from ir_ads_tpu_torch.models import build_model
from ir_ads_tpu_torch.training.metrics import Metrics
from ir_ads_tpu_torch.utils.config import load_config
from ir_ads_tpu_torch.utils.logging import get_logger

def build_eval_model(cfg: Dict, num_classes: int, device: str = "cuda",
                     dispatch: str = "r5", seed: int = 0,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """The config's model on ``device`` in eval mode: bf16 unless
    ``TRAIN.AMP`` is false, head-native logits, weights from ``state_dict``
    (the training driver's gate), else from ``EVAL.MODEL_PATH``, else drawn
    from ``seed``."""
    from ir_ads_tpu_torch.serve import weights_from

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("val_mm: CUDA is not available (pass --device cpu to run the "
                           "plain versions)")
    model_cfg = cfg["MODEL"]
    dtype = torch.bfloat16 if cfg["TRAIN"].get("AMP", True) else None
    path = cfg["EVAL"].get("MODEL_PATH", "")
    if state_dict is None and path:
        state_dict = weights_from(path)
    model = build_model(model_cfg.get("NAME", "CMNeXt"), model_cfg["BACKBONE"], num_classes,
                        dtype, model_cfg.get("BACKBONE_KWARGS"), dispatch, state_dict, seed,
                        upsample_logits=False)
    return model.to(device)


def _val_dataset(cfg: Dict):
    eval_cfg, ds_cfg = cfg["EVAL"], cfg["DATASET"]
    transform = get_val_augmentation(eval_cfg["IMAGE_SIZE"])
    dataset = get_dataset(ds_cfg["NAME"])(ds_cfg["ROOT"], "val", transform, ds_cfg["MODALS"],
                                          **dataset_kwargs(ds_cfg, "val"))
    cache_dir = eval_cfg.get("CACHE_DIR", "")
    if not cache_dir:
        return dataset, False
    # decode once into memory maps; the batches stay uint8 and are
    # normalised on the device
    cached = RawCache.build(dataset, cache_dir,
                            transform=get_val_augmentation_device_norm(eval_cfg["IMAGE_SIZE"]))
    cached.n_classes, cached.CLASSES = dataset.n_classes, dataset.CLASSES
    cached.modals = dataset.modals
    return cached, True


def main(cfg: Dict, device: str = "cuda", dispatch: str = "r5", seed: int = 0,
         workers: str = "thread") -> Dict:
    """Evaluate; returns {"miou", "mf1", "macc", "ious", "images", "seconds",
    "latency_s" (per batch, to a device synchronize), "mode"}."""
    logger = get_logger()
    eval_cfg = cfg["EVAL"]
    if (eval_cfg.get("SPATIAL_SHARD") or {}).get("ENABLE", False):
        raise NotImplementedError("EVAL.SPATIAL_SHARD: the spatially sharded eval is "
                                  "multi-device and not ported yet (ROADMAP Queue 1 item 4)")
    dataset, device_norm = _val_dataset(cfg)
    model = build_eval_model(cfg, dataset.n_classes, device, dispatch, seed)
    forward = make_forward_fn(model, device_norm=device_norm)
    if model.backbone.DeformMPGBlocks[-1].deform_atten.rpe3 == "pallas":
        logger.info(f"dispatch {dispatch}: the einsum DSCF's rpe bias (level 3 at 480x640) "
                    "by the packed kernel (K6), where the JAX package's default r5 builds "
                    "it in XLA (a recorded choice, ROADMAP Queue 3 item 1)")
    loader = DataLoader(dataset, eval_cfg["BATCH_SIZE"], shuffle=False, drop_last=False,
                        workers=workers)
    metrics = Metrics(dataset.n_classes, cfg["DATASET"]["IGNORE_LABEL"],
                      device=torch.device(device))
    dev = torch.device(device)

    def batches():
        for b in loader:  # (modal_0, ..., modal_k, label): the first two streams
            yield (torch.from_numpy(b[0]).to(dev), torch.from_numpy(b[1 % (len(b) - 1)]).to(dev),
                   torch.from_numpy(b[-1]).to(dev))

    sliding = eval_cfg.get("SLIDING") or {}
    msf = eval_cfg["MSF"]
    latency: List[float] = []
    t0 = time.time()
    if sliding.get("ENABLE", False):
        mode = "sliding"
        predict = make_sliding_window_fn(
            forward, tuple(eval_cfg["IMAGE_SIZE"]),
            tuple(sliding.get("TILE_SIZE", eval_cfg["IMAGE_SIZE"])), dataset.n_classes,
            overlap=sliding.get("OVERLAP", 1.0 / 3.0), flip=sliding.get("FLIP", True))
        for rgb, dte, label in batches():
            t = time.perf_counter()
            logits = predict(rgb, dte)
            metrics.update(logits.argmax(dim=-1), label)
            if logits.is_cuda:
                torch.cuda.synchronize()
            latency.append(time.perf_counter() - t)
    else:
        mode = "msf" if msf["ENABLE"] else "single-scale"
        evaluate(forward, batches(), metrics, msf=msf["ENABLE"], scales=tuple(msf["SCALES"]),
                 flip=msf["FLIP"], timings=latency)
    elapsed = time.time() - t0

    ious, miou = metrics.compute_iou()
    f1, mf1 = metrics.compute_f1()
    acc, macc = metrics.compute_pixel_acc()
    n = len(dataset)
    logger.info(f"mIoU {miou}  mF1 {mf1}  mAcc {macc}")
    logger.info(f"eval ({mode}, {dispatch}, {device}) of {n} images in {elapsed:.1f}s "
                f"({n / elapsed:.2f} img/s)")
    if eval_cfg.get("MODEL_PATH"):
        out_dir = os.path.dirname(eval_cfg["MODEL_PATH"]) or "."
        report = os.path.join(out_dir, f"eval_{time.strftime('%Y%m%d_%H%M%S')}.txt")
        with open(report, "w") as f:
            f.write(f"{'Class':24s} {'IoU':>8s} {'F1':>8s} {'Acc':>8s}\n")
            for name, i, ff, a in zip(dataset.CLASSES, ious, f1, acc):
                f.write(f"{name:24s} {i * 100:8.2f} {ff:8.2f} {a:8.2f}\n")
            f.write(f"{'Mean':24s} {miou:8.2f} {mf1:8.2f} {macc:8.2f}\n")
        logger.info(f"report written to {report}")
    return dict(miou=miou, mf1=mf1, macc=macc, ious=ious, images=n, seconds=elapsed,
                latency_s=latency, mode=mode)


def cli(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", type=str, default="configs/nyu_rgbd.yaml")
    ap.add_argument("--dispatch", type=str, default="r5")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", choices=("thread", "process"), default="thread")
    args = ap.parse_args(argv)
    return main(load_config(args.cfg), args.device, args.dispatch, args.seed, args.workers)


if __name__ == "__main__":
    cli()
