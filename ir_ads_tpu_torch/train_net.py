"""Open-set detection training on the port: counterpart of the JAX
package's train_net.py entry point.

Trains the vCLR deformable-mask DINO (``detection.train``: EMA teacher on
the weak view, CDN denoising, Hungarian + mask + consistency losses) and
evaluates the EMA weights with the COCO AP / AR@{1..900} suite, or with
``--evaluator lvis`` the LVIS federated rules (``detection.lvis_eval``;
each image's ``neg_category_ids`` and ``not_exhaustive_category_ids`` from
the sample where it has them, else exhaustive).  Runs on the
GPU in bf16 over f32 master parameters unless ``--device cpu`` is given
(f32, the kernels' plain versions).

    python -m ir_ads_tpu_torch.train_net --train-json ann.json --train-root imgs/ \\
        --val-json val.json --val-root val_imgs/ --max-iter 60000
    python -m ir_ads_tpu_torch.train_net --synthetic --max-iter 2 --device cpu

``--synthetic`` writes a tiny random COCO set under ``--output`` and shrinks
the model (ResNet-18, embed 32, 1 + 1 layers, 20 queries, 96 px).  The
weights (``weights.msgpack``, ``ema_weights.msgpack``) are the JAX
package's files: its train_net ``--resume`` reads them, and ``--resume``
here reads its.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ir_ads_tpu_torch.detection.coco_eval import COCOEvaluator
from ir_ads_tpu_torch.detection.data import (
    CocoDetection, ViewSamplingMapper, detection_batches,
)
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.detection.lvis_eval import LVISEvaluator
from ir_ads_tpu_torch.detection.train import DetTrainState
from ir_ads_tpu_torch.serve import det_postprocess
from ir_ads_tpu_torch.utils.checkpoint import load_dino_weights, save_dino_weights
from ir_ads_tpu_torch.utils.logging import ScalarWriter, get_logger, log_to_file


def make_synthetic_coco(root: str, n_images: int = 8, size: int = 96, n_classes: int = 4,
                        seed: int = 0):
    """Write a tiny random COCO dataset (train_net.py's, draw for draw);
    returns (annotations.json, images/)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        fname = f"{i:04d}.jpg"
        arr = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "images", fname))
        images.append({"id": i, "file_name": fname, "height": size, "width": size})
        for _ in range(rng.randint(1, 4)):
            w, h = (int(v) for v in rng.randint(10, 40, 2))
            x = int(rng.randint(0, size - w))
            y = int(rng.randint(0, size - h))
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": int(rng.randint(1, n_classes + 1)),
                "bbox": [float(x), float(y), float(w), float(h)], "area": float(w * h),
                "iscrowd": 0, "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]],
            })
            ann_id += 1
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"c{c}"} for c in range(n_classes)]}
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path, os.path.join(root, "images")


def evaluate_detector(state: DetTrainState, mapper: ViewSamplingMapper, logger, topk: int = 300,
                      score_thresh: float = 0.0, class_agnostic: bool = False,
                      evaluator: str = "coco") -> Dict[str, float]:
    """Inference with the EMA weights over the dataset, then the COCO or
    the LVIS summary (train_net.py's ``evaluate_detector``)."""
    from torch.func import functional_call

    ev = LVISEvaluator() if evaluator == "lvis" else COCOEvaluator(class_agnostic=class_agnostic)
    model, variables = state.model, state.variables(state.ema_params)
    model.eval()
    rng = np.random.default_rng(0)
    for i in range(len(mapper.ds)):
        sample = mapper(i, rng)
        imgs = torch.from_numpy(np.array(sample.weak_image[None], np.float32)).to(state.device)
        with torch.no_grad():
            out = functional_call(model, variables, (imgs,), dict(want_masks=True))
            s, xyxy, keep, cls_ids, _ = det_postprocess(out, min(topk, out["pred_boxes"].shape[2]))
        s, xyxy = (t[0].float().cpu().numpy() for t in (s, xyxy))
        keep = keep[0].cpu().numpy()
        oh, ow = sample.orig_size
        sel = keep & (s > score_thresh)
        boxes = xyxy[sel]
        # normalised xyxy -> original-pixel xywh
        boxes = np.stack([boxes[:, 0] * ow, boxes[:, 1] * oh, (boxes[:, 2] - boxes[:, 0]) * ow,
                          (boxes[:, 3] - boxes[:, 1]) * oh], axis=-1)
        gt_cxcywh = sample.boxes[sample.valid]
        gt_boxes = np.stack([(gt_cxcywh[:, 0] - gt_cxcywh[:, 2] / 2) * ow,
                             (gt_cxcywh[:, 1] - gt_cxcywh[:, 3] / 2) * oh,
                             gt_cxcywh[:, 2] * ow, gt_cxcywh[:, 3] * oh], axis=-1)
        labels = (np.zeros(sel.sum(), int) if class_agnostic
                  else cls_ids[0].cpu().numpy()[: len(xyxy)][sel])
        extra = {}
        if evaluator == "lvis":
            extra = dict(neg_category_ids=getattr(sample, "neg_category_ids", ()),
                         not_exhaustive_category_ids=getattr(
                             sample, "not_exhaustive_category_ids", ()))
        ev.add_image(boxes, s[sel], labels, gt_boxes, sample.labels[sample.valid], **extra)
    stats = ev.summarize()
    logger.info("eval: " + "  ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    return stats


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train-json")
    p.add_argument("--train-root")
    p.add_argument("--val-json")
    p.add_argument("--val-root")
    p.add_argument("--style-root", default=None)
    p.add_argument("--depth-root", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--num-queries", type=int, default=900)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--enc-layers", type=int, default=6)
    p.add_argument("--dec-layers", type=int, default=6)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--max-gt", type=int, default=20)
    p.add_argument("--dn-number", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-iter", type=int, default=60000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--eval-period", type=int, default=5000)
    p.add_argument("--class-agnostic-eval", action="store_true")
    p.add_argument("--no-teacher", action="store_true")
    p.add_argument("--evaluator", default="coco", choices=["coco", "lvis"],
                   help="COCO AP or LVIS federated evaluation")
    p.add_argument("--output", default="output/detection")
    p.add_argument("--resume", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=3407)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, float]]:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_net: CUDA is not available (pass --device cpu to run the "
                           "plain versions)")
    with log_to_file(get_logger(), os.path.join(args.output, "train.log")) as logger:
        return _train(args, device, logger)


def _train(args: argparse.Namespace, device: torch.device, logger) -> Optional[Dict[str, float]]:
    writer = ScalarWriter(args.output)

    if args.synthetic:
        args.train_json, args.train_root = make_synthetic_coco(
            os.path.join(args.output, "synthetic_coco"))
        args.val_json, args.val_root = args.train_json, args.train_root
        args.image_size, args.num_queries, args.embed_dim = 96, 20, 32
        args.enc_layers = args.dec_layers = 1
        args.backbone, args.max_gt, args.dn_number, args.batch_size = "resnet18", 4, 8, 2
        args.eval_period = max(args.eval_period, args.max_iter)

    train_ds = CocoDetection(args.train_json, args.train_root, args.style_root, args.depth_root)
    size = (args.image_size, args.image_size)
    mapper = ViewSamplingMapper(train_ds, size, args.max_gt, train=True)
    logger.info(f"train images: {len(train_ds)}, classes: {train_ds.num_classes}")

    torch.manual_seed(args.seed)
    model = DINODetector(num_classes=train_ds.num_classes, num_queries=args.num_queries,
                         embed_dim=args.embed_dim, num_encoder_layers=args.enc_layers,
                         num_decoder_layers=args.dec_layers, backbone_arch=args.backbone,
                         dn_number=args.dn_number, max_gt=args.max_gt).to(device)
    logger.info(f"model: {sum(p.numel() for p in model.state_dict().values()) / 1e6:.1f}M "
                "tensors' elements")
    state = DetTrainState.create(
        model, dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        seed=args.seed, base_lr=args.lr, ema_decay=args.ema_decay,
        use_teacher=not args.no_teacher)
    if args.resume and os.path.isdir(args.resume):
        sd = load_dino_weights(os.path.join(args.resume, "weights.msgpack"))
        with torch.no_grad():  # in place: the optimizer holds these tensors
            for k, v in state.params.items():
                v.copy_(sd[k])
            for k, v in state.stats.items():
                if k in sd:
                    v.copy_(sd[k])
        logger.info(f"resumed weights from {args.resume}")

    def evaluate() -> Dict[str, float]:
        val_ds = CocoDetection(args.val_json, args.val_root)
        val_mapper = ViewSamplingMapper(val_ds, size, args.max_gt, train=False)
        return evaluate_detector(state, val_mapper, logger,
                                 class_agnostic=args.class_agnostic_eval,
                                 evaluator=args.evaluator)

    t0 = time.time()
    for it, batch in enumerate(detection_batches(mapper, args.batch_size, shuffle=True)):
        if it >= args.max_iter:
            break
        arrs = [torch.as_tensor(batch[k], device=device) for k in
                ("image", "weak_image", "labels", "boxes", "valid")]
        arrs[2] = arrs[2].long()
        masks = batch.get("masks")
        arrs.append(None if masks is None else torch.as_tensor(masks, device=device))
        metrics = state.train_step(arrs)
        if (it + 1) % 20 == 0 or it + 1 == args.max_iter:
            loss = float(metrics["loss"])
            ips = args.batch_size * (it + 1) / (time.time() - t0)
            writer.add_scalar("train/loss", loss, it)
            logger.info(f"iter {it + 1}/{args.max_iter} loss {loss:.4f} ({ips:.2f} img/s)")
        if (it + 1) % args.eval_period == 0 and args.val_json:
            writer.add_scalar("val/AP", evaluate()["AP"], it)

    os.makedirs(args.output, exist_ok=True)
    save_dino_weights(os.path.join(args.output, "weights.msgpack"), state.state_dict())
    save_dino_weights(os.path.join(args.output, "ema_weights.msgpack"),
                      state.state_dict(ema=True))
    logger.info(f"saved weights to {args.output}")
    stats = evaluate() if args.val_json else None
    writer.close()
    return stats


if __name__ == "__main__":
    main()
