"""Single-image / folder inference entry point: the port's counterpart of
infer_mm.py.

    python -m ir_ads_tpu_torch.infer_mm --cfg configs/nyu_rgbd.yaml --input img.png [--dte dte.png] [--output DIR] [--overlay] [--device cuda] [--dispatch r5]

Resizes each image so that its short side is ``EVAL.IMAGE_SIZE[0]`` (both
sides up to a multiple of 32), runs the fused head, and writes the
prediction in the dataset's palette (a seeded one where the dataset has
none) at the input's size, optionally over the RGB input.  Without a
second-modality image the RGB image is mirrored into that stream.
``SemSeg.predict_array`` takes arrays and needs no PIL: its resizes are
the same bilinear and nearest resamples in torch.  Weights as val_mm.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ir_ads_tpu_torch.data.augmentations import IMAGENET_MEAN, IMAGENET_STD
from ir_ads_tpu_torch.data.datasets import get_dataset
from ir_ads_tpu_torch.evaluation.semseg_eval import make_forward_fn
from ir_ads_tpu_torch.utils.config import load_config
from ir_ads_tpu_torch.utils.logging import get_logger
from ir_ads_tpu_torch.val_mm import build_eval_model

SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp"}


def default_palette(n: int) -> np.ndarray:
    rng = np.random.RandomState(42)
    pal = rng.randint(0, 255, (n, 3))
    pal[0] = [0, 0, 0]
    return pal


def _target_size(h: int, w: int, short: int) -> Tuple[int, int]:
    scale = short / min(h, w)
    return (math.ceil(round(h * scale) / 32) * 32, math.ceil(round(w * scale) / 32) * 32)


class SemSeg:
    """``SemSeg(cfg, device, dispatch, seed)``; ``predict(rgb_path, dte_path,
    overlay)`` and ``predict_array(rgb, dte, overlay)`` return (colour
    prediction (H, W, 3) uint8 at the input's size, seconds)."""

    def __init__(self, cfg: Dict, device: str = "cuda", dispatch: str = "r5", seed: int = 0):
        self.cfg = cfg
        ds_cls = get_dataset(cfg["DATASET"]["NAME"])
        self.classes = ds_cls.CLASSES
        self.palette = (ds_cls.PALETTE if ds_cls.PALETTE is not None
                        else default_palette(len(ds_cls.CLASSES)))
        self.size = cfg["EVAL"]["IMAGE_SIZE"]
        self.device = torch.device(device)
        self.model = build_eval_model(cfg, len(self.classes), device, dispatch, seed)
        self._forward = make_forward_fn(self.model)

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """PIL bilinear resize to the aligned size, as float32 (the JAX
        infer_mm.py's)."""
        from PIL import Image

        nh, nw = _target_size(*img.shape[:2], self.size[0])
        return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR)).astype(
            np.float32)

    def predict(self, rgb_path: str, dte_path: Optional[str] = None, overlay: bool = False):
        from PIL import Image

        rgb = np.asarray(Image.open(rgb_path).convert("RGB"))
        dte = np.asarray(Image.open(dte_path).convert("RGB")) if dte_path else rgb.copy()
        x_rgb, x_dte = self.preprocess(rgb), self.preprocess(dte)
        pred, dt = self._labels(x_rgb, x_dte)
        pred = np.asarray(Image.fromarray(pred.astype(np.uint8)).resize(
            (rgb.shape[1], rgb.shape[0]), Image.NEAREST))
        return self._colour(pred, rgb, overlay), dt

    def predict_array(self, rgb: np.ndarray, dte: Optional[np.ndarray] = None,
                      overlay: bool = False):
        """``predict`` on (H, W, 3) uint8 arrays, with torch's bilinear
        (align_corners=False, no antialiasing) and nearest resamples in
        place of PIL's."""
        dte = rgb.copy() if dte is None else dte
        size = _target_size(*rgb.shape[:2], self.size[0])

        def resize(a):
            t = torch.from_numpy(np.array(a, np.float32)).permute(2, 0, 1)[None]
            return F.interpolate(t, size=size, mode="bilinear", align_corners=False)[0].permute(
                1, 2, 0).numpy()

        pred, dt = self._labels(resize(rgb), resize(dte))
        pred = F.interpolate(torch.from_numpy(pred)[None, None].float(), size=rgb.shape[:2],
                             mode="nearest")[0, 0].long().numpy()
        return self._colour(pred, rgb, overlay), dt

    def _labels(self, x_rgb: np.ndarray, x_dte: np.ndarray):
        """Normalise, run the fused head, argmax at the model's input size."""
        x_rgb = (x_rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        x_dte = x_dte / 255.0
        t0 = time.time()
        rgb = torch.from_numpy(np.ascontiguousarray(x_rgb, np.float32))[None].to(self.device)
        dte = torch.from_numpy(np.ascontiguousarray(x_dte, np.float32))[None].to(self.device)
        logits = self._forward(rgb, dte)
        if logits.shape[1:3] != rgb.shape[1:3]:  # head-native: the model's upsample
            logits = F.interpolate(logits.permute(0, 3, 1, 2), size=rgb.shape[1:3],
                                   mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        pred = logits.argmax(dim=-1)[0].cpu().numpy()
        return pred, time.time() - t0

    def _colour(self, pred: np.ndarray, rgb: np.ndarray, overlay: bool) -> np.ndarray:
        color = np.asarray(self.palette)[pred].astype(np.uint8)
        if overlay:
            color = (0.4 * rgb + 0.6 * color).astype(np.uint8)
        return color


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", type=str, default="configs/nyu_rgbd.yaml")
    ap.add_argument("--input", type=str, required=True, help="image or directory")
    ap.add_argument("--dte", type=str, default=None, help="second-modality image or directory")
    ap.add_argument("--output", type=str, default="output/inference")
    ap.add_argument("--overlay", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--dispatch", type=str, default="r5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from PIL import Image

    logger = get_logger()
    seg = SemSeg(load_config(args.cfg), args.device, args.dispatch, args.seed)
    os.makedirs(args.output, exist_ok=True)
    inputs = sorted(Path(args.input).glob("*")) if os.path.isdir(args.input) else [
        Path(args.input)]
    for p in inputs:
        if p.suffix.lower() not in SUFFIXES:
            continue
        dte_path = None
        if args.dte:
            dte_path = os.path.join(args.dte, p.name) if os.path.isdir(args.dte) else args.dte
        color, dt = seg.predict(str(p), dte_path, args.overlay)
        out = Path(args.output) / f"{p.stem}_pred.png"
        Image.fromarray(color).save(out)
        logger.info(f"{p.name}: {dt * 1000:.1f} ms -> {out}")


if __name__ == "__main__":
    main()
