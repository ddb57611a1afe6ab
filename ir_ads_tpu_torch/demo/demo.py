"""Detection demo: image, folder, video or webcam inference with boxes drawn,
and multi-object tracking over a frame sequence.  Counterpart of the JAX
package's demo/demo.py (detectron2 demo/demo.py, demo/mot_demo.py).

    python -m ir_ads_tpu_torch.demo.demo --input img.jpg --output out_vis/
    python -m ir_ads_tpu_torch.demo.demo --input frames/ --track hungarian
    python -m ir_ads_tpu_torch.demo.demo --weights out/ema_weights.msgpack --num-classes 20 \\
        --input video.mp4

The detector is the vCLR deformable-mask DINO (``detection/dino.py``) with
the JAX demo's defaults: ResNet-50, 900 queries, 6 + 6 layers, 20 classes,
frames resized to 512 x 512.  Weights come from ``--weights`` (a JAX or
port weights.msgpack, ``utils/checkpoint.load_dino_weights``), else are
drawn from seed 0, as the JAX demo draws them from its fixed key.
Post-processing is the JAX demo's: each query ranked by its best sigmoid
class score, the top min(100, queries) kept, then class-agnostic NMS
(``dino.nms_topk``).  It runs on the card in bf16, where
each frame launches the deformable-attention kernel 12 times (6 encoder, 6
decoder layers), unless ``--device cpu`` is given (f32, plain versions);
without CUDA it raises.  Video and webcam input need OpenCV.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ir_ads_tpu_torch.detection.dino import DINODetector, nms_topk

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True, help="image file, directory, video file or webcam")
    p.add_argument("--output", default="output/demo")
    p.add_argument("--weights", default="")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--num-queries", type=int, default=900)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--enc-layers", type=int, default=6)
    p.add_argument("--dec-layers", type=int, default=6)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--score-thresh", type=float, default=0.4)
    p.add_argument("--track", choices=["iou", "hungarian"], default=None,
                   help="treat the input as a frame sequence and track")
    p.add_argument("--camera", type=int, default=0, help="camera index for --input webcam")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop webcam capture after N frames")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_model(args: argparse.Namespace) -> DINODetector:
    """The demo's detector on ``args.device``: bf16 on the card, f32 on the
    CPU, in eval mode."""
    from ir_ads_tpu_torch.serve import cast_model_, init_random_
    from ir_ads_tpu_torch.utils.checkpoint import load_dino_weights

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the demo: CUDA is not available (pass --device cpu to run the "
                           "plain versions)")
    model = DINODetector(num_classes=args.num_classes, num_queries=args.num_queries,
                         embed_dim=args.embed_dim, num_encoder_layers=args.enc_layers,
                         num_decoder_layers=args.dec_layers, backbone_arch=args.backbone,
                         max_gt=1, dn_number=0)
    if args.weights:
        model.load_state_dict(load_dino_weights(args.weights))
    else:
        init_random_(model, 0)
    if device.type == "cuda":
        cast_model_(model, torch.bfloat16)
    return model.to(device).eval()


def postprocess(out: Dict, num_queries: int):
    """(scores (B, k), boxes xyxy normalised (B, k, 4), keep (B, k), every
    query's best class (B, Q)), k = min(100, queries)."""
    scores = torch.sigmoid(out["pred_logits"][-1].float())
    s, xyxy, keep = nms_topk(scores.amax(-1), out["pred_boxes"][-1],
                             topk=min(100, num_queries))
    return s, xyxy, keep, scores.argmax(-1)


def make_infer(model: DINODetector, num_queries: int):
    """(1, S, S, 3) float RGB in [0, 255] (numpy) -> ``postprocess``'s tuple."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def infer(img):
        return postprocess(model(torch.as_tensor(img, device=device), want_masks=False),
                           num_queries)

    return infer


def load_image(img: np.ndarray, size: int) -> np.ndarray:
    """An RGB uint8 frame resized to size x size, float32 (the JAX demo's)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((size, size))).astype(np.float32)


def draw(img: np.ndarray, boxes, scores, keep, thresh) -> np.ndarray:
    from PIL import Image, ImageDraw

    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    h, w = img.shape[:2]
    for box, score, k in zip(boxes, scores, keep):
        if not k or score < thresh:
            continue
        x1, y1, x2, y2 = box[0] * w, box[1] * h, box[2] * w, box[3] * h
        d.rectangle([x1, y1, x2, y2], outline=(0, 255, 0), width=2)
        d.text((x1 + 2, y1 + 2), f"{score:.2f}", fill=(255, 255, 0))
    return np.asarray(im)


def _fetch(dev):
    scores, boxes, keep, cls = dev
    return (scores[0].float().cpu().numpy(), boxes[0].float().cpu().numpy(),
            keep[0].cpu().numpy(), cls[0].cpu().numpy())


def _track(tracker, s_, b, k_, cls, thresh):
    """The frame's detections above ``thresh`` through the tracker: the
    active tracks as boxes, ``id + score / 10`` as the drawn score."""
    sel = k_ & (s_ > thresh)
    tracks = tracker.update(b[sel], cls[: len(b)][sel], s_[sel])
    boxes = np.stack([t.box for t in tracks]) if tracks else np.zeros((0, 4))
    shown = np.asarray([t.track_id + t.score / 10 for t in tracks])
    return tracks, boxes, shown, np.ones(len(boxes), bool)


def _frame(args, tracker, name, found, ms):
    """A frame's record (its detections; with a tracker also its active
    tracks as (id, box, label, score)) and what is drawn (boxes, scores,
    keep, threshold)."""
    s_, b, k_, cls = found
    rec = dict(name=name, scores=s_, boxes=b, keep=k_, classes=cls, ms=ms, tracks=None)
    if tracker is None:
        return rec, (b, s_, k_, args.score_thresh)
    tracks, b, s_, k_ = _track(tracker, s_, b, k_, cls, args.score_thresh)
    rec["tracks"] = [(t.track_id, np.array(t.box), t.label, t.score) for t in tracks]
    return rec, (b, s_, k_, 0.0)


def run_video(args, infer, tracker) -> List[Dict]:
    """Video file or webcam: a host thread decodes and preprocesses ahead
    while the card runs earlier frames (``predictors.AsyncPredictor``)."""
    from ir_ads_tpu_torch.demo.predictors import (AsyncPredictor, require_cv2, video_frames,
                                                  webcam_frames)

    cv2 = require_cv2()
    if args.input == "webcam":
        frames = webcam_frames(args.camera, args.max_frames)
        fps, stem = 25.0, "webcam"
    else:
        cap = cv2.VideoCapture(args.input)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        cap.release()
        frames = video_frames(args.input)
        stem = Path(args.input).stem
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, stem + "_det.mp4")
    writer, results, t0 = None, [], time.time()
    pipeline = AsyncPredictor(lambda img: load_image(img, args.image_size)[None], infer, _fetch)
    for n, (img, found) in enumerate(pipeline(frames)):
        rec, shown = _frame(args, tracker, f"{stem}:{n}", found, None)
        results.append(rec)
        vis = draw(np.ascontiguousarray(img), *shown)
        if writer is None:
            writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                     (vis.shape[1], vis.shape[0]))
        writer.write(vis[..., ::-1])
    if writer is not None:
        writer.release()
    dt = time.time() - t0
    print(f"{len(results)} frames in {dt:.1f}s ({len(results) / max(dt, 1e-6):.1f} fps) "
          f"-> {out_path}")
    return results


def main(argv=None) -> List[Dict]:
    """Runs the demo; returns each frame's detections (scores, boxes, keep,
    classes before tracking) and, with ``--track``, its active tracks."""
    from PIL import Image

    from ir_ads_tpu_torch.detection.tracking import TRACKERS

    args = parse_args(argv)
    tracker = TRACKERS[args.track]() if args.track else None
    if args.input != "webcam" and not os.path.exists(args.input):
        raise SystemExit(f"input not found: {args.input}")
    model = build_model(args)
    infer = make_infer(model, args.num_queries)
    if args.input == "webcam" or (os.path.isfile(args.input)
                                  and Path(args.input).suffix.lower() in VIDEO_EXTS):
        return run_video(args, infer, tracker)
    os.makedirs(args.output, exist_ok=True)
    paths = (sorted(Path(args.input).glob("*")) if os.path.isdir(args.input)
             else [Path(args.input)])
    sync = torch.cuda.synchronize if model.pixel_mean.is_cuda else (lambda: None)
    results = []
    for path in paths:
        if path.suffix.lower() not in IMAGE_EXTS:
            continue
        img = np.asarray(Image.open(path).convert("RGB"))
        inp = load_image(img, args.image_size)
        t0 = time.perf_counter()
        dev = infer(inp[None])
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        rec, shown = _frame(args, tracker, path.name, _fetch(dev), ms)
        results.append(rec)
        vis = draw(img, *shown)
        out = Path(args.output) / f"{path.stem}_det.png"
        Image.fromarray(vis).save(out)
        print(f"{path.name}: {ms:.0f} ms -> {out}")
    return results


if __name__ == "__main__":
    main()
