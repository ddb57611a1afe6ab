"""Detection data pipeline: counterpart of ir_ads_tpu/detection/data.py
(``CocoDetection``, ``ViewSamplingMapper``, ``detection_batches``).

COCO JSON is plain json; polygon segmentations rasterize through PIL's
``ImageDraw``; uncompressed and compressed COCO RLE decode in numpy
(``detection.rle``).  PIL is imported on first use, as the semseg readers
import it.  Every random choice draws from the numpy ``Generator`` the
caller passes, in the JAX package's order, so the same generator gives the
same sample bit for bit.

View sampling: each train image is replaced with probability 1/3 each by its
style-transferred or depth-colormap twin (where those sibling directories
exist); the original rgb is always kept as the weak view for the EMA
teacher.  Random mix / erase / grayscale apply to the student view.
Output: GT padded to ``max_gt``, boxes cxcywh normalised.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ir_ads_tpu_torch.detection.rle import decode_rle


def _pil():
    from PIL import Image, ImageDraw

    return Image, ImageDraw


def rasterize_polygons(
    polygons: List[List[float]], h: int, w: int
) -> np.ndarray:
    """COCO polygon list -> (h, w) uint8 mask via PIL."""
    Image, ImageDraw = _pil()
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        if len(poly) >= 6:
            draw.polygon([tuple(poly[i : i + 2]) for i in range(0, len(poly), 2)], fill=1)
    return np.asarray(img, dtype=np.uint8)


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    if isinstance(seg, list):
        return rasterize_polygons(seg, h, w)
    return decode_rle(seg, h, w)


@dataclass
class DetSample:
    image: np.ndarray  # strong view HWC uint8
    weak_image: np.ndarray  # original rgb HWC uint8
    boxes: np.ndarray  # (G, 4) cxcywh normalized
    labels: np.ndarray  # (G,)
    valid: np.ndarray  # (G,) bool
    masks: Optional[np.ndarray]  # (G, Hm, Wm) float or None
    image_id: int
    orig_size: Tuple[int, int]


class CocoDetection:
    """COCO-format dataset.  Layout: images under ``image_root``, optional
    sibling view roots (style / depth-colormap)."""

    def __init__(
        self,
        json_file: str,
        image_root: str,
        style_root: Optional[str] = None,
        depth_root: Optional[str] = None,
        use_masks: bool = True,
        class_ids: Optional[Sequence[int]] = None,
    ):
        with open(json_file) as f:
            coco = json.load(f)
        self.image_root = image_root
        self.style_root = style_root
        self.depth_root = depth_root
        self.use_masks = use_masks

        cats = sorted(c["id"] for c in coco.get("categories", []))
        if class_ids is not None:
            cats = [c for c in cats if c in set(class_ids)]
        self.cat_to_contiguous = {c: i for i, c in enumerate(cats)}
        self.contiguous_to_cat = {i: c for c, i in self.cat_to_contiguous.items()}
        self.num_classes = len(cats)

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["category_id"] not in self.cat_to_contiguous:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.images = [
            img for img in coco["images"] if anns_by_img.get(img["id"])
        ]
        self.anns_by_img = anns_by_img

    def __len__(self) -> int:
        return len(self.images)

    def load(self, index: int) -> Tuple[np.ndarray, dict, List[dict]]:
        info = self.images[index]
        path = os.path.join(self.image_root, info["file_name"])
        Image = _pil()[0]
        img = np.asarray(Image.open(path).convert("RGB"))
        return img, info, self.anns_by_img[info["id"]]


def random_grayscale(img: np.ndarray, rng, p=0.2) -> np.ndarray:
    if rng.random() < p:
        g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
        return np.repeat(g[..., None], 3, -1).astype(np.uint8)
    return img


def random_erase(img: np.ndarray, rng, p=0.5, max_frac=0.2, n=3) -> np.ndarray:
    if rng.random() >= p:
        return img
    img = img.copy()
    h, w = img.shape[:2]
    for _ in range(int(rng.integers(1, n + 1))):
        eh = int(rng.uniform(0.02, max_frac) * h)
        ew = int(rng.uniform(0.02, max_frac) * w)
        y = int(rng.integers(0, max(h - eh, 1)))
        x = int(rng.integers(0, max(w - ew, 1)))
        img[y : y + eh, x : x + ew] = rng.integers(0, 256, (eh, ew, 3))
    return img


def random_mix(img: np.ndarray, other: np.ndarray, rng, p=0.3) -> np.ndarray:
    """Blend with another image (dino.py random_mix)."""
    if rng.random() >= p:
        return img
    lam = rng.uniform(0.5, 0.9)
    Image = _pil()[0]
    o = np.asarray(
        Image.fromarray(other).resize((img.shape[1], img.shape[0]))
    )
    return (lam * img + (1 - lam) * o).astype(np.uint8)


class ViewSamplingMapper:
    """Per-sample processing: view selection, resize, flip, strong augs,
    static GT padding."""

    def __init__(
        self,
        dataset: CocoDetection,
        image_size: Tuple[int, int] = (512, 512),
        max_gt: int = 20,
        mask_size: Tuple[int, int] = (128, 128),
        train: bool = True,
    ):
        self.ds = dataset
        self.image_size = image_size
        self.max_gt = max_gt
        self.mask_size = mask_size
        self.train = train

    def _pick_view(self, img, info, rng) -> np.ndarray:
        roots = []
        if self.ds.style_root:
            roots.append(self.ds.style_root)
        if self.ds.depth_root:
            roots.append(self.ds.depth_root)
        if not roots or not self.train:
            return img
        choice = rng.integers(0, len(roots) + 1)
        if choice == len(roots):
            return img
        alt = os.path.join(roots[int(choice)], info["file_name"])
        alt = os.path.splitext(alt)[0] + ".png"
        if os.path.exists(alt):
            return np.asarray(_pil()[0].open(alt).convert("RGB"))
        return img

    def __call__(self, index: int, rng: np.random.Generator) -> DetSample:
        Image = _pil()[0]
        img, info, anns = self.ds.load(index)
        orig_h, orig_w = img.shape[:2]
        th, tw = self.image_size

        view = self._pick_view(img, info, rng)
        weak = img

        boxes, labels, masks = [], [], []
        for a in anns[: self.max_gt]:
            x, y, w, h = a["bbox"]
            boxes.append([(x + w / 2) / orig_w, (y + h / 2) / orig_h,
                          w / orig_w, h / orig_h])
            labels.append(self.ds.cat_to_contiguous[a["category_id"]])
            if self.ds.use_masks and "segmentation" in a:
                m = segmentation_to_mask(a["segmentation"], orig_h, orig_w)
                m = np.asarray(
                    Image.fromarray(m * 255).resize(
                        (self.mask_size[1], self.mask_size[0]), Image.BILINEAR
                    )
                )
                masks.append((m > 127).astype(np.float32))

        g = len(boxes)
        pad = self.max_gt - g
        boxes_arr = np.zeros((self.max_gt, 4), np.float32)
        labels_arr = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        if g:
            boxes_arr[:g] = np.asarray(boxes, np.float32)
            labels_arr[:g] = np.asarray(labels, np.int32)
            valid[:g] = True
        masks_arr = None
        if self.ds.use_masks:
            masks_arr = np.zeros((self.max_gt, *self.mask_size), np.float32)
            for i, m in enumerate(masks):
                masks_arr[i] = m

        def resize(x):
            return np.asarray(
                Image.fromarray(x).resize((tw, th), Image.BILINEAR)
            )

        view = resize(view)
        weak = resize(weak)

        if self.train:
            if rng.random() < 0.5:  # hflip
                view = view[:, ::-1].copy()
                weak = weak[:, ::-1].copy()
                boxes_arr[:, 0] = np.where(valid, 1.0 - boxes_arr[:, 0], 0.0)
                if masks_arr is not None:
                    masks_arr = masks_arr[:, :, ::-1].copy()
            other_idx = int(rng.integers(0, len(self.ds)))
            other = resize(self.ds.load(other_idx)[0])
            view = random_mix(view, other, rng)
            view = random_erase(view, rng)
            view = random_grayscale(view, rng)

        return DetSample(
            image=view, weak_image=weak, boxes=boxes_arr, labels=labels_arr,
            valid=valid, masks=masks_arr, image_id=info["id"],
            orig_size=(orig_h, orig_w),
        )


def detection_batches(
    mapper: ViewSamplingMapper,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Yields dict batches of stacked numpy arrays."""
    n = len(mapper.ds)
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            samples = [mapper(int(i), rng) for i in idx]
            batch = {
                "image": np.stack([s.image for s in samples]).astype(np.float32),
                "weak_image": np.stack([s.weak_image for s in samples]).astype(np.float32),
                "boxes": np.stack([s.boxes for s in samples]),
                "labels": np.stack([s.labels for s in samples]),
                "valid": np.stack([s.valid for s in samples]),
                "image_id": np.asarray([s.image_id for s in samples]),
                "orig_size": np.asarray([s.orig_size for s in samples]),
            }
            if samples[0].masks is not None:
                batch["masks"] = np.stack([s.masks for s in samples])
            yield batch
        epoch += 1
