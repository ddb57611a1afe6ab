"""MVTec-AD-style open-set anomaly dataset, CutMix pseudo-anomalies and the
balanced batch stream: the port's own copy of ir_ads_tpu/anomaly/data.py
(numpy and PIL; given the same tree and seeds, bit-equal arrays).

Label protocol (the reference's mvtecad.py:150-165): 0 = normal, 1 = known
outlier, 2 = pseudo (CutMix) / OOD outlier-exposure sample.  ``know_class``
selects which defect class is "known" at train time; test uses the unseen
classes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

IMG_EXTS = (".png", ".jpg", ".jpeg", ".npy")


def _is_img(f: str) -> bool:
    return f.lower().endswith(IMG_EXTS)


def _load_image(path: str) -> Image.Image:
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.uint8)[:, :, :3]
        return Image.fromarray(arr)
    return Image.open(path).convert("RGB")


def cutmix(img: Image.Image, rng: np.random.Generator,
           area_ratio=(0.02, 0.15), aspect_ratio=0.3,
           color_jitter=0.1) -> Image.Image:
    """Paste a jittered random crop elsewhere in the image
    (reference cutmix.py:21-50)."""
    w, h = img.size
    ratio_area = rng.uniform(*area_ratio) * w * h
    log_lo, log_hi = math.log(aspect_ratio), math.log(1 / aspect_ratio)
    aspect = math.exp(rng.uniform(log_lo, log_hi))
    cut_w = int(round(math.sqrt(ratio_area * aspect)))
    cut_h = int(round(math.sqrt(ratio_area / aspect)))
    cut_w, cut_h = max(1, min(cut_w, w - 1)), max(1, min(cut_h, h - 1))
    fy = int(rng.uniform(0, h - cut_h))
    fx = int(rng.uniform(0, w - cut_w))
    patch = img.crop((fx, fy, fx + cut_w, fy + cut_h))
    if color_jitter:
        arr = np.asarray(patch).astype(np.float32)
        arr = arr * rng.uniform(1 - color_jitter, 1 + color_jitter)
        mean = arr.mean()
        arr = (arr - mean) * rng.uniform(1 - color_jitter, 1 + color_jitter) + mean
        patch = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    ty = int(rng.uniform(0, h - cut_h))
    tx = int(rng.uniform(0, w - cut_w))
    out = img.copy()
    out.paste(patch, (tx, ty, tx + cut_w, ty + cut_h))
    return out


def _rotate(img: Image.Image, rng: np.random.Generator, deg=180.0) -> Image.Image:
    return img.rotate(rng.uniform(-deg, deg), resample=Image.BILINEAR)


def _normalize(img: Image.Image, size: int) -> np.ndarray:
    arr = np.asarray(img.resize((size, size), Image.BILINEAR), np.float32)
    return (arr / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


@dataclass
class ADConfig:
    dataset_root: str
    classname: str
    know_class: Optional[str] = None
    n_anomaly: int = 10
    cont_rate: float = 0.0  # training-set pollution
    test_threshold: int = 0
    test_rate: float = 0.0
    img_size: int = 448
    outlier_root: Optional[str] = None  # OOD outlier-exposure source
    seed: int = 42


class MVTecAD:
    """File list + label assembly mirroring mvtecad.py:26-114."""

    def __init__(self, cfg: ADConfig, train: bool = True):
        self.cfg = cfg
        self.train = train
        self.root = os.path.join(cfg.dataset_root, cfg.classname)
        self.test_threshold = cfg.test_threshold or cfg.n_anomaly

        def list_dir(split):
            d = os.path.join(self.root, split, "good")
            return sorted(
                f"{split}/good/{f}" for f in os.listdir(d) if _is_img(f)
            )

        normal_data = list_dir("train")
        self.n_pollution = int(
            len(normal_data) / (1 - cfg.cont_rate) * cfg.cont_rate
        )
        if cfg.test_threshold == 0 and cfg.test_rate > 0:
            self.test_threshold = (
                int(len(normal_data) / (1 - cfg.test_rate) * cfg.test_rate)
                + cfg.n_anomaly
            )
        self.ood_data = self._get_ood_data()
        if not train:
            normal_data = list_dir("test")

        outlier_data, pollution_data = self._split_outlier()
        normal_data = normal_data + sorted(pollution_data)
        self.images = normal_data + sorted(outlier_data)
        self.labels = np.concatenate(
            [np.zeros(len(normal_data)), np.ones(len(outlier_data))]
        ).astype(np.int32)
        self.normal_idx = np.flatnonzero(self.labels == 0)
        self.outlier_idx = np.flatnonzero(self.labels == 1)

    def _get_ood_data(self) -> Optional[List[str]]:
        if self.cfg.outlier_root is None:
            return None
        ood = []
        for cl in sorted(os.listdir(self.cfg.outlier_root)):
            if cl == self.cfg.classname:
                continue
            d = os.path.join(self.cfg.outlier_root, cl, "train", "good")
            if os.path.isdir(d):
                ood += [os.path.join(d, f) for f in sorted(os.listdir(d)) if _is_img(f)]
        return ood or None

    def _split_outlier(self) -> Tuple[List[str], List[str]]:
        test_dir = os.path.join(self.root, "test")
        classes = sorted(os.listdir(test_dir))
        rng = np.random.RandomState(self.cfg.seed)

        def files_of(cl):
            return sorted(
                f"test/{cl}/{f}"
                for f in os.listdir(os.path.join(test_dir, cl))
                if _is_img(f)
            )

        if self.cfg.know_class and self.cfg.know_class in classes:
            know, unknown = [], []
            for cl in classes:
                if cl == "good":
                    continue
                (know if cl == self.cfg.know_class else unknown).extend(
                    files_of(cl)
                )
            rng.shuffle(know)
            if self.train:
                return know[: self.cfg.n_anomaly], []
            return unknown, []

        outliers = []
        for cl in classes:
            if cl != "good":
                outliers.extend(files_of(cl))
        rng.shuffle(outliers)
        if self.train:
            return (
                outliers[: self.cfg.n_anomaly],
                outliers[self.cfg.n_anomaly : self.cfg.n_anomaly + self.n_pollution],
            )
        return outliers[self.test_threshold :], []

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        """Returns (normalized HWC image, label in {0,1,2})."""
        size = self.cfg.img_size
        if self.train and index in self.normal_idx and rng.integers(2) == 0:
            if self.ood_data is None:
                # CutMix pseudo-anomaly from a random normal image
                src = int(rng.choice(self.normal_idx))
                img = _load_image(os.path.join(self.root, self.images[src]))
                img = img.resize((size, size), Image.BILINEAR)
                img = cutmix(img, rng)
                img = _rotate(img, rng)
                return _normalize(img, size), 2
            img = _load_image(str(rng.choice(self.ood_data)))
            img = _rotate(img, rng)
            return _normalize(img, size), 2
        img = _load_image(os.path.join(self.root, self.images[index]))
        if self.train:
            img = _rotate(img, rng)
        return _normalize(img, size), int(self.labels[index])


def balanced_batches(
    dataset: MVTecAD,
    batch_size: int,
    steps_per_epoch: int,
    seed: int = 10,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """2:1 normal:outlier batches (reference BalancedBatchSampler,
    dataloaders/utlis.py:10-46).  All-normal when the dataset has no known
    outliers."""
    rng = np.random.default_rng(seed)
    has_outliers = len(dataset.outlier_idx) > 0
    n_normal = 2 * batch_size // 3 if has_outliers else batch_size
    n_outlier = batch_size - n_normal

    def stream(idx_pool):
        while True:
            for i in rng.permutation(idx_pool):
                yield int(i)

    normal = stream(dataset.normal_idx)
    outlier = stream(dataset.outlier_idx) if has_outliers else None
    for _ in range(steps_per_epoch):
        idx = [next(normal) for _ in range(n_normal)]
        if outlier is not None:
            idx += [next(outlier) for _ in range(n_outlier)]
        imgs, labels = zip(*(dataset.get(i, rng) for i in idx))
        yield np.stack(imgs), np.asarray(labels, np.int32)


def test_batches(
    dataset: MVTecAD, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(0)
    for start in range(0, len(dataset), batch_size):
        idx = range(start, min(start + batch_size, len(dataset)))
        imgs, labels = zip(*(dataset.get(i, rng) for i in idx))
        yield np.stack(imgs), np.asarray(labels, np.int32)
