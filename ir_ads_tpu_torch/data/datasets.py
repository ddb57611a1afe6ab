"""Multimodal segmentation datasets.  Counterpart of
ir_ads_tpu/data/datasets.py: the same directory layouts, split files, class
lists, palettes and label mappings, so that the same tree gives the same
samples through either package.

Every dataset yields ``(sample_dict, label)``: modality name -> HWC uint8
array, and an HW int32 label with ``ignore_label`` on void pixels.  The
transform (data/augmentations.py) takes the dict with the label under
'mask'.  The readers take cv2 where it imports (one internal thread), else
PIL; both are imported on first read.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


@functools.lru_cache(maxsize=None)
def _cv2():
    """cv2 with one internal thread (loader workers do the parallelism), or
    None where it does not import."""
    try:
        import cv2
    except Exception:
        return None
    cv2.setNumThreads(1)
    return cv2


def _pil_image():
    from PIL import Image

    return Image


def _read_rgb(path: str) -> np.ndarray:
    """HWC uint8, 3 channels (grayscale replicated, alpha dropped, 16-bit
    scaled to 8)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            elif img.shape[-1] == 4:
                img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGB)
            else:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if img.dtype == np.uint16:
                img = (img.astype(np.float32) / 65535.0 * 255.0).astype(np.uint8)
            return img
    img = np.asarray(_pil_image().open(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.dtype == np.uint16:
        img = (img.astype(np.float32) / 65535.0 * 255.0).astype(np.uint8)
    return img


def _read_label(path: str) -> np.ndarray:
    """HW int32; palette PNGs give their indices (PIL), not their colours."""
    cv2 = _cv2()
    if cv2 is not None:
        lbl = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if lbl is not None and lbl.ndim == 2:
            return lbl.astype(np.int32)
    lbl = np.asarray(_pil_image().open(path))
    if lbl.ndim == 3:
        lbl = lbl[..., 0]
    return lbl.astype(np.int32)


def _read_split_file(path: str) -> List[str]:
    names = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                names.append(line.split(" ")[0])
    return names


def _shift_void(lbl: np.ndarray, ignore_label: int) -> np.ndarray:
    """Raw 0 (and 255) is void: label - 1, void to ``ignore_label``."""
    lbl[lbl == 255] = 0
    lbl = lbl - 1
    lbl[lbl < 0] = ignore_label
    return lbl


class SegDataset:
    """Base class: subclasses define CLASSES / PALETTE and the paths."""

    CLASSES: Sequence[str] = ()
    PALETTE: Optional[np.ndarray] = None
    ignore_label: int = 255

    def __init__(self, root, split, transform=None, modals=("img", "depth"), case=None):
        self.root = root
        self.split = split
        self.transform = transform
        self.modals = list(modals)
        self.case = case
        self.files = self._list_files()
        if not self.files:
            raise FileNotFoundError(f"No images found for {type(self).__name__} at {root}")

    @property
    def n_classes(self) -> int:
        return len(self.CLASSES)

    def __len__(self) -> int:
        return len(self.files)

    def _list_files(self) -> List[str]:
        raise NotImplementedError

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __getitem__(self, index: int):
        sample = self._load(index)
        if self.transform is not None:
            rng = np.random.default_rng(abs(hash((index, self.split))) % (2**31))
            sample = self.transform(sample, rng)
        label = sample.pop("mask")
        return sample, np.asarray(label)


class NYU(SegDataset):
    """NYUDepthv2 RGB + HHA, 40 classes: <root>/{RGB,HHA,Label}/<name>.
    {jpg,jpg,png}, splits train.txt / test.txt; raw 0 is void."""

    CLASSES = [
        "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
        "window", "bookshelf", "picture", "counter", "blinds", "desk",
        "shelves", "curtain", "dresser", "pillow", "mirror", "floor mat",
        "clothes", "ceiling", "books", "refridgerator", "television", "paper",
        "towel", "shower curtain", "box", "whiteboard", "person",
        "night stand", "toilet", "sink", "lamp", "bathtub", "bag",
        "otherstructure", "otherfurniture", "otherprop",
    ]

    def _list_files(self):
        return _read_split_file(os.path.join(
            self.root, "test.txt" if self.split == "val" else "train.txt"))

    def _load(self, index):
        name = self.files[index]
        sample = {"img": _read_rgb(os.path.join(self.root, "RGB", name + ".jpg"))}
        if "depth" in self.modals:
            sample["depth"] = _read_rgb(os.path.join(self.root, "HHA", name + ".jpg"))
        lbl = _read_label(os.path.join(self.root, "Label", name + ".png"))
        sample["mask"] = _shift_void(lbl, self.ignore_label)
        return sample


class SUN(SegDataset):
    """SUNRGBD, 37 classes: <root>/{RGB,Depth,labels}/<name>.{jpg,png,png}."""

    CLASSES = NYU.CLASSES[:37]

    def _list_files(self):
        return _read_split_file(os.path.join(
            self.root, "test.txt" if self.split == "val" else "train.txt"))

    def _load(self, index):
        name = self.files[index]
        sample = {"img": _read_rgb(os.path.join(self.root, "RGB", name + ".jpg"))}
        if "depth" in self.modals:
            sample["depth"] = _read_rgb(os.path.join(self.root, "Depth", name + ".png"))
        lbl = _read_label(os.path.join(self.root, "labels", name + ".png"))
        sample["mask"] = _shift_void(lbl, self.ignore_label)
        return sample


class MFNet(SegDataset):
    """MFNet RGB-thermal, 9 classes: <root>/{rgb,ther,labels}/<name>.png."""

    CLASSES = [
        "unlabeled", "car", "person", "bike", "curve", "car_stop",
        "guardrail", "color_cone", "bump",
    ]
    PALETTE = np.asarray(
        [[0, 0, 0], [64, 0, 128], [64, 64, 0], [0, 128, 192], [0, 0, 192],
         [128, 128, 0], [64, 64, 128], [192, 128, 128], [192, 64, 0]]
    )

    def _list_files(self):
        return _read_split_file(os.path.join(
            self.root, "test.txt" if self.split == "val" else "train.txt"))

    def _load(self, index):
        name = self.files[index]
        sample = {"img": _read_rgb(os.path.join(self.root, "rgb", name + ".png"))}
        if "thermal" in self.modals:
            sample["thermal"] = _read_rgb(os.path.join(self.root, "ther", name + ".png"))
        sample["mask"] = _read_label(os.path.join(self.root, "labels", name + ".png"))
        return sample


class PST(SegDataset):
    """PST900 RGB-thermal, 5 classes: <root>/{train,test}/{rgb,thermal,labels}/*.png."""

    CLASSES = ["Background", "Fire-Extinguisher", "Backpack", "Hand-Drill", "Survivor"]
    PALETTE = np.asarray(
        [[0, 0, 0], [100, 40, 40], [55, 90, 80], [220, 20, 60], [153, 153, 153]]
    )

    def _list_files(self):
        split = "test" if self.split == "val" else self.split
        return sorted(glob.glob(os.path.join(self.root, split, "rgb", "*.png")))

    def _load(self, index):
        rgb = self.files[index]
        sample = {"img": _read_rgb(rgb)}
        if "thermal" in self.modals:
            sample["thermal"] = _read_rgb(rgb.replace("/rgb", "/thermal"))
        sample["mask"] = _read_label(rgb.replace("/rgb", "/labels"))
        return sample


class DELIVER(SegDataset):
    """DELIVER RGB-D-E-L, 25 classes: <root>/img/<weather>/<split>/<seq>/
    *_rgb.png with sibling hha, lidar, event and semantic trees."""

    CLASSES = [
        "Building", "Fence", "Other", "Pedestrian", "Pole", "RoadLine",
        "Road", "SideWalk", "Vegetation", "Cars", "Wall", "TrafficSign",
        "Sky", "Ground", "Bridge", "RailTrack", "GroundRail", "TrafficLight",
        "Static", "Dynamic", "Water", "Terrain", "TwoWheeler", "Bus", "Truck",
    ]
    CASES = [
        "cloud", "fog", "night", "rain", "sun", "motionblur", "overexposure",
        "underexposure", "lidarjitter", "eventlowres",
    ]

    def _list_files(self):
        files = sorted(glob.glob(os.path.join(self.root, "img", "*", self.split, "*", "*.png")))
        if self.case is not None:
            assert self.case in self.CASES, f"unknown case {self.case}"
            files = [f for f in files if self.case in f]
        return files

    def _load(self, index):
        rgb = self.files[index]
        sample = {"img": _read_rgb(rgb)}
        if "depth" in self.modals:
            sample["depth"] = _read_rgb(rgb.replace("/img", "/hha").replace("_rgb", "_depth"))
        if "lidar" in self.modals:
            sample["lidar"] = _read_rgb(rgb.replace("/img", "/lidar").replace("_rgb", "_lidar"))
        if "event" in self.modals:
            ev = _read_rgb(rgb.replace("/img", "/event").replace("_rgb", "_event"))
            if ev.shape[:2] != sample["img"].shape[:2]:
                h, w = sample["img"].shape[:2]
                image = _pil_image()
                ev = np.asarray(image.fromarray(ev).resize((w, h), image.NEAREST))
            sample["event"] = ev
        lbl = _read_label(rgb.replace("/img", "/semantic").replace("_rgb", "_semantic"))
        sample["mask"] = _shift_void(lbl, self.ignore_label)
        return sample


class DeepCrack(SegDataset):
    """Crack segmentation, {background, crack}: <root>/<split>_img/* with
    <root>/<split>_lab/*.png masks, or <root>/{images,labels}/<split>/.
    RGB-only sets mirror RGB into the second stream; RGB-T sets read a
    sibling 'ther' tree."""

    CLASSES = ["background", "crack"]
    PALETTE = np.asarray([[0, 0, 0], [255, 255, 255]])

    def _list_files(self):
        for d in (os.path.join(self.root, f"{self.split}_img"),
                  os.path.join(self.root, "images", self.split)):
            if os.path.isdir(d):
                self._img_dir = d
                return sorted(
                    f for f in glob.glob(os.path.join(d, "*"))
                    if f.lower().endswith((".jpg", ".png", ".jpeg", ".bmp")))
        return []

    def _label_path(self, rgb: str) -> str:
        base = os.path.splitext(os.path.basename(rgb))[0] + ".png"
        if self._img_dir.endswith("_img"):
            return os.path.join(self._img_dir[: -len("_img")] + "_lab", base)
        return os.path.join(self.root, "labels", self.split, base)

    def _load(self, index):
        rgb_path = self.files[index]
        img = _read_rgb(rgb_path)
        sample = {"img": img}
        ther_path = rgb_path.replace("/rgb", "/ther")
        if "thermal" in self.modals and os.path.exists(ther_path):
            sample["thermal"] = _read_rgb(ther_path)
        elif len(self.modals) > 1:
            sample[self.modals[1]] = img.copy()
        lbl = _read_label(self._label_path(rgb_path))
        sample["mask"] = (lbl > 127).astype(np.int32)
        return sample


class MCubeS(SegDataset):
    """MCubeS RGB + AoLP + DoLP + NIR, 20 classes: <root>/{polL_color,
    polL_aolp_sin, polL_aolp_cos, polL_dolp, NIR_warped, GT}/<name>.{png,npy};
    splits in list_folder/{train,val}.txt; 16-bit images scaled to 8 bits; a
    192-pixel left crop removes the polarimeter's calibration strip."""

    CLASSES = [
        "asphalt", "concrete", "metal", "road_marking", "fabric", "glass",
        "plaster", "plastic", "rubber", "sand", "gravel", "ceramic",
        "cobblestone", "brick", "grass", "wood", "leaf", "water", "human",
        "sky",
    ]
    LEFT_OFFSET = 192

    def _list_files(self):
        for cand in (os.path.join(self.root, "list_folder", f"{self.split}.txt"),
                     os.path.join(self.root, f"{self.split}.txt")):
            if os.path.exists(cand):
                return _read_split_file(cand)
        return []

    def _read16(self, path):
        img = np.asarray(_pil_image().open(path))
        if img.dtype == np.uint16:
            return (img.astype(np.float32) / 65535.0 * 255.0).astype(np.uint8)
        return img.astype(np.uint8)

    def _load(self, index):
        name = self.files[index]
        lo = self.LEFT_OFFSET
        rgb = self._read16(os.path.join(self.root, "polL_color", name + ".png"))
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        sample = {"img": rgb[:, lo:]}
        if "aolp" in self.modals:
            s = np.load(os.path.join(self.root, "polL_aolp_sin", name + ".npy"))
            c = np.load(os.path.join(self.root, "polL_aolp_cos", name + ".npy"))
            aolp = np.stack([s, c, s], axis=-1)
            sample["aolp"] = np.clip((aolp * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)[:, lo:]
        if "dolp" in self.modals:
            d = np.load(os.path.join(self.root, "polL_dolp", name + ".npy"))
            dolp = np.stack([d, d, d], axis=-1)
            sample["dolp"] = np.clip(dolp * 255, 0, 255).astype(np.uint8)[:, lo:]
        if "nir" in self.modals:
            nir = self._read16(os.path.join(self.root, "NIR_warped", name + ".png"))
            if nir.ndim == 2:
                nir = np.stack([nir] * 3, -1)
            sample["nir"] = nir[:, lo:]
        lbl = _read_label(os.path.join(self.root, "GT", name + ".png"))
        sample["mask"] = lbl[:, lo:]
        return sample


class Synthetic(SegDataset):
    """Deterministic random dataset, no files: sample i of a split draws from
    ``RandomState(i + (0 if train else 10000))``; ``learnable`` gives block
    colour regions labelled by their colour octant."""

    CLASSES = [f"class_{i}" for i in range(8)]

    def __init__(self, root="", split="train", transform=None,
                 modals=("img", "depth"), case=None, length=16,
                 image_size=(64, 64), num_classes=8, learnable=False):
        self.length = length
        self.image_size = tuple(image_size)
        self.learnable = learnable or root == "learnable"
        self.CLASSES = [f"class_{i}" for i in range(num_classes)]
        super().__init__(root, split, transform, modals, case)

    def _list_files(self):
        return [str(i) for i in range(self.length)]

    def _load(self, index):
        rng = np.random.RandomState(index + (0 if self.split == "train" else 10_000))
        h, w = self.image_size
        if self.learnable:
            bs = 8
            bh, bw = -(-h // bs), -(-w // bs)
            octants = rng.randint(0, 8, (bh, bw))
            colors = (np.stack([(octants >> 2) & 1, (octants >> 1) & 1, octants & 1], -1)
                      * 200 + 28).astype(np.uint8)
            img = np.repeat(np.repeat(colors, bs, 0), bs, 1)[:h, :w]
            lbl = np.repeat(np.repeat(octants % self.n_classes, bs, 0), bs, 1)[:h, :w].astype(
                np.int32)
            sample = {"img": img}
            for m in self.modals:
                if m != "img":
                    sample[m] = img.copy()
        else:
            sample = {m: rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for m in self.modals}
            lbl = rng.randint(0, self.n_classes, (h, w)).astype(np.int32)
        lbl[:2, :2] = self.ignore_label
        sample["mask"] = lbl
        return sample


DATASETS = {
    "NYU": NYU,
    "SUN": SUN,
    "MFNet": MFNet,
    "PST": PST,
    "DELIVER": DELIVER,
    "MCubeS": MCubeS,
    "DeepCrack": DeepCrack,
    "Synthetic": Synthetic,
}


def dataset_kwargs(ds_cfg: Dict, split: str) -> Dict:
    """The config's constructor keywords for ``split``: ``DATASET.KWARGS``
    (``Synthetic``'s ``image_size``, ``num_classes``, ``length``), with
    ``DATASET.VAL_KWARGS`` over them for the val split.  Both are the
    port's keys; the JAX package's drivers construct the datasets bare."""
    kw = dict(ds_cfg.get("KWARGS") or {})
    if split == "val":
        kw.update(ds_cfg.get("VAL_KWARGS") or {})
    return kw


def get_dataset(name: str):
    if name not in DATASETS:
        raise ValueError(f"Unknown dataset {name!r}; available: {sorted(DATASETS)}")
    return DATASETS[name]
