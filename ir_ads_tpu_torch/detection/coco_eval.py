"""COCO-style detection evaluator with the IR-ADS AR@k extensions:
counterpart of ir_ads_tpu/detection/coco_eval.py.

The standard COCO AP suite plus AR@{1,10,20,30,50,100,300,900} and
size-bucketed AR (the reference's COCOEvaluatorCustom).  The pairwise box
IoU and the greedy threshold matching run in C++ (the port's copy of the
native source, ir_ads_tpu_torch/native/cocoeval.cpp, built with g++ into
ir_ads_tpu_torch/build/ at first use and loaded with ctypes); the
PR-curve accumulation is numpy.  ``match_image_py`` and the numpy IoU are
the plain versions: ``COCOEvaluator(native=False)`` runs them.  A failed
build raises (the evaluator does not fall back silently).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
# the reference's COCOevalMaxDets AR@k set
MAX_DETS = (1, 10, 20, 30, 50, 100, 300, 900)

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "native" / "cocoeval.cpp"
LIBRARY = PKG / "build" / "libcocoeval.so"

_LIB = None


def _load_native():
    """The native library, built first where it is missing or older than
    its source; raises if g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        tmp = LIBRARY.with_name(f"libcocoeval.{os.getpid()}.so")  # concurrent builds
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"coco_eval: g++ failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, LIBRARY)
    lib = ctypes.CDLL(str(LIBRARY))
    lib.bbox_iou.restype = None
    lib.bbox_iou.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.match_image.restype = None
    lib.match_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return lib


def bbox_iou_xywh(
    dt: np.ndarray, gt: np.ndarray, iscrowd: Optional[np.ndarray] = None,
    native: bool = True,
) -> np.ndarray:
    """Pairwise IoU, COCO xywh convention (``native=False``: numpy)."""
    dt = np.ascontiguousarray(dt, np.float64)
    gt = np.ascontiguousarray(gt, np.float64)
    n_dt, n_gt = len(dt), len(gt)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt))
    crowd = np.ascontiguousarray(
        iscrowd if iscrowd is not None else np.zeros(n_gt), np.uint8
    )
    if native:
        lib = _load_native()
        out = np.zeros((n_dt, n_gt), np.float64)
        lib.bbox_iou(
            dt.ctypes.data_as(ctypes.c_void_p), n_dt,
            gt.ctypes.data_as(ctypes.c_void_p), n_gt,
            crowd.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out
    # numpy
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0
    )
    iy = np.maximum(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0
    )
    inter = ix * iy
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(crowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_image(
    ious: np.ndarray,
    gt_ignore: np.ndarray,
    gt_crowd: np.ndarray,
    thrs: np.ndarray = IOU_THRS,
    native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy matching (detections pre-sorted by score desc, gts sorted with
    ignored last).  Returns (dt_match, gt_match, dt_ignore); ``native=False``
    runs ``match_image_py``."""
    n_dt, n_gt = ious.shape
    n_thr = len(thrs)
    if native and n_dt and n_gt:
        lib = _load_native()
        ious_c = np.ascontiguousarray(ious, np.float64)
        gi = np.ascontiguousarray(gt_ignore, np.uint8)
        gc = np.ascontiguousarray(gt_crowd, np.uint8)
        th = np.ascontiguousarray(thrs, np.float64)
        dtm = np.zeros((n_thr, n_dt), np.int64)
        gtm = np.zeros((n_thr, n_gt), np.int64)
        dti = np.zeros((n_thr, n_dt), np.uint8)
        lib.match_image(
            ious_c.ctypes.data_as(ctypes.c_void_p), n_dt, n_gt,
            gi.ctypes.data_as(ctypes.c_void_p),
            gc.ctypes.data_as(ctypes.c_void_p),
            th.ctypes.data_as(ctypes.c_void_p), n_thr,
            dtm.ctypes.data_as(ctypes.c_void_p),
            gtm.ctypes.data_as(ctypes.c_void_p),
            dti.ctypes.data_as(ctypes.c_void_p),
        )
        return dtm, gtm, dti.astype(bool)
    return match_image_py(ious, gt_ignore, gt_crowd, thrs)


def match_image_py(ious, gt_ignore, gt_crowd, thrs=IOU_THRS):
    """Reference python matching (pycocotools evaluateImg semantics)."""
    n_dt, n_gt = ious.shape
    n_thr = len(thrs)
    dtm = np.zeros((n_thr, n_dt), np.int64)
    gtm = np.zeros((n_thr, n_gt), np.int64)
    dti = np.zeros((n_thr, n_dt), bool)
    for t, thr in enumerate(thrs):
        for d in range(n_dt):
            best = min(thr, 1 - 1e-10)
            m = -1
            for g in range(n_gt):
                if gtm[t, g] > 0 and not gt_crowd[g]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dti[t, d] = bool(gt_ignore[m])
            dtm[t, d] = m + 1
            gtm[t, m] = d + 1
    return dtm, gtm, dti


def mask_iou(
    pred: np.ndarray, gt: np.ndarray, iscrowd: Optional[np.ndarray] = None
) -> np.ndarray:
    """Dense binary mask IoU: pred (D, H, W), gt (G, H, W) -> (D, G).
    Vectorized as one matmul over flattened masks (pycocotools maskUtils.iou
    semantics incl. the crowd convention)."""
    d = pred.reshape(len(pred), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = d @ g.T
    d_area = d.sum(-1)[:, None]
    g_area = g.sum(-1)[None]
    union = d_area + g_area - inter
    if iscrowd is not None:
        union = np.where(iscrowd[None].astype(bool), d_area, union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvaluator:
    """Streaming evaluator.  Feed per-image predictions + GT, then
    summarize() -> dict of AP/AR metrics incl. the custom AR@k set.

    Predictions/GT boxes are COCO xywh absolute pixels.  Pass dense binary
    masks (any common resolution) to ``add_image`` for segm metrics
    (iou_type='segm' summarized alongside bbox)."""

    def __init__(
        self,
        iou_thrs: np.ndarray = IOU_THRS,
        max_dets: Sequence[int] = MAX_DETS,
        class_agnostic: bool = False,
        native: bool = True,
    ):
        self.iou_thrs = np.asarray(iou_thrs)
        self.max_dets = tuple(max_dets)
        self.class_agnostic = class_agnostic
        self.native = native
        # per (iou_type, category, area_range): lists over images
        self._results: Dict[Tuple[str, int, str], List[dict]] = {}
        self._cats: set = set()
        self._has_masks = False

    def add_image(
        self,
        pred_boxes: np.ndarray,  # (D, 4) xywh
        pred_scores: np.ndarray,
        pred_labels: np.ndarray,
        gt_boxes: np.ndarray,  # (G, 4) xywh
        gt_labels: np.ndarray,
        gt_crowd: Optional[np.ndarray] = None,
        pred_masks: Optional[np.ndarray] = None,  # (D, H, W) binary
        gt_masks: Optional[np.ndarray] = None,  # (G, H, W) binary
    ) -> None:
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_boxes), bool)
        if self.class_agnostic:
            pred_labels = np.zeros_like(pred_labels)
            gt_labels = np.zeros_like(gt_labels)
        use_masks = pred_masks is not None and gt_masks is not None
        self._has_masks |= use_masks
        cats = set(np.unique(gt_labels).tolist()) | set(
            np.unique(pred_labels).tolist()
        )
        max_det = max(self.max_dets)
        for cat in cats:
            self._cats.add(int(cat))
            d_sel = pred_labels == cat
            g_sel = gt_labels == cat
            db = pred_boxes[d_sel]
            ds = pred_scores[d_sel]
            order = np.argsort(-ds, kind="mergesort")[:max_det]
            db, ds = db[order], ds[order]
            gb = gt_boxes[g_sel]
            gc = gt_crowd[g_sel]
            g_area = gb[:, 2] * gb[:, 3] if len(gb) else np.zeros(0)
            d_area = db[:, 2] * db[:, 3] if len(db) else np.zeros(0)
            iou_tables = {}
            for aname, (lo, hi) in AREA_RANGES.items():
                g_ignore = gc | (g_area < lo) | (g_area > hi)
                # sort gts: unignored first (pycocotools)
                g_order = np.argsort(g_ignore, kind="mergesort")
                gb_s = gb[g_order]
                gi_s = g_ignore[g_order]
                gc_s = gc[g_order]
                iou_tables["bbox"] = bbox_iou_xywh(db, gb_s, gc_s, self.native)
                if use_masks:
                    iou_tables["segm"] = mask_iou(
                        pred_masks[d_sel][order], gt_masks[g_sel][g_order], gc_s
                    )
                out_of_range = (d_area < lo) | (d_area > hi)
                for iou_type, ious in iou_tables.items():
                    dtm, gtm, dti = match_image(
                        ious, gi_s, gc_s, self.iou_thrs, self.native
                    )
                    # unmatched detections outside the area range are ignored
                    dti2 = dti | ((dtm == 0) & out_of_range[None, :])
                    self._results.setdefault(
                        (iou_type, int(cat), aname), []
                    ).append(
                        dict(scores=ds, dtm=dtm, dti=dti2,
                             n_gt=int((~gi_s).sum()))
                    )

    def _accumulate(self, cat: int, aname: str, max_det: int,
                    iou_type: str = "bbox"):
        """-> (precision (T, R), recall (T,)) or None if no GT."""
        entries = self._results.get((iou_type, cat, aname), [])
        if not entries:
            return None
        scores = np.concatenate([e["scores"][:max_det] for e in entries])
        dtm = np.concatenate([e["dtm"][:, :max_det] for e in entries], axis=1)
        dti = np.concatenate([e["dti"][:, :max_det] for e in entries], axis=1)
        n_gt = sum(e["n_gt"] for e in entries)
        if n_gt == 0:
            return None
        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dti = dti[:, order]
        tps = (dtm > 0) & ~dti
        fps = (dtm == 0) & ~dti
        tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
        rc = tp_cum / n_gt
        pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
        n_thr = len(self.iou_thrs)
        precision = np.zeros((n_thr, len(REC_THRS)))
        recall = rc[:, -1] if rc.shape[1] else np.zeros(n_thr)
        for t in range(n_thr):
            p = pr[t].copy()
            # precision envelope
            for i in range(len(p) - 1, 0, -1):
                p[i - 1] = max(p[i - 1], p[i])
            idx = np.searchsorted(rc[t], REC_THRS, side="left")
            valid = idx < len(p)
            precision[t, valid] = p[idx[valid]]
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        cats = sorted(self._cats)

        def mean_ap(aname="all", max_det=100, iou=None, iou_type="bbox"):
            vals = []
            for cat in cats:
                acc = self._accumulate(cat, aname, max_det, iou_type)
                if acc is None:
                    continue
                precision, _ = acc
                if iou is None:
                    vals.append(precision.mean())
                else:
                    t = int(np.argmin(np.abs(self.iou_thrs - iou)))
                    vals.append(precision[t].mean())
            return float(np.mean(vals)) if vals else float("nan")

        def mean_ar(aname="all", max_det=100, iou_type="bbox"):
            vals = []
            for cat in cats:
                acc = self._accumulate(cat, aname, max_det, iou_type)
                if acc is None:
                    continue
                _, recall = acc
                vals.append(recall.mean())
            return float(np.mean(vals)) if vals else float("nan")

        stats = {
            "AP": mean_ap(),
            "AP50": mean_ap(iou=0.5),
            "AP75": mean_ap(iou=0.75),
            "APs": mean_ap("small"),
            "APm": mean_ap("medium"),
            "APl": mean_ap("large"),
        }
        # the reference's extended AR@k suite (COCOevalMaxDets.summarize)
        for k in self.max_dets:
            stats[f"AR@{k}"] = mean_ar(max_det=k)
        for aname in ("small", "medium", "large"):
            stats[f"AR{aname[0]}@{max(self.max_dets)}"] = mean_ar(
                aname, max(self.max_dets)
            )
        if self._has_masks:
            stats["segm_AP"] = mean_ap(iou_type="segm")
            stats["segm_AP50"] = mean_ap(iou=0.5, iou_type="segm")
            stats["segm_AR@100"] = mean_ar(max_det=100, iou_type="segm")
        return stats
