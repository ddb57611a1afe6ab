"""LVIS federated evaluation: counterpart of ir_ads_tpu/detection/lvis_eval.py,
on the port's ``COCOEvaluator``.

Reference: detectron2/detectron2/evaluation/lvis_evaluation.py (LVISEvaluator
wrapping the `lvis` package's LVISEval), used by the vCLR COCO->LVIS recipe
(projects/vCLR_deformable_mask/configs/dino-resnet/
deformable_train_coco_eval_lvis.py).  Its rules:

  * Federated inclusion: for category c and image i, the pair (i, c) enters
    c's evaluation ONLY if c has ground truth on i (positive set) or
    c is in i's ``neg_category_ids`` (verified absent).  Detections of c on
    any other image are dropped entirely (never false positives),
    because LVIS does not verify their absence there.
  * Non-exhaustive annotation: if c is in i's
    ``not_exhaustive_category_ids``, unmatched detections of c on i are
    ignored rather than counted as false positives.
  * No crowd handling (LVIS has no iscrowd), max_dets=300 default,
    and AP bucketed by category frequency: APr (rare, 1-10 training
    images), APc (common, 11-100), APf (frequent, >100).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ir_ads_tpu_torch.detection.coco_eval import COCOEvaluator


class LVISEvaluator(COCOEvaluator):
    def __init__(
        self,
        iou_thrs: Optional[np.ndarray] = None,
        max_dets: Sequence[int] = (300,),
        category_frequencies: Optional[Dict[int, str]] = None,
    ):
        """category_frequencies: cat_id -> 'r' | 'c' | 'f' (rare/common/
        frequent), as given by LVIS category metadata ('frequency')."""
        kw = {} if iou_thrs is None else {"iou_thrs": iou_thrs}
        super().__init__(max_dets=max_dets, **kw)
        self.category_frequencies = category_frequencies or {}

    def add_image(  # noqa: D417 — extends the COCO signature
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_labels: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        neg_category_ids: Sequence[int] = (),
        not_exhaustive_category_ids: Sequence[int] = (),
        pred_masks: Optional[np.ndarray] = None,
        gt_masks: Optional[np.ndarray] = None,
    ) -> None:
        neg = set(int(c) for c in neg_category_ids)
        nel = set(int(c) for c in not_exhaustive_category_ids)
        pos = set(int(c) for c in np.unique(gt_labels).tolist())
        # Federated filter: keep only detections whose category is in
        # pos | neg for this image (lvis.LVISEval: img_pl / img_nl sets).
        keep_cats = pos | neg
        keep = np.asarray(
            [int(c) in keep_cats for c in pred_labels], dtype=bool
        )
        pred_boxes = pred_boxes[keep]
        pred_scores = pred_scores[keep]
        pred_labels = pred_labels[keep]
        if pred_masks is not None:
            pred_masks = pred_masks[keep]

        if not nel:
            super().add_image(
                pred_boxes, pred_scores, pred_labels, gt_boxes, gt_labels,
                pred_masks=pred_masks, gt_masks=gt_masks,
            )
            return

        # Split: categories annotated exhaustively go through the normal
        # path; not-exhaustive ones get their unmatched detections ignored.
        ex_keep = np.asarray(
            [int(c) not in nel for c in pred_labels], dtype=bool
        )
        ex_gt = np.asarray([int(c) not in nel for c in gt_labels], dtype=bool)
        super().add_image(
            pred_boxes[ex_keep], pred_scores[ex_keep], pred_labels[ex_keep],
            gt_boxes[ex_gt], gt_labels[ex_gt],
            pred_masks=None if pred_masks is None else pred_masks[ex_keep],
            gt_masks=None if gt_masks is None else gt_masks[ex_gt],
        )
        nel_keep = ~ex_keep
        nel_gt = ~ex_gt
        if not (nel_keep.any() or nel_gt.any()):
            return
        # Evaluate the not-exhaustive categories with every unmatched
        # detection ignored: reuse the COCO matcher, then patch dti.
        before = {
            k: len(v) for k, v in self._results.items()
        }
        super().add_image(
            pred_boxes[nel_keep], pred_scores[nel_keep],
            pred_labels[nel_keep],
            gt_boxes[nel_gt], gt_labels[nel_gt],
            pred_masks=None if pred_masks is None else pred_masks[nel_keep],
            gt_masks=None if gt_masks is None else gt_masks[nel_gt],
        )
        for key, entries in self._results.items():
            added = len(entries) - before.get(key, 0)
            if added <= 0:
                continue
            _, cat, _ = key
            if cat not in nel:
                continue
            for e in entries[-added:]:
                # unmatched -> ignored (not false positive)
                e["dti"] = e["dti"] | (e["dtm"] == 0)

    def summarize(self) -> Dict[str, float]:
        stats = super().summarize()
        # rename the headline AR to LVIS convention and add APr/APc/APf
        md = max(self.max_dets)
        out = {
            "AP": stats["AP"], "AP50": stats["AP50"], "AP75": stats["AP75"],
            "APs": stats["APs"], "APm": stats["APm"], "APl": stats["APl"],
            f"AR@{md}": stats.get(f"AR@{md}", float("nan")),
        }
        if self.category_frequencies:
            for bucket, name in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                vals = []
                for cat in sorted(self._cats):
                    if self.category_frequencies.get(int(cat)) != bucket:
                        continue
                    acc = self._accumulate(cat, "all", md)
                    if acc is None:
                        continue
                    vals.append(acc[0].mean())
                out[name] = float(np.mean(vals)) if vals else float("nan")
        return out
