"""Multi-object tracking: a copy of ir_ads_tpu/detection/tracking.py, which
imports no JAX (detectron2/tracking/: BaseTracker, BBoxIOUTracker,
VanillaHungarianBBoxIOUTracker, used by demo/mot_demo.py); the port keeps
its own copy and imports nothing of the JAX package.

Host-side numpy: tracking is sequential per-frame logic over a handful of
boxes, not accelerator work.  Two trackers:

  * IOUTracker: greedy IoU association (d2 BBoxIOUTracker semantics).
  * HungarianIOUTracker: optimal assignment on the IoU matrix
    (d2 VanillaHungarianBBoxIOUTracker).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.maximum(
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]), 0
    )
    iy = np.maximum(
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]), 0
    )
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # xyxy
    label: int
    score: float
    lost_frames: int = 0
    age: int = 0


class _BaseIOUTracker:
    def __init__(
        self,
        iou_threshold: float = 0.5,
        max_lost_frames: int = 30,
        min_box_area: float = 0.0,
        track_same_class_only: bool = True,
    ):
        self.iou_threshold = iou_threshold
        self.max_lost_frames = max_lost_frames
        self.min_box_area = min_box_area
        self.same_class = track_same_class_only
        self.tracks: List[Track] = []
        self._next_id = 0

    def _new_track(self, box, label, score) -> Track:
        t = Track(self._next_id, np.asarray(box, float), int(label), float(score))
        self._next_id += 1
        return t

    def _filter(self, boxes, labels, scores):
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = area >= self.min_box_area
        return boxes[keep], labels[keep], scores[keep]

    def _assign(self, iou: np.ndarray) -> List[Tuple[int, int]]:
        raise NotImplementedError

    def update(
        self, boxes: np.ndarray, labels: np.ndarray, scores: np.ndarray
    ) -> List[Track]:
        """One frame; returns the active tracks (matched or newly created)."""
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        labels = np.asarray(labels, int).reshape(-1)
        scores = np.asarray(scores, float).reshape(-1)
        boxes, labels, scores = self._filter(boxes, labels, scores)

        prev_boxes = np.stack([t.box for t in self.tracks]) if self.tracks \
            else np.zeros((0, 4))
        iou = iou_xyxy(prev_boxes, boxes)
        if self.same_class and len(self.tracks) and len(boxes):
            prev_labels = np.asarray([t.label for t in self.tracks])
            iou = np.where(prev_labels[:, None] == labels[None], iou, 0.0)

        matches = self._assign(iou)
        matched_tracks = {m[0] for m in matches}
        matched_dets = {m[1] for m in matches}

        for ti, di in matches:
            t = self.tracks[ti]
            t.box = boxes[di]
            t.score = scores[di]
            t.label = int(labels[di])
            t.lost_frames = 0
            t.age += 1

        survivors = []
        for i, t in enumerate(self.tracks):
            if i in matched_tracks:
                survivors.append(t)
            else:
                t.lost_frames += 1
                if t.lost_frames <= self.max_lost_frames:
                    survivors.append(t)
        for di in range(len(boxes)):
            if di not in matched_dets:
                survivors.append(
                    self._new_track(boxes[di], labels[di], scores[di])
                )
        self.tracks = survivors
        return [t for t in self.tracks if t.lost_frames == 0]


class IOUTracker(_BaseIOUTracker):
    """Greedy: repeatedly take the highest IoU pair (d2 BBoxIOUTracker)."""

    def _assign(self, iou):
        iou = iou.copy()
        matches = []
        while iou.size and iou.max() >= self.iou_threshold:
            ti, di = np.unravel_index(np.argmax(iou), iou.shape)
            matches.append((int(ti), int(di)))
            iou[ti, :] = -1
            iou[:, di] = -1
        return matches


class HungarianIOUTracker(_BaseIOUTracker):
    """Optimal assignment (d2 VanillaHungarianBBoxIOUTracker)."""

    def _assign(self, iou):
        if iou.size == 0:
            return []
        rows, cols = linear_sum_assignment(-iou)
        return [
            (int(r), int(c))
            for r, c in zip(rows, cols)
            if iou[r, c] >= self.iou_threshold
        ]


TRACKERS = {"iou": IOUTracker, "hungarian": HungarianIOUTracker}
