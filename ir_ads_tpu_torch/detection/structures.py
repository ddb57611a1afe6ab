"""Detection data structures: counterpart of
ir_ads_tpu/detection/structures.py (reference detectron2/structures: Boxes,
Instances, ImageList, BitMasks), host-side numpy.

The JAX package keeps static shapes, and so does the port, whose batches
come from ``detection/data.py`` in the same padded layouts:

  * ``Instances``: a NamedTuple of parallel arrays with an explicit
    ``valid`` mask in place of a dynamic-length Instances;
  * ``image_list_from``: a list of HWC images padded to one (B, H, W, C)
    batch with the images' sizes, the ImageList contract;
  * boxes are plain (N, 4) arrays, their formats those of ``box_ops``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Instances(NamedTuple):
    """Fixed-capacity instance set: padded to ``max_instances``, validity
    masked."""

    boxes: np.ndarray  # (N, 4) xyxy absolute
    labels: np.ndarray  # (N,)
    scores: np.ndarray  # (N,)
    valid: np.ndarray  # (N,) bool
    masks: Optional[np.ndarray] = None  # (N, H, W)

    def __len__(self) -> int:
        return int(self.valid.sum())

    def compact(self) -> "Instances":
        """The valid slots only."""
        v = self.valid
        return Instances(
            self.boxes[v], self.labels[v], self.scores[v],
            np.ones(int(v.sum()), bool),
            None if self.masks is None else self.masks[v],
        )


def instances_from_arrays(
    boxes, labels, scores, max_instances: int, masks=None
) -> Instances:
    """The first ``max_instances`` instances, padded with zeros to it."""
    n = len(boxes)
    k = min(n, max_instances)
    out_boxes = np.zeros((max_instances, 4), np.float32)
    out_labels = np.zeros((max_instances,), np.int32)
    out_scores = np.zeros((max_instances,), np.float32)
    valid = np.zeros((max_instances,), bool)
    out_boxes[:k] = boxes[:k]
    out_labels[:k] = labels[:k]
    out_scores[:k] = scores[:k]
    valid[:k] = True
    out_masks = None
    if masks is not None:
        out_masks = np.zeros((max_instances,) + masks.shape[1:], masks.dtype)
        out_masks[:k] = masks[:k]
    return Instances(out_boxes, out_labels, out_scores, valid, out_masks)


def image_list_from(
    images: Sequence[np.ndarray], size_divisibility: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """HWC images zero-padded at the bottom and right to a common size
    divisible by ``size_divisibility`` (d2 ImageList.from_tensors).
    Returns (batch (B, H, W, C), sizes (B, 2) of the original (h, w))."""
    sizes = np.asarray([im.shape[:2] for im in images])
    d = size_divisibility
    h = -(-int(np.max(sizes[:, 0])) // d) * d
    w = -(-int(np.max(sizes[:, 1])) // d) * d
    c = images[0].shape[2]
    batch = np.zeros((len(images), h, w, c), images[0].dtype)
    for i, im in enumerate(images):
        batch[i, : im.shape[0], : im.shape[1]] = im
    return batch, sizes
