"""COCO RLE mask codec in pure numpy: counterpart of
ir_ads_tpu/detection/rle.py (pycocotools.mask's decode without pycocotools).

Supports both uncompressed RLE ({"counts": [ints], "size": [h, w]}) and the
compressed LEB128-style string format produced by pycocotools.  COCO RLE is
column-major (Fortran order).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """pycocotools rleFrString: 6-bit varint with delta coding."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(rle: dict, h: int = None, w: int = None) -> np.ndarray:
    """rle: {"counts": list|str|bytes, "size": [h, w]} -> (h, w) uint8."""
    if "size" in rle:
        h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def encode_rle(mask: np.ndarray) -> dict:
    """(h, w) binary -> uncompressed RLE dict (column-major)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # run lengths starting with a zero-run
    diffs = np.flatnonzero(np.diff(flat)) + 1
    boundaries = np.concatenate([[0], diffs, [flat.size]])
    runs = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return {"counts": runs, "size": [h, w]}
