// COCO evaluation hot loops in C++ (ctypes ABI): the port's copy of the
// JAX package's native/cocoeval.cpp, which ir_ads_tpu_torch/detection/
// coco_eval.py builds with g++ into ir_ads_tpu_torch/build/ at first use.
//
// The per-image greedy matching across IoU thresholds and the box-IoU
// matrix (pycocotools' evaluateImg semantics, the reference's
// _C.COCOevalEvaluateImages); the PR-curve accumulation is numpy on the
// Python side.
//
// Build: g++ -O3 -shared -fPIC -o libcocoeval.so cocoeval.cpp
//
// All boxes are COCO xywh.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Pairwise IoU between detections and ground truths.
// dt: (n_dt, 4), gt: (n_gt, 4), iscrowd: (n_gt,) — crowd GTs use the
// pycocotools "iou = inter / dt_area" convention.
// out: (n_dt, n_gt) row-major.
void bbox_iou(const double* dt, int64_t n_dt, const double* gt, int64_t n_gt,
              const uint8_t* iscrowd, double* out) {
  for (int64_t i = 0; i < n_dt; ++i) {
    const double dx = dt[i * 4], dy = dt[i * 4 + 1];
    const double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    const double d_area = dw * dh;
    for (int64_t j = 0; j < n_gt; ++j) {
      const double gx = gt[j * 4], gy = gt[j * 4 + 1];
      const double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      const double g_area = gw * gh;
      const double ix = std::min(dx + dw, gx + gw) - std::max(dx, gx);
      const double iy = std::min(dy + dh, gy + gh) - std::max(dy, gy);
      double iou = 0.0;
      if (ix > 0 && iy > 0) {
        const double inter = ix * iy;
        const double uni = iscrowd && iscrowd[j]
                               ? d_area
                               : d_area + g_area - inter;
        if (uni > 0) iou = inter / uni;
      }
      out[i * n_gt + j] = iou;
    }
  }
}

// Greedy per-image, per-category matching (pycocotools evaluateImg inner
// loop; reference cocoeval.cpp MatchDetectionsToGroundTruth).
//
// Inputs (detections already sorted by descending score, gts sorted so
// ignored GTs come last):
//   ious:      (n_dt, n_gt) row-major
//   gt_ignore: (n_gt,) 0/1
//   thrs:      (n_thr,) IoU thresholds
// Outputs:
//   dt_match:  (n_thr, n_dt) matched gt index + 1, 0 = unmatched
//   gt_match:  (n_thr, n_gt) matched dt index + 1
//   dt_ignore: (n_thr, n_dt) 1 if detection matched an ignored gt
void match_image(const double* ious, int64_t n_dt, int64_t n_gt,
                 const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                 const double* thrs, int64_t n_thr, int64_t* dt_match,
                 int64_t* gt_match, uint8_t* dt_ignore) {
  for (int64_t t = 0; t < n_thr; ++t) {
    const double thr = thrs[t];
    for (int64_t d = 0; d < n_dt; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t g = 0; g < n_gt; ++g) {
        // gt already matched (and not crowd) -> skip
        if (gt_match[t * n_gt + g] > 0 && !(gt_crowd && gt_crowd[g])) continue;
        // best unignored match done, this gt is ignored -> stop (gts sorted)
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        const double iou = ious[d * n_gt + g];
        if (iou < best) continue;
        best = iou;
        m = g;
      }
      if (m == -1) continue;
      dt_ignore[t * n_dt + d] = gt_ignore[m];
      dt_match[t * n_dt + d] = m + 1;
      gt_match[t * n_gt + m] = d + 1;
    }
  }
}

}  // extern "C"
