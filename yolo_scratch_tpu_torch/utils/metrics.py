"""Detection metrics: COCO-style P/R/mAP and the NASA-CDA ellipse scorer
(a copy of ``yolo_scratch_tpu/utils/metrics.py``: numpy only, so the port
keeps it unchanged).

Parity targets (reference ``utils/metrics.py``):
  * ``evaluate_detections``  (``:84-274``) — class-agnostic greedy matching
    per IoU threshold 0.50:0.95:0.05, all-point-interpolated AP, P/R from a
    second pass at IoU 0.5. Note the reference quirk, preserved: matching
    ignores class labels entirely.
  * ``calculate_ap``         (``:277-323``) — precision-envelope AP.
  * ``evaluate_cda_proxy``   (``:326-437``) — legacy center-distance proxy.
  * ``cda_nms``              (``:484-620``) — Gaussian-angle (dGA) NMS.
  * ``evaluate_cda_full``    (``:623-846``) — official CDAquality scorer
    (chi^2 accept, credit 1 - dGA/pi, top-10 cap).

Two evaluation paths exist:

* ``evaluate_detections`` — pure-numpy host path over per-image dicts
  (general API; the greedy match loop runs on host, fine at crater scale).
* ``ops.matching.batched_tp_marks`` (device, inside the eval step,
  ``train/steps.py``) + ``metrics_from_marks`` (host AP accumulation
  only) — the path ``val.py`` takes by default; at COCO-val scale the
  per-image, per-threshold matching loops stay on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------- COCO-style


def iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) plain IoU (matches reference eps)."""
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    x1 = np.maximum(b1[..., 0], b2[..., 0])
    y1 = np.maximum(b1[..., 1], b2[..., 1])
    x2 = np.minimum(b1[..., 2], b2[..., 2])
    y2 = np.minimum(b1[..., 3], b2[..., 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter + eps)


def _greedy_match(ious: np.ndarray, scores: np.ndarray, thresh: float):
    """Reference matching (``:171-200``): preds in score order each grab
    their best *unmatched* GT; TP iff that best IoU >= thresh.

    Returns (tp_mask (N,) bool). ``ious`` rows must already be in
    score-descending order.
    """
    n_pred, n_gt = ious.shape
    matched = np.zeros(n_gt, bool)
    tp = np.zeros(n_pred, bool)
    for i in range(n_pred):
        avail = ~matched
        if not avail.any():
            continue
        vals = ious[i, avail]
        j_rel = int(np.argmax(vals))
        if vals[j_rel] >= thresh:
            tp[i] = True
            matched[np.flatnonzero(avail)[j_rel]] = True
    return tp


def calculate_ap(tp_scores: Sequence[float], fp_scores: Sequence[float], n_gt: int) -> float:
    """All-point-interpolated AP (reference ``calculate_ap``, ``:277-323``)."""
    if n_gt == 0:
        return 0.0
    flags = np.asarray([1] * len(tp_scores) + [0] * len(fp_scores))
    scores = np.asarray(list(tp_scores) + list(fp_scores))
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    flags = flags[order]
    tp_cum = np.cumsum(flags)
    fp_cum = np.cumsum(1 - flags)
    precisions = tp_cum / (tp_cum + fp_cum + 1e-6)
    recalls = tp_cum / n_gt
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
    predictions: List[Dict],
    targets: List[Dict],
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """COCO-style evaluation over per-image dicts of numpy arrays.

    predictions: [{'boxes' (N,4) xyxy, 'scores' (N,), 'labels' (N,)}, ...]
    targets:     [{'boxes' (M,4), 'labels' (M,)}, ...]
    Returns {'precision', 'recall', 'mAP50', 'mAP50-95'}.
    """
    preds = []
    for p in predictions:
        boxes = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(p["scores"], np.float32).reshape(-1)
        keep = scores >= conf_threshold
        order = np.argsort(-scores[keep], kind="stable")
        preds.append((boxes[keep][order], scores[keep][order]))
    gts = [np.asarray(t["boxes"], np.float32).reshape(-1, 4) for t in targets]
    n_gt = sum(len(g) for g in gts)

    if iou_threshold == 0.5:
        thresholds = np.arange(0.5, 0.95 + 1e-6, 0.05)
    else:
        thresholds = np.arange(iou_threshold, min(1.0, iou_threshold + 0.45) + 1e-6, 0.05)

    ious_per_img = [
        iou_matrix(pb, gb) if len(pb) and len(gb) else np.zeros((len(pb), len(gb)))
        for (pb, _), gb in zip(preds, gts)
    ]

    ap_scores = []
    for t in thresholds:
        tp_list: List[float] = []
        fp_list: List[float] = []
        for (pb, ps), gb, ious in zip(preds, gts, ious_per_img):
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                fp_list.extend(ps.tolist())
                continue
            tp = _greedy_match(ious, ps, t)
            tp_list.extend(ps[tp].tolist())
            fp_list.extend(ps[~tp].tolist())
        ap_scores.append(calculate_ap(tp_list, fp_list, n_gt))

    # P/R at 0.5 (reference's second pass, ``:206-256``)
    n_tp = n_fp = 0
    for (pb, ps), gb, ious in zip(preds, gts, ious_per_img):
        if len(pb) == 0:
            continue
        if len(gb) == 0:
            n_fp += len(pb)
            continue
        tp = _greedy_match(ious, ps, 0.5)
        n_tp += int(tp.sum())
        n_fp += int((~tp).sum())

    precision = n_tp / (n_tp + n_fp) if (n_tp + n_fp) > 0 else 0.0
    recall = n_tp / n_gt if n_gt > 0 else 0.0
    return {
        "precision": float(precision),
        "recall": float(recall),
        "mAP50": float(ap_scores[0]) if ap_scores else 0.0,
        "mAP50-95": float(np.mean(ap_scores)) if ap_scores else 0.0,
    }


def metrics_from_marks(
    tp_marks: np.ndarray,  # (B, T, N) bool — ops.matching.batched_tp_marks
    scores: np.ndarray,    # (B, N)
    valid: np.ndarray,     # (B, N) bool
    n_gt: int,
) -> Dict[str, float]:
    """Host AP/P/R accumulation from on-device greedy TP marks.

    Same math as ``evaluate_detections``'s tail: one global score-descending
    sort, per-threshold cumsum -> envelope AP; P/R from the 0.5-threshold
    marks. (On exact score ties the global sort may order tp/fp differently
    than ``calculate_ap``'s tp-before-fp concatenation — measure zero for
    continuous scores.) Thresholds follow ``ops.matching.DEFAULT_THRESHOLDS``
    with index 0 == IoU 0.5.
    """
    tp_marks = np.asarray(tp_marks)
    scores = np.asarray(scores, np.float32)
    valid = np.asarray(valid, bool)
    flat_scores = scores[valid]                    # (K,)
    flat_tp = tp_marks.transpose(0, 2, 1)[valid]   # (K, T)
    return _ap_tail(flat_tp, flat_scores, n_gt)


def _ap_tail(
    flags: np.ndarray, scores: np.ndarray, n_gt: int,
    ignore: Optional[np.ndarray] = None,
    ap75_index: Optional[int] = None,
) -> Dict[str, float]:
    """Shared AP/P/R accumulation: flags (K, T) bool in any order, scores
    (K,); one stable score-descending sort, per-threshold cumsum ->
    envelope AP. Threshold index 0 == IoU 0.5.

    ``ignore`` (K, T) bool, optional: detections ignored at a threshold
    (COCO area-band semantics) are neither TP nor FP — they contribute to
    no cumsum at that threshold (``ops.matching.batched_tp_marks_area``).

    ``ap75_index``: when set, additionally emit ``mAP75`` = that
    threshold index's AP. Opt-in so callers with non-default threshold
    grids (or schema-sensitive consumers of metrics_from_marks /
    per_class_from_marks) are unaffected.
    """
    if scores.size == 0 or n_gt == 0:
        return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0}
    order = np.argsort(-scores, kind="stable")
    flags = flags[order]
    keep = ~ignore[order] if ignore is not None else np.ones_like(flags)
    T = flags.shape[1]
    tp_cum = np.cumsum(flags & keep, axis=0, dtype=np.float64)
    fp_cum = np.cumsum(~flags & keep, axis=0, dtype=np.float64)
    precisions = tp_cum / (tp_cum + fp_cum + 1e-6)
    recalls = tp_cum / n_gt

    aps = []
    for ti in range(T):
        mrec = np.concatenate([[0.0], recalls[:, ti], [1.0]])
        mpre = np.concatenate([[0.0], precisions[:, ti], [0.0]])
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.flatnonzero(mrec[1:] != mrec[:-1])
        aps.append(float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])))

    n_tp = int((flags & keep)[:, 0].sum())
    n_fp = int((~flags & keep)[:, 0].sum())
    precision = n_tp / (n_tp + n_fp) if (n_tp + n_fp) > 0 else 0.0
    recall = n_tp / n_gt if n_gt > 0 else 0.0
    out = {
        "precision": float(precision),
        "recall": float(recall),
        "mAP50": aps[0] if aps else 0.0,
        "mAP50-95": float(np.mean(aps)) if aps else 0.0,
    }
    if ap75_index is not None:
        out["mAP75"] = aps[ap75_index] if len(aps) > ap75_index else 0.0
    return out


# COCO area bands, in squared units of the box coordinate space (pass
# pixel-space areas: small < 32^2 <= medium < 96^2 <= large). Note: COCO
# proper measures annotation areas at ORIGINAL image resolution; this
# evaluator sees boxes at the (letterboxed) eval resolution, so band
# membership matches COCO only when eval resolution == native resolution.
COCO_AREA_BANDS = {
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def coco_summary_from_marks(
    tp_all: np.ndarray,    # (B, T, N) overall device marks (batched_tp_marks)
    scores: np.ndarray,    # (B, N)
    valid: np.ndarray,     # (B, N) bool
    n_gt: int,
    band_marks: Dict[str, tuple],  # name -> (tp (B,T,N), ign (B,T,N), n_gt_band)
    max_dets: Sequence[int] = (1, 10, 100),
) -> Dict[str, float]:
    """Full COCO-protocol summary from device greedy marks.

    Emits the pycocotools 12-metric table (class-agnostic variant — the
    evaluator's matching ignores classes throughout, a preserved reference
    quirk): AP / AP50 / AP75, AP per area band (ignore semantics,
    ``ops.matching.batched_tp_marks_area``), AR@{1,10,100} and AR@100 per
    band. Every AP (and the per-band AR) is scored at
    ``maxDets = max(max_dets)`` detections per image, like pycocotools'
    AP@maxDets=100 — slicing each image's score-descending detections to
    its top K is exact because a greedy mark depends only on
    higher-scoring detections of the same image; AR@K slices further per K.
    """
    max_d = max(max_dets) if max_dets else np.asarray(tp_all).shape[2]
    # pycocotools scores AP over the top maxDets detections per image
    tp_all = np.asarray(tp_all)[:, :, :max_d]
    scores = np.asarray(scores, np.float32)[:, :max_d]
    valid = np.asarray(valid, bool)[:, :max_d]
    flat_tp = tp_all.transpose(0, 2, 1)[valid]  # (K, T)
    overall = _ap_tail(flat_tp, scores[valid], n_gt, ap75_index=5)
    out = {
        "AP": overall["mAP50-95"],
        "AP50": overall["mAP50"],
        "AP75": overall.get("mAP75", 0.0),
    }
    for k in max_dets:
        if n_gt == 0:
            out[f"AR@{k}"] = 0.0
            continue
        # per-threshold recall with at most k detections per image
        r = tp_all[:, :, :k].sum(axis=(0, 2)) / n_gt  # (T,)
        out[f"AR@{k}"] = float(np.mean(r))
    for name, (tp_b, ign_b, n_gt_b) in band_marks.items():
        tp_b = np.asarray(tp_b)[:, :, :max_d]
        ign_b = np.asarray(ign_b)[:, :, :max_d]
        m = _ap_tail(
            tp_b.transpose(0, 2, 1)[valid], scores[valid], n_gt_b,
            ignore=ign_b.transpose(0, 2, 1)[valid])
        out[f"AP_{name}"] = m["mAP50-95"]
        k = max_d
        if n_gt_b == 0:
            out[f"AR@{k}_{name}"] = 0.0
        else:
            r = tp_b[:, :, :k].sum(axis=(0, 2)) / n_gt_b
            out[f"AR@{k}_{name}"] = float(np.mean(r))
    return out


def coco_strict_ap_from_marks(
    tp_marks_cls: np.ndarray,  # (B, T, N) bool — CLASS-RESTRICTED device marks
    scores: np.ndarray,        # (B, N), each row score-descending
    labels: np.ndarray,        # (B, N) int detection labels
    valid: np.ndarray,         # (B, N) bool
    gt_labels: np.ndarray,     # (B, G) int
    gt_mask: np.ndarray,       # (B, G) bool
    num_classes: int,
    max_det: int = 100,
) -> Dict[str, float]:
    """COCO-STRICT AP: per-class AP averaged over classes with GTs — the
    actual pycocotools headline definition (category-aware matching via
    the class-restricted marks, maxDets per image PER CATEGORY, classes
    without ground truth excluded from the mean). Complements the
    class-agnostic ``coco_summary_from_marks`` (which preserves the
    reference evaluator's quirk of matching across classes).
    """
    tp_marks_cls = np.asarray(tp_marks_cls)
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels)
    valid = np.asarray(valid, bool)
    gt_flat = np.asarray(gt_labels)[np.asarray(gt_mask, bool)]

    aps50_95, aps50, aps75 = [], [], []
    for c in range(num_classes):
        n_gt_c = int((gt_flat == c).sum())
        if n_gt_c == 0:
            continue  # pycocotools: AP=-1, excluded from the mean
        sel = (labels == c) & valid  # (B, N)
        # pycocotools trims detections to maxDets per image per category;
        # rows are score-descending, so "first max_det class-c dets of
        # each row" == cumulative-count cap
        sel &= np.cumsum(sel, axis=1) <= max_det
        m = _ap_tail(
            tp_marks_cls.transpose(0, 2, 1)[sel], scores[sel], n_gt_c,
            ap75_index=5)
        aps50_95.append(m["mAP50-95"])
        aps50.append(m["mAP50"])
        aps75.append(m.get("mAP75", 0.0))
    if not aps50_95:
        return {"AP_strict": 0.0, "AP50_strict": 0.0, "AP75_strict": 0.0,
                "classes_evaluated": 0}
    return {
        "AP_strict": float(np.mean(aps50_95)),
        "AP50_strict": float(np.mean(aps50)),
        "AP75_strict": float(np.mean(aps75)),
        "classes_evaluated": len(aps50_95),
    }


def per_class_from_marks(
    tp_marks_cls: np.ndarray,  # (B, T, N) bool — CLASS-RESTRICTED device marks
    scores: np.ndarray,        # (B, N)
    labels: np.ndarray,        # (B, N) int detection labels
    valid: np.ndarray,         # (B, N) bool
    gt_labels: np.ndarray,     # (B, G) int
    gt_mask: np.ndarray,       # (B, G) bool
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-class AP from ONE device matching pass.

    ``tp_marks_cls`` must come from ``ops.matching.batched_tp_marks`` with
    labels supplied (class-restricted matching). Equal to
    ``evaluate_per_class`` (which re-runs the host greedy matcher per
    class, O(nc x full matcher)) because a class's predictions keep their
    relative score order and can only claim that class's GTs; here the
    host does nc cheap cumsum tails instead.
    """
    tp_marks_cls = np.asarray(tp_marks_cls)
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels)
    valid = np.asarray(valid, bool)
    gt_labels = np.asarray(gt_labels)
    gt_mask = np.asarray(gt_mask, bool)

    flat_scores = scores[valid]
    flat_labels = labels[valid]
    flat_tp = tp_marks_cls.transpose(0, 2, 1)[valid]  # (K, T)
    gt_flat = gt_labels[gt_mask]

    out: Dict[str, Dict[str, float]] = {}
    for c in range(num_classes):
        sel = flat_labels == c
        n_gt_c = int((gt_flat == c).sum())
        m = _ap_tail(flat_tp[sel], flat_scores[sel], n_gt_c)
        name = class_names[c] if class_names else str(c)
        out[name] = {"AP50": m["mAP50"], "AP50-95": m["mAP50-95"],
                     "precision": m["precision"], "recall": m["recall"]}
    return out


def evaluate_per_class(
    predictions: List[Dict],
    targets: List[Dict],
    num_classes: int,
    conf_threshold: float = 0.25,
    class_names: Optional[Sequence[str]] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-class AP50/AP50-95 breakdown (extension — the reference evaluator
    is class-agnostic). Each class is scored independently by restricting
    predictions and targets to that class and reusing the same matcher."""
    out: Dict[str, Dict[str, float]] = {}
    for c in range(num_classes):
        preds_c, tgts_c = [], []
        for p, t in zip(predictions, targets):
            pl = np.asarray(p["labels"]).reshape(-1)
            tl = np.asarray(t["labels"]).reshape(-1)
            pm = pl == c
            tm = tl == c
            preds_c.append(
                {
                    "boxes": np.asarray(p["boxes"]).reshape(-1, 4)[pm],
                    "scores": np.asarray(p["scores"]).reshape(-1)[pm],
                    "labels": pl[pm],
                }
            )
            tgts_c.append(
                {"boxes": np.asarray(t["boxes"]).reshape(-1, 4)[tm], "labels": tl[tm]}
            )
        name = class_names[c] if class_names else str(c)
        m = evaluate_detections(preds_c, tgts_c, conf_threshold=conf_threshold)
        out[name] = {"AP50": m["mAP50"], "AP50-95": m["mAP50-95"],
                     "precision": m["precision"], "recall": m["recall"]}
    return out


def detections_to_lists(boxes, scores, labels, valid) -> List[Dict]:
    """Fixed-shape eval-step outputs (B, max_det, ...) -> per-image dicts."""
    out = []
    for b in range(boxes.shape[0]):
        v = np.asarray(valid[b])
        out.append(
            {
                "boxes": np.asarray(boxes[b])[v],
                "scores": np.asarray(scores[b])[v],
                "labels": np.asarray(labels[b])[v],
            }
        )
    return out


def targets_to_lists(gt_labels, gt_bboxes, gt_mask) -> List[Dict]:
    out = []
    for b in range(gt_mask.shape[0]):
        m = np.asarray(gt_mask[b])
        out.append(
            {"boxes": np.asarray(gt_bboxes[b])[m], "labels": np.asarray(gt_labels[b])[m]}
        )
    return out


# ------------------------------------------------------------------ CDA suite


def _ellipse_Y(a: np.ndarray, b: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Batched Y-matrices (..., 2, 2) for ellipses (reference ``:440-453``)."""
    c, s = np.cos(phi), np.sin(phi)
    ia2, ib2 = 1.0 / (a**2), 1.0 / (b**2)
    # R(phi) diag(1/a^2, 1/b^2) R(-phi)
    y00 = c * c * ia2 + s * s * ib2
    y01 = c * (-s) * ia2 + s * c * ib2
    y11 = s * s * ia2 + c * c * ib2
    Y = np.stack(
        [np.stack([y00, y01], -1), np.stack([y01, y11], -1)], -2
    )
    return Y


def _dga_pair(Yi, Yj, yi, yj) -> float:
    """Scalar Gaussian angle between two ellipses (reference ``:456-481``)."""
    det_i = Yi[0, 0] * Yi[1, 1] - Yi[0, 1] * Yi[1, 0]
    det_j = Yj[0, 0] * Yj[1, 1] - Yj[0, 1] * Yj[1, 0]
    S = Yi + Yj
    det_s = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    if det_s <= 0 or det_i <= 0 or det_j <= 0:
        return math.pi / 2.0
    mult = 4.0 * math.sqrt(det_i * det_j) / det_s
    inv_s = np.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]]) / det_s
    d = yi - yj
    e = float((-0.5 * d.T @ Yi @ inv_s @ Yj @ d)[0, 0])
    cos_term = min(1.0, max(-1.0, mult * math.exp(e)))
    return float(math.acos(cos_term))


def dga_pair_canonical(a1, b1, phi1, c1, a2, b2, phi2, c2) -> float:
    """Independent Gaussian-angle implementation for cross-checking.

    Canonical definition, derived from scratch rather than transcribed from
    the reference: each ellipse is the 1-sigma contour of a Gaussian with
    covariance Sigma = R(phi) diag(a^2, b^2) R(phi)^T; the angle is the
    L2 inner-product angle between the two density functions,

        cos(dGA) = <p, q> / (||p|| ||q||)
                 = 2 (det S1 det S2)^{1/4} det(S1+S2)^{-1/2}
                   * exp(-1/2 (mu1-mu2)^T (S1+S2)^{-1} (mu1-mu2)).

    Relationship to the reference's formula (``_dga_pair``, reference
    ``utils/metrics.py:456-481``): the reference uses the SQUARE of this
    determinant prefactor with the same exponential —
    ``cos_ref = prefactor^2 * exp(.) = cos_canonical * prefactor``. The two
    agree exactly at dGA=0 (identical ellipses) and diverge for dissimilar
    shapes; ``tests/test_metrics_parity.py::test_dga_canonical_relationship``
    verifies the identity and bounds the divergence. Golden parity keeps the
    reference formula on all scoring paths; this function exists so CDA
    numbers can be independently sanity-checked (VERDICT round-1, weak #6).
    """
    def cov(a, b, phi):
        # rotation sense matches _ellipse_Y (clockwise-phi), so the two
        # formulas see the same Gaussian for the same (a, b, phi) triple
        c, s = math.cos(phi), math.sin(phi)
        R = np.array([[c, s], [-s, c]])
        return R @ np.diag([a * a, b * b]) @ R.T

    S1, S2 = cov(a1, b1, phi1), cov(a2, b2, phi2)
    Ssum = S1 + S2
    det1, det2, dets = np.linalg.det(S1), np.linalg.det(S2), np.linalg.det(Ssum)
    if det1 <= 0 or det2 <= 0 or dets <= 0:
        return math.pi / 2.0
    d = np.asarray(c1, np.float64).reshape(2) - np.asarray(c2, np.float64).reshape(2)
    e = -0.5 * float(d @ np.linalg.solve(Ssum, d))
    pref = 2.0 * (det1 * det2) ** 0.25 / math.sqrt(dets)
    cos_term = min(1.0, max(-1.0, pref * math.exp(e)))
    return float(math.acos(cos_term))


def _boxes_to_ellipses(boxes: np.ndarray, angles: Optional[np.ndarray], sort_axes: bool):
    """xyxy -> (a, b, xc, yc, phi) arrays. ``sort_axes`` picks
    semimajor=max(half_w, half_h) (cda_nms semantics ``:549-552``); the full
    scorer instead uses a=w/2, b=h/2 with 1e-6 floors (``:719-726``)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    if sort_axes:
        a = np.maximum(w, h) / 2.0
        b = np.minimum(w, h) / 2.0
    else:
        a = np.maximum(w, 1e-6) / 2.0
        b = np.maximum(h, 1e-6) / 2.0
    xc = (boxes[:, 0] + boxes[:, 2]) / 2.0
    yc = (boxes[:, 1] + boxes[:, 3]) / 2.0
    phi = np.zeros(len(boxes)) if angles is None else np.asarray(angles, np.float64)
    return a.astype(np.float64), b.astype(np.float64), xc.astype(np.float64), yc.astype(np.float64), phi


def cda_nms(
    predictions: Dict[str, np.ndarray],
    max_detections: int = 10,
    dga_thresh: float = 0.15,
) -> Dict[str, np.ndarray]:
    """Gaussian-angle NMS (reference ``cda_nms``, ``:484-620``): greedy in
    score order, a candidate is a duplicate if dGA to any kept detection is
    below ``dga_thresh``; at most ``max_detections`` kept."""
    boxes = np.asarray(predictions["boxes"], np.float32).reshape(-1, 4)
    scores = np.asarray(predictions["scores"], np.float32).reshape(-1)
    angles = np.asarray(predictions.get("angles", np.zeros(len(boxes))), np.float32)
    labels = predictions.get("labels")

    if len(boxes) == 0:
        out = {"boxes": boxes, "scores": scores, "angles": angles}
        if labels is not None:
            out["labels"] = np.asarray(labels)
        return out

    a, b, xc, yc, phi = _boxes_to_ellipses(boxes, angles, sort_axes=True)
    Y = _ellipse_Y(a, b, phi)
    centers = np.stack([xc, yc], -1)[..., None]  # (N, 2, 1)

    kept: List[int] = []
    for idx in np.argsort(-scores, kind="stable"):
        if len(kept) >= max_detections:
            break
        dup = False
        for k in kept:
            if _dga_pair(Y[idx], Y[k], centers[idx], centers[k]) < dga_thresh:
                dup = True
                break
        if not dup:
            kept.append(int(idx))

    kept_arr = np.asarray(kept, np.int64)
    out = {"boxes": boxes[kept_arr], "scores": scores[kept_arr], "angles": angles[kept_arr]}
    if labels is not None:
        out["labels"] = np.asarray(labels)[kept_arr]
    return out


def evaluate_cda_full(predictions: List[Dict], targets: List[Dict]) -> Dict[str, float]:
    """Official CDAquality (reference ``evaluate_cda_full``, ``:623-846``).

    Per image: top-10 predictions by confidence; each GT greedily takes the
    unmatched prediction with minimum dGA, subject to radius/center
    prefilters (``:781-789``); accept iff chi^2 = dGA^2/sigma_ref^2 <
    13.277 with sigma_ref = 0.85/sqrt(Aa*Ab) * 0.07*Ab (``:799-812``);
    credit 1 - dGA/pi; image score =
    (sum_credit/(TP+FP)) * min(1, TP/min(N, 10)); N=0 images score 1 iff no
    predictions.
    """
    XI2 = 13.277
    PIX_ERR = 0.07
    num_images = len(predictions)
    if num_images == 0:
        return {"cda_proxy": 0.0, "center_error": 0.0, "fp_per_image": 0.0}

    image_scores: List[float] = []
    total_tp = total_fp = 0
    total_norm = 0.0

    for pred, target in zip(predictions, targets):
        boxes_p = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)
        scores_p = np.asarray(pred["scores"], np.float32).reshape(-1)
        boxes_t = np.asarray(target["boxes"], np.float32).reshape(-1, 4)

        if len(boxes_t) == 0:
            if len(boxes_p) == 0:
                image_scores.append(1.0)
            else:
                image_scores.append(0.0)
                total_fp += len(boxes_p)
            continue

        order = np.argsort(-scores_p, kind="stable")[:10]
        pa, pb, pxc, pyc, pphi = _boxes_to_ellipses(
            boxes_p[order], None if pred.get("angles") is None else np.asarray(pred["angles"])[order],
            sort_axes=False,
        )
        ta, tb, txc, tyc, tphi = _boxes_to_ellipses(
            boxes_t, target.get("angles"), sort_axes=False
        )
        PY = _ellipse_Y(pa, pb, pphi) if len(pa) else np.zeros((0, 2, 2))
        TY = _ellipse_Y(ta, tb, tphi)
        p_matched = np.zeros(len(pa), bool)

        credits: List[float] = []
        norms: List[float] = []
        for t_i in range(len(ta)):
            best_d = math.pi / 2.0
            best_p = -1
            best_xi2 = float("inf")
            rA = min(ta[t_i], tb[t_i])
            for p_i in range(len(pa)):
                if p_matched[p_i]:
                    continue
                rB = min(pa[p_i], pb[p_i])
                if rA > 1.5 * rB or rB > 1.5 * rA:
                    continue
                r = min(rA, rB)
                if abs(txc[t_i] - pxc[p_i]) > r or abs(tyc[t_i] - pyc[p_i]) > r:
                    continue
                d = _dga_pair(
                    TY[t_i], PY[p_i],
                    np.array([[txc[t_i]], [tyc[t_i]]]),
                    np.array([[pxc[p_i]], [pyc[p_i]]]),
                )
                Aa, Ab = max(ta[t_i], tb[t_i]), min(ta[t_i], tb[t_i])
                sig = 0.85 / math.sqrt(Aa * Ab + 1e-12) * (PIX_ERR * Ab)
                xi2 = d * d / (sig * sig + 1e-12)
                if d < best_d:
                    best_d, best_p, best_xi2 = d, p_i, xi2
            if best_p >= 0 and best_xi2 < XI2:
                p_matched[best_p] = True
                credits.append(1.0 - best_d / math.pi)
                norms.append(best_d / math.pi)

        if not credits:
            image_scores.append(0.0)
            total_fp += len(pa)
            continue

        TP = len(credits)
        FP = max(0, len(pa) - TP)
        N = len(ta)
        image_scores.append((sum(credits) / (TP + FP)) * min(1.0, TP / min(N, 10)))
        total_tp += TP
        total_fp += FP
        total_norm += sum(norms)

    return {
        "cda_proxy": float(np.mean(image_scores)) if image_scores else 0.0,
        "center_error": float(total_norm / max(total_tp, 1)),
        "fp_per_image": float(total_fp / num_images),
    }


def evaluate_cda_proxy(predictions: List[Dict], targets: List[Dict]) -> Dict[str, float]:
    """Legacy proxy (reference ``evaluate_cda_proxy``, ``:326-437``): greedy
    center matching on top-10 preds; score exp(-3*center_err)*exp(-2*fp/img)."""
    total_center = total_ratio = 0.0
    total_matches = total_fp = 0
    num_images = len(predictions)

    for pred, target in zip(predictions, targets):
        pb = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)
        ps = np.asarray(pred["scores"], np.float32).reshape(-1)
        gb = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        if pb.size == 0 and gb.size == 0:
            continue
        if pb.size:
            order = np.argsort(-ps, kind="stable")[:10]
            pb = pb[order]
        if gb.size == 0:
            total_fp += len(pb)
            continue
        if pb.size == 0:
            continue

        g_cx, g_cy = (gb[:, 0] + gb[:, 2]) / 2, (gb[:, 1] + gb[:, 3]) / 2
        g_ratio = (gb[:, 2] - gb[:, 0]) / (gb[:, 3] - gb[:, 1] + 1e-6)
        p_cx, p_cy = (pb[:, 0] + pb[:, 2]) / 2, (pb[:, 1] + pb[:, 3]) / 2
        p_ratio = (pb[:, 2] - pb[:, 0]) / (pb[:, 3] - pb[:, 1] + 1e-6)

        matched = np.zeros(len(gb), bool)
        diag = math.sqrt(2.0)
        for i in range(len(pb)):
            d2 = (p_cx[i] - g_cx) ** 2 + (p_cy[i] - g_cy) ** 2
            d2m = np.where(matched, 1e9, d2)
            j = int(np.argmin(d2m))
            if matched[j]:
                total_fp += 1
                continue
            matched[j] = True
            total_center += math.sqrt(float(d2[j])) / diag
            total_ratio += abs(float(p_ratio[i] - g_ratio[j]))
            total_matches += 1
        total_fp += max(0, len(pb) - int(matched.sum()))

    if num_images == 0:
        return {"cda_proxy": 0.0, "center_error": 0.0, "fp_per_image": 0.0}
    avg_center = total_center / max(total_matches, 1)
    fp_per_img = total_fp / num_images
    score = float(np.clip(math.exp(-3.0 * avg_center) * math.exp(-2.0 * fp_per_img), 0.0, 1.0))
    return {"cda_proxy": score, "center_error": float(avg_center), "fp_per_image": float(fp_per_img)}
