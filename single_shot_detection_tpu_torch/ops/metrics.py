"""Detection metrics: mean average precision (host-side numpy).

Port of the JAX package's ``ops/metrics.py`` (plain numpy there too, kept
as the port's own copy): greedy TP/FP assignment over score-sorted
predictions with per-GT dedup, VOC ``difficult`` exclusion, a monotone
precision envelope, and VOC 11-point or continuous AP integration.
``coco_mean_average_precision`` sweeps the COCO protocol's IoU thresholds
.50:.05:.95 over one matching pass (the greedy argmax-IoU assignment does
not depend on the threshold).

This runs on the host over the final detections, which are small; the heavy
work (decoding, NMS) already ran on the device.
"""

from __future__ import annotations

from collections import defaultdict
import logging

import numpy as np

LOC_INDEX_START = 0
LOC_INDEX_END = 4
CLASS_INDEX = 4
SCORE_INDEX = 5
DIFFICULT_INDEX = 6


def _iou_one_to_many(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """IoU of one corner box against ``[N, 4]`` corner boxes."""
    mins = np.maximum(box[:2], others[:, :2])
    maxs = np.minimum(box[2:], others[:, 2:])
    inter = np.clip(maxs[:, 0] - mins[:, 0], 0, None) * np.clip(maxs[:, 1] - mins[:, 1], 0, None)
    area_a = max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
    area_b = (np.clip(others[:, 2] - others[:, 0], 0, None)
              * np.clip(others[:, 3] - others[:, 1], 0, None))
    return inter / (area_a + area_b - inter)


def _match(predictions, gts) -> dict:
    """Threshold-independent half of the vectorized mAP.

    The greedy score-ordered assignment with per-GT dedup reduces to "the
    highest-scored prediction whose argmax-IoU GT is g wins g", which never
    crosses (image, class) group boundaries.  So: pack every group's GT into
    one padded ``[G, K, 4]`` table and compute every prediction's argmax-IoU
    GT in chunked batched numpy (no per-group python loop — COCO-scale eval
    is ~400k groups).  The IoU threshold only enters later (``_aps_at``), so
    one matching pass serves any number of thresholds.
    """
    predictions = np.asarray(predictions, dtype=np.float64)
    if predictions.ndim != 2 or predictions.size == 0:
        predictions = predictions.reshape(0, 7)
    gts = [np.asarray(g, dtype=np.float64).reshape(
        -1, np.asarray(g).shape[-1] if np.asarray(g).size else 5)
        for g in gts]

    ignore_difficult = len(gts) > 0 and gts[0].shape[1] > DIFFICULT_INDEX
    total_positive = defaultdict(int)

    # ---- padded per-(image, class) GT table ------------------------------
    n_gt = sum(len(g) for g in gts)
    gt_rows = (np.concatenate([g for g in gts if len(g)], axis=0)
               if n_gt else np.zeros((0, 7 if ignore_difficult else 5)))
    gt_img = (np.concatenate([np.full(len(g), i, np.int64)
                              for i, g in enumerate(gts) if len(g)])
              if n_gt else np.zeros(0, np.int64))
    gt_cls = gt_rows[:, CLASS_INDEX].astype(np.int64) if n_gt else np.zeros(0, np.int64)
    gt_difficult = (gt_rows[:, DIFFICULT_INDEX] != 0 if ignore_difficult and n_gt
                    else np.zeros(n_gt, bool))

    for c, tp_count in zip(*np.unique(gt_cls[~gt_difficult], return_counts=True)):
        total_positive[int(c)] = int(tp_count)
    for c in np.unique(gt_cls):  # classes whose GT is all-difficult still count
        total_positive.setdefault(int(c), 0)

    n_cls = int(max(gt_cls.max() + 1 if n_gt else 1, 1))
    gt_key = gt_img * n_cls + gt_cls
    # stable sort keeps each group's rows in file order (argmax-tie parity
    # with the reference's per-group candidate array)
    gt_order = np.argsort(gt_key, kind='stable')
    group_keys, group_start, group_count = np.unique(
        gt_key[gt_order], return_index=True, return_counts=True)
    num_groups = len(group_keys)
    K = int(group_count.max()) if num_groups else 1

    padded = np.zeros((num_groups, K, 4))
    padded_difficult = np.zeros((num_groups, K), bool)
    slot_valid = np.arange(K)[None, :] < group_count[:, None]
    if n_gt:
        g_sorted = gt_rows[gt_order]
        padded[slot_valid] = g_sorted[:, LOC_INDEX_START:LOC_INDEX_END]
        padded_difficult[slot_valid] = gt_difficult[gt_order]
    gt_area = (np.clip(padded[..., 2] - padded[..., 0], 0, None)
               * np.clip(padded[..., 3] - padded[..., 1], 0, None))

    # ---- match every prediction against its group's table ----------------
    # global score order (stable, matching torch argsort descending)
    order = np.argsort(-predictions[:, 6], kind='stable')
    predictions = predictions[order]

    n = len(predictions)
    pred_cls = predictions[:, 5].astype(np.int64)
    pred_key = predictions[:, 0].astype(np.int64) * n_cls + pred_cls
    gidx = np.searchsorted(group_keys, pred_key)
    gidx_safe = np.minimum(gidx, max(num_groups - 1, 0))
    if num_groups:
        has_gt = (group_keys[gidx_safe] == pred_key) \
            & (pred_cls >= 0) & (pred_cls < n_cls)
    else:
        has_gt = np.zeros(n, bool)

    best = np.zeros(n, np.int64)
    best_iou = np.full(n, -np.inf)
    chunk = max(1, int(4_000_000 // max(K, 1)))
    with np.errstate(invalid='ignore', divide='ignore'):
        for lo in range(0, n if num_groups else 0, chunk):
            hi = min(lo + chunk, n)
            boxes = predictions[lo:hi, 1:5]
            cand = padded[gidx_safe[lo:hi]]            # [c, K, 4]
            valid = slot_valid[gidx_safe[lo:hi]]       # [c, K]
            mins = np.maximum(boxes[:, None, :2], cand[..., :2])
            maxs = np.minimum(boxes[:, None, 2:], cand[..., 2:])
            inter = (np.clip(maxs[..., 0] - mins[..., 0], 0, None)
                     * np.clip(maxs[..., 1] - mins[..., 1], 0, None))
            area_p = (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
                      * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))
            iou = inter / (area_p[:, None] + gt_area[gidx_safe[lo:hi]] - inter)
            iou[~valid] = -np.inf  # padding never wins argmax
            best[lo:hi] = iou.argmax(axis=1)
            best_iou[lo:hi] = iou[np.arange(hi - lo), best[lo:hi]]

    is_difficult = (padded_difficult[gidx_safe, best] & has_gt
                    if num_groups else np.zeros(n, bool))

    # extras for the COCO extended protocol (area ranges, max-dets caps)
    pred_area = (np.clip(predictions[:, 3] - predictions[:, 1], 0, None)
                 * np.clip(predictions[:, 4] - predictions[:, 2], 0, None))
    matched_gt_area = (gt_area[gidx_safe, best] if num_groups
                       else np.zeros(n))
    # per-image rank of each prediction in global score order (prediction i
    # is the rank-th best-scored detection of its image) — drives max_dets
    pred_img = predictions[:, 0].astype(np.int64)
    rank = np.zeros(n, np.int64)
    if n:
        o = np.argsort(pred_img, kind='stable')  # stable keeps score order
        starts = np.unique(pred_img[o], return_index=True)[1]
        grp = np.zeros(n, np.int64)
        grp[starts] = 1
        grp = np.cumsum(grp) - 1
        rank[o] = np.arange(n) - starts[grp]

    return {'pred_cls': pred_cls, 'has_gt': has_gt, 'best': best,
            'best_iou': best_iou, 'is_difficult': is_difficult,
            'gidx_safe': gidx_safe, 'K': K,
            'total_positive': dict(total_positive),
            'pred_area': pred_area, 'matched_gt_area': matched_gt_area,
            'pred_rank': rank,
            'gt_cls_all': gt_cls, 'gt_difficult_all': gt_difficult,
            'gt_area_all': (np.clip(gt_rows[:, 2] - gt_rows[:, 0], 0, None)
                            * np.clip(gt_rows[:, 3] - gt_rows[:, 1], 0, None)
                            if n_gt else np.zeros(0))}


def _eval_at(match: dict, iou_threshold: float, voc: bool,
             area_range=None, max_dets=None) -> tuple:
    """Per-class (AP, final recall) at one IoU threshold from ``_match``.

    ``area_range=(lo, hi)`` restricts the evaluation to GT whose box area is
    in [lo, hi] (out-of-range GT is *ignored* like VOC ``difficult``, and
    unmatched predictions whose own area is out of range are ignored rather
    than counted FP — the pycocotools convention mapped onto the reference's
    greedy matcher).  ``max_dets`` keeps only each image's top-k scored
    predictions.  Classes with zero in-range positives are dropped from the
    filtered means (pycocotools: precision/recall -1, excluded)."""
    n = len(match['pred_cls'])
    above = match['has_gt'] & (match['best_iou'] > iou_threshold)
    # matched GT ignored when difficult OR (filtered) out of the area range
    gt_ignored = match['is_difficult']
    if area_range is not None:
        lo, hi = area_range
        gt_ignored = gt_ignored | (match['has_gt']
                                   & ((match['matched_gt_area'] < lo)
                                      | (match['matched_gt_area'] > hi)))
        gt_all_in = ((match['gt_area_all'] >= lo)
                     & (match['gt_area_all'] <= hi))
        total_positive = {}
        sel_gt = ~match['gt_difficult_all'] & gt_all_in
        for c, cnt in zip(*np.unique(match['gt_cls_all'][sel_gt],
                                     return_counts=True)):
            total_positive[int(c)] = int(cnt)
    else:
        total_positive = match['total_positive']

    keep = (match['pred_rank'] < max_dets if max_dets is not None
            else np.ones(n, bool))

    # first kept eligible prediction (global score order) per (group, GT)
    # wins: np.unique's return_index picks exactly the first occurrence
    elig = np.nonzero(keep & above & ~gt_ignored)[0]
    _, first = np.unique(match['gidx_safe'][elig] * match['K']
                         + match['best'][elig], return_index=True)
    tp_flag = np.zeros(n, bool)
    tp_flag[elig[first]] = True
    # ignored predictions: matched an ignored GT, or (filtered) unmatched
    # with own area out of range
    ignored = above & gt_ignored
    if area_range is not None:
        lo, hi = area_range
        ignored = ignored | (~tp_flag & ~above
                             & ((match['pred_area'] < lo)
                                | (match['pred_area'] > hi)))
    fp_flag = keep & ~tp_flag & ~ignored
    tp_flag &= keep

    pred_cls = match['pred_cls']
    average_precision = {c: 0.0 for c in total_positive}
    final_recall = {c: 0.0 for c in total_positive if total_positive[c] > 0}

    # classes whose GT is all-difficult carry total_positive == 0: their
    # recall is 0/0 (the reference divides by zero there too); keep the
    # semantics, silence the numpy warning
    with np.errstate(invalid='ignore', divide='ignore'):
        return _per_class_eval(match, total_positive, tp_flag, fp_flag,
                               final_recall, average_precision, voc)


def _per_class_eval(match, total_positive, tp_flag, fp_flag, final_recall,
                    average_precision, voc):
    pred_cls = match['pred_cls']
    for class_index in sorted(total_positive.keys()):
        sel = pred_cls == class_index
        # drop ignored predictions (difficult matches): duplicate cumulative
        # points contribute nothing to the envelope/integral.  Deliberate
        # divergence: when a class's HIGHEST-scored prediction matches a
        # difficult GT the reference's cumulative arrays start 0/0 and its AP
        # (and whole mAP) becomes NaN (mean_average_precision.py:62-97);
        # dropping the row keeps the metric finite.
        counted = tp_flag[sel] | fp_flag[sel]
        tp = np.cumsum(tp_flag[sel][counted]).astype(np.float64)
        fp = np.cumsum(fp_flag[sel][counted]).astype(np.float64)
        if len(tp) == 0:
            tp = np.array([0.0])
            fp = np.array([1.0])

        precision = tp / (tp + fp)
        precision = np.concatenate([precision, [0.0]])
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        recall = tp / total_positive[class_index]
        if class_index in final_recall:
            final_recall[class_index] = float(recall[-1])

        if voc:
            recall = np.concatenate([recall, [1.0]])
            points = np.arange(0, 1.1, 0.1)
            indexes = (points[None, :] > recall[:, None]).sum(axis=0)
            average_precision[class_index] = float(precision[indexes].mean())
        else:
            recall = np.concatenate([[0.0], recall, [1.0]])
            average_precision[class_index] = float(
                np.dot(recall[1:] - recall[:-1], precision))

    return average_precision, final_recall


def _aps_at(match: dict, iou_threshold: float, voc: bool) -> dict:
    """Per-class AP at one IoU threshold (unfiltered protocol)."""
    return _eval_at(match, iou_threshold, voc)[0]


def mean_average_precision(predictions,
                           gts,
                           class_labels,
                           iou_threshold: float,
                           voc: bool = False,
                           verbose: bool = True) -> float:
    """Vectorized mAP with the reference's exact greedy semantics.

    Predictions matched to ``difficult`` GT are ignored (neither TP nor FP),
    exactly as mean_average_precision.py:62-69.  See ``_match`` for the
    vectorization strategy.
    """
    match = _match(predictions, gts)
    average_precision = _aps_at(match, iou_threshold, voc)

    if verbose:
        logging.info('Mean Average Precision results:')
        for class_index in sorted(average_precision.keys()):
            name = (class_labels.get(class_index, str(class_index))
                    if class_labels else str(class_index))
            logging.info(f'{name}: {average_precision[class_index]:6f}')

    if not average_precision:
        return 0.0
    map_value = sum(average_precision.values()) / len(average_precision)
    if verbose:
        logging.info(f'Total mean: {map_value:6f}')
    return map_value


COCO_THRESHOLDS = tuple(np.round(np.arange(0.50, 0.96, 0.05), 2))


# COCO area ranges in (input-space) pixels², pycocotools boundaries
COCO_AREA_RANGES = {'small': (0.0, 32.0 ** 2),
                    'medium': (32.0 ** 2, 96.0 ** 2),
                    'large': (96.0 ** 2, float('inf'))}


def coco_mean_average_precision(predictions,
                                gts,
                                class_labels=None,
                                thresholds=COCO_THRESHOLDS,
                                extended: bool = False,
                                verbose: bool = True) -> dict:
    """COCO-protocol headline numbers: mAP averaged over IoU .50:.05:.95,
    plus the mAP@.50 and mAP@.75 cut points (beyond reference parity — the
    reference only evaluates a single threshold).

    Matching semantics are the reference's greedy argmax-IoU assignment
    (NOT pycocotools' best-unmatched-above-threshold assignment), applied
    at each threshold; continuous AP integration.  One matching pass
    serves the whole sweep.  Returns ``{'mAP@[.5:.95]', 'mAP@.50',
    'mAP@.75'}``.

    ``extended=True`` adds the rest of the COCO scoreboard — area-based AP
    (``mAP-small/medium/large``; box areas in input-pipeline pixels²) and
    average recall (``AR@1/10/100`` and ``AR-small/medium/large`` at 100
    detections), each averaged over the IoU sweep.  Classes without GT in
    an area band are excluded from that band's mean (pycocotools rule).
    """
    match = _match(predictions, gts)
    per_thr = {}
    ars = {k: [] for k in ('AR@1', 'AR@10', 'AR@100')}
    area_aps = {k: [] for k in COCO_AREA_RANGES}
    area_ars = {k: [] for k in COCO_AREA_RANGES}
    for thr in thresholds:
        aps = _aps_at(match, float(thr), voc=False)
        per_thr[float(thr)] = (sum(aps.values()) / len(aps)) if aps else 0.0
        if not extended:
            continue
        for k, md in (('AR@1', 1), ('AR@10', 10), ('AR@100', 100)):
            _, rec = _eval_at(match, float(thr), voc=False, max_dets=md)
            ars[k].append(sum(rec.values()) / len(rec) if rec else 0.0)
        for name, rng in COCO_AREA_RANGES.items():
            a, rec = _eval_at(match, float(thr), voc=False,
                              area_range=rng, max_dets=100)
            area_aps[name].append(sum(a.values()) / len(a) if a else 0.0)
            area_ars[name].append(sum(rec.values()) / len(rec)
                                  if rec else 0.0)
    avg = sum(per_thr.values()) / max(len(per_thr), 1)
    out = {'mAP@[.5:.95]': avg}
    for cut, key in ((0.5, 'mAP@.50'), (0.75, 'mAP@.75')):
        if any(abs(t - cut) < 1e-9 for t in per_thr):
            out[key] = per_thr[min(per_thr, key=lambda t: abs(t - cut))]
    if extended:
        for name in COCO_AREA_RANGES:
            out[f'mAP-{name}'] = (sum(area_aps[name]) / len(area_aps[name])
                                  if area_aps[name] else 0.0)
        for k in ars:
            out[k] = sum(ars[k]) / len(ars[k]) if ars[k] else 0.0
        for name in COCO_AREA_RANGES:
            out[f'AR-{name}'] = (sum(area_ars[name]) / len(area_ars[name])
                                 if area_ars[name] else 0.0)
    if verbose:
        logging.info('COCO-protocol mAP: ' +
                     ' '.join(f'{k}={v:6f}' for k, v in out.items()))
    return out


def mean_average_precision_loop(predictions,
                                gts,
                                class_labels,
                                iou_threshold: float,
                                voc: bool = False,
                                verbose: bool = True) -> float:
    """Compute mAP (parity: mean_average_precision.py:10-116).

    Args:
      predictions: ``[N, 7]`` rows ``[image_id, x0, y0, x1, y1, class, score]``.
      gts: list over images of ``[Ni, >=5]`` rows ``[x0, y0, x1, y1, class,
        (score), (difficult)]``.
      class_labels: dict class_id -> name (for logging).
      iou_threshold: TP IoU threshold.
      voc: 11-point interpolation when True, continuous integration otherwise.
    """
    predictions = np.asarray(predictions, dtype=np.float64)
    gts = [np.asarray(g, dtype=np.float64).reshape(-1, max(np.asarray(g).shape[-1] if np.asarray(g).size else 5, 5))
           for g in gts]

    ignore_difficult = len(gts) > 0 and gts[0].shape[1] > DIFFICULT_INDEX
    total_positive = defaultdict(int)
    gt_grouped = []

    for gt in gts:
        by_class = defaultdict(list)
        for row in gt:
            class_index = int(row[CLASS_INDEX])
            by_class[class_index].append(row)
            if not ignore_difficult or row[DIFFICULT_INDEX] == 0:
                total_positive[class_index] += 1
        gt_grouped.append({c: np.stack(rows) for c, rows in by_class.items()})

    if predictions.size:
        predictions = predictions[np.argsort(-predictions[:, 6], kind='stable')]

    true_positive = defaultdict(list)
    false_positive = defaultdict(list)
    matched = defaultdict(lambda: defaultdict(set))

    for pred in predictions:
        image_id = int(pred[0])
        class_index = int(pred[5])
        box = pred[1:5]

        tp = true_positive[class_index]
        fp = false_positive[class_index]
        tp.append(0 if not tp else tp[-1])
        fp.append(0 if not fp else fp[-1])

        if class_index not in gt_grouped[image_id]:
            fp[-1] += 1
            continue

        candidates = gt_grouped[image_id][class_index]
        ious = _iou_one_to_many(box, candidates[:, LOC_INDEX_START:LOC_INDEX_END])
        index = int(np.argmax(ious))
        if ious[index] > iou_threshold:
            if not ignore_difficult or candidates[index, DIFFICULT_INDEX] == 0:
                if index not in matched[image_id][class_index]:
                    tp[-1] += 1
                    matched[image_id][class_index].add(index)
                else:
                    fp[-1] += 1
        else:
            fp[-1] += 1

    average_precision = {c: 0.0 for c in total_positive}
    if verbose:
        logging.info('Mean Average Precision results:')

    for class_index in sorted(total_positive.keys()):
        tp = np.asarray(true_positive.get(class_index, [0]), dtype=np.float64)
        fp = np.asarray(false_positive.get(class_index, [1]), dtype=np.float64)

        precision = tp / (tp + fp)
        precision = np.concatenate([precision, [0.0]])
        # monotone envelope (mean_average_precision.py:98-100)
        precision = np.maximum.accumulate(precision[::-1])[::-1]

        recall = tp / total_positive[class_index]

        if voc:
            recall = np.concatenate([recall, [1.0]])
            # 11-point interpolation: for each r in {0, .1, ..., 1.0} find the
            # first index with recall >= r (mean_average_precision.py:101-105)
            points = np.arange(0, 1.1, 0.1)
            indexes = (points[None, :] > recall[:, None]).sum(axis=0)
            average_precision[class_index] = float(precision[indexes].mean())
        else:
            recall = np.concatenate([[0.0], recall, [1.0]])
            average_precision[class_index] = float(np.dot(recall[1:] - recall[:-1], precision))

        if verbose:
            name = class_labels.get(class_index, str(class_index)) if class_labels else str(class_index)
            logging.info(f'{name}: {average_precision[class_index]:6f}')

    if not average_precision:
        return 0.0
    map_value = sum(average_precision.values()) / len(average_precision)
    if verbose:
        logging.info(f'Total mean: {map_value:6f}')
    return map_value


METRICS = {
    'mean_average_precision': mean_average_precision,
    'coco_mean_average_precision': coco_mean_average_precision,
}
