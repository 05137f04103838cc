"""Greedy IoU non-maximum suppression (vectorized, numpy).

A copy of lvd_tpu/eval/nms.py; parity target of both: the reference's
utils/eval/eval.py:5-132 (`nms`,
`class_aware_nms`). Used to post-process OWL-ViT detections before the
benchmark predicates run.
"""

from __future__ import annotations

import numpy as np


def nms(boxes, scores, labels, threshold, input_in_pixels=False):
    """Greedy NMS across all labels. Returns (boxes, scores, labels) arrays
    ordered by descending confidence."""
    boxes = np.asarray(boxes, dtype=float).reshape(-1, 4)
    scores = np.asarray(scores, dtype=float)
    labels = np.asarray(labels)
    if boxes.shape[0] == 0:
        return np.array([]), np.array([]), np.array([])

    offset = 1.0 if input_in_pixels else 0.0
    areas = (boxes[:, 2] - boxes[:, 0] + offset) * (boxes[:, 3] - boxes[:, 1] + offset)

    order = np.argsort(scores)[::-1]
    keep = []
    while order.size > 0:
        index = order[0]
        keep.append(index)
        rest = order[1:]
        x1 = np.maximum(boxes[index, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[index, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[index, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[index, 3], boxes[rest, 3])
        w = np.maximum(0.0, x2 - x1 + offset)
        h = np.maximum(0.0, y2 - y1 + offset)
        inter = w * h
        iou = inter / (areas[index] + areas[rest] - inter)
        order = rest[iou < threshold]

    keep = np.array(keep, dtype=int)
    return boxes[keep], scores[keep], labels[keep]


def class_aware_nms(boxes, scores, labels, threshold, input_in_pixels=False):
    """NMS run independently per label."""
    boxes = np.asarray(boxes, dtype=float).reshape(-1, 4)
    scores = np.asarray(scores, dtype=float)
    labels = np.asarray(labels)
    if boxes.shape[0] == 0:
        return np.array([]), np.array([]), np.array([])

    kept_boxes, kept_scores, kept_labels = [], [], []
    for label in np.unique(labels):
        sel = labels == label
        b, s, l = nms(
            boxes[sel], scores[sel], labels[sel], threshold, input_in_pixels
        )
        if len(b):
            kept_boxes.append(b)
            kept_scores.append(s)
            kept_labels.append(l)

    if not kept_boxes:
        return np.array([]), np.array([]), np.array([])
    return (
        np.concatenate(kept_boxes),
        np.concatenate(kept_scores),
        np.concatenate(kept_labels),
    )


def to_gen_box_format(box, width, height, rounding):
    """Normalized xyxy -> pixel xywh (layout-cache box format)."""
    x_min, y_min, x_max, y_max = box
    if rounding:
        return [
            round(x_min * width),
            round(y_min * height),
            round((x_max - x_min) * width),
            round((y_max - y_min) * height),
        ]
    return [
        x_min * width,
        y_min * height,
        (x_max - x_min) * width,
        (y_max - y_min) * height,
    ]
