"""Paste per-detection mask probabilities into image coordinates: a copy of
``one_peace_tpu/vision/mask_paste.py`` (held equal by
``tests/test_torch_port_coco_data.py``).  Pure numpy, on the host.

detectron2 ``paste_masks_in_image`` semantics (the reference's det app
converts 28x28 mask-head outputs to full-image instance masks this way
before COCOEvaluator scores segm AP, ref one_peace_vision/det/
lazyconfig_train_net.py:36-40 -> detectron2 inference postprocess):
for every output pixel CENTER, bilinearly sample the mask grid at the
``align_corners=False`` position relative to the detection box, zero
outside the grid, then threshold at 0.5.

Pasting happens at a configurable raster ``stride`` (the dataset stores
static-shape GT masks at stride 4), so a (N, S/4, S/4) raster is 16x
cheaper than full-res with the same matcher downstream; stride=1
reproduces detectron2 exactly.
"""

from __future__ import annotations

import numpy as np


def _bilinear_zero_pad(m: np.ndarray, fy: np.ndarray,
                       fx: np.ndarray) -> np.ndarray:
    """Sample grid ``m`` (H, W) at fractional rows fy / cols fx with
    bilinear weights and zero padding outside (grid_sample
    padding_mode='zeros')."""
    mh, mw = m.shape
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    wy1 = (fy - y0).astype(np.float32)
    wx1 = (fx - x0).astype(np.float32)
    out = np.zeros((len(fy), len(fx)), np.float32)
    for dy in (0, 1):
        yy = y0 + dy
        wy = (wy1 if dy else 1.0 - wy1) * ((yy >= 0) & (yy < mh))
        yyc = np.clip(yy, 0, mh - 1)
        for dx in (0, 1):
            xx = x0 + dx
            wx = (wx1 if dx else 1.0 - wx1) * ((xx >= 0) & (xx < mw))
            xxc = np.clip(xx, 0, mw - 1)
            out += m[np.ix_(yyc, xxc)] * (wy[:, None] * wx[None, :])
    return out


def paste_masks(masks: np.ndarray, boxes: np.ndarray, out_h: int,
                out_w: int, stride: int = 1,
                threshold: float = 0.5) -> np.ndarray:
    """masks (N, mh, mw) probabilities + boxes (N, 4) xyxy in image px
    -> (N, out_h, out_w) boolean rasters whose cell (i, j) covers image
    pixel center ((j + 0.5) * stride, (i + 0.5) * stride)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    n = len(boxes)
    out = np.zeros((n, out_h, out_w), bool)
    if n == 0:
        return out
    masks = np.asarray(masks, np.float32)
    mh, mw = masks.shape[1:]
    for i in range(n):
        x0, y0, x1, y1 = boxes[i]
        w, h = max(x1 - x0, 1e-6), max(y1 - y0, 1e-6)
        # only raster cells whose centers fall inside (a hair beyond) the
        # box can be nonzero — zero padding kills everything outside
        cx0 = max(int(np.floor(x0 / stride - 0.5)), 0)
        cx1 = min(int(np.ceil(x1 / stride + 0.5)) + 1, out_w)
        cy0 = max(int(np.floor(y0 / stride - 0.5)), 0)
        cy1 = min(int(np.ceil(y1 / stride + 0.5)) + 1, out_h)
        if cx1 <= cx0 or cy1 <= cy0:
            continue
        ys = (np.arange(cy0, cy1, dtype=np.float64) + 0.5) * stride
        xs = (np.arange(cx0, cx1, dtype=np.float64) + 0.5) * stride
        # [-1, 1] box-normalized -> align_corners=False grid position
        fy = (ys - y0) / h * mh - 0.5
        fx = (xs - x0) / w * mw - 0.5
        vals = _bilinear_zero_pad(masks[i], fy, fx)
        out[i, cy0:cy1, cx0:cx1] = vals >= threshold
    return out
