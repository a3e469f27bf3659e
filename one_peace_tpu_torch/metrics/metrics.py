"""Evaluation metric reducers (counterpart of ``one_peace_tpu/metrics/metrics.py``).

``Recall``: R@1/5/10 from the full similarity matrix with duplicate-id
matching (ref metrics/recall.py:8-80) -- text side embedded once, image/
audio side accumulated per batch.  ``Recall.retrieval_eval`` is a copy of
the JAX package's (held equal by ``tests/test_torch_port_retrieval_data.py``).
``DetectionAP``: COCO-protocol box and mask AP (pycocotools semantics), a
copy of the JAX package's with its ragged pack / unpack helpers (held equal
by ``tests/test_torch_port_coco_data.py``).
``Accuracy``: the classification tasks' top-1 accuracy, or VQA's summed
soft scores (``ncorrect``/``count``), after the JAX package's (held equal by
``tests/test_torch_port_classify_data.py``); each batch's count stays on
the card and ``merge_results`` fetches them all at once.
One card holds the whole evaluation set, so nothing is gathered across
processes: a sharded evaluation raises in the task's
``get_batch_iterator``, and the JAX reducer's ``_sync_across_processes``
is not copied.
``MIoU``: the ADE20K mean IoU over a confusion matrix, after the JAX
package's (held equal by ``tests/test_torch_port_seg_data.py``).
``IouAcc``: RefCOCO's Acc@0.5 on boxes in the original image's
coordinates, a copy of the JAX package's ``box_iou`` and counts.
``MAP``: FSD50K's mean average precision over classes, the logits kept on
the card until one fetch at merge; each class's average precision is
sklearn's ``average_precision_score(average=None)`` rewritten in numpy
(held equal through the JAX ``MAP`` by
``tests/test_torch_port_classify_rest_data.py``): step-wise precision at
each distinct score, tied scores taken together, and 0.0 for a class with
no positive, as sklearn 1.9 gives.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def fetch_once(tree):
    """One batched host fetch for everything a reducer accumulated.

    Reducers store per-batch results WITHOUT converting (tensors on the
    card stay there), so the eval loop never waits on a host round-trip
    per batch; at merge time the tensor leaves of ``tree`` are
    concatenated on their device, one buffer per dtype, and each buffer
    crosses to the host in one copy.  bf16 leaves travel as fp32 (numpy
    has no bf16).  Returns the tree with numpy arrays for tensors."""
    fetch_once.calls += 1
    leaves, spec = pytree.tree_flatten(tree)
    groups: Dict = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            leaves[i] = leaf.detach().float() if leaf.dtype == torch.bfloat16 else leaf.detach()
            groups.setdefault((leaves[i].device, leaves[i].dtype), []).append(i)
    for members in groups.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in members]).cpu().numpy()
        parts = np.split(flat, np.cumsum([leaves[i].numel() for i in members])[:-1])
        for i, part in zip(members, parts):
            leaves[i] = part.reshape(leaves[i].shape)
    return pytree.tree_unflatten(leaves, spec)


fetch_once.calls = 0


class Recall:
    def initialize(self, text_ids, text_logits):
        # accepts arrays OR lists of (possibly device) chunks; conversion
        # is deferred to merge_results (fetch_once)
        self.text_ids = text_ids
        self.text_logits = (list(text_logits)
                            if isinstance(text_logits, list) else [text_logits])
        self.image_ids_list: List = []
        self.image_logits_list: List = []

    def compute(self, image_ids, image_logits):
        self.image_ids_list.append(image_ids)
        self.image_logits_list.append(image_logits)

    def merge_results(self, output_predict: bool = False) -> Dict:
        if not self.image_ids_list:  # no valid batches accumulated
            return {"txt_r1": 0.0, "txt_r5": 0.0, "txt_r10": 0.0,
                    "txt_r_mean": 0.0, "img_count": 0,
                    "img_r1": 0.0, "img_r5": 0.0, "img_r10": 0.0,
                    "img_r_mean": 0.0, "txt_count": 0, "r_mean": 0.0}
        got = fetch_once({
            "ti": self.text_ids, "tl": self.text_logits,
            "ii": self.image_ids_list, "il": self.image_logits_list})
        self.text_ids = np.asarray(got["ti"])
        self.text_logits = np.concatenate(
            [np.asarray(x, np.float32) for x in got["tl"]])
        image_ids = np.concatenate([np.asarray(x) for x in got["ii"]])
        image_logits = np.concatenate(
            [np.asarray(x, np.float32) for x in got["il"]])
        sim_i2t = image_logits @ self.text_logits.T
        return self.retrieval_eval(image_ids, sim_i2t, output_predict)

    def retrieval_eval(self, image_ids, scores_i2t, output_predict=False) -> Dict:
        text_ids = self.text_ids
        k = min(10, scores_i2t.shape[1])
        rank_txt = np.argsort(-scores_i2t, axis=1)[:, :k]
        predict_txt = text_ids[rank_txt]
        i2t = [
            float(np.any(predict_txt[:, :r] == image_ids[:, None], axis=1).sum())
            for r in (1, 5, 10)
        ]
        n_img = scores_i2t.shape[0]
        tr = [100.0 * c / n_img for c in i2t]

        scores_t2i = scores_i2t.T
        k2 = min(10, scores_t2i.shape[1])
        rank_img = np.argsort(-scores_t2i, axis=1)[:, :k2]
        predict_img = image_ids[rank_img]
        t2i = [
            float(np.any(predict_img[:, :r] == text_ids[:, None], axis=1).sum())
            for r in (1, 5, 10)
        ]
        n_txt = scores_t2i.shape[0]
        ir = [100.0 * c / n_txt for c in t2i]

        log = {
            "txt_r1": tr[0], "txt_r5": tr[1], "txt_r10": tr[2],
            "txt_r_mean": sum(tr) / 3, "img_count": n_img,
            "img_r1": ir[0], "img_r5": ir[1], "img_r10": ir[2],
            "img_r_mean": sum(ir) / 3, "txt_count": n_txt,
            "r_mean": (sum(tr) + sum(ir)) / 6,
        }
        if output_predict:
            log["predict_txt"] = dict(zip(image_ids.tolist(), predict_txt.tolist()))
            log["predict_img"] = dict(zip(text_ids.tolist(), predict_img.tolist()))
        return log


#: COCO area ranges in ORIGINAL-image px^2 (pycocotools params.areaRng)
_COCO_AREA_RANGES = {
    "all": (0.0, 1e10),
    "s": (0.0, 32.0 ** 2),
    "m": (32.0 ** 2, 96.0 ** 2),
    "l": (96.0 ** 2, 1e10),
}


class Accuracy:
    def initialize(self):
        self.ncorrect_list: List = []
        self.total = 0

    def compute(self, logits=None, targets=None, ncorrect=None, count=None):
        """Either ``logits`` (B, C) and integer ``targets`` (B,), counted
        by top-1, or an already summed ``ncorrect`` over ``count`` samples.
        The per-batch count stays where it was computed."""
        if ncorrect is not None:
            self.ncorrect_list.append(ncorrect)
            self.total += int(count)
        else:
            targets = torch.as_tensor(np.asarray(targets), device=logits.device)
            self.ncorrect_list.append((logits.argmax(-1) == targets).sum())
            self.total += len(targets)

    def merge_results(self) -> Dict:
        ncorrect = float(sum(float(x) for x in fetch_once(self.ncorrect_list)))
        return {"accuracy": 100.0 * ncorrect / max(self.total, 1), "count": self.total}


class IouAcc:
    """Grounding Acc@0.5: predicted boxes rescaled back to original image
    coordinates by the resize ratios (ref tasks/vl_tasks/refcoco.py:24-48)."""

    def initialize(self):
        self.ncorrect = 0.0
        self.total = 0

    @staticmethod
    def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        lt = np.maximum(a[:, :2], b[:, :2])
        rb = np.minimum(a[:, 2:], b[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        return inter / np.maximum(area_a + area_b - inter, 1e-6)

    def compute(self, pred_boxes, target_boxes, threshold: float = 0.5):
        ious = self.box_iou(np.asarray(pred_boxes), np.asarray(target_boxes))
        self.ncorrect += float((ious >= threshold).sum())
        self.total += len(ious)

    def merge_results(self) -> Dict:
        return {"acc@0.5": 100.0 * self.ncorrect / max(self.total, 1), "count": self.total}


def average_precision(target: np.ndarray, score: np.ndarray) -> float:
    """One class's average precision over (N,) binary targets and scores:
    the sum over the distinct scores, from the highest down, of the
    precision at that score times the recall it adds; tied scores form one
    step.  0.0 where no target is positive."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, target = score[order], np.asarray(target, np.float64)[order]
    last = np.r_[np.flatnonzero(np.diff(score)), score.size - 1]  # each distinct score's last row
    tps = np.cumsum(target)[last]
    if tps[-1] == 0:
        return 0.0
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


class MAP:
    """Multi-label mean average precision (ref metrics/map.py:11-35): the
    sigmoid of the logits, each class's average precision, their mean."""

    def initialize(self):
        self.logits: List = []
        self.targets: List = []

    def compute(self, ids, logits, targets):
        """``logits`` (B, C) stay where they were computed; ``targets`` (B,
        C) multi-hot."""
        self.logits.append(logits)
        self.targets.append(targets)

    def merge_results(self) -> Dict:
        if not self.logits:  # no valid batches accumulated
            return {"map": 0.0, "count": 0}
        got = fetch_once({"l": self.logits, "t": self.targets})
        logits = np.concatenate([np.asarray(x, np.float32) for x in got["l"]])
        targets = np.concatenate([np.asarray(x, np.float32) for x in got["t"]])
        preds = 1.0 / (1.0 + np.exp(-logits))
        ap = [average_precision(targets[:, c], preds[:, c]) for c in range(targets.shape[1])]
        return {"map": 100.0 * float(np.mean(ap)), "count": len(targets)}


class MIoU:
    """Semantic-segmentation mean IoU over a fixed class count (the ADE20K
    metric of the reference's seg app; ignore_index pixels excluded).  The
    segmentation task sums each batch's confusion matrix on the card and
    folds it in once (``update_confusion``)."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def initialize(self):
        n = self.num_classes
        self.intersection = np.zeros(n, np.int64)
        self.union = np.zeros(n, np.int64)

    def compute(self, pred: np.ndarray, target: np.ndarray):
        """pred/target: integer label maps of identical shape."""
        pred = np.asarray(pred).ravel()
        target = np.asarray(target).ravel()
        valid = target != self.ignore_index
        pred, target = pred[valid], target[valid]
        n = self.num_classes
        pred = np.clip(pred, 0, n - 1)
        cm = np.bincount(target.astype(np.int64) * n + pred,
                         minlength=n * n).reshape(n, n)
        self.update_confusion(cm)

    def update_confusion(self, cm: np.ndarray):
        """Fold a (C, C) confusion matrix (rows = target, cols = pred) into
        the accumulators."""
        cm = np.asarray(cm, np.int64)
        inter = np.diag(cm)
        self.intersection += inter
        self.union += cm.sum(0) + cm.sum(1) - inter

    def merge_results(self) -> Dict:
        present = self.union > 0
        iou = np.zeros(self.num_classes, np.float64)
        iou[present] = self.intersection[present] / self.union[present]
        miou = float(iou[present].mean()) if present.any() else 0.0
        return {"miou": 100.0 * miou, "acc_classes": int(present.sum())}


class DetectionAP:
    """COCO-protocol average precision/recall (bbox AND segm) over IoU
    thresholds .5:.05:.95 — the detection app's metric pair (the
    reference evaluates both through detectron2's COCOEvaluator /
    pycocotools in its test loop, ref one_peace_vision/det/
    lazyconfig_train_net.py:36-40; headline 60.4 box / 52.9 mask AP).

    Protocol fidelity (pycocotools cocoeval.py semantics):
    - greedy score-ordered matching per (image, class, area range),
      best-IoU unmatched GT wins, re-run per area range;
    - crowd regions are IGNORE: IoU vs a crowd GT is intersection /
      det-area, a crowd GT absorbs any number of detections, and a
      det matched to an ignored GT is neither TP nor FP;
    - unmatched detections outside the area range are ignored too;
    - 101-point interpolated precision with the monotone envelope;
    - AP_small/medium/large (area buckets in ORIGINAL px^2 — pass
      ``area_scale`` when detections live in resized coordinates) and
      AR@maxDets.

    The expensive geometry (IoU matrices, at most maxDets x maxGts per
    image) is computed ONCE per image in ``compute``; ``merge_results``
    re-walks only those small matrices, so the 10-threshold x 4-area sweep
    is score-sorts and cumsums.  One card holds the whole evaluation, so
    nothing is gathered across processes (a sharded iterator raises in the
    task); ``_pack_ragged_images`` / ``_unpack_ragged_images`` are the
    exchange format such a gather would use (ROADMAP queue 7)."""

    def __init__(self, num_classes: int,
                 iou_thresholds: Optional[List[float]] = None,
                 max_dets: int = 100):
        self.num_classes = num_classes
        self.thresholds = np.asarray(
            iou_thresholds or [0.5 + 0.05 * i for i in range(10)])
        self.max_dets = max_dets

    def initialize(self):
        self.images: List[Dict] = []
        self.has_masks = False

    # ------------------------------------------------------------------

    @staticmethod
    def _box_iou(d, g, crowd):
        """(D, G) IoU; vs crowd GTs the denominator is the DET area
        (pycocotools maskUtils.iou iscrowd semantics)."""
        if len(d) == 0 or len(g) == 0:
            return np.zeros((len(d), len(g)))
        lt = np.maximum(d[:, None, :2], g[None, :, :2])
        rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
        area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
        union = area_d[:, None] + area_g[None, :] - inter
        union = np.where(crowd[None, :], area_d[:, None], union)
        return inter / np.maximum(union, 1e-9)

    @staticmethod
    def _mask_iou(d, g, crowd):
        """(D, G) mask IoU from boolean rasters at a common resolution."""
        if len(d) == 0 or len(g) == 0:
            return np.zeros((len(d), len(g)))
        df = d.reshape(len(d), -1).astype(np.float32)
        gf = g.reshape(len(g), -1).astype(np.float32)
        inter = df @ gf.T
        area_d = df.sum(1)
        area_g = gf.sum(1)
        union = area_d[:, None] + area_g[None, :] - inter
        union = np.where(crowd[None, :], area_d[:, None], union)
        return inter / np.maximum(union, 1e-9)

    def compute(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                det_masks=None, gt_masks=None, gt_crowd=None, gt_areas=None,
                area_scale: float = 1.0,
                mask_area_scale: Optional[float] = None):
        """Accumulate one image.

        det_masks / gt_masks: boolean rasters at a common (h, w) — enables
        segm AP.  gt_crowd: iscrowd flags (ignore regions).  gt_areas:
        annotation areas in ORIGINAL px^2 (COCO buckets use the original
        segment area); defaults to box area * area_scale.  area_scale:
        multiplier taking areas computed in detection coordinates back to
        original px^2 (1/f^2 for a uniform resize f).  mask_area_scale:
        original px^2 covered by ONE mask-raster cell (area_scale *
        stride^2 for a stride-s raster) — segm eval ignores out-of-range
        dets by MASK area like pycocotools; defaults to area_scale."""
        dboxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        dscores = np.asarray(det_scores, np.float64).ravel()
        dlabels = np.asarray(det_labels).ravel()
        gboxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        glabels = np.asarray(gt_labels).ravel()
        crowd = (np.zeros(len(glabels), bool) if gt_crowd is None
                 else np.asarray(gt_crowd, bool).ravel())
        # score-sort once (stable, like pycocotools mergesort)
        order = np.argsort(-dscores, kind="stable")
        dboxes, dscores, dlabels = dboxes[order], dscores[order], dlabels[order]
        dareas = ((dboxes[:, 2] - dboxes[:, 0])
                  * (dboxes[:, 3] - dboxes[:, 1]) * area_scale)
        if gt_areas is None:
            gareas = ((gboxes[:, 2] - gboxes[:, 0])
                      * (gboxes[:, 3] - gboxes[:, 1]) * area_scale)
        else:
            gareas = np.asarray(gt_areas, np.float64).ravel()
        rec = {
            "scores": dscores, "dlabels": dlabels, "dareas": dareas,
            "glabels": glabels, "gcrowd": crowd, "gareas": gareas,
            "iou_box": self._box_iou(dboxes, gboxes, crowd),
        }
        if det_masks is not None and gt_masks is not None:
            dm = np.asarray(det_masks, bool)[order]
            gm = np.asarray(gt_masks, bool)
            assert dm.shape[1:] == gm.shape[1:] or 0 in (len(dm), len(gm)), (
                dm.shape, gm.shape)
            rec["iou_mask"] = self._mask_iou(dm, gm, crowd)
            rec["dareas_mask"] = (dm.sum(axis=(1, 2)).astype(np.float64)
                                  * float(mask_area_scale
                                          if mask_area_scale is not None
                                          else area_scale))
            self.has_masks = True
        self.images.append(rec)

    # ------------------------------------------------------------------

    @staticmethod
    def _match_image(iou, scores, gcrowd, gignore, darea, rng, thrs,
                     max_dets):
        """pycocotools evaluateImg for one (image, class, areaRng):
        returns (matched (T, D'), det_ignore (T, D'), scores (D',),
        n_gt_used) with dets capped at max_dets."""
        d = min(iou.shape[0], max_dets)
        g = iou.shape[1]
        # gts sorted: non-ignored first (stable — pycocotools gtind)
        gord = np.argsort(gignore.astype(np.int8), kind="stable")
        gignore = gignore[gord]
        gcrowd = gcrowd[gord]
        iou = iou[:d][:, gord]
        t_count = len(thrs)
        matched = np.zeros((t_count, d), bool)
        dt_ign = np.zeros((t_count, d), bool)
        for ti, t in enumerate(thrs):
            gtm = np.full(g, -1, np.int64)
            thr = min(t, 1.0 - 1e-10)
            for di in range(d):
                best, best_iou = -1, thr
                for gi in range(g):
                    if gtm[gi] >= 0 and not gcrowd[gi]:
                        continue
                    # gts are ignore-sorted: once we hold a real match,
                    # the remaining (ignored) gts can't improve it
                    if best > -1 and not gignore[best] and gignore[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best, best_iou = gi, iou[di, gi]
                if best >= 0:
                    gtm[best] = di
                    matched[ti, di] = True
                    dt_ign[ti, di] = gignore[best]
            # unmatched dets outside the area range are ignored, not FPs
            out = (darea[:d] < rng[0]) | (darea[:d] > rng[1])
            dt_ign[ti] |= (~matched[ti]) & out
        return matched, dt_ign, scores[:d], int((~gignore).sum())

    def _accumulate(self, iou_key: str) -> Dict[str, float]:
        """pycocotools accumulate over (class, areaRng): global score sort
        per class, vectorized over the 10 thresholds."""
        rec_thrs = np.linspace(0.0, 1.0, 101)
        t_count = len(self.thresholds)
        ap_out: Dict[str, List[float]] = {k: [] for k in _COCO_AREA_RANGES}
        ap50, ap75, ar_all = [], [], []
        classes_with_gt = 0
        for c in range(self.num_classes):
            per_img = []
            any_gt = False
            for rec in self.images:
                if iou_key not in rec:
                    continue
                dsel = rec["dlabels"] == c
                gsel = rec["glabels"] == c
                if not dsel.any() and not gsel.any():
                    continue
                any_gt = any_gt or bool((gsel & ~rec["gcrowd"]).any())
                darea_key = ("dareas_mask" if iou_key == "iou_mask"
                             and "dareas_mask" in rec else "dareas")
                per_img.append({
                    "iou": rec[iou_key][dsel][:, gsel],
                    "scores": rec["scores"][dsel],
                    "darea": rec[darea_key][dsel],
                    "garea": rec["gareas"][gsel],
                    "gcrowd": rec["gcrowd"][gsel],
                })
            if not any_gt:
                continue  # pycocotools: classes without GT are excluded
            classes_with_gt += 1
            for rng_name, rng in _COCO_AREA_RANGES.items():
                m_list, ig_list, s_list, npig = [], [], [], 0
                for im in per_img:
                    gignore = (im["gcrowd"] | (im["garea"] < rng[0])
                               | (im["garea"] > rng[1]))
                    m, ig, s, ng = self._match_image(
                        im["iou"], im["scores"], im["gcrowd"], gignore,
                        im["darea"], rng, self.thresholds, self.max_dets)
                    m_list.append(m)
                    ig_list.append(ig)
                    s_list.append(s)
                    npig += ng
                if npig == 0:
                    continue
                scores = np.concatenate(s_list) if s_list else np.zeros(0)
                matched = (np.concatenate(m_list, axis=1) if m_list
                           else np.zeros((t_count, 0), bool))
                ignored = (np.concatenate(ig_list, axis=1) if ig_list
                           else np.zeros((t_count, 0), bool))
                order = np.argsort(-scores, kind="stable")
                matched, ignored = matched[:, order], ignored[:, order]
                tp = np.cumsum(matched & ~ignored, axis=1, dtype=np.float64)
                fp = np.cumsum(~matched & ~ignored, axis=1, dtype=np.float64)
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # monotone precision envelope then 101-pt interpolation
                pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                ap_t = np.zeros(t_count)
                for ti in range(t_count):
                    inds = np.searchsorted(rc[ti], rec_thrs, side="left")
                    valid = inds < pr.shape[1]
                    q = np.zeros(len(rec_thrs))
                    q[valid] = pr[ti][inds[valid]]
                    ap_t[ti] = q.mean()
                ap_out[rng_name].append(float(ap_t.mean()))
                if rng_name == "all":
                    # nearest threshold to the labeled point — exact under
                    # the default .5:.05:.95 sweep, honest under custom lists
                    i50 = int(np.argmin(np.abs(self.thresholds - 0.5)))
                    ap50.append(float(ap_t[i50]))
                    i75 = int(np.argmin(np.abs(self.thresholds - 0.75)))
                    ap75.append(float(ap_t[i75]))
                    ar_all.append(float(rc[:, -1].mean()) if rc.size else 0.0)

        def mean(xs):
            return 100.0 * float(np.mean(xs)) if xs else 0.0

        return {
            "ap": mean(ap_out["all"]), "ap50": mean(ap50),
            "ap75": mean(ap75), "ap_s": mean(ap_out["s"]),
            "ap_m": mean(ap_out["m"]), "ap_l": mean(ap_out["l"]),
            f"ar{self.max_dets}": mean(ar_all),
            "classes_with_gt": classes_with_gt,
        }

    def merge_results(self) -> Dict:
        out = self._accumulate("iou_box")
        if self.has_masks:
            segm = self._accumulate("iou_mask")
            out.update({(f"ap_mask{k[2:]}" if k.startswith("ap") else
                         f"{k}_mask"): v
                        for k, v in segm.items() if k != "classes_with_gt"})
        return out


def _pack_ragged_images(images: List[Dict]) -> Dict[str, np.ndarray]:
    """Per-image ragged eval records -> fixed-rank packed arrays + counts
    (the exchange format for cross-process gather).  IoU matrices pack as
    flattened rows; (D, G) reconstructs from the per-image counts."""
    def cat(arrs):
        arrs = [np.asarray(a, np.float64).ravel() for a in arrs]
        return (np.concatenate(arrs) if arrs else np.zeros((0,), np.float64))

    has_mask = np.asarray([("iou_mask" in r) for r in images], np.int64)
    return {
        "det_counts": np.asarray([len(r["scores"]) for r in images], np.int64),
        "gt_counts": np.asarray([len(r["glabels"]) for r in images], np.int64),
        "has_mask": has_mask,
        "scores": cat([r["scores"] for r in images]),
        "dlabels": cat([r["dlabels"] for r in images]),
        "dareas": cat([r["dareas"] for r in images]),
        "glabels": cat([r["glabels"] for r in images]),
        "gcrowd": cat([r["gcrowd"] for r in images]),
        "gareas": cat([r["gareas"] for r in images]),
        "iou_box": cat([r["iou_box"] for r in images]),
        "iou_mask": cat([r.get("iou_mask", np.zeros((0,)))
                         for r in images]),
        "dareas_mask": cat([r.get("dareas_mask", np.zeros((0,)))
                            for r in images]),
    }


def _unpack_ragged_images(p: Dict[str, np.ndarray]) -> List[Dict]:
    """Inverse of _pack_ragged_images (works on the gathered concatenation
    because counts arrive in the same process order as the values)."""
    images: List[Dict] = []
    d_off = g_off = m_off = mm_off = 0
    for i, (nd, ng) in enumerate(zip(p["det_counts"], p["gt_counts"])):
        nd, ng = int(nd), int(ng)
        rec = {
            "scores": p["scores"][d_off:d_off + nd],
            "dlabels": p["dlabels"][d_off:d_off + nd].astype(np.int64),
            "dareas": p["dareas"][d_off:d_off + nd],
            "glabels": p["glabels"][g_off:g_off + ng].astype(np.int64),
            "gcrowd": p["gcrowd"][g_off:g_off + ng].astype(bool),
            "gareas": p["gareas"][g_off:g_off + ng],
            "iou_box": p["iou_box"][m_off:m_off + nd * ng].reshape(nd, ng),
        }
        if int(p["has_mask"][i]):
            rec["iou_mask"] = p["iou_mask"][
                mm_off:mm_off + nd * ng].reshape(nd, ng)
            mm_off += nd * ng
        d_off += nd
        g_off += ng
        m_off += nd * ng
        images.append(rec)
    # mask det areas pack densely over mask-bearing images only
    md_off = 0
    for rec in images:
        if "iou_mask" in rec:
            nd = len(rec["scores"])
            rec["dareas_mask"] = p["dareas_mask"][md_off:md_off + nd]
            md_off += nd
    return images
