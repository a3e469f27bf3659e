"""Batch-level Mixup / CutMix with soft targets.

The port's copy of ``one_peace_tpu/data/mixup.py`` (held equal by
``tests/test_torch_port_classify_data.py``).

Capability equivalent of timm's Mixup used by the reference ImageNet
pipeline (ref vision_data/image_classify_dataset.py:46-52: mixup_alpha,
cutmix_alpha, prob, switch_prob, label_smoothing, num_classes; batch
mode).  Independent numpy implementation applied after collation; emits
(B, num_classes) soft targets, which the classify criterion's soft-target
branch consumes (criterions.py ClassifyCriterion)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def one_hot(targets: np.ndarray, num_classes: int, on: float, off: float) -> np.ndarray:
    out = np.full((len(targets), num_classes), off, np.float32)
    out[np.arange(len(targets)), targets] = on
    return out


def rand_bbox(rng, h: int, w: int, lam: float) -> Tuple[int, int, int, int]:
    """CutMix box with area ratio (1 - lam)."""
    cut_ratio = np.sqrt(1.0 - lam)
    ch, cw = int(h * cut_ratio), int(w * cut_ratio)
    cy, cx = rng.randint(h), rng.randint(w)
    y0, y1 = np.clip(cy - ch // 2, 0, h), np.clip(cy + ch // 2, 0, h)
    x0, x1 = np.clip(cx - cw // 2, 0, w), np.clip(cx + cw // 2, 0, w)
    return y0, y1, x0, x1


def rand_bbox_minmax(rng, h: int, w: int, minmax) -> Tuple[int, int, int, int]:
    """timm rand_bbox_minmax: each cut side is a uniform ratio of the image
    side in [minmax[0], minmax[1]) — the box area, not the beta lam,
    determines the final mixing weight."""
    ch = rng.randint(int(h * minmax[0]), int(h * minmax[1]))
    cw = rng.randint(int(w * minmax[0]), int(w * minmax[1]))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    return y0, y0 + ch, x0, x0 + cw


class Mixup:
    """Modes (timm Mixup): 'batch' draws one lam for the whole batch and
    pairs each sample with a random permutation partner; 'pair' / 'elem'
    pair sample i with its batch-flip partner B-1-i, drawing lam per pair /
    per element (timm mixup.py _mix_pair/_mix_elem).  ``cutmix_minmax``
    (a (lo, hi) ratio pair) switches the cut box to uniform side-ratio
    sampling."""

    def __init__(self, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1, num_classes: int = 1000,
                 seed: int = 0, mode: str = "batch", cutmix_minmax=None):
        assert mode in ("batch", "pair", "elem"), mode
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.mode = mode
        self.cutmix_minmax = tuple(cutmix_minmax) if cutmix_minmax else None
        self.rng = np.random.RandomState(seed)

    def _draw(self):
        """One (use_cutmix, lam) draw — shared by every mode."""
        use_cutmix = (self.cutmix_alpha > 0
                      and self.rng.rand() < self.switch_prob) or self.mixup_alpha <= 0
        alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
        return use_cutmix, float(self.rng.beta(alpha, alpha))

    def _box(self, h, w, lam):
        """One cut box + its corrected lam (actual kept-area ratio)."""
        if self.cutmix_minmax is not None:
            y0, y1, x0, x1 = rand_bbox_minmax(self.rng, h, w, self.cutmix_minmax)
        else:
            y0, y1, x0, x1 = rand_bbox(self.rng, h, w, lam)
        return (y0, y1, x0, x1), 1.0 - ((y1 - y0) * (x1 - x0) / (h * w))

    def __call__(self, images: np.ndarray, targets: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """images (B, C, H, W); targets (B,) int -> (mixed images,
        (B, num_classes) soft targets)."""
        ls = self.label_smoothing
        off = ls / self.num_classes
        on = 1.0 - ls + off
        soft = one_hot(targets, self.num_classes, on, off)
        if self.rng.rand() >= self.prob:
            return images, soft
        b = len(images)
        out = images.copy()

        h, w = out.shape[2], out.shape[3]
        if self.mode == "batch":
            use_cutmix, lam = self._draw()
            perm = self.rng.permutation(b)
            if use_cutmix:
                (y0, y1, x0, x1), lam = self._box(h, w, lam)
                out[:, :, y0:y1, x0:x1] = images[perm][:, :, y0:y1, x0:x1]
            else:
                out = lam * out + (1.0 - lam) * images[perm]
            soft = lam * soft + (1.0 - lam) * soft[perm]
            return out.astype(np.float32), soft

        # pair/elem: partner is sample b-1-i, mixed FROM THE ORIGINAL batch
        # (timm _mix_pair/_mix_elem clone x first); 'pair' draws one lam +
        # one box per pair and swaps the patches both ways
        lams = np.ones(b, np.float64)
        idxs = range(b // 2) if self.mode == "pair" else range(b)
        for i in idxs:
            j = b - 1 - i
            use_cutmix, lam = self._draw()
            if use_cutmix:
                (y0, y1, x0, x1), lam = self._box(h, w, lam)
                out[i, :, y0:y1, x0:x1] = images[j, :, y0:y1, x0:x1]
                if self.mode == "pair":
                    out[j, :, y0:y1, x0:x1] = images[i, :, y0:y1, x0:x1]
            else:
                out[i] = lam * images[i] + (1.0 - lam) * images[j]
                if self.mode == "pair":
                    out[j] = lam * images[j] + (1.0 - lam) * images[i]
            lams[i] = lam
            if self.mode == "pair":
                lams[j] = lam
        flip = soft[::-1]
        soft = lams[:, None] * soft + (1.0 - lams[:, None]) * flip
        return out.astype(np.float32), soft.astype(np.float32)
