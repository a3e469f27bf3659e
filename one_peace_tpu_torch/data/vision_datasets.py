"""The COCO detection and ADE20K segmentation datasets and
``vision_collate``: the COCO and ADE20K parts of
``one_peace_tpu/data/vision_datasets.py``, copied (held equal by
``tests/test_torch_port_coco_data.py``, ``tests/test_torch_port_seg_data.py``
and ``tests/test_torch_port_copies.py``).

- :class:`CocoDetectionDataset` -- COCO ``instances_*.json`` annotations,
  detectron2-style large-scale-jitter augmentation (ResizeScale 0.1-2.0 +
  FixedSizeCrop, ref det/configs/common/coco_loader_lsj.py), GT padded to
  a fixed ``max_boxes`` slot budget with a ``gt_valid`` mask so the whole
  batch is one static shape; instance masks rasterized from polygons /
  RLE at stride ``mask_stride``.
- :class:`Ade20kSegDataset` -- mmseg-style ``images/ + annotations/`` dirs
  (ref seg/configs/_base_/datasets/ade20k.py): train = ratio resize
  0.5-2.0 + random crop + flip, val = fixed-size resize; ADE20K
  ``reduce_zero_label`` relabeling (0 -> ignore, k -> k-1).

Samples are fixed-shape numpy arrays; ``vision_collate`` just stacks them.
Images are normalized with the CLIP statistics the trunk was pretrained
with.  The dataset draws every random choice from one
``np.random.RandomState(seed)`` in fetch order, as the JAX package's does,
so two runs that fetch the same samples in the same order see the same
crops; ``data.iterators.EpochBatchIterator`` fetches in order on its one
prefetch thread.  The video dataset is not ported yet (ROADMAP queue 1
item 3).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base_dataset import normalize_image


def _load_pil(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _paste_normalized(img_arr: np.ndarray, out_size: int,
                      top: int = 0, left: int = 0) -> np.ndarray:
    """Normalize (CLIP stats) then paste onto a zero canvas -- zeros in
    normalized space are exactly the mean pixel, so padding is neutral."""
    chw = normalize_image(img_arr)
    canvas = np.zeros((3, out_size, out_size), np.float32)
    h, w = chw.shape[1:]
    canvas[:, top:top + h, left:left + w] = chw
    return canvas


def rle_decode(rle: Dict, h: int, w: int) -> np.ndarray:
    """COCO RLE -> (h, w) uint8 mask.  Supports uncompressed (counts =
    list) and compressed (counts = str, the pycocotools LEB128-style
    char encoding with delta-coded runs)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        nums: List[int] = []
        i = 0
        while i < len(counts):
            val, k, more = 0, 0, True
            while more:
                c = ord(counts[i]) - 48
                val |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if val & (1 << (5 * k - 1)):  # sign-extend
                val -= 1 << (5 * k)
            if len(nums) > 2:
                val += nums[-2]  # delta from the run two back
            nums.append(val)
        counts = nums
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            mask[pos:pos + run] = 1
        pos += run
        val ^= 1
    # COCO RLE is column-major
    return mask.reshape(w, h).T


def _polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int,
                      scale: float = 1.0,
                      offset: Tuple[float, float] = (0.0, 0.0),
                      flip_w: Optional[float] = None) -> np.ndarray:
    """Rasterize COCO polygon lists at (h, w) after the given transform
    (flip in the ORIGINAL image of width flip_w, then scale, then
    subtract (left, top) offset)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    ox, oy = offset
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if flip_w is not None:
            pts[:, 0] = flip_w - pts[:, 0]
        pts = pts * scale - np.asarray([ox, oy])
        if len(pts) >= 3:
            draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, np.uint8)


class CocoDetectionDataset:
    """COCO-json detection/instance-segmentation dataset with static-shape
    GT (ref: detectron2 COCO loader + LSJ recipe used by
    det/configs/onepeace/cascade_mask_rcnn_vitdet_50ep.py).

    Each sample:
      src_images (3, S, S) float32   CLIP-normalized, LSJ-augmented
      gt_boxes   (M, 4)    float32   xyxy in input pixels, zero-padded
      gt_labels  (M,)      int32     contiguous [0, C), zero-padded
      gt_valid   (M,)      bool
      gt_crowd   (M,)      bool      crowd (ignore) regions, valid split only
      gt_areas   (M,)      float32   annotation areas in original px^2
      im_scale   ()        float32   the resize factor original -> input px
      gt_masks   (M, S/ms, S/ms) uint8   (with_masks only)
    """

    def __init__(self, split: str, ann_file: str, image_dir: str,
                 image_size: int = 1024, max_boxes: int = 100,
                 with_masks: bool = True, mask_stride: int = 4,
                 lsj_min_scale: float = 0.1, lsj_max_scale: float = 2.0,
                 seed: int = 3407):
        self.split = split
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.with_masks = with_masks
        self.mask_stride = mask_stride
        self.lsj = (lsj_min_scale, lsj_max_scale)
        self.rng = np.random.RandomState(seed)

        with open(ann_file) as fh:
            coco = json.load(fh)
        self.images = sorted(coco["images"], key=lambda im: im["id"])
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_to_label = {c: i for i, c in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        self.anns_by_image: Dict[int, List[Dict]] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0) and split == "train":
                # training filters crowd instances out of the targets
                # (detectron2 dataset_mapper keeps iscrowd == 0 only);
                # eval keeps them as IGNORE regions for the COCO protocol
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        from PIL import Image

        info = self.images[index]
        img = _load_pil(os.path.join(self.image_dir, info["file_name"]))
        w0, h0 = img.size
        anns = self.anns_by_image.get(info["id"], [])
        rng = self.rng
        size = self.image_size

        flip = self.split == "train" and rng.rand() < 0.5
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)

        if self.split == "train":
            # detectron2 ResizeScale: a random target scale, then fit
            s = rng.uniform(*self.lsj)
            f = s * min(size / h0, size / w0)
        else:
            f = min(size / h0, size / w0)  # fit the long side, keep AR
        new_w, new_h = max(1, int(round(w0 * f))), max(1, int(round(h0 * f)))
        resized = img.resize((new_w, new_h), Image.BILINEAR)

        # FixedSizeCrop: random crop when larger, top-left paste when smaller
        left = rng.randint(0, max(new_w - size, 0) + 1) if self.split == "train" else 0
        top = rng.randint(0, max(new_h - size, 0) + 1) if self.split == "train" else 0
        cropped = np.asarray(resized)[top:top + size, left:left + size]
        src = _paste_normalized(cropped, size)

        m = self.max_boxes
        gt_boxes = np.zeros((m, 4), np.float32)
        gt_labels = np.zeros((m,), np.int32)
        gt_valid = np.zeros((m,), bool)
        gt_crowd = np.zeros((m,), bool)
        gt_areas = np.zeros((m,), np.float32)
        ms = size // self.mask_stride
        gt_masks = np.zeros((m, ms, ms), np.uint8) if self.with_masks else None

        slot = 0
        # Real GTs take slots before crowd (ignore) regions: under the fixed
        # max_boxes budget a crowd ann must never evict a scoreable instance
        # (dropping a crowd region only forfeits its ignore effect; dropping a
        # real GT silently deflates recall AND counts its match as an FP).
        anns = sorted(anns, key=lambda a: bool(a.get("iscrowd", 0)))
        for ann in anns:
            if slot >= m:
                break
            x, y, bw, bh = ann["bbox"]
            x1, y1, x2, y2 = x, y, x + bw, y + bh
            if flip:
                x1, x2 = w0 - x2, w0 - x1
            box = np.asarray([x1, y1, x2, y2], np.float64) * f
            box -= [left, top, left, top]
            box = np.clip(box, 0, size)
            if box[2] - box[0] < 1 or box[3] - box[1] < 1:
                continue
            gt_boxes[slot] = box
            gt_labels[slot] = self.cat_to_label.get(ann["category_id"], 0)
            gt_valid[slot] = True
            gt_crowd[slot] = bool(ann.get("iscrowd", 0))
            # COCO area buckets use the annotation's segment area in
            # ORIGINAL px^2 (pycocotools params.areaRng)
            gt_areas[slot] = float(ann.get("area", bw * bh))
            if gt_masks is not None:
                seg = ann.get("segmentation")
                if isinstance(seg, dict):
                    full = rle_decode(seg, info["height"], info["width"])
                    if flip:
                        full = full[:, ::-1]
                    cy = (np.arange(ms) + 0.5) * self.mask_stride
                    cx = (np.arange(ms) + 0.5) * self.mask_stride
                    ys = np.clip((cy + top) / f, 0, h0 - 1).astype(np.int64)
                    xs = np.clip((cx + left) / f, 0, w0 - 1).astype(np.int64)
                    samp = full[np.ix_(ys, xs)]
                    # canvas rows/cols beyond the pasted image are padding,
                    # not edge clones
                    samp[cy + top >= new_h, :] = 0
                    samp[:, cx + left >= new_w] = 0
                    gt_masks[slot] = samp
                elif seg:
                    gt_masks[slot] = _polygons_to_mask(
                        seg, ms, ms, scale=f / self.mask_stride,
                        offset=(left / self.mask_stride,
                                top / self.mask_stride),
                        flip_w=w0 if flip else None)
            slot += 1

        sample = {
            "id": int(info["id"]),
            "src_images": src,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            "gt_crowd": gt_crowd,
            "gt_areas": gt_areas,
            # uniform resize factor original -> input px (eval rescales
            # areas back to original px^2 for the COCO size buckets)
            "im_scale": np.float32(f),
        }
        if gt_masks is not None:
            sample["gt_masks"] = gt_masks
        return sample


class Ade20kSegDataset:
    """Semantic segmentation over an mmseg-style directory pair
    (ref seg/configs/_base_/datasets/ade20k.py).

    Each sample:
      src_images (3, S, S) float32   CLIP-normalized
      target     (S, S)    int32     class ids, ``ignore_index`` padded
    """

    def __init__(self, split: str, img_dir: str, ann_dir: str,
                 crop_size: int = 896, num_classes: int = 150,
                 ignore_index: int = 255, reduce_zero_label: bool = True,
                 scale_range: Tuple[float, float] = (0.5, 2.0),
                 seed: int = 3407, img_suffix: str = ".jpg",
                 ann_suffix: str = ".png"):
        self.split = split
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.scale_range = scale_range
        self.rng = np.random.RandomState(seed)
        self.pairs: List[Tuple[str, str]] = []
        for name in sorted(os.listdir(img_dir)):
            if not name.endswith(img_suffix):
                continue
            stem = name[: -len(img_suffix)]
            ann = os.path.join(ann_dir, stem + ann_suffix)
            if os.path.exists(ann):
                self.pairs.append((os.path.join(img_dir, name), ann))

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_label(self, path: str) -> np.ndarray:
        from PIL import Image

        lab = np.asarray(Image.open(path)).astype(np.int32)
        if lab.ndim == 3:
            lab = lab[..., 0]
        if self.reduce_zero_label:
            # mmseg ADE20K convention: 0 -> ignore, k -> k-1 (and pixels
            # already at ignore_index stay ignored after the shift)
            ign = self.ignore_index
            lab = np.where(lab == 0, ign + 1, lab) - 1
            lab = np.where(lab == ign - 1, ign, lab)
        return lab

    def __getitem__(self, index: int):
        from PIL import Image

        img_path, ann_path = self.pairs[index]
        img = _load_pil(img_path)
        lab = self._load_label(ann_path)
        size = self.crop_size
        rng = self.rng

        if self.split == "train":
            w0, h0 = img.size
            s = rng.uniform(*self.scale_range)
            f = s * size / min(h0, w0)  # ratio-jittered short side
            new_w, new_h = max(1, int(round(w0 * f))), max(1, int(round(h0 * f)))
            img = img.resize((new_w, new_h), Image.BILINEAR)
            lab_img = Image.fromarray(lab.astype(np.int32))  # mode "I"
            lab = np.asarray(
                lab_img.resize((new_w, new_h), Image.NEAREST)).astype(np.int32)
            if rng.rand() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                lab = lab[:, ::-1]
            top = rng.randint(0, max(new_h - size, 0) + 1)
            left = rng.randint(0, max(new_w - size, 0) + 1)
            img_arr = np.asarray(img)[top:top + size, left:left + size]
            lab = lab[top:top + size, left:left + size]
        else:
            img = img.resize((size, size), Image.BILINEAR)
            lab_img = Image.fromarray(lab.astype(np.int32))  # mode "I"
            lab = np.asarray(
                lab_img.resize((size, size), Image.NEAREST)).astype(np.int32)
            img_arr = np.asarray(img)

        src = _paste_normalized(img_arr, size)
        target = np.full((size, size), self.ignore_index, np.int32)
        target[: lab.shape[0], : lab.shape[1]] = lab
        return {"id": index, "src_images": src, "target": target}


def vision_collate(samples: List[Dict]) -> Dict:
    """Fixed-shape samples -> stacked batch (no padding needed)."""
    if not samples:
        return {}
    batch: Dict = {"nsentences": len(samples), "ntokens": len(samples)}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "id":
            batch["id"] = np.asarray(vals)
        else:
            batch[key] = np.stack([np.asarray(v) for v in vals])
    return batch
