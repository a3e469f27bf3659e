"""The COCO detection, ADE20K segmentation and K400 rawframe video datasets
and ``vision_collate``: ``one_peace_tpu/data/vision_datasets.py``, copied
(held equal by ``tests/test_torch_port_coco_data.py``,
``tests/test_torch_port_seg_data.py``,
``tests/test_torch_port_video_data.py`` and
``tests/test_torch_port_copies.py``).

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
- :class:`RawframeVideoDataset` -- mmaction2 rawframes layout
  (``ann.txt`` lines ``rel_dir num_frames label``; frames
  ``img_00001.jpg``...), dense clip sampling (SampleFrames clip_len=T
  frame_interval=4, loop-padded) or TSN segments, RandomResizedCrop +
  ColorJitter or scale-jitter train aug, and test views of several
  temporal clips x ThreeCrop.

Samples are fixed-shape numpy arrays; ``vision_collate`` just stacks them.
Images are normalized with the CLIP statistics the trunk was pretrained
with.  The dataset draws every random choice from one
``np.random.RandomState(seed)`` in fetch order, as the JAX package's does,
so two runs that fetch the same samples in the same order see the same
crops; ``data.iterators.EpochBatchIterator`` fetches in order on its one
prefetch thread, and saves the generator's state with its position
(``data_rng``), so a resumed run draws the straight run's crops.
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


# ---------------------------------------------------------------------------
# K400 rawframe video classification
# ---------------------------------------------------------------------------


def _jitter_brightness_contrast_saturation(arr: np.ndarray, b: float,
                                           c: float, s: float) -> np.ndarray:
    """torchvision adjust_brightness/contrast/saturation semantics on a
    (H, W, 3) uint8 array, applied in that fixed order (mmaction2's
    ColorJitter order)."""
    x = arr.astype(np.float32) * b
    x = np.clip(x, 0, 255)
    gray = x @ np.asarray([0.299, 0.587, 0.114], np.float32)
    x = x * c + float(gray.mean()) * (1.0 - c)        # toward mean gray
    x = np.clip(x, 0, 255)
    gray = x @ np.asarray([0.299, 0.587, 0.114], np.float32)
    x = x * s + gray[..., None] * (1.0 - s)           # toward per-px gray
    return np.clip(x, 0, 255).astype(np.uint8)


def _jitter_hue(arr: np.ndarray, h: float) -> np.ndarray:
    """torchvision adjust_hue (PIL path): RGB -> HSV, shift the uint8 hue
    channel by h*255 with wraparound, back to RGB."""
    if h == 0.0:
        return arr
    from PIL import Image

    hsv = np.asarray(Image.fromarray(arr).convert("HSV")).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                   + int(round(h * 255.0))) % 256
    return np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))


class RawframeVideoDataset:
    """mmaction2 rawframes-format video dataset: an annotation file with
    lines ``rel_dir num_frames label`` and per-clip frame directories
    (``img_00001.jpg``…).

    Temporal sampling (``sampling``):
    - ``dense`` (default) — one contiguous window of ``num_frames`` frames
      ``frame_interval`` apart, random start for train, evenly-spread
      centered starts for test clips, short videos loop-padded by modular
      indexing: mmaction2 ``SampleFrames(clip_len=32, frame_interval=4,
      num_clips=1, out_of_bound_opt='loop')``, the reference's 88.1 recipe
      (ref video/configs/recognition/onepeace_k400_frame32.py:20-31,56).
    - ``segment`` (opt-in) — TSN-style: split into ``num_frames`` equal
      segments, one frame per segment (random / center).

    Train spatial augmentation (``train_aug``):
    - ``rrc`` (default) — short side to S, RandomResizedCrop (area
      0.08-1.0, aspect 3/4-4/3), resize to SxS, flip 0.5, per-clip
      ColorJitter b/c/s 0.5 + hue 0.1 (the recipe's train_pipeline,
      ref onepeace_k400_frame32.py:20-31).
    - ``scale_jitter`` (opt-in) — short-side jitter 1.0-1.25 + random crop
      + flip (the lighter legacy pipeline).

    Each sample:
      src_videos (T, 3, S, S) float32   CLIP-normalized
      target     ()           int32
    """

    def __init__(self, split: str, ann_file: str, data_root: str,
                 num_frames: int = 16, image_size: int = 256,
                 frame_tmpl: str = "img_{:05d}.jpg", start_index: int = 1,
                 test_num_clips: int = 1, test_three_crop: bool = False,
                 sampling: str = "dense", frame_interval: int = 4,
                 train_aug: str = "rrc", color_jitter: bool = True,
                 seed: int = 3407):
        assert sampling in ("dense", "segment"), sampling
        assert train_aug in ("rrc", "scale_jitter"), train_aug
        self.split = split
        self.data_root = data_root
        self.num_frames = num_frames
        self.image_size = image_size
        self.frame_tmpl = frame_tmpl
        self.start_index = start_index
        self.test_num_clips = test_num_clips
        self.test_three_crop = test_three_crop
        self.sampling = sampling
        self.frame_interval = frame_interval
        self.train_aug = train_aug
        self.color_jitter = color_jitter
        self.rng = np.random.RandomState(seed)
        self.clips: List[Tuple[str, int, int]] = []
        with open(ann_file) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 3:
                    self.clips.append((parts[0], int(parts[1]), int(parts[2])))

    def __len__(self) -> int:
        return len(self.clips)

    def _frame_indices(self, total: int, clip_idx: int = 0,
                       num_clips: int = 1) -> np.ndarray:
        t = self.num_frames
        if self.sampling == "dense":
            # mmaction2 SampleFrames(clip_len=t, frame_interval=I):
            # _get_train_clips / _get_test_clips with num_clips starts,
            # then out_of_bound_opt='loop' modular indexing
            ori = t * self.frame_interval
            if self.split == "train":
                avg = (total - ori + 1) // num_clips
                if avg > 0:
                    off = clip_idx * avg + int(self.rng.randint(avg))
                elif total > max(num_clips, ori):
                    off = int(np.sort(self.rng.randint(
                        total - ori + 1, size=num_clips))[clip_idx])
                elif avg == 0:
                    off = int(round(clip_idx * (total - ori + 1)
                                    / num_clips))
                else:
                    off = 0
            else:
                avg = (total - ori + 1) / float(num_clips)
                off = (int(clip_idx * avg + avg / 2.0)
                       if total > ori - 1 else 0)
            idx = off + np.arange(t, dtype=np.int64) * self.frame_interval
            return np.mod(idx, total)
        seg = total / t
        if self.split == "train":
            offs = self.rng.uniform(0, seg, t)
        else:
            # multi-clip testing: clip i samples offset fraction
            # (i + 0.5)/num_clips of every segment, spreading the test
            # clips across the video; num_clips=1 -> the segment centers
            offs = np.full(t, seg * (clip_idx + 0.5) / num_clips)
        idx = (np.arange(t) * seg + offs).astype(np.int64)
        return np.clip(idx, 0, total - 1)

    def _rrc_box(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """mmaction2 RandomResizedCrop.get_crop_bbox: 10 attempts at a
        random-area (0.08-1.0), random-log-aspect (3/4-4/3) box, falling
        back to the largest centered square."""
        area = h * w
        for _ in range(10):
            target = self.rng.uniform(0.08, 1.0) * area
            ar = float(np.exp(self.rng.uniform(np.log(3.0 / 4.0),
                                               np.log(4.0 / 3.0))))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x0 = int(self.rng.randint(0, w - cw + 1))
                y0 = int(self.rng.randint(0, h - ch + 1))
                return x0, y0, cw, ch
        cs = min(h, w)
        return (w - cs) // 2, (h - cs) // 2, cs, cs

    def _load_short_side(self, rel_dir: str, fi: int):
        """Decode one frame and resize its short side to image_size."""
        from PIL import Image

        path = os.path.join(self.data_root, rel_dir,
                            self.frame_tmpl.format(int(fi) + self.start_index))
        img = _load_pil(path)
        w0, h0 = img.size
        size = self.image_size
        f = size / min(h0, w0)
        new_w = max(size, int(round(w0 * f)))
        new_h = max(size, int(round(h0 * f)))
        return img.resize((new_w, new_h), Image.BILINEAR)

    def _test_views(self, rel_dir: str, total: int) -> np.ndarray:
        """(V, T, 3, S, S) test views: test_num_clips temporal clips x
        ThreeCrop (3 crops along the long axis) or center crop (ref
        video test_pipeline: SampleFrames num_clips=3 + ThreeCrop 256)."""
        size = self.image_size
        views = []
        n = self.test_num_clips
        for ci in range(n):
            frames = [self._load_short_side(rel_dir, fi)
                      for fi in self._frame_indices(total, ci, n)]
            w, h = frames[0].size
            if self.test_three_crop:
                if w >= h:
                    offs = [(0, 0), ((w - size) // 2, 0), (w - size, 0)]
                else:
                    offs = [(0, 0), (0, (h - size) // 2), (0, h - size)]
            else:
                offs = [((w - size) // 2, (h - size) // 2)]
            for left, top in offs:
                views.append(np.stack([
                    normalize_image(np.asarray(
                        f.crop((left, top, left + size, top + size))))
                    for f in frames]).astype(np.float32))
        return np.stack(views)

    def __getitem__(self, index: int):
        from PIL import Image

        rel_dir, total, label = self.clips[index]
        if self.split != "train" and (self.test_num_clips > 1
                                      or self.test_three_crop):
            return {
                "id": index,
                "src_videos": self._test_views(rel_dir, total),
                "target": np.int32(label),
            }
        size = self.image_size
        rng = self.rng

        if self.split == "train" and self.train_aug == "rrc":
            # recipe train pipeline (ref onepeace_k400_frame32.py:20-31):
            # Resize(-1, S) -> RandomResizedCrop -> Resize(SxS) -> Flip
            # -> ColorJitter, one transform per clip shared by all frames
            pils = [self._load_short_side(rel_dir, fi)
                    for fi in self._frame_indices(total)]
            w, h = pils[0].size
            x0, y0, cw, ch = self._rrc_box(h, w)
            flip = rng.rand() < 0.5
            jit = None
            if self.color_jitter:
                # mmaction2 ColorJitter defaults b/c/s=0.5, hue=0.1
                jit = (rng.uniform(0.5, 1.5), rng.uniform(0.5, 1.5),
                       rng.uniform(0.5, 1.5), rng.uniform(-0.1, 0.1))
            frames = []
            for img in pils:
                img = img.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                    (size, size), Image.BILINEAR)
                if flip:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
                arr = np.asarray(img)
                if jit is not None:
                    arr = _jitter_hue(_jitter_brightness_contrast_saturation(
                        arr, *jit[:3]), jit[3])
                frames.append(normalize_image(arr))
            return {
                "id": index,
                "src_videos": np.stack(frames).astype(np.float32),
                "target": np.int32(label),
            }

        # eval single-view / legacy scale_jitter train: one spatial
        # transform per clip, shared by all frames
        if self.split == "train":
            scale = rng.uniform(1.0, 1.25)
            flip = rng.rand() < 0.5
            crop_frac = (rng.rand(), rng.rand())
        else:
            scale, flip, crop_frac = 1.0, False, (0.5, 0.5)

        frames = []
        for fi in self._frame_indices(total):
            path = os.path.join(self.data_root, rel_dir,
                                self.frame_tmpl.format(int(fi) + self.start_index))
            img = _load_pil(path)
            w0, h0 = img.size
            f = scale * size / min(h0, w0)  # short side to scale*size
            new_w, new_h = max(size, int(round(w0 * f))), max(size, int(round(h0 * f)))
            img = img.resize((new_w, new_h), Image.BILINEAR)
            left = int(round(crop_frac[0] * (new_w - size)))
            top = int(round(crop_frac[1] * (new_h - size)))
            img = img.crop((left, top, left + size, top + size))
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            frames.append(normalize_image(np.asarray(img)))
        return {
            "id": index,
            "src_videos": np.stack(frames).astype(np.float32),
            "target": np.int32(label),
        }


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
