"""Task datasets: the pretrain, retrieval and classification parts of
``one_peace_tpu/data/datasets.py``, copied (held equal by
``tests/test_torch_port_copies.py``, ``tests/test_torch_port_retrieval_data.py``,
``tests/test_torch_port_classify_data.py``,
``tests/test_torch_port_classify_rest_data.py`` and
``tests/test_torch_port_pretrain_data.py``).  Each sample is built on the
host in numpy; batching happens in ``data/collate.py``, the masks come
from ``data/masking.py``.

- ImageTextPretrainDataset    ref pretrain_data/image_text_pretrain_dataset.py
- AudioTextPretrainDataset    ref pretrain_data/audio_text_pretrain_dataset.py
- ImageTextRetrievalDataset   ref vl_data/image_text_retrieval_dataset.py
- AudioTextRetrievalDataset   ref audio_data/audio_text_retrieval_dataset.py
- VqaDataset                  ref vl_data/vqa_dataset.py
- Nlvr2Dataset                ref vl_data/nlvr2_dataset.py
- RefCOCODataset              ref vl_data/refcoco_dataset.py
- VggsoundDataset             ref audio_data/vggsound_dataset.py
- Fsd50kDataset               ref audio_data/fsd50k.py (multi-label)
- AqaDataset                  ref audio_data/aqa_dataset.py
- ImageClassifyDataset        ref vision_data/image_classify_dataset.py

``ImageClassifyDataset`` and ``Nlvr2Dataset`` draw their flips from one
``RandomState(seed)`` and their distortion, blur and RandAugment from
generators seeded seed+1..+3 (``RefCOCODataset`` its blur from seed+2), in
fetch order; the iterator's prefetch thread fetches in order, so a run
draws what the JAX package's draws, and the iterator saves every one of
these generators with its position, so a resumed run draws what the
straight run drew.  The pretrain datasets draw every mask (and the VL
crop) from one ``RandomState(seed)`` in fetch order, as the JAX package's
do.
"""

from __future__ import annotations


import numpy as np

from .base_dataset import (
    BaseDataset,
    audio_postprocess,
    center_crop_image,
    clean_text,
    horizontal_flip,
    normalize_image,
    random_resized_crop,
    resize_image,
)
from .masking import (
    add_whole_word_mask,
    compute_block_mask_1d,
    nested_subset_mask,
    random_patch_mask,
    superset_patch_mask,
    to_preserve_ids,
    whole_word_starts,
    with_cls,
)

DEFAULT_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                (512, 3, 2), (512, 2, 2), (512, 2, 2))


class ImageTextPretrainDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, patch_image_size=256, text_mask_ratio=0.15,
                 image_mask_ratio=0.75, vl_text_mask_ratio=0.4,
                 vl_image_mask_ratio=0.6875, min_scale=0.9, seed=3407):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.patch_image_size = patch_image_size
        self.num_patches = (patch_image_size // 16) ** 2
        self.text_mask_ratio = text_mask_ratio
        self.image_mask_ratio = image_mask_ratio
        self.vl_text_mask_ratio = vl_text_mask_ratio
        self.vl_image_mask_ratio = vl_image_mask_ratio
        self.min_scale = min_scale
        self.word_starts = whole_word_starts(tokenizer.dictionary, tokenizer.bpe)
        self.rng = np.random.RandomState(seed)

    def __getitem__(self, index):
        uniq_id, image, caption = self.table[index]
        rng = self.rng
        caption = clean_text(caption)
        text = self.encode_text(f" {caption}", self.max_src_length, append_eos=False)
        text_mask = add_whole_word_mask(rng, text, self.word_starts, self.text_mask_ratio)
        vl_text_mask = nested_subset_mask(rng, text_mask, self.vl_text_mask_ratio)

        img = self.read_image(image)
        if self.split == "train":
            img = random_resized_crop(rng, img, self.patch_image_size, self.min_scale)
        else:
            img = resize_image(img, self.patch_image_size)
        patch_image = normalize_image(np.asarray(img))

        image_mask = random_patch_mask(rng, self.num_patches, self.image_mask_ratio)
        vl_image_mask = superset_patch_mask(rng, image_mask, self.vl_image_mask_ratio)

        text = np.concatenate([text, [self.eos]])
        text_mask = with_cls(text_mask, trailing_false=True)
        vl_text_mask = with_cls(vl_text_mask, trailing_false=True)
        image_mask = with_cls(image_mask)
        vl_image_mask = with_cls(vl_image_mask)
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": text,
            "text_mask_indices": text_mask,
            "text_preserve_ids": to_preserve_ids(text_mask),
            "source_image": patch_image,
            "image_mask_indices": image_mask,
            "image_preserve_ids": to_preserve_ids(image_mask),
            "vl_text_mask_indices": vl_text_mask,
            "vl_text_preserve_ids": to_preserve_ids(vl_text_mask),
            "vl_image_mask_indices": vl_image_mask,
            "vl_image_preserve_ids": to_preserve_ids(vl_image_mask),
        }


class AudioTextPretrainDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, max_duration=15,
                 feature_encoder_spec=DEFAULT_SPEC, audio_mask_ratio=0.55,
                 al_text_mask_ratio=0.4, al_audio_mask_ratio=0.45,
                 audio_mask_prob_adjust=0.1, audio_mask_length=5, seed=3407):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.max_duration = max_duration
        self.spec = feature_encoder_spec
        self.audio_mask_ratio = audio_mask_ratio
        self.al_text_mask_ratio = al_text_mask_ratio
        self.al_audio_mask_ratio = al_audio_mask_ratio
        self.adjust = audio_mask_prob_adjust
        self.mask_length = audio_mask_length
        self.word_starts = whole_word_starts(tokenizer.dictionary, tokenizer.bpe)
        self.rng = np.random.RandomState(seed)

    def __getitem__(self, index):
        uniq_id, audio, caption, duration = self.table[index]
        rng = self.rng
        caption = clean_text(caption)
        text = self.encode_text(f" {caption}", self.max_src_length, append_eos=False)
        al_text_mask = add_whole_word_mask(rng, text, self.word_starts,
                                           self.al_text_mask_ratio)
        text = np.concatenate([text, [self.eos]])

        wav, sr = self.read_audio(audio)
        feats = audio_postprocess(wav, sr, self.max_duration)
        t = self.conv_length(len(feats), self.spec)
        audio_mask = compute_block_mask_1d(rng, t, self.audio_mask_ratio,
                                           self.mask_length, self.adjust)
        al_audio_mask = compute_block_mask_1d(rng, t, self.al_audio_mask_ratio,
                                              self.mask_length, self.adjust)
        audio_mask = with_cls(audio_mask)
        al_audio_mask = with_cls(al_audio_mask)
        al_text_mask = with_cls(al_text_mask, trailing_false=True)
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": text,
            "source_audio": feats,
            "audio_padding_mask": np.zeros(t + 1, bool),
            "audio_mask_indices": audio_mask,
            "audio_preserve_ids": to_preserve_ids(audio_mask),
            "al_text_mask_indices": al_text_mask,
            "al_text_preserve_ids": to_preserve_ids(al_text_mask),
            "al_audio_mask_indices": al_audio_mask,
            "al_audio_preserve_ids": to_preserve_ids(al_audio_mask),
        }


def coerce_id(uniq_id, fallback):
    """TSV uniq_id -> sample id (ref image_text_pretrain_dataset.py:63-64:
    numeric ids become ints); Recall matches these against the valid-file
    JSON keys, so returning the row index would break any corpus whose ids
    are not 0..N-1 in row order."""
    if uniq_id is None:
        return fallback
    try:
        return int(uniq_id)
    except (TypeError, ValueError):
        return uniq_id


class ImageTextRetrievalDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, patch_image_size=256):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.patch_image_size = patch_image_size

    def __getitem__(self, index):
        uniq_id, image, caption = self.table[index]
        caption = clean_text(caption)
        text = self.encode_text(f" {caption}", self.max_src_length)
        img = resize_image(self.read_image(image), self.patch_image_size)
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": text,
            "source_image": normalize_image(np.asarray(img)),
        }


class AudioTextRetrievalDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, max_duration=15,
                 feature_encoder_spec=DEFAULT_SPEC):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.max_duration = max_duration
        self.spec = feature_encoder_spec

    def __getitem__(self, index):
        uniq_id, audio, caption, duration = self.table[index]
        wav, sr = self.read_audio(audio)
        feats = audio_postprocess(wav, sr, self.max_duration)
        t = self.conv_length(len(feats), self.spec)
        caption = clean_text(caption)
        text = self.encode_text(f" {caption}", self.max_src_length)
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": text,
            "source_audio": feats,
            "audio_padding_mask": np.zeros(t + 1, bool),
        }


class VqaDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, patch_image_size=480, answer_cnt=3129):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.patch_image_size = patch_image_size
        self.answer_cnt = answer_cnt

    def __getitem__(self, index):
        uniq_id, image, question, refs = self.table[index]
        img = resize_image(self.read_image(image), self.patch_image_size)
        question = clean_text(question)
        text = self.encode_text(f" {question}", self.max_src_length)
        label = np.zeros(self.answer_cnt, np.float32)
        for item in refs.strip().split("&&"):
            _, label_id, conf = item.split("|!+")
            label[int(label_id)] = float(conf)
        return {
            "id": int(uniq_id),
            "source_text": text,
            "source_image": normalize_image(np.asarray(img)),
            "target": label,
        }


class Nlvr2Dataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, patch_image_size=384, seed=3407):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.patch_image_size = patch_image_size
        self.rng = np.random.RandomState(seed)
        if split == "train":
            # ref nlvr2_dataset.py:33-42: distortion + blur + flip + randaug
            from .randaugment import GaussianBlur, RandomAugment, RandomDistortion

            # distinct per-transform seeds: sharing one seed gives four
            # IDENTICAL random streams, correlating blur/distort/augment
            # decisions sample-by-sample
            self.distort = RandomDistortion(0.4, 0.4, 0.4, 0, 0.5,
                                            seed=seed + 1)
            self.blur = GaussianBlur(0.5, seed=seed + 2)
            self.randaug = RandomAugment(
                2, 7, augs=["Identity", "Equalize", "Brightness", "Sharpness",
                            "ShearX", "ShearY", "TranslateX", "TranslateY",
                            "Rotate"], seed=seed + 3)

    def _transform(self, img):
        img = resize_image(img, self.patch_image_size)
        if self.split == "train":
            img = self.distort(img)
            img = self.blur(img)
            img = horizontal_flip(self.rng, img)
            img = self.randaug(img)
        return normalize_image(np.asarray(img))

    def __getitem__(self, index):
        uniq_id, text, image1, image2, label = self.table[index]
        target = {"True": 0, "False": 1}[label]
        text = clean_text(text)
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": self.encode_text(f" {text}", self.max_src_length),
            "source_image": self._transform(self.read_image(image1)),
            "source_image_2": self._transform(self.read_image(image2)),
            "target": np.int64(target),
        }


class RefCOCODataset(BaseDataset):
    """Grounding pairs (ref vl_data/refcoco_dataset.py:31-42).

    Geometry note: the reference's RandomResize([S], max_size=S) clamps
    BOTH output dims to S for every aspect ratio (utils/transforms.py:
    17-39), i.e. a square S x S stretch; its Normalize then divides the
    ratio-scaled boxes by max_image_size=S — so the target works out to
    exactly (x/w, y/h), which is what this port computes directly."""

    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, patch_image_size=384, seed=3407):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.patch_image_size = patch_image_size
        self.blur = None
        if split == "train":
            # ref refcoco_dataset.py:33: train adds GaussianBlur(0.5)
            from .randaugment import GaussianBlur

            self.blur = GaussianBlur(0.5, seed=seed + 2)

    def __getitem__(self, index):
        image, text, region_coord = self.table[index]
        img = self.read_image(image)
        w, h = img.size
        x0, y0, x1, y1 = (float(v) for v in region_coord.strip().split(","))
        s = self.patch_image_size
        img_r = resize_image(img, s)
        if self.blur is not None:
            img_r = self.blur(img_r)
        # targets normalized to [0,1] of the resized square (boxes scale
        # with the resize ratios; ref utils/transforms Normalize — see
        # the class docstring for the equivalence)
        target = np.asarray([x0 / w, y0 / h, x1 / w, y1 / h], np.float32)
        text = clean_text(text, self.max_src_length)
        return {
            "id": index,
            "source_text": self.encode_text(f" {text}"),
            "source_image": normalize_image(np.asarray(img_r)),
            "target": target,
            "region_coords": np.asarray([x0, y0, x1, y1], np.float32),
            "image_widths": np.float32(w),
            "image_heights": np.float32(h),
        }


class VggsoundDataset(BaseDataset):
    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_duration=15, feature_encoder_spec=DEFAULT_SPEC,
                 num_classes=309):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_duration = max_duration
        self.spec = feature_encoder_spec
        self.num_classes = num_classes

    def __getitem__(self, index):
        uniq_id, audio, text, duration = self.table[index]
        wav, sr = self.read_audio(audio)
        feats = audio_postprocess(wav, sr, self.max_duration)
        t = self.conv_length(len(feats), self.spec)
        return {
            "id": coerce_id(uniq_id, index),
            "source_audio": feats,
            "audio_padding_mask": np.zeros(t + 1, bool),
            "target": np.int64(int(text.strip())),
        }


class Fsd50kDataset(BaseDataset):
    """Multi-label: target is a binary vector (ref audio_data/fsd50k.py)."""

    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_duration=15, feature_encoder_spec=DEFAULT_SPEC,
                 num_classes=200):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_duration = max_duration
        self.spec = feature_encoder_spec
        self.num_classes = num_classes

    def __getitem__(self, index):
        uniq_id, audio, labels, duration = self.table[index]
        wav, sr = self.read_audio(audio)
        feats = audio_postprocess(wav, sr, self.max_duration)
        t = self.conv_length(len(feats), self.spec)
        target = np.zeros(self.num_classes, np.float32)
        for lab in str(labels).strip().split(","):
            if lab != "":
                target[int(lab)] = 1.0
        return {
            "id": coerce_id(uniq_id, index),
            "source_audio": feats,
            "audio_padding_mask": np.zeros(t + 1, bool),
            "target": target,
        }


class AqaDataset(BaseDataset):
    """4-choice audio QA (ref audio_data/aqa_dataset.py:25-55)."""

    def __init__(self, split, table, tokenizer, dataset_dir="",
                 max_src_length=70, max_duration=15,
                 feature_encoder_spec=DEFAULT_SPEC):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.max_src_length = max_src_length
        self.max_duration = max_duration
        self.spec = feature_encoder_spec

    def __getitem__(self, index):
        uniq_id, audio, text, duration = self.table[index]
        question, a1, a2, a3, a4, choice = text.strip().split("&&&")
        wav, sr = self.read_audio(audio)
        feats = audio_postprocess(wav, sr, self.max_duration)
        t = self.conv_length(len(feats), self.spec)
        choices = [self.encode_text(f" {question} answer: {a}")
                   for a in (a1, a2, a3, a4)]
        return {
            "id": coerce_id(uniq_id, index),
            "source_text": choices,  # list -> flattened by collate
            "source_audio": feats,
            "audio_padding_mask": np.zeros(t + 1, bool),
            "target": np.int64(int(choice)),
        }


class ImageClassifyDataset(BaseDataset):
    """ImageNet finetuning (ref vision_data/image_classify_dataset.py).
    Training uses the reference's raw_transform pipeline: resize +
    distortion + blur + flip + RandAugment; batch-level mixup/cutmix is
    applied by the image_classify task iterator (tasks.py)."""

    def __init__(self, split, table, tokenizer, dataset_dir="",
                 patch_image_size=384, center_crop=False, seed=3407,
                 **_unused):
        super().__init__(split, table, tokenizer, dataset_dir)
        self.patch_image_size = patch_image_size
        self.center_crop = center_crop
        self.rng = np.random.RandomState(seed)
        if split == "train":
            from .randaugment import GaussianBlur, RandomAugment, RandomDistortion

            # distinct per-transform seeds: sharing one seed gives four
            # IDENTICAL random streams, correlating blur/distort/augment
            # decisions sample-by-sample
            self.distort = RandomDistortion(0.4, 0.4, 0.4, 0, 0.5,
                                            seed=seed + 1)
            self.blur = GaussianBlur(0.5, seed=seed + 2)
            self.randaug = RandomAugment(
                2, 7, augs=["Identity", "Equalize", "Brightness", "Sharpness",
                            "ShearX", "ShearY", "TranslateX", "TranslateY",
                            "Rotate"], seed=seed + 3)

    def __getitem__(self, index):
        image, label = self.table[index][:2]
        img = self.read_image(image)
        if self.split != "train" and self.center_crop:
            # ref image_classify_dataset.py:78-84: shorter-side bicubic
            # resize + center crop instead of the square stretch
            img = center_crop_image(img, self.patch_image_size)
        else:
            img = resize_image(img, self.patch_image_size)
        if self.split == "train":
            img = self.distort(img)
            img = self.blur(img)
            img = horizontal_flip(self.rng, img)
            img = self.randaug(img)
        return {
            "id": index,
            "source_image": normalize_image(np.asarray(img)),
            "target": np.int64(int(label)),
        }
