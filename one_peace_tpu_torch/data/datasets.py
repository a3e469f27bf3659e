"""Task datasets: the retrieval part of ``one_peace_tpu/data/datasets.py``,
copied (held equal by ``tests/test_torch_port_retrieval_data.py``).
Host-side numpy sample builders; batching happens in ``data/collate.py``.

- ImageTextRetrievalDataset   ref vl_data/image_text_retrieval_dataset.py
- AudioTextRetrievalDataset   ref audio_data/audio_text_retrieval_dataset.py

The pretrain, VQA, NLVR2, RefCOCO, audio-classification, AQA and
image-classification datasets (and the masking, mixup and RandAugment
helpers they use) are not ported yet.
"""

from __future__ import annotations


import numpy as np

from .base_dataset import BaseDataset, audio_postprocess, clean_text, normalize_image, resize_image

DEFAULT_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                (512, 3, 2), (512, 2, 2), (512, 2, 2))


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
