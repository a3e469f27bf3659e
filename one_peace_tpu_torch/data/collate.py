"""Batch collation (numpy).

The port's copy of ``one_peace_tpu/data/collate.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``).

Behavioral spec: ref one_peace/data/__init__.py:6-90 (merge per key; pad
tokens with the dict pad, masks with False, preserve_ids with -1, audio
with 0; stack images) and utils/data_utils.py:22-47 (collate_tokens).

``pad_to_length``/``pad_to_multiple`` pad to a fixed length or a multiple
of one.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def collate_tokens(values: List[np.ndarray], pad_value, pad_to_length=None,
                   pad_to_multiple: int = 1) -> np.ndarray:
    size = max(len(v) for v in values)
    if pad_to_length is not None:
        size = max(size, pad_to_length)
    if pad_to_multiple != 1 and size % pad_to_multiple != 0:
        size = int(((size - 0.1) // pad_to_multiple + 1) * pad_to_multiple)
    v0 = np.asarray(values[0])
    out = np.full((len(values), size) + v0.shape[1:], pad_value, dtype=v0.dtype)
    for i, v in enumerate(values):
        out[i, : len(v)] = v
    return out


_PAD_RULES = {
    "source_text": ("src_tokens", "pad"),
    "source_audio": ("src_audios", 0.0),
    "audio_padding_mask": ("audio_padding_masks", True),
    "text_mask_indices": ("text_mask_indices", False),
    "text_preserve_ids": ("text_preserve_ids", -1),
    "image_mask_indices": ("image_mask_indices", False),
    "image_preserve_ids": ("image_preserve_ids", -1),
    "audio_mask_indices": ("audio_mask_indices", False),
    "audio_preserve_ids": ("audio_preserve_ids", -1),
    "vl_text_mask_indices": ("vl_text_mask_indices", False),
    "vl_text_preserve_ids": ("vl_text_preserve_ids", -1),
    "vl_image_mask_indices": ("vl_image_mask_indices", False),
    "vl_image_preserve_ids": ("vl_image_preserve_ids", -1),
    "al_text_mask_indices": ("al_text_mask_indices", False),
    "al_text_preserve_ids": ("al_text_preserve_ids", -1),
    "al_audio_mask_indices": ("al_audio_mask_indices", False),
    "al_audio_preserve_ids": ("al_audio_preserve_ids", -1),
}


def collate(samples: List[Dict], pad_idx: int = 1,
            pad_to_length: Optional[Dict[str, int]] = None) -> Dict:
    """list of per-sample dicts -> batch dict mirroring the reference's
    net_input structure (flattened: the criterions read keys directly)."""
    if not samples:
        return {}
    pad_to_length = pad_to_length or {}
    batch: Dict = {
        "id": np.asarray([s.get("id", i) for i, s in enumerate(samples)]),
        "nsentences": len(samples),
        "ntokens": len(samples),
    }
    first = samples[0]
    for key, (out_key, pad) in _PAD_RULES.items():
        if first.get(key) is not None:
            if isinstance(first[key], list):  # per-sample lists (e.g. choices)
                # flatten BEFORE any np.asarray: ragged choice lists
                # (answers tokenize to different lengths) would make
                # np.asarray raise on numpy >= 1.24
                values = [np.asarray(item) for s in samples for item in s[key]]
            else:
                values = [np.asarray(s[key]) for s in samples]
            pad_val = pad_idx if pad == "pad" else pad
            batch[out_key] = collate_tokens(values, pad_val,
                                            pad_to_length.get(out_key))
    if first.get("source_image") is not None:
        batch["src_images"] = np.stack([s["source_image"] for s in samples])
    if first.get("source_image_2") is not None:
        batch["src_images_2"] = np.stack([s["source_image_2"] for s in samples])
    if first.get("target") is not None:
        t0 = np.asarray(first["target"])
        if t0.ndim == 0:
            batch["target"] = np.asarray([s["target"] for s in samples])
        else:
            batch["target"] = np.stack([np.asarray(s["target"]) for s in samples])
    for extra in ("region_coords", "image_widths", "image_heights"):
        if first.get(extra) is not None:
            batch[extra] = np.stack([np.asarray(s[extra]) for s in samples])
    return batch
