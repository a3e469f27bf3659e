"""Host-side mask generators for masked-denoising pretraining (numpy).

The port's copy of ``one_peace_tpu/data/masking.py`` (held equal by
``tests/test_torch_port_copies.py``).

Behavioral specs:
- whole-word text masking: ref data/pretrain_data/
  image_text_pretrain_dataset.py:124-138 + utils/data_utils.py:88-107
  (word starts sampled, mask extended over continuation BPE pieces);
- nested VL masks: a random subset of the unimodal text mask / a superset
  of the unmasked image patches (ref :74-95);
- random patch masking: ref :86-89;
- 1-D block masking for audio frames: ref utils/data_utils.py:110-220
  (data2vec-style: random centers dilated to length-5 blocks, then
  trimmed/expanded to exactly L*mask_prob masked frames).
"""

from __future__ import annotations

import math

import numpy as np


def whole_word_starts(dictionary, bpe) -> np.ndarray:
    """Per-dictionary-index flag: does this symbol begin a word?
    (ref utils/data_utils.py:88-107).  GPT-2 byte-level: a token begins a
    word iff its decoded text starts with whitespace (the 'Ġ' byte) or is
    not a continuation; specials count as beginnings."""
    flags = np.zeros(len(dictionary), dtype=bool)
    nspecial = 4
    for i in range(len(dictionary)):
        if i < nspecial:
            flags[i] = True
            continue
        sym = dictionary.symbols[i]
        if sym.startswith("madeupword"):
            flags[i] = True
            continue
        try:
            gpt2_id = int(sym)
        except ValueError:
            flags[i] = True
            continue
        tok = bpe.decoder.get(gpt2_id, "")
        # byte-level BPE: 'Ġ' (U+0120) encodes a leading space.  fairseq's
        # GPT2BPE.is_beginning_of_word is solely decode(x).startswith(' ')
        # — a no-leading-space punctuation token is a *continuation*, so no
        # isalnum special-casing here (it would change mask extents on any
        # caption with punctuation)
        flags[i] = (not tok) or tok[0] == "Ġ"
    return flags


def add_whole_word_mask(rng: np.random.RandomState, source: np.ndarray,
                        is_word_start_table: np.ndarray, p: float) -> np.ndarray:
    """ref image_text_pretrain_dataset.py:124-147."""
    is_word_start = is_word_start_table[source]
    num_to_mask = int(math.ceil(is_word_start.sum() * p))
    word_starts = np.nonzero(is_word_start)[0]
    indices = rng.permutation(word_starts)[:num_to_mask]
    mask = np.zeros(len(source), dtype=bool)
    mask[indices] = True
    # extend over word continuations
    extended = np.concatenate([is_word_start, [255]])
    cur = indices
    while cur.size > 0:
        uncompleted = extended[cur + 1] == 0
        cur = cur[uncompleted] + 1
        mask[cur] = True
    return mask


def nested_subset_mask(rng: np.random.RandomState, base_mask: np.ndarray,
                       ratio: float) -> np.ndarray:
    """VL text mask: |out| = int(len * ratio) positions drawn
    preferentially from OUTSIDE the unimodal base mask, spilling into it
    only when the complement is too small (ref
    image_text_pretrain_dataset.py:71-77 — randn ``masked_fill(base,
    -inf).argsort(descending)`` ranks every non-base position above every
    base position)."""
    n = int(len(base_mask) * ratio)
    outside = np.nonzero(~base_mask)[0]
    chosen = rng.permutation(outside)[:n]
    if n > outside.size:
        inside = np.nonzero(base_mask)[0]
        chosen = np.concatenate(
            [chosen, rng.permutation(inside)[: n - outside.size]])
    out = np.zeros(len(base_mask), dtype=bool)
    out[chosen] = True
    return out


def random_patch_mask(rng: np.random.RandomState, num_patches: int,
                      ratio: float) -> np.ndarray:
    """ref :86-89."""
    n = int(num_patches * ratio)
    ids = rng.permutation(num_patches)[:n]
    mask = np.zeros(num_patches, dtype=bool)
    mask[ids] = True
    return mask


def superset_patch_mask(rng: np.random.RandomState, base_mask: np.ndarray,
                        ratio: float) -> np.ndarray:
    """VL image mask: all patches NOT in the unimodal mask, plus enough
    random ones from inside it to reach num_patches*ratio (ref :91-95)."""
    num_patches = len(base_mask)
    target = int(num_patches * ratio)
    outside = np.nonzero(~base_mask)[0]
    extra = target - outside.size
    inside = np.nonzero(base_mask)[0]
    chosen = rng.permutation(inside)[:max(extra, 0)]
    out = np.zeros(num_patches, dtype=bool)
    out[outside] = True
    out[chosen] = True
    return out


def compute_block_mask_1d(rng: np.random.RandomState, length: int,
                          mask_prob: float, mask_length: int = 5,
                          mask_prob_adjust: float = 0.1) -> np.ndarray:
    """data2vec block masking (ref utils/data_utils.py:110-220, the
    overlapping branch with require_same_masks=True): sample centers,
    dilate by mask_length, then trim to exactly int(L * mask_prob)."""
    mask = np.zeros(length, dtype=bool)
    n_centers = int(length * ((mask_prob + mask_prob_adjust) / mask_length))
    centers = rng.randint(0, length, size=n_centers)
    offset = mask_length // 2
    for i in range(mask_length):
        idx = np.clip(centers + (i - offset), 0, length - 1)
        mask[idx] = True
    final_target = int(length * mask_prob)
    n = int(mask.sum())
    if n > final_target:
        masked = np.nonzero(mask)[0]
        unmask = rng.permutation(masked)[: n - final_target]
        mask[unmask] = False
    elif n < final_target:
        # center collisions under-shoot the target; require_same_masks
        # adds random positions to hit the exact count (ref fairseq
        # data_utils.py `elif n < final_target_len`) so every sample in a
        # batch masks exactly int(L * mask_prob) frames
        unmasked = np.nonzero(~mask)[0]
        extra = rng.permutation(unmasked)[: final_target - n]
        mask[extra] = True
    return mask


def to_preserve_ids(mask_with_cls: np.ndarray) -> np.ndarray:
    """Indices of un-masked positions (ref :100-107)."""
    return np.nonzero(~mask_with_cls)[0]


def with_cls(mask: np.ndarray, trailing_false: bool = False) -> np.ndarray:
    """Prepend the always-unmasked CLS flag (and EOS for text)."""
    parts = [np.zeros(1, bool), mask]
    if trailing_false:
        parts.append(np.zeros(1, bool))
    return np.concatenate(parts)
