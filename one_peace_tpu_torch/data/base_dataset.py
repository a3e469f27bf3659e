"""Dataset base: image/audio IO, text cleaning, preprocessing transforms.

The port's copy of ``one_peace_tpu/data/base_dataset.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``); its lazy imports reach the
port's ``hub.load_audio`` and ``models.adapters.audio.conv_output_length``.

Behavioral spec: ref one_peace/data/base_dataset.py:27-121.  Implemented
host-side in numpy/PIL (the reference uses torchvision transforms; PIL
bicubic is the same resampler torchvision calls on PIL inputs).
"""

from __future__ import annotations

import math
import os
import re
from typing import Optional, Tuple

import numpy as np

CLIP_DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


def clean_text(text: str, max_words: Optional[int] = None) -> str:
    """ref base_dataset.py:70-84 (process_text)."""
    text = text.lower().lstrip(",.!?*#:;~")
    text = re.sub(r"\s{2,}|\t", " ", text)
    text = text.rstrip("\n").strip(" ")
    if max_words is not None:
        text = " ".join(text.split(" ")[:max_words])
    return text


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """HWC uint8/float [0,1] -> CHW normalized float32 (CLIP stats)."""
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_DEFAULT_MEAN, np.float32)) / np.asarray(
        CLIP_DEFAULT_STD, np.float32)
    return arr.transpose(2, 0, 1).astype(np.float32)


def resize_image(img, size: int):
    """PIL bicubic resize to (size, size) — torchvision Resize semantics on
    PIL inputs."""
    from PIL import Image

    return img.resize((size, size), Image.BICUBIC)


def center_crop_image(img, size: int):
    """torchvision Resize(size) (shorter side, bicubic) + CenterCrop(size)
    (ref image_classify_dataset.py:78-84 center_crop eval transform)."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nw, nh = max(size, int(round(w * size / h))), size
    img = img.resize((nw, nh), Image.BICUBIC)
    x0 = int(round((nw - size) / 2.0))
    y0 = int(round((nh - size) / 2.0))
    return img.crop((x0, y0, x0 + size, y0 + size))


def random_resized_crop(rng: np.random.RandomState, img, size: int,
                        min_scale: float = 0.9, max_scale: float = 1.0):
    """torchvision RandomResizedCrop (scale in [min_scale, max_scale],
    ratio 3/4..4/3), bicubic (ref image_text_pretrain_dataset.py:46-52)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(min_scale, max_scale)
        log_ratio = (math.log(3 / 4), math.log(4 / 3))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            return img.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                (size, size), Image.BICUBIC)
    return img.resize((size, size), Image.BICUBIC)


def horizontal_flip(rng: np.random.RandomState, img, p: float = 0.5):
    from PIL import Image

    if rng.rand() < p:
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def audio_postprocess(wav: np.ndarray, sample_rate: int,
                      max_duration: int = 15) -> np.ndarray:
    """ref base_dataset.py:86-103: mono, LayerNorm over the raw waveform,
    crop to max_duration, tile to >= 1 s."""
    if wav.ndim == 2:
        wav = wav.mean(-1)
    if sample_rate != 16000:
        raise ValueError(f"sample rate {sample_rate}, need 16000")
    wav = wav.astype(np.float32)
    wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
    if wav.shape[-1] > sample_rate * max_duration:
        wav = wav[: sample_rate * max_duration]
    if wav.shape[-1] < sample_rate:
        wav = np.tile(wav, math.ceil(sample_rate / wav.shape[-1]))[:sample_rate]
    return wav


class BaseDataset:
    """ref base_dataset.py:27-121 — IO + text encode glue shared by every
    task dataset."""

    def __init__(self, split: str, table, tokenizer, dataset_dir: str = ""):
        self.split = split
        self.table = table
        self.tokenizer = tokenizer
        self.dataset_dir = dataset_dir
        self.pad = tokenizer.pad
        self.eos = tokenizer.eos
        self._features_size_map = {}

    def __len__(self):
        return len(self.table)

    def read_image(self, image_path: str):
        from PIL import Image

        path = os.path.join(self.dataset_dir, image_path)
        return Image.open(path).convert("RGB")

    def read_audio(self, audio_path: str) -> Tuple[np.ndarray, int]:
        from ..hub import load_audio

        path = os.path.join(self.dataset_dir, audio_path)
        return load_audio(path, target_sr=16000), 16000

    def encode_text(self, text: str, length: Optional[int] = None,
                    append_eos: bool = True) -> np.ndarray:
        ids = self.tokenizer.dictionary.encode_line(
            " ".join(map(str, self.tokenizer.bpe.encode(text))))
        if length is not None:
            ids = ids[:length]
        if append_eos:
            ids = ids + [self.eos]
        return np.asarray(ids, np.int64)

    def conv_length(self, size: int, spec) -> int:
        if size not in self._features_size_map:
            from ..models.adapters.audio import conv_output_length

            self._features_size_map[size] = conv_output_length(size, spec)
        return self._features_size_map[size]
