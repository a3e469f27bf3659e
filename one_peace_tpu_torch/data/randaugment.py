"""RandAugment + photometric distortion transforms (PIL/numpy).

The port's copy of ``one_peace_tpu/data/randaugment.py`` (held equal by
``tests/test_torch_port_classify_data.py``).

Behavioral spec: ref one_peace/utils/randaugment.py (RandomAugment with N
ops of magnitude M over a named op list) and one_peace/utils/transforms.py
RandomDistortion/GaussianBlur — the training augmentations for NLVR2 and
ImageNet classification (ref nlvr2_dataset.py:33-42,
image_classify_dataset.py:55-66).

Independent implementation over PIL ImageOps/ImageEnhance.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

MAX_LEVEL = 10


def _scale(level: float, maxval: float) -> float:
    return level / MAX_LEVEL * maxval


def _rand_sign(rng) -> int:
    return 1 if rng.random() < 0.5 else -1


def apply_op(img: Image.Image, name: str, level: float, rng: random.Random) -> Image.Image:
    if name == "Identity":
        return img
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Invert":
        return ImageOps.invert(img)
    if name == "Posterize":
        bits = 8 - int(_scale(level, 4))
        return ImageOps.posterize(img, max(bits, 1))
    if name == "Solarize":
        thresh = 256 - int(_scale(level, 256))
        return ImageOps.solarize(img, thresh)
    if name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + _rand_sign(rng) * _scale(level, 0.9))
    if name == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + _rand_sign(rng) * _scale(level, 0.9))
    if name == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + _rand_sign(rng) * _scale(level, 0.9))
    if name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + _rand_sign(rng) * _scale(level, 0.9))
    if name == "Rotate":
        deg = _rand_sign(rng) * _scale(level, 30)
        return img.rotate(deg, resample=Image.BICUBIC, fillcolor=(128, 128, 128))
    if name == "ShearX":
        sh = _rand_sign(rng) * _scale(level, 0.3)
        return img.transform(img.size, Image.AFFINE, (1, sh, 0, 0, 1, 0),
                             resample=Image.BICUBIC, fillcolor=(128, 128, 128))
    if name == "ShearY":
        sh = _rand_sign(rng) * _scale(level, 0.3)
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, sh, 1, 0),
                             resample=Image.BICUBIC, fillcolor=(128, 128, 128))
    if name == "TranslateX":
        t = _rand_sign(rng) * _scale(level, 0.45) * img.size[0]
        return img.transform(img.size, Image.AFFINE, (1, 0, t, 0, 1, 0),
                             resample=Image.BICUBIC, fillcolor=(128, 128, 128))
    if name == "TranslateY":
        t = _rand_sign(rng) * _scale(level, 0.45) * img.size[1]
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, t),
                             resample=Image.BICUBIC, fillcolor=(128, 128, 128))
    raise ValueError(f"unknown augment op {name!r}")


DEFAULT_OPS = [
    "Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
]


class RandomAugment:
    """Apply N randomly chosen ops at magnitude M
    (ref utils/randaugment.py RandomAugment(2, 7, augs=[...]))."""

    def __init__(self, n: int = 2, m: int = 7,
                 augs: Optional[Sequence[str]] = None, seed: int = 0):
        self.n = n
        self.m = m
        self.augs: List[str] = list(augs) if augs else DEFAULT_OPS
        self.rng = random.Random(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        for name in self.rng.choices(self.augs, k=self.n):
            img = apply_op(img, name, self.m, self.rng)
        return img


class RandomDistortion:
    """Photometric jitter (brightness/contrast/saturation/hue) applied with
    probability p (ref utils/transforms.py RandomDistortion(0.4,...,0.5))."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.0,
                 prob=0.5, seed=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.prob = prob
        self.rng = random.Random(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        r = self.rng
        if r.random() >= self.prob:
            return img
        if self.brightness:
            img = ImageEnhance.Brightness(img).enhance(
                1 + r.uniform(-self.brightness, self.brightness))
        if self.contrast:
            img = ImageEnhance.Contrast(img).enhance(
                1 + r.uniform(-self.contrast, self.contrast))
        if self.saturation:
            img = ImageEnhance.Color(img).enhance(
                1 + r.uniform(-self.saturation, self.saturation))
        if self.hue:
            arr = np.asarray(img.convert("HSV"), np.int16)
            arr[..., 0] = (arr[..., 0] + int(r.uniform(-self.hue, self.hue) * 255)) % 256
            img = Image.fromarray(arr.astype(np.uint8), "HSV").convert("RGB")
        return img


class GaussianBlur:
    """Blur with probability p (ref utils/transforms.py GaussianBlur(0.5))."""

    def __init__(self, prob=0.5, radius_range=(0.1, 2.0), seed=0):
        self.prob = prob
        self.radius_range = radius_range
        self.rng = random.Random(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < self.prob:
            radius = self.rng.uniform(*self.radius_range)
            return img.filter(ImageFilter.GaussianBlur(radius))
        return img
