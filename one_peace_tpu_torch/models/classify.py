"""ONE-PEACE classification model (counterpart of
``one_peace_tpu/models/classify.py``): the encoder wrapper and the classify
head of ``models/one_peace.py``.

- The head type gates the branches: text for ``text``/``vl``/``al``, image
  for ``image``/``vl``, audio for ``audio``/``al``.
- The model always keeps one rel-pos table per layer
  (``num_rel_tables=layers``), whatever ``copy_rel_pos_table`` says, as the
  JAX model does.
- The head reads the text features where there are any, unless
  ``use_image_features``; else the image's, else the audio's.
- A second image (NLVR2) runs through the wrapper with
  ``is_second_image=True`` and the head concatenates its pooled features;
  the head must be built with ``use_two_images``.
- ``freeze_finetune_updates``: while the update count is below it, the
  encoder's features are detached, so only the head trains.  The count is
  ``forward``'s ``num_updates`` where the trainer passes it, else
  ``set_num_updates``' value (unfrozen by default).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.registry import MODELS
from .components import split_generator
from .one_peace import ClassifyHead, ModelWrapper

# the batch keys ``forward`` reads
NET_INPUT_KEYS = ("src_tokens", "src_images", "src_images_2", "src_audios",
                  "audio_padding_masks")


def choice_net_input(batch: Dict, num_choices: int, device=None) -> Dict:
    """AQA's net input: the batch holds one token row per answer choice,
    (B * num_choices, Lt), and one clip per question; each clip and its
    padding mask are repeated num_choices times (``repeat_interleave``) on
    ``device``, the clip's own device when None."""
    out = {"src_tokens": batch["src_tokens"]}
    for key in ("src_audios", "audio_padding_masks"):
        out[key] = torch.as_tensor(batch[key], device=device).repeat_interleave(num_choices, dim=0)
    return out


@MODELS.register("one_peace_classify")
class OnePeaceClassifyModel(nn.Module):
    """Parameters are created uninitialised on ``device`` (the card unless
    the caller asks for another) in ``dtype``; ``model.cfg.encoder.attn_impl``
    selects the attention path at run time."""

    def __init__(self, cfg: ModelConfig, num_classes: int, head_scale_ratio: float = 1.0,
                 use_pooler: bool = False, pooler_dropout: float = 0.0,
                 attn_pooling: bool = False, use_two_images: bool = False,
                 use_image_features: bool = False, freeze_finetune_updates: int = 0,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        cfg = copy.deepcopy(cfg)
        self.cfg = cfg
        enc = cfg.encoder
        head = cfg.head_type
        enc.use_text_moe = head in ("text", "vl", "al")
        enc.use_image_moe = head in ("image", "vl")
        enc.use_audio_moe = head in ("audio", "al")
        self.head_type = head
        self.use_image_features = use_image_features
        self.freeze_finetune_updates = freeze_finetune_updates
        self.num_updates = freeze_finetune_updates
        kw = dict(device=device, dtype=dtype)
        self.encoder_wrapper = ModelWrapper(
            enc, use_text_norm=enc.use_text_moe, use_image_norm=enc.use_image_moe,
            use_audio_norm=enc.use_audio_moe, num_rel_tables=enc.layers, **kw)
        self.classify_head = ClassifyHead(
            attn_pooling=attn_pooling, use_pooler=use_pooler, pooler_dropout=pooler_dropout,
            input_dim=enc.embed_dim, num_heads=enc.attention_heads,
            head_scale_ratio=head_scale_ratio, num_classes=num_classes,
            use_two_images=use_two_images, **kw)

    def set_num_updates(self, num_updates: int) -> None:
        self.num_updates = num_updates

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        src_images: Optional[torch.Tensor] = None,
        src_images_2: Optional[torch.Tensor] = None,
        src_audios: Optional[torch.Tensor] = None,
        audio_padding_masks: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        num_updates: Optional[int] = None,
    ) -> torch.Tensor:
        """(B, num_classes) logits.  ``deterministic=False`` with a
        generator is the training path."""
        updates = self.num_updates if num_updates is None else num_updates
        frozen = bool(self.freeze_finetune_updates) and updates < self.freeze_finetune_updates

        def maybe_freeze(x):
            return x.detach() if frozen and x is not None else x

        gens = split_generator(generator, 3)

        def run(images, second, gen):
            return self.encoder_wrapper(
                src_tokens=src_tokens, src_images=images, is_second_image=second,
                src_audios=src_audios, audio_padding_masks=audio_padding_masks,
                encoder_type=self.head_type, deterministic=deterministic,
                return_padding_mask=True, generator=gen)

        text_f, image_f, audio_f, text_pad, image_pad, audio_pad = run(src_images, False, gens[0])
        text_f, image_f, audio_f = map(maybe_freeze, (text_f, image_f, audio_f))
        feats_2 = None
        if src_images_2 is not None:
            feats_2 = tuple(map(maybe_freeze, run(src_images_2, True, gens[1])[:3]))

        if text_f is not None and not self.use_image_features:
            feats, pad, slot = text_f, text_pad, 0
        elif image_f is not None:
            feats, pad, slot = image_f, image_pad, 1
        elif audio_f is not None:
            feats, pad, slot = audio_f, audio_pad, 2
        else:
            raise NotImplementedError(self.head_type)
        f2 = feats_2[slot] if feats_2 else None
        return self.classify_head(feats, f2, pad, deterministic=deterministic,
                                  generator=gens[2])


def check_head(state: Dict[str, torch.Tensor], model: OnePeaceClassifyModel) -> None:
    """Raise ``ValueError`` naming the first ``classify_head`` entry of
    ``state`` that ``model``'s head lacks or holds in another shape: a
    checkpoint whose head was trained with another class count, a second
    image, attention pooling or a pooler does not fit the task's head."""
    wanted = model.state_dict()
    for key, value in state.items():
        if not key.startswith("classify_head."):
            continue
        if key not in wanted:
            raise ValueError(f"the checkpoint's {key} has no counterpart in the model's head; "
                             f"the checkpoint's head differs from the one the task builds")
        if tuple(value.shape) != tuple(wanted[key].shape):
            raise ValueError(f"the checkpoint's {key} is {tuple(value.shape)}, the model's head "
                             f"holds {tuple(wanted[key].shape)}; the checkpoint's head differs "
                             f"from the one the task builds")
