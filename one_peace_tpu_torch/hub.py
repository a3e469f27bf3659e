"""Public inference API: ``from_pretrained`` and the hub interface
(counterpart of ``one_peace_tpu/hub.py``).

``from_pretrained`` loads a fairseq ``.pt`` checkpoint (converted on the fly
by ``utils/checkpoint_convert.py``) or the JAX package's flat ``.npz`` export
into the retrieval model, or with ``model_type="one_peace_classify"`` into
the classify model (``num_classes`` and ``classify_kwargs`` build its head),
on ``device``; casts it to ``dtype``, and with ``quantize`` converts the
trunk's projections to int8 (``ops/quant.py``), in that order, as the JAX
hub does.  The interface exposes ``process_text/image/audio`` and
``extract_{text,image,audio,vl}_features``; on a classify model the
``extract_*`` calls return its logits and take no ``encoder_type``.

Preprocessing is the JAX hub's (ref hub_interface.py:92-193):
- text: ``' ' + lower()`` -> GPT-2 BPE -> dict ids -> trunc 70 -> + EOS;
- image: PIL bicubic resize to (patch_image_size,)*2, CLIP mean/std; or with
  ``on_device=True`` the resize and normalisation on the model's device
  (``ops/preprocess.resize_normalize``);
- audio: 16 kHz mono waveform, LayerNorm over the raw waveform, crop to the
  task's max duration / tile to >= 1 s, conv-length (or fbank-length)
  arithmetic for the padding mask.  WAV is decoded with the stdlib, FLAC
  with the JAX package's decoder (``data/flac.py``, no JAX).

The extraction runs eagerly under ``torch.inference_mode()``: there is no
jit, so no shape buckets.  ``dtype`` "float32", "bf16" or "fp16": the
attention kernels and the int8 path take all three.  Not ported: orbax
checkpoint directories, which raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .core.config import ModelConfig, TaskConfig
from .data.tokenizer import TextTokenizer, find_bpe_dir

from .models.adapters.audio import conv_output_length
from .models.classify import OnePeaceClassifyModel, check_head
from .models.one_peace import OnePeaceRetrievalModel
from .ops.preprocess import LogMelFbank, resize_normalize
from .ops.quant import quantize_ffn_
from .utils.checkpoint import load_npz
from .utils.checkpoint_convert import (convert_classify_model, convert_retrieval_model,
                                       load_torch_state_dict)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
QUANTIZE = ("none", "ffn", "ffn_attn")


def _load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode a WAV file to mono fp32 at target_sr (stdlib + scipy)."""
    import wave

    with wave.open(path, "rb") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        ch = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = math.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def load_audio(path_or_array, target_sr: int = 16000) -> np.ndarray:
    """Accepts a file path (wav/flac) or a raw waveform array."""
    if isinstance(path_or_array, np.ndarray):
        return path_or_array.astype(np.float32)
    path = str(path_or_array)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return _load_wav(path, target_sr)
    if ext == ".flac":
        from .data.flac import read_flac  # the native decoder

        wav, sr = read_flac(path)
        if sr != target_sr:
            from scipy.signal import resample_poly

            g = math.gcd(sr, target_sr)
            wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        return wav
    raise ValueError(f"unsupported audio format: {path}")


def from_pretrained(
    model_path: str,
    model_type: str = "one_peace_retrieval",
    dtype: str = "float32",
    bpe_dir: Optional[str] = None,
    model_cfg: Optional[ModelConfig] = None,
    task_cfg: Optional[TaskConfig] = None,
    attn_impl: str = "pallas",
    num_classes: Optional[int] = None,
    classify_kwargs: Optional[dict] = None,
    quantize: str = "none",
    device="cuda",
) -> "OnePeaceHubInterface":
    """Load a checkpoint into the retrieval model, or the classify model
    with ``model_type="one_peace_classify"``, on ``device``.

    ``model_path`` is a fairseq ``.pt`` or the JAX package's ``.npz``.
    ``dtype`` is "float32", "bf16" or "fp16".  The classify head has
    ``num_classes`` classes (2 when not given, as in the JAX hub) and takes
    ``classify_kwargs`` (``attn_pooling``, ``use_pooler``,
    ``use_two_images``, ...); a checkpoint whose ``classify_head`` differs
    from that head raises, naming the entry.
    ``quantize``: "ffn" serves the per-modality FFN projections in int8,
    "ffn_attn" also the self-attention q/k/v/out projections, "none"
    (default) keeps the exact path; the classify head stays as it is."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be one of {QUANTIZE}, got {quantize!r}")
    built_default_model_cfg = model_cfg is None
    if model_cfg is None:
        model_cfg = ModelConfig(_name=model_type)
        model_cfg.encoder.attn_impl = attn_impl
    if task_cfg is None:
        task_cfg = TaskConfig()
    if built_default_model_cfg:
        # keep the image rel-pos grid in step with the eval resolution
        model_cfg.encoder.image_adapter.rel_bucket_size = task_cfg.patch_image_size // 16

    classify = model_type == "one_peace_classify"
    if model_path.endswith(".pt"):
        convert = convert_classify_model if classify else convert_retrieval_model
        state = convert(load_torch_state_dict(model_path), model_cfg)
    elif os.path.isdir(model_path):
        raise NotImplementedError("orbax checkpoint directories are not ported: export "
                                  "the params to .npz (utils/native_checkpoint.save_params)")
    else:
        state = load_npz(model_path)
    if classify:
        model = OnePeaceClassifyModel(model_cfg, num_classes=num_classes or 2,
                                      **(classify_kwargs or {}), device=device,
                                      dtype=DTYPES[dtype])
    else:
        model = OnePeaceRetrievalModel(model_cfg, device=device, dtype=DTYPES[dtype])
    if classify:
        check_head(state, model)
    # branches the head does not use are pruned (ref one_peace_retrieval.py:143-150)
    wanted = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in state.items() if k in wanted}, strict=True)
    del state
    if quantize != "none":  # after the cast, as the JAX hub: int8 of the dtype's weights
        quantize_ffn_(model, include_attn=quantize == "ffn_attn")
    return OnePeaceHubInterface(model_cfg, task_cfg, model, dtype=DTYPES[dtype],
                                bpe_dir=bpe_dir)


class OnePeaceHubInterface:
    """User-facing embedding interface (ref hub_interface.py:76-226).
    Outputs are tensors on the model's device."""

    def __init__(self, model_cfg: ModelConfig, task_cfg: TaskConfig, model,
                 dtype: torch.dtype = torch.float32, bpe_dir: Optional[str] = None):
        self.model_cfg = model_cfg
        self.task_cfg = task_cfg
        self.model = model.eval()
        self.dtype = dtype
        self.device = next(model.parameters()).device
        bpe = find_bpe_dir(bpe_dir or task_cfg.bpe_dir or None)
        if bpe is None:
            raise FileNotFoundError(
                "BPE assets not found; set bpe_dir or $ONE_PEACE_BPE_DIR to a "
                "directory with encoder.json/vocab.bpe/dict.txt")
        self.tokenizer = TextTokenizer(bpe, max_src_length=task_cfg.max_src_length)
        ad_cfg = model_cfg.encoder.audio_adapter
        if ad_cfg.frontend == "fbank":
            self._audio_out_len = LogMelFbank(
                n_fft=ad_cfg.fbank_n_fft, hop=ad_cfg.fbank_hop,
                n_mels=ad_cfg.fbank_n_mels).num_frames
        else:
            self._audio_out_len = lambda n: conv_output_length(n, ad_cfg.feature_encoder_spec)

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _forward(self, encoder_type: str, **net_input) -> torch.Tensor:
        """The model on ``net_input`` under ``torch.inference_mode()``: the
        embeddings of ``encoder_type``, or a classify model's logits."""
        net_input = {k: self._to_device(v) for k, v in net_input.items()}
        with torch.inference_mode():
            if isinstance(self.model, OnePeaceClassifyModel):
                return self.model(**net_input)
            return self.model(**net_input, encoder_type=encoder_type)

    # ------------------------------------------------------------------
    # preprocessing
    # ------------------------------------------------------------------

    def process_text(self, text_list: Sequence[str], pad_to: Optional[int] = None) -> torch.Tensor:
        batch = self.tokenizer.encode_batch(list(text_list))
        if pad_to is not None and batch.shape[1] < pad_to:
            batch = np.pad(batch, ((0, 0), (0, pad_to - batch.shape[1])),
                           constant_values=self.tokenizer.pad)
        return self._to_device(batch.astype(np.int64))

    def _load_image(self, img) -> np.ndarray:
        from PIL import Image

        size = self.task_cfg.patch_image_size
        if isinstance(img, (str, os.PathLike)):
            img = Image.open(img).convert("RGB")
        if isinstance(img, Image.Image):  # bicubic resize like the ref
            img = img.resize((size, size), Image.BICUBIC)
            arr = np.asarray(img, np.float32) / 255.0
        elif np.asarray(img).dtype == np.uint8:  # pre-resized raw pixels
            arr = np.asarray(img, np.float32) / 255.0
        else:  # ndarray float: pre-resized, scaled to [0, 1]
            arr = np.asarray(img, np.float32)
        arr = (arr - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
        return arr.transpose(2, 0, 1)  # CHW

    def process_image(self, image_list, return_image_sizes: bool = False,
                      on_device: bool = False):
        """``on_device=True`` runs the bicubic resize + CLIP normalisation on
        the model's device; the host PIL path stays the parity default."""
        from PIL import Image

        arrays, widths, heights = [], [], []
        for item in image_list:
            img = Image.open(item).convert("RGB") if isinstance(item, (str, os.PathLike)) \
                else item
            if isinstance(img, Image.Image):
                w, h = img.size
            else:
                h, w = np.shape(img)[:2]
            widths.append(w)
            heights.append(h)
            if on_device:
                raw = np.array(img)  # a writable copy: PIL's array view is read-only
                if raw.dtype != np.uint8:  # pre-scaled [0,1] float input
                    raw = np.clip(raw * 255.0, 0, 255).astype(np.uint8)
                arrays.append(resize_normalize(self._to_device(raw),
                                               self.task_cfg.patch_image_size,
                                               CLIP_MEAN, CLIP_STD))
            else:
                arrays.append(self._load_image(img))
        if on_device:
            src_images = torch.stack(arrays).to(self.dtype)
        else:  # float64 -> fp32 -> dtype, as the JAX hub's host arrays go
            src_images = self._to_device(np.stack(arrays).astype(np.float32)).to(self.dtype)
        if return_image_sizes:
            return src_images, torch.tensor(widths), torch.tensor(heights)
        return src_images

    def process_audio(self, audio_list, pad_to: Optional[int] = None):
        """LayerNorm the raw waveform, crop to the max duration, tile to
        >= 1 s, build the frame padding mask (ref hub_interface.py:170-193)."""
        sr = 16000
        feats_list, lengths = [], []
        for item in audio_list:
            wav = load_audio(item, sr)
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
            if wav.shape[-1] > sr * self.task_cfg.max_duration:
                wav = wav[: sr * self.task_cfg.max_duration]
            if wav.shape[-1] < sr:
                reps = math.ceil(sr / wav.shape[-1])
                wav = np.tile(wav, reps)[:sr]
            feats_list.append(wav)
            lengths.append(wav.shape[-1])
        max_len = max(lengths) if pad_to is None else max(pad_to, max(lengths))
        src = np.zeros((len(feats_list), max_len), np.float32)
        masks = np.ones((len(feats_list), self._audio_out_len(max_len) + 1), bool)
        for i, wav in enumerate(feats_list):
            src[i, : len(wav)] = wav
            masks[i, : self._audio_out_len(len(wav)) + 1] = False
        return self._to_device(src).to(self.dtype), self._to_device(masks)

    def process_image_text_pairs(self, image_text_list, return_image_sizes=False):
        images = [p[0] for p in image_text_list]
        texts = [p[1] for p in image_text_list]
        src_tokens = self.process_text(texts)
        if return_image_sizes:
            src_images, w, h = self.process_image(images, return_image_sizes=True)
            return (src_images, w, h), src_tokens
        return self.process_image(images), src_tokens

    # ------------------------------------------------------------------
    # feature extraction
    # ------------------------------------------------------------------

    def extract_text_features(self, src_tokens) -> torch.Tensor:
        return self._forward("text", src_tokens=src_tokens)

    def extract_image_features(self, src_images) -> torch.Tensor:
        return self._forward("image", src_images=src_images)

    def extract_audio_features(self, src_audios, audio_padding_masks) -> torch.Tensor:
        return self._forward("audio", src_audios=src_audios,
                             audio_padding_masks=audio_padding_masks)

    def extract_vl_features(self, src_images, src_tokens):
        """Joint VL forward: the per-modality features (text, image, None)."""
        with torch.inference_mode():
            return self.model.encoder_wrapper(
                src_tokens=self._to_device(src_tokens),
                src_images=self._to_device(src_images), encoder_type="vl")
