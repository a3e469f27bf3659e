"""The assembled vision models (counterpart of ``one_peace_tpu/vision/zoo.py``).

- ``OnePeaceDetector``: the windowed trunk, the learned pyramid, a proposer
  (RPN, the recipe's, or FCOS), the 3-stage cascade box head and the mask
  head.  ``detect`` runs the trunk, pyramid and proposer on the device,
  decodes proposals on the host, pads them to ``max_proposals`` per image,
  runs the cascade and the mask head as one batched call each, and decodes
  on the host.  ``vision/det_train.detector_training_loss`` trains it.
- ``OnePeaceMask2FormerSegmenter`` (the reference's 896 px ADE20K recipe)
  and ``OnePeaceSegmenter`` (UperNet): the ViT-Adapter backbone and a
  decode head, served on one crop (``logits``), by sliding windows
  (``slide_scores``) and over scales and flips (``ms_flip_logits``), all on
  the device.  The JAX package's ``ONE_PEACE_SLIDE_IMPL`` knob and its host
  window loop work around TPU compiles and have no counterpart here.
- ``OnePeaceVideoClassifier``: the K400 recognizer (``vision/video_backbone``)
  with ``load_pretrained``: the trunk from a pretrain checkpoint, the
  adapters, norm and head as the model holds them (its init).

The models are built on ``cuda`` unless the caller passes a device."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.components import resize_linear
from ..ops.quant import quantize_ffn_
from ..utils.checkpoint import params_from_jax
from ..utils.checkpoint_convert import (convert_encoder_wrapper, load_torch_state_dict,
                                        upgrade_state_dict)
from ..utils.vision_checkpoint import convert_det_backbone, convert_video_backbone
from .adapter import OnePeaceAdapterBackbone
from .cascade_rcnn import CascadeBoxHead, MaskHead
from .det_backbone import DetBackbone, SimpleFeaturePyramid
from .detection import FCOSHead, empty_result
from .mask2former import Mask2FormerHead, semantic_inference
from .rpn import RPNHead
from .upernet import UperNetHead
from .video_backbone import VideoClassifierV2


# the JAX package's ``vision/zoo.quantize_serving_params``: int8 serving of a
# zoo model's trunk FFNs, in place (``quantize_ffn_``'s docstring)
quantize_serving_params = quantize_ffn_


class OnePeaceDetector(nn.Module):
    """Cascade Mask R-CNN over the windowed ONE-PEACE trunk.  ``backbone_kw``
    go to ``DetBackbone``: its geometry, ``drop_path_rate``,
    ``checkpoint_activations`` and ``attn_impl``."""

    PYRAMID_KEYS = ("p4", "p8", "p16", "p32")
    STRIDES = (4, 8, 16, 32)

    def __init__(self, num_classes: int = 80, image_size: int = 1024, fpn_channels: int = 256,
                 with_masks: bool = True, proposer: str = "fcos", device="cuda", dtype=None,
                 **backbone_kw):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        backbone_kw.setdefault("bucket_size", image_size // 16)
        self.backbone = DetBackbone(**backbone_kw, **kw)
        self.fpn = SimpleFeaturePyramid(self.backbone.d, out_channels=fpn_channels, **kw)
        if proposer == "fcos":
            self.proposer = FCOSHead(fpn_channels, num_classes, strides=self.STRIDES, **kw)
        elif proposer == "rpn":
            self.proposer = RPNHead(fpn_channels, strides=self.STRIDES, **kw)
        else:
            raise ValueError(f"unknown proposer {proposer!r}")
        self.proposer_kind = proposer
        self.box_head = CascadeBoxHead(fpn_channels, num_classes, **kw)
        self.mask_head = MaskHead(fpn_channels, num_classes, **kw) if with_masks else None
        self.num_classes = num_classes

    @torch.no_grad()
    def load_pretrained(self, sd: Union[str, Dict[str, np.ndarray]]) -> "OnePeaceDetector":
        """The trunk from a pretrain checkpoint (a fairseq ``.pt`` path or its
        {name: np.ndarray} state dict, pretrain or vision naming); the
        pyramid and heads keep their values (fill them first, e.g. with
        ``utils.random_weights.fill_random_``), as the reference's
        strict=False load leaves them fresh."""
        if isinstance(sd, str):
            sd = load_torch_state_dict(sd)
        tree = convert_det_backbone(sd, self.backbone)
        state = params_from_jax({"backbone": tree})
        self.load_state_dict(state, strict=False)
        missing = {k for k in self.state_dict() if k.startswith("backbone.")} - set(state)
        if missing:
            raise KeyError(f"the checkpoint left trunk weights unset: {sorted(missing)[:5]}")
        return self

    def jax_layout(self) -> Dict[str, Dict]:
        """What ``utils.checkpoint.params_to_jax`` needs to rebuild the JAX
        package's tree from this model's ``state_dict``: the trunk's global
        period (its layers regroup into ``win_layers`` / ``glob_layers``) and
        the JAX keys of the pyramid's levels (``scale_4_0`` -> ``scale_4.0``)."""
        return {"periods": {"backbone.layers": self.backbone.global_period},
                "names": {f"fpn.{self.fpn.stage_name(s)}": f"scale_{s}" for s in self.fpn.scales}}

    def features(self, images: torch.Tensor):
        """images (B, 3, H, W) -> (the pyramid dict, the proposer's outputs
        per level)."""
        pyr = self.fpn(self.backbone(images))
        return pyr, self.proposer([pyr[k] for k in self.PYRAMID_KEYS])

    @torch.no_grad()
    def detect(self, images: torch.Tensor, score_thresh: float = 0.05, max_proposals: int = 512,
               max_dets: int = 100) -> List[Dict[str, np.ndarray]]:
        """Full inference: per image a dict of boxes (x0, y0, x1, y1),
        scores, labels and, with the mask head, ``masks`` (n, 28, 28)
        probabilities of each detection's class."""
        pyr, outs = self.features(images)
        feats = tuple(pyr[k] for k in self.PYRAMID_KEYS)  # multi-level ROIPooler input
        props = self.proposer.decode(outs, score_thresh=score_thresh, max_dets=max_proposals)
        bsz, device = images.shape[0], images.device
        boxes_pad = np.zeros((bsz, max_proposals, 4), np.float32)
        nprops = [min(len(p["boxes"]), max_proposals) for p in props]
        for b, p in enumerate(props):
            boxes_pad[b, :nprops[b]] = p["boxes"][:nprops[b]]
        bidx = torch.arange(bsz, device=device).repeat_interleave(max_proposals)
        scores, refined = self.box_head(feats, torch.from_numpy(boxes_pad).to(device).reshape(-1, 4),
                                        bidx)
        scores = scores.cpu().numpy().reshape(bsz, max_proposals, -1)
        refined = refined.cpu().numpy().reshape(bsz, max_proposals, 4)
        results = [self.box_head.decode(scores[b, :n], refined[b, :n], score_thresh=score_thresh,
                                        max_dets=max_dets) if n else empty_result()
                   for b, n in enumerate(nprops)]

        if self.mask_head is not None and any(len(r["boxes"]) for r in results):
            dboxes = np.zeros((bsz, max_dets, 4), np.float32)
            for b, r in enumerate(results):
                dboxes[b, :len(r["boxes"])] = r["boxes"]
            bidx = torch.arange(bsz, device=device).repeat_interleave(max_dets)
            logits = self.mask_head(feats, torch.from_numpy(dboxes).to(device).reshape(-1, 4), bidx)
            logits = logits.float().cpu().numpy()
            logits = logits.reshape((bsz, max_dets) + logits.shape[1:])
            for b, r in enumerate(results):
                nd = len(r["boxes"])
                if nd:
                    sel = logits[b, np.arange(nd), :, :, r["labels"]]
                    r["masks"] = 1.0 / (1.0 + np.exp(-sel))
        return results


class OnePeaceSegmenter(nn.Module):
    """ViT-Adapter backbone + UperNet (the lighter alternative to the
    recipe's Mask2Former head, on the same 896 px backbone).  ``adapter_kw``
    go to ``OnePeaceAdapterBackbone``.  Serving: ``logits`` on one crop,
    ``slide_scores`` over windows of any image, ``ms_flip_logits`` over
    scales and flips."""

    is_mask2former = False

    def __init__(self, enc_cfg, num_classes: int = 150, channels: int = 512, device="cuda",
                 dtype=None, **adapter_kw):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.backbone = OnePeaceAdapterBackbone(enc_cfg, **adapter_kw, **kw)
        self.num_classes = num_classes
        if not self.is_mask2former:
            self.head = UperNetHead([enc_cfg.embed_dim] * 4, channels=channels,
                                    num_classes=num_classes, **kw)

    @torch.no_grad()
    def load_pretrained(self, sd: Union[str, Dict[str, np.ndarray]]) -> "OnePeaceSegmenter":
        """The image adapter and the encoder layers from a pretrain
        checkpoint (a fairseq ``.pt`` path or its {name: np.ndarray} state
        dict), the position tables interpolated to the segmentation grid, the
        one rel-pos table copied to every layer; the spatial priors, the
        interactions and the head keep their values (fill them first), as the
        reference's strict=False load leaves them fresh.  A fine-tuned mmseg
        checkpoint is refused: its SyncBatchNorm statistics have no
        counterpart in this backbone's GroupNorms."""
        if isinstance(sd, str):
            sd = load_torch_state_dict(sd)
        bn_keys = [k for k in sd if "running_mean" in k or "running_var" in k
                   or k.startswith(("decode_head.", "auxiliary_head."))]
        if bn_keys:
            raise ValueError(
                "state dict looks like a finetuned mmseg seg checkpoint "
                f"(found {bn_keys[:3]}...); its SyncBatchNorm statistics have no "
                "GroupNorm equivalent in this backbone -- load the multimodal "
                "pretrain checkpoint instead")
        enc = self.backbone.cfg
        converted = convert_encoder_wrapper(upgrade_state_dict(dict(sd), enc.layers), enc)
        renames = (("encoder_wrapper.image_adapter.", "backbone.image_adapter."),
                   ("encoder_wrapper.fusion.", "backbone.encoder."))
        own = self.state_dict()
        state = {}
        for key, value in converted.items():
            for src, dst in renames:
                if key.startswith(src) and dst + key[len(src):] in own:
                    name = dst + key[len(src):]
                    if value.shape != own[name].shape:
                        raise ValueError(f"{name}: checkpoint {tuple(value.shape)}, "
                                         f"model {tuple(own[name].shape)}")
                    state[name] = value
        self.load_state_dict(state, strict=False)
        missing = {k for k in own if k.startswith(("backbone.image_adapter.",
                                                    "backbone.encoder.layers."))} - set(state)
        if missing:
            raise KeyError(f"the checkpoint left trunk weights unset: {sorted(missing)[:5]}")
        return self

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) -> (B, H/4, W/4, num_classes)."""
        return self.head(self.backbone(images))

    forward = logits

    @staticmethod
    def _slide_origins(h: int, w: int, crop: int, stride: int):
        """mmseg slide window grid: stride steps plus the shifted-back
        tail window (ref test_cfg mode='slide' semantics)."""
        ys = list(range(0, max(h - crop, 0) + 1, stride))
        xs = list(range(0, max(w - crop, 0) + 1, stride))
        if ys[-1] + crop < h:
            ys.append(h - crop)
        if xs[-1] + crop < w:
            xs.append(w - crop)
        return [(y, x) for y in ys for x in xs]

    @torch.no_grad()
    def slide_scores(self, images: torch.Tensor, crop: int, stride: int) -> torch.Tensor:
        """Sliding-window inference (the reference's test_cfg mode='slide',
        crop 896, stride 512): ``crop`` windows of the image zero-padded to at
        least the crop, each window's class scores resized to the crop and
        summed into a (B, H, W, C) fp32 canvas on the images' device, then
        averaged per pixel.  One loop on the device; the canvas never leaves
        it."""
        b, _, h, w = images.shape
        hp, wp = max(h, crop), max(w, crop)
        imgs = torch.nn.functional.pad(images.float(), (0, wp - w, 0, hp - h))
        canvas = torch.zeros(b, hp, wp, self.num_classes, dtype=torch.float32,
                             device=images.device)
        count = torch.zeros(hp, wp, dtype=torch.float32, device=images.device)
        for y, x in self._slide_origins(h, w, crop, stride):
            scores = self.logits(imgs[:, :, y:y + crop, x:x + crop]).float()
            canvas[:, y:y + crop, x:x + crop] += resize_linear(scores, (crop, crop), (1, 2))
            count[y:y + crop, x:x + crop] += 1.0
        return (canvas / count.clamp_min(1.0)[None, :, :, None])[:, :h, :w]

    @torch.no_grad()
    def ms_flip_logits(self, images: torch.Tensor, crop: int, stride: int,
                       ratios=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75), flip: bool = True) -> torch.Tensor:
        """mmseg's MultiScaleFlipAug test (the reference's "ms" numbers, ref
        seg/test.py:143-148): for each image ratio and its horizontal flip,
        slide inference, the class scores resized back to the input size,
        softmax, and the views' probabilities averaged.  Returns (B, H, W, C)
        fp32 on the images' device."""
        b, _, h, w = images.shape
        images = images.float()
        acc, views = None, 0
        for r in ratios:
            nh, nw = max(1, round(h * r)), max(1, round(w * r))
            imr = images if (nh, nw) == (h, w) else resize_linear(images, (nh, nw), (2, 3))
            for flipped in ((False, True) if flip else (False,)):
                sc = self.slide_scores(imr.flip(3) if flipped else imr, crop, stride)
                if flipped:
                    sc = sc.flip(2)
                if tuple(sc.shape[1:3]) != (h, w):
                    sc = resize_linear(sc, (h, w), (1, 2))
                prob = torch.softmax(sc, dim=-1)
                acc = prob if acc is None else acc + prob
                views += 1
        return acc / views


class OnePeaceMask2FormerSegmenter(OnePeaceSegmenter):
    """ViT-Adapter backbone + the Mask2Former head: the reference's 896 px
    ADE20K recipe (200 queries, feat/out 1024, a 6-layer MSDeformAttn pixel
    decoder, a 9-layer masked-attention decoder).  ``load_pretrained`` is the
    UperNet segmenter's (the backbone from the pretrain checkpoint)."""

    is_mask2former = True

    def __init__(self, enc_cfg, num_classes: int = 150, feat_channels: int = 256,
                 out_channels: Optional[int] = None, num_queries: int = 100, dec_layers: int = 9,
                 dec_heads: int = 8, dec_ffn_dim: Optional[int] = None, pixel_layers: int = 6,
                 pixel_heads: int = 8, pixel_ffn_dim: Optional[int] = None, device="cuda",
                 dtype=None, **adapter_kw):
        super().__init__(enc_cfg, num_classes=num_classes, device=device, dtype=dtype,
                         **adapter_kw)
        self.num_queries = num_queries
        d = enc_cfg.embed_dim
        self.head = Mask2FormerHead(
            num_classes, [d, d, d, d], feat_channels=feat_channels,
            out_channels=out_channels or feat_channels, num_queries=num_queries,
            num_layers=dec_layers, num_heads=dec_heads, ffn_dim=dec_ffn_dim or 8 * feat_channels,
            pixel_decoder_layers=pixel_layers, pixel_heads=pixel_heads,
            pixel_ffn_dim=pixel_ffn_dim or 4 * feat_channels, device=device, dtype=dtype)

    def forward_sets(self, images: torch.Tensor):
        """images (B, 3, H, W) -> (all_cls (L+1, B, Q, C+1), all_masks (L+1, B,
        Q, H/4, W/4)), the set predictions of every decoder round."""
        return self.head(self.backbone(images))

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """Semantic class scores (B, H/4, W/4, C): the final round's set
        prediction collapsed per pixel (probabilities, argmax-compatible with
        the UperNet path's logits)."""
        all_cls, all_masks = self.forward_sets(images)
        return semantic_inference(all_cls[-1], all_masks[-1])

    forward = logits


class OnePeaceVideoClassifier(VideoClassifierV2):
    """The K400 recognizer with pretrain loading.  ``backbone_kw`` go to
    ``VideoBackbone``: its geometry, frames, drop path, remat and
    ``attn_impl``.  Built on ``cuda`` unless the caller passes a device."""

    def __init__(self, num_classes: int = 400, device="cuda", dtype=None, **backbone_kw):
        super().__init__(num_classes, device=device, dtype=dtype, **backbone_kw)

    @torch.no_grad()
    def load_pretrained(self, sd: Union[str, Dict[str, np.ndarray]]) -> "OnePeaceVideoClassifier":
        """The trunk from a pretrain checkpoint (a fairseq ``.pt`` path or its
        {name: np.ndarray} state dict, pretrain or vision naming), the
        temporal embedding zero and the rel-pos table the checkpoint's (zero
        where its size differs); the adapters, the norm and the head keep
        their values (``utils.random_weights.init_video_classifier_`` draws
        them, the adapters' ``fc2`` zero), as the JAX package's load draws
        them fresh."""
        if isinstance(sd, str):
            sd = load_torch_state_dict(sd)
        state = params_from_jax({"backbone": convert_video_backbone(sd, self.backbone)})
        own = self.state_dict()
        for name, value in state.items():
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: checkpoint {tuple(value.shape)}, "
                                 f"model {tuple(own[name].shape)}")
        self.load_state_dict(state, strict=False)
        frozen = {k for k, train in self.trainable_mask().items()
                  if k.startswith("backbone.") and not train}
        missing = frozen - set(state)
        if missing:
            raise KeyError(f"the checkpoint left trunk weights unset: {sorted(missing)[:5]}")
        return self

    def jax_layout(self) -> Dict[str, Dict]:
        """Nothing beyond ``params_to_jax``'s rules: the layers stack back into
        ``backbone/layers`` as the JAX tree holds them."""
        return {}
