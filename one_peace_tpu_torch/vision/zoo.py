"""The assembled detector (counterpart of ``one_peace_tpu/vision/zoo.py``
``OnePeaceDetector``): the windowed trunk, the learned pyramid, a proposer
(RPN, the recipe's, or FCOS), the 3-stage cascade box head and the mask
head.  ``detect`` runs the trunk, pyramid and proposer on the device,
decodes proposals on the host, pads them to ``max_proposals`` per image, runs
the cascade and the mask head as one batched call each, and decodes on the
host.  ``vision/det_train.detector_training_loss`` trains it.  The model is
built on ``cuda`` unless the caller passes a device."""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
from torch import nn

from ..utils.checkpoint import params_from_jax
from ..utils.checkpoint_convert import load_torch_state_dict
from ..utils.vision_checkpoint import convert_det_backbone
from .cascade_rcnn import CascadeBoxHead, MaskHead
from .det_backbone import DetBackbone, SimpleFeaturePyramid
from .detection import FCOSHead, empty_result
from .rpn import RPNHead


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
