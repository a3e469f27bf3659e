"""Evaluation metric reducers (counterpart of ``one_peace_tpu/metrics/metrics.py``).

``Recall``: R@1/5/10 from the full similarity matrix with duplicate-id
matching (ref metrics/recall.py:8-80) -- text side embedded once, image/
audio side accumulated per batch.  ``Recall.retrieval_eval`` is a copy of
the JAX package's (held equal by ``tests/test_torch_port_retrieval_data.py``).
One card holds the whole evaluation set, so nothing is gathered across
processes: a sharded evaluation raises in ``BaseTask.get_batch_iterator``.

The accuracy, IoU, mAP, detection AP and mIoU reducers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree


def fetch_once(tree):
    """One batched host fetch for everything a reducer accumulated.

    Reducers store per-batch results WITHOUT converting (tensors on the
    card stay there), so the eval loop never waits on a host round-trip
    per batch; at merge time the tensor leaves of ``tree`` are
    concatenated on their device, one buffer per dtype, and each buffer
    crosses to the host in one copy.  bf16 leaves travel as fp32 (numpy
    has no bf16).  Returns the tree with numpy arrays for tensors."""
    fetch_once.calls += 1
    leaves, spec = pytree.tree_flatten(tree)
    groups: Dict = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            leaves[i] = leaf.detach().float() if leaf.dtype == torch.bfloat16 else leaf.detach()
            groups.setdefault((leaves[i].device, leaves[i].dtype), []).append(i)
    for members in groups.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in members]).cpu().numpy()
        parts = np.split(flat, np.cumsum([leaves[i].numel() for i in members])[:-1])
        for i, part in zip(members, parts):
            leaves[i] = part.reshape(leaves[i].shape)
    return pytree.tree_unflatten(leaves, spec)


fetch_once.calls = 0


class Recall:
    def initialize(self, text_ids, text_logits):
        # accepts arrays OR lists of (possibly device) chunks; conversion
        # is deferred to merge_results (fetch_once)
        self.text_ids = text_ids
        self.text_logits = (list(text_logits)
                            if isinstance(text_logits, list) else [text_logits])
        self.image_ids_list: List = []
        self.image_logits_list: List = []

    def compute(self, image_ids, image_logits):
        self.image_ids_list.append(image_ids)
        self.image_logits_list.append(image_logits)

    def merge_results(self, output_predict: bool = False) -> Dict:
        if not self.image_ids_list:  # no valid batches accumulated
            return {"txt_r1": 0.0, "txt_r5": 0.0, "txt_r10": 0.0,
                    "txt_r_mean": 0.0, "img_count": 0,
                    "img_r1": 0.0, "img_r5": 0.0, "img_r10": 0.0,
                    "img_r_mean": 0.0, "txt_count": 0, "r_mean": 0.0}
        got = fetch_once({
            "ti": self.text_ids, "tl": self.text_logits,
            "ii": self.image_ids_list, "il": self.image_logits_list})
        self.text_ids = np.asarray(got["ti"])
        self.text_logits = np.concatenate(
            [np.asarray(x, np.float32) for x in got["tl"]])
        image_ids = np.concatenate([np.asarray(x) for x in got["ii"]])
        image_logits = np.concatenate(
            [np.asarray(x, np.float32) for x in got["il"]])
        sim_i2t = image_logits @ self.text_logits.T
        return self.retrieval_eval(image_ids, sim_i2t, output_predict)

    def retrieval_eval(self, image_ids, scores_i2t, output_predict=False) -> Dict:
        text_ids = self.text_ids
        k = min(10, scores_i2t.shape[1])
        rank_txt = np.argsort(-scores_i2t, axis=1)[:, :k]
        predict_txt = text_ids[rank_txt]
        i2t = [
            float(np.any(predict_txt[:, :r] == image_ids[:, None], axis=1).sum())
            for r in (1, 5, 10)
        ]
        n_img = scores_i2t.shape[0]
        tr = [100.0 * c / n_img for c in i2t]

        scores_t2i = scores_i2t.T
        k2 = min(10, scores_t2i.shape[1])
        rank_img = np.argsort(-scores_t2i, axis=1)[:, :k2]
        predict_img = image_ids[rank_img]
        t2i = [
            float(np.any(predict_img[:, :r] == text_ids[:, None], axis=1).sum())
            for r in (1, 5, 10)
        ]
        n_txt = scores_t2i.shape[0]
        ir = [100.0 * c / n_txt for c in t2i]

        log = {
            "txt_r1": tr[0], "txt_r5": tr[1], "txt_r10": tr[2],
            "txt_r_mean": sum(tr) / 3, "img_count": n_img,
            "img_r1": ir[0], "img_r5": ir[1], "img_r10": ir[2],
            "img_r_mean": sum(ir) / 3, "txt_count": n_txt,
            "r_mean": (sum(tr) + sum(ir)) / 6,
        }
        if output_predict:
            log["predict_txt"] = dict(zip(image_ids.tolist(), predict_txt.tolist()))
            log["predict_img"] = dict(zip(text_ids.tolist(), predict_img.tolist()))
        return log
