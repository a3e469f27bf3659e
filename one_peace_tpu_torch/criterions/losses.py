"""Loss primitives (counterpart of ``one_peace_tpu/criterions/losses.py``).

The contrastive loss runs over the whole batch with the gallery side
detached, as the JAX package and the reference do: each direction's gradient
flows only through its query-side embeddings.  The denoising contrastive
loss (DCL) of pretraining scores each masked student token against the
teacher's tokens of its gallery (the batch, or ``gallery_chunks`` equal
parts of it).  The classification losses (cross entropy with label
smoothing, BCE over multi-hot targets, soft-target cross entropy) compute
in fp32 and sum over the batch, as the JAX package's do; so do RefCOCO's
box loss (L1 and 1 - GIoU) and AQA's multiple-choice hinge.

Across data ranks (``parallel.data.batch_rows``) the contrastive losses
score this rank's rows against the gallery of the global batch, gathered
without a gradient, with the targets offset by this rank's first row, and
DCL and the GIoU term divide by the count over every rank: each rank's
value, weighted by its share of the batch and summed, is the one-process
loss of the global batch, as the JAX loss over the mesh is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..parallel.data import gather_rows, global_mean, leading_rows


def label_smoothed_nll(lprobs: torch.Tensor, targets: torch.Tensor,
                       epsilon: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed NLL of (N, C) log-probabilities."""
    nll = -lprobs.gather(-1, targets[:, None])[:, 0]
    if epsilon == 0.0:
        return nll.mean()
    smooth = -lprobs.sum(-1)
    eps_i = epsilon / (lprobs.shape[-1] - 1)
    return ((1.0 - epsilon - eps_i) * nll + eps_i * smooth).mean()


def itc_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, logit_scale: torch.Tensor,
             label_smoothing: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over the batch.  emb_a, emb_b: (B, D) L2-normalised.
    Returns (loss, {"a2b_ncorrect", "b2a_ncorrect"}).  Across data ranks
    the rows are this rank's and the gallery the global batch's."""
    offset, _ = leading_rows()
    targets = torch.arange(emb_a.shape[0], device=emb_a.device) + offset
    a32, b32 = emb_a.float(), emb_b.float()
    sim_a2b = logit_scale * (a32 @ gather_rows(b32).detach().T)
    sim_b2a = logit_scale * (b32 @ gather_rows(a32).detach().T)
    loss = 0.5 * (label_smoothed_nll(torch.log_softmax(sim_a2b, -1), targets, label_smoothing)
                  + label_smoothed_nll(torch.log_softmax(sim_b2a, -1), targets, label_smoothing))
    metrics = {"a2b_ncorrect": (sim_a2b.argmax(1) == targets).sum(),
               "b2a_ncorrect": (sim_b2a.argmax(1) == targets).sum()}
    return loss, metrics


def dcl_loss(student: torch.Tensor, teacher: torch.Tensor, mask_indices: torch.Tensor,
             padding_mask: Optional[torch.Tensor] = None, logit_scale: float = 2.5,
             label_smoothing: float = 0.0, gallery_chunks: int = 1) -> torch.Tensor:
    """Denoising contrastive loss (``losses.dcl_loss``).

    student, teacher: (B, L, D) with CLS at position 0; mask_indices: (B, L)
    True where a token was masked (scored); padding_mask: (B, L-1) or
    (B, L) True at padding, or None.  CLS is dropped and the rest flattened
    to N = B (L-1) tokens.  Each scored token's cosine similarity times
    ``logit_scale`` against every non-padding teacher token of its gallery
    (padding columns at -inf, so they leave the softmax) gives a
    log-softmax whose target is the token's own teacher token, with label
    smoothing spread over the gallery's valid columns less one.  The
    teacher is detached.  With ``gallery_chunks`` g > 1 the N tokens form g
    galleries of B/g samples each (the reference's per-rank galleries); the
    NLL is summed over every scored row and divided by their count.
    Unscored rows are dropped with ``where``: a padded row's own column is
    -inf, so its NLL is inf.  Across data ranks the galleries are the global
    batch's: the teacher's tokens of every rank are gathered for
    ``gallery_chunks`` 1, and with more each rank must hold whole galleries;
    the count is the global one."""
    b, l, d = student.shape
    offset, total_rows = leading_rows()
    total_rows = total_rows or b
    sf = student[:, 1:].float()
    tf = teacher[:, 1:].detach().float()
    scored = mask_indices[:, 1:]
    pad = (padding_mask[:, -(l - 1):] if padding_mask is not None
           else torch.zeros(b, l - 1, dtype=torch.bool, device=student.device))
    scored = scored & ~pad
    g = max(int(gallery_chunks), 1)
    if total_rows % g:
        raise ValueError(f"a batch of {total_rows} does not split into {g} DCL galleries")
    per = total_rows // g  # samples a gallery
    if g == 1 and b != total_rows:  # one gallery over every rank's tokens
        tf, col_valid, first = gather_rows(tf), ~gather_rows(pad), offset
        groups = 1
    else:
        if b % per or offset % per:
            raise ValueError(f"DCL galleries of {per} samples split across ranks holding "
                             f"{b} rows from row {offset}")
        col_valid, first, groups = ~pad, 0, b // per
    nq = b * (l - 1) // groups
    sf, scored = sf.reshape(groups, nq, d), scored.reshape(groups, nq)
    tf = tf.reshape(groups, -1, d)
    col_valid = col_valid.reshape(groups, -1)
    sn = sf / torch.linalg.vector_norm(sf, dim=-1, keepdim=True).clamp(min=1e-6)
    tn = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True).clamp(min=1e-6)
    sim = logit_scale * (sn @ tn.transpose(1, 2))  # (g, N/g, N/g) on one process
    sim = sim.masked_fill(~col_valid[:, None, :], float("-inf"))
    lprobs = torch.log_softmax(sim, dim=-1)
    own = first * (l - 1) + torch.arange(nq, device=student.device)
    nll = -lprobs.gather(-1, own.expand(groups, nq)[..., None])[..., 0]
    if label_smoothing > 0.0:
        n_valid = col_valid.float().sum(-1, keepdim=True)
        smooth = -torch.where(col_valid[:, None, :], lprobs, 0.0).sum(-1)
        eps_i = label_smoothing / (n_valid - 1).clamp(min=1.0)
        nll = (1.0 - label_smoothing - eps_i) * nll + eps_i * smooth
    total = torch.where(scored, nll, 0.0).sum()
    return global_mean(total, scored.float().sum(), min_count=1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       label_smoothing: float = 0.0, reduction: str = "sum") -> torch.Tensor:
    """Cross entropy in fp32; label smoothing spreads uniformly over all C
    classes, the target included (``F.cross_entropy``'s rule)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets[:, None].long())[:, 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -lp.mean(-1)
    return nll.sum() if reduction == "sum" else nll.mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         reduction: str = "sum") -> torch.Tensor:
    """Multi-label BCE with logits in fp32, in the JAX package's stable form."""
    lf = logits.float()
    per = lf.clamp(min=0) - lf * targets + torch.log1p(torch.exp(-lf.abs()))
    return per.sum() if reduction == "sum" else per.mean()


def soft_target_ce_loss(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy against (B, C) soft targets (mixup), summed."""
    return -(soft_targets * torch.log_softmax(logits.float(), dim=-1)).sum()


def box_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of each row's (x0, y0, x1, y1) box pair, (N,)."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, :2], boxes2[:, :2])
    rb = torch.minimum(boxes1[:, 2:], boxes2[:, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp(min=1e-6)
    lt_e = torch.minimum(boxes1[:, :2], boxes2[:, :2])
    rb_e = torch.maximum(boxes1[:, 2:], boxes2[:, 2:])
    wh_e = (rb_e - lt_e).clamp(min=0)
    enclose = wh_e[:, 0] * wh_e[:, 1]
    return iou - (enclose - union) / enclose.clamp(min=1e-6)


def refcoco_loss(pred_coords_sigmoid: torch.Tensor, targets: torch.Tensor,
                 nsentences: int) -> torch.Tensor:
    """L1 summed over the batch over ``nsentences``, plus the mean 1 - GIoU
    over the predictions whose boxes are valid (x0 < x1 and y0 < y1); the
    invalid ones are masked out with a fixed-shape ``where``."""
    l1 = (pred_coords_sigmoid - targets).abs().sum() / nsentences
    valid = (pred_coords_sigmoid[:, :2] < pred_coords_sigmoid[:, 2:]).all(dim=1)
    ious = box_giou(pred_coords_sigmoid, targets)
    vf = valid.float()
    loss_iou = global_mean(((1 - ious) * vf).sum(), vf.sum(), min_count=1.0)
    return l1 + loss_iou


def hinge_loss(logits: torch.Tensor, targets: torch.Tensor,
               margin: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """AQA's multiple-choice hinge over (B, C) logits: the sum of
    max(0, margin + logit - the answer's logit), the answer's own term
    included (it contributes ``margin``); and the argmax hits."""
    pos = logits.gather(1, targets[:, None].long())
    loss = (margin + logits - pos).clamp(min=0.0).sum()
    ncorrect = (logits.argmax(1) == targets).sum()
    return loss, ncorrect
