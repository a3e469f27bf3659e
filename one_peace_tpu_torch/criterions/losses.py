"""Loss primitives (counterpart of ``one_peace_tpu/criterions/losses.py``).

The contrastive loss runs over the whole batch with the gallery side
detached, as the JAX package and the reference do: each direction's gradient
flows only through its query-side embeddings.  DCL and the classification,
grounding and hinge losses are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


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
    Returns (loss, {"a2b_ncorrect", "b2a_ncorrect"})."""
    targets = torch.arange(emb_a.shape[0], device=emb_a.device)
    a32, b32 = emb_a.float(), emb_b.float()
    sim_a2b = logit_scale * (a32 @ b32.detach().T)
    sim_b2a = logit_scale * (b32 @ a32.detach().T)
    loss = 0.5 * (label_smoothed_nll(torch.log_softmax(sim_a2b, -1), targets, label_smoothing)
                  + label_smoothed_nll(torch.log_softmax(sim_b2a, -1), targets, label_smoothing))
    metrics = {"a2b_ncorrect": (sim_a2b.argmax(1) == targets).sum(),
               "b2a_ncorrect": (sim_b2a.argmax(1) == targets).sum()}
    return loss, metrics
