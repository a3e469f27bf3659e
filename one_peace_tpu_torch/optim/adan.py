"""Adan (counterpart of ``one_peace_tpu/optim/adan.py`` and the Adan arm of
its ``build_optimizer``, ``optim/adamw.py:191-203``), as a
``torch.optim.Optimizer`` over foreach ops.

The JAX chain is clip -> scale_by_adan -> scale_by_tree(layer scale) ->
scale_by_learning_rate -> proximal_weight_decay:

  m = b1 m + (1 - b1) g
  d = b2 d + (1 - b2) (g - g_prev)          (g_prev = g on the first step)
  v = b3 v + (1 - b3) (g + b2 (g - g_prev))^2
  u = (m / bc1 + b2 d / bc2) / (sqrt(v / bc3) + eps) * s * (-lr)
  p = p + ((p + u) / (1 + lr wd) - p)       (the proximal decay; p + u without wd)

with bc_i = 1 - b_i^t, s the parameter's layer-decay scale (one value per
table, along the leading axis, for the per-layer rel-pos tables, as
``AdamW.slice_scales`` moves them) and lr the schedule's value at the count
of applied updates, which the trainer sets on every group as
``schedule_lr`` (the proximal factor takes it without the layer scale).
The JAX package applies the proximal decay to every parameter under Adan,
with no decay mask; so does this (ROADMAP section 3).  The clip lives in
``Trainer._apply``.  The four states (m, v, d, g_prev) are fp32, beside
the fp32 masters.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params, scales: Dict[torch.Tensor, Union[float, torch.Tensor]],
                 betas: Tuple[float, float, float] = (0.98, 0.92, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      lr=0.0, schedule_lr=0.0, lr_scale=1.0))
        self.scales = scales  # parameter -> layer-decay scale (a float or a tensor)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for chunk in _chunks(params, CHUNK_ELEMENTS):
                self._step_chunk(group, chunk)
        return loss

    def _step_chunk(self, group, params) -> None:
        """The update of ``params``, one chunk of a group: its temporaries
        (the difference, the Nesterov term, the update) are as large as the
        chunk, not as the model."""
        b1, b2, b3 = group["betas"]
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        for p, st in zip(params, states):
            if not st:
                st["step"] = 0
                st["m"], st["v"], st["d"] = (torch.zeros_like(p) for _ in range(3))
                st["prev_grad"] = p.grad.clone()  # the first step's diff is 0
        m, v, d, prev = ([st[key] for st in states] for key in ("m", "v", "d", "prev_grad"))
        count = states[0]["step"] + 1
        diff = torch._foreach_sub(grads, prev)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(d, b2)
        torch._foreach_add_(d, torch._foreach_mul(diff, 1 - b2))
        nesterov = torch._foreach_add(grads, torch._foreach_mul(diff, b2))
        torch._foreach_mul_(v, b3)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(nesterov, nesterov),
                                                  1 - b3))
        del diff, nesterov
        bc1, bc2, bc3 = (1 - b ** count for b in (b1, b2, b3))
        num = torch._foreach_add(torch._foreach_div(m, bc1),
                                 torch._foreach_div(torch._foreach_mul(d, b2), bc2))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc3)),
                                 group["eps"])
        updates = torch._foreach_div(num, den)
        del num, den
        lr, wd = group["schedule_lr"], group["weight_decay"]
        factor = 1.0 / (1.0 + lr * wd)
        for p, u, g, st in zip(params, updates, grads, states):
            u.mul_(self.scales.get(p, 1.0)).mul_(-lr)
            if wd:
                u = (p + u).mul_(factor).sub_(p)
            p.add_(u)
            st["prev_grad"].copy_(g)
            st["step"] = count


CHUNK_ELEMENTS = 1 << 28  # a chunk's elements: its temporaries take 1 GiB each in fp32


def _chunks(params: List[torch.Tensor], limit: int):
    """``params`` in runs of at most ``limit`` elements (a larger tensor
    alone)."""
    run, size = [], 0
    for p in params:
        if run and size + p.numel() > limit:
            yield run
            run, size = [], 0
        run.append(p)
        size += p.numel()
    if run:
        yield run


def build_adan(cfg, named_params: List[Tuple[str, torch.Tensor]],
               scales: Dict[str, Union[float, torch.Tensor]]) -> Adan:
    """Adan over ``named_params`` in one group, or two under FSDP (every
    parameter decays),
    each moved by its layer-decay scale in ``scales`` (by name)."""
    per_param = {}
    for name, p in named_params:
        s = scales[name]
        per_param[p] = s.to(p.device, p.dtype) if isinstance(s, torch.Tensor) else float(s)
    # FSDP's sharded parameters (DTensors) and replicated ones in groups of
    # their own: a multi-tensor step takes one kind at a time
    groups = []
    for sharded in (False, True):
        kind = [(n, p) for n, p in named_params if hasattr(p, "device_mesh") == sharded]
        if kind:
            groups.append({"params": [p for _, p in kind], "names": [n for n, _ in kind]})
    return Adan(groups, per_param, betas=tuple(cfg.adan_betas), eps=cfg.adam_eps,
                weight_decay=cfg.weight_decay)
