"""GPipe over the ``pp`` ranks (counterpart of
``one_peace_tpu/parallel/pipeline.py``).

Stage s of ``pp`` holds the fusion encoder's layers [s·L/pp, (s+1)·L/pp).
The batch is cut into ``num_micro_batches`` micro-batches (``micro_batches``:
as ``torch.tensor_split`` cuts, so a batch the count does not divide, such
as validation's last, runs too), which stream through the stages: stage 0 takes them from the encoder's input, a later
stage receives each from the stage before it (point-to-point), runs its
layers on it and sends it on; the last stage keeps them.  The stages run
only real micro-batches (the JAX function computes on garbage in its bubble
ticks, an artefact of one SPMD program, not ported).  The whole batch's
output then goes from the last stage to every ``pp`` rank, as the JAX
function returns it: the contrastive losses are taken over the whole batch,
so no schedule that computes a loss per micro-batch can serve.

``pipeline_forward`` is one ``torch.autograd.Function``.  Its backward is
the mirrored schedule: the last stage takes the micro-batches' gradients
from its own copy of the output's gradient (every ``pp`` rank computes the
same loss, so summing the copies would give ``pp`` times the gradient),
runs each micro-batch's backward in reverse order and sends the input's
gradient to the stage before.  The stage's parameters (and the side inputs
that need one, such as the rel-pos bias) are inputs of the Function, so
their gradients reach autograd, also through ``torch.autograd.grad``.  Stage
0 returns the input's gradient; later stages return zeros for it, and each
stage its part of a broadcast input's gradient: the caller sums what comes
before the pipeline over ``pp`` (``Trainer``).

``checkpoint_stages`` keeps only each micro-batch's input in the forward and
runs the stage again in the backward (the JAX function's remat of the
stage); otherwise each micro-batch's graph is kept.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .tensor_parallel import Shard


def micro_batches(rows: int, num_micro_batches: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each micro-batch of a batch of ``rows`` rows:
    ``min(num_micro_batches, rows)`` of them (one where ``rows`` is 0), the
    first ``rows % count`` one row longer, as ``torch.tensor_split`` cuts."""
    count = max(min(num_micro_batches, rows), 1)
    base, extra = divmod(rows, count)
    out, start = [], 0
    for m in range(count):
        out.append((start, base + (m < extra)))
        start += out[-1][1]
    return out


class _Plan:
    """What the Function needs besides its tensors."""

    def __init__(self, stage_fn, shard: Shard, ranks: List[int], bounds: List[Tuple[int, int]],
                 n_batch: int, n_bcast: int, checkpoint: bool):
        self.stage_fn, self.shard, self.ranks = stage_fn, shard, ranks
        self.bounds, self.n_batch, self.n_bcast = bounds, n_batch, n_bcast
        self.checkpoint = checkpoint


def _leaf(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.detach().requires_grad_(t.requires_grad)


def _cut(t: Optional[torch.Tensor], start: int, rows: int) -> Optional[torch.Tensor]:
    return None if t is None else t.narrow(0, start, rows)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plan: _Plan, x, *tensors):
        s, n = plan.shard.rank, plan.shard.size
        group, ranks = plan.shard.group, plan.ranks
        batch = list(tensors[:plan.n_batch])
        bcast = list(tensors[plan.n_batch:plan.n_batch + plan.n_bcast])
        params = list(tensors[plan.n_batch + plan.n_bcast:])
        grads_wanted = any(ctx.needs_input_grad)
        x_grad = ctx.needs_input_grad[1]
        keep = grads_wanted and not plan.checkpoint
        if keep:
            bcast, params = [_leaf(t) for t in bcast], [_leaf(t) for t in params]
        saved, outs, pending = [], [], []
        for m, (start, rows) in enumerate(plan.bounds):
            if s == 0:
                inp = x.narrow(0, start, rows)
            else:
                inp = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
                dist.recv(inp, ranks[s - 1], group=group)
            aux = [_cut(a, start, rows) for a in batch]
            if keep:
                with torch.enable_grad():
                    inp = inp.detach().requires_grad_(s > 0 or x_grad)
                    aux = [_leaf(a) for a in aux]
                    out = plan.stage_fn(m, inp, aux, bcast, params)
                saved.append((inp, aux, out))
            else:
                out = plan.stage_fn(m, inp, aux, bcast, params)
                if grads_wanted:
                    saved.append(inp.detach())
            if s < n - 1:
                pending.append(dist.isend(out.detach().contiguous(), ranks[s + 1], group=group))
            else:
                outs.append(out.detach())
        for work in pending:
            work.wait()
        full = torch.cat(outs) if s == n - 1 else torch.empty_like(x)
        dist.broadcast(full, ranks[n - 1], group=group)
        if grads_wanted:
            ctx.plan, ctx.saved = plan, saved
            ctx.batch, ctx.bcast, ctx.params = batch, bcast, params
            ctx.x_meta = (x.shape, x.dtype, x.device, x_grad)
        return full

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        s, n = plan.shard.rank, plan.shard.size
        group, ranks = plan.shard.group, plan.ranks
        x_shape, x_dtype, x_device, x_grad = ctx.x_meta
        bcast, params = ctx.bcast, ctx.params
        if plan.checkpoint:
            bcast, params = [_leaf(t) for t in bcast], [_leaf(t) for t in params]
        bcast_grads: List[Optional[torch.Tensor]] = [None] * len(bcast)
        param_grads: List[Optional[torch.Tensor]] = [None] * len(params)
        count = len(plan.bounds)
        batch_parts = [[None] * count for _ in ctx.batch]
        dx_parts, pending = [None] * count, []
        for m in reversed(range(count)):
            start, rows = plan.bounds[m]
            if s == n - 1:
                g = grad.narrow(0, start, rows).contiguous()
            else:
                g = torch.empty((rows,) + tuple(x_shape[1:]), dtype=grad.dtype,
                                device=grad.device)
                dist.recv(g, ranks[s + 1], group=group)
            if plan.checkpoint:
                with torch.enable_grad():
                    inp = ctx.saved[m].requires_grad_(s > 0 or x_grad)
                    aux = [_leaf(_cut(a, start, rows)) for a in ctx.batch]
                    out = plan.stage_fn(m, inp, aux, bcast, params)
            else:
                inp, aux, out = ctx.saved[m]
                ctx.saved[m] = None
            slots = [("x", 0, inp)] + [("batch", i, a) for i, a in enumerate(aux)] \
                + [("bcast", i, t) for i, t in enumerate(bcast)] \
                + [("param", i, t) for i, t in enumerate(params)]
            slots = [sl for sl in slots if sl[2] is not None and sl[2].requires_grad]
            got = (torch.autograd.grad(out, [sl[2] for sl in slots], g, allow_unused=True)
                   if slots and out.requires_grad else [None] * len(slots))
            gx = next((gt for (kind, _, _), gt in zip(slots, got) if kind == "x"), None)
            if s > 0:  # the stage before waits for it, used or not
                gx = torch.zeros_like(inp) if gx is None else gx
                pending.append(dist.isend(gx.contiguous(), ranks[s - 1], group=group))
            else:
                dx_parts[m] = gx
            for (kind, i, t), gt in zip(slots, got):
                if gt is None or kind == "x":
                    continue
                if kind == "batch":
                    batch_parts[i][m] = gt
                elif kind == "bcast":
                    bcast_grads[i] = gt if bcast_grads[i] is None else bcast_grads[i] + gt
                else:
                    param_grads[i] = gt if param_grads[i] is None else param_grads[i] + gt
        for work in pending:
            work.wait()
        ctx.saved = None
        dx = None
        if x_grad:
            if s == 0:
                dx = torch.cat([torch.zeros((rows,) + tuple(x_shape[1:]), dtype=x_dtype,
                                            device=x_device) if p is None else p
                                for (_, rows), p in zip(plan.bounds, dx_parts)])
            else:
                dx = torch.zeros(x_shape, dtype=x_dtype, device=x_device)
        batch_grads = []
        for a, parts in zip(ctx.batch, batch_parts):
            if a is None or not a.requires_grad:
                batch_grads.append(None)
            else:
                batch_grads.append(torch.cat([
                    torch.zeros_like(_cut(a, *bounds)) if p is None else p
                    for bounds, p in zip(plan.bounds, parts)]))
        return (None, dx, *batch_grads, *bcast_grads, *param_grads)


def pipeline_forward(stage_fn: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
                     shard: Shard, ranks: List[int], num_micro_batches: int,
                     batch_aux: Sequence[Optional[torch.Tensor]] = (),
                     broadcast_aux: Sequence[Optional[torch.Tensor]] = (),
                     checkpoint_stages: bool = False) -> torch.Tensor:
    """GPipe over ``shard`` (the ``pp`` group; ``ranks`` its global ranks in
    stage order); the output is the serial stack's, on every stage.

    ``stage_fn(m, x_m, batch_aux_m, broadcast_aux, params) -> y_m`` runs this
    stage's layers on micro-batch ``m`` (the rows ``micro_batches(B,
    num_micro_batches)[m]``): ``x_m`` its activations,
    ``batch_aux_m`` the micro-batch's rows of each ``batch_aux`` tensor (the
    padding mask, a per-sample bias), ``broadcast_aux`` whole (a shared
    bias), ``params`` the stage's parameters."""
    plan = _Plan(stage_fn, shard, ranks, micro_batches(x.shape[0], num_micro_batches),
                 len(batch_aux), len(broadcast_aux), checkpoint_stages)
    return _Pipeline.apply(plan, x, *batch_aux, *broadcast_aux, *params)
