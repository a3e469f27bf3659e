"""Ring attention: exact attention over a sequence split across the ``sp``
ranks (counterpart of ``one_peace_tpu/ops/ring_attention.py``).

Each rank holds one (B, L/sp, H, Dh) chunk of q, k and v.  The k/v chunks
travel around the ring (rank i sends to i + 1) while every rank keeps an
online softmax over the blocks it has seen, in fp32, as the JAX function
computes it (the max and the denominator per row, a padded key at -1e30);
the (L, L) scores never exist on one rank.  The rel-pos bias (H, L, L) and
the key padding mask (B, L) stay whole on every rank, and each step reads
the tile of its rows and the block's columns.

- Forward: each step's exchange (``dist.batch_isend_irecv``) is posted
  before the block's arithmetic, so that the copy overlaps it; the last
  step rotates nothing, as in JAX.
- Backward: a ring of its own over the saved output and row log-sum-exp.
  dq accumulates in place; the dk / dv accumulators travel with their k / v
  chunk and reach its owner again after ``sp`` hops, so the backward's last
  hop is not skipped.  Each rank's d(rel_bias) holds its own rows only, and
  is summed over ``sp``.

The block arithmetic is plain torch (the JAX function computes it outside
Pallas too); running the blocks on the flash kernels is queued work.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _exchange(tensors: List[torch.Tensor], nxt: int, prv: int, group):
    """Post sends of ``tensors`` to ``nxt`` and receives of as many from
    ``prv``; returns (the works, the receive buffers)."""
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _logits(qf, kb, bias, pad, rows: slice, src: int, lc: int):
    """fp32 scores of the query chunk against block ``src``, with its bias
    tile and padded keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
    if bias is not None:
        logits = logits + bias[:, rows, src * lc:(src + 1) * lc].float()[None]
    if pad is not None:
        cut = pad[:, src * lc:(src + 1) * lc]
        logits = logits + torch.where(cut, NEG_INF, 0.0)[:, None, None, :]
    return logits


def start_state(q: torch.Tensor):
    """The online softmax before the first block: (o, row max, row sum)."""
    b, lc, h, d = q.shape
    return (torch.zeros((b, lc, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, lc), float("-inf"), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, lc), dtype=torch.float32, device=q.device))


def forward_block(state, qf, kb, vb, bias, pad, rank: int, src: int):
    """One step of the forward on the rank ``rank``: the online softmax
    ``state`` after the k/v block of chunk ``src``.  ``qf``: the query chunk
    in fp32, scaled."""
    o, m, den = state
    lc = qf.shape[1]
    logits = _logits(qf, kb, bias, pad, slice(rank * lc, (rank + 1) * lc), src, lc)
    new_m = torch.maximum(m, logits.amax(-1))
    corr = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    den = den * corr + p.sum(-1)
    o = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
    return o, new_m, den


def finish_state(state):
    """(the fp32 output chunk, the rows' log-sum-exp) of a finished state."""
    o, m, den = state
    return o / den.transpose(1, 2)[..., None], m + torch.log(den)


def backward_block(qf, do, delta, lse, kb, vb, bias, pad, rank: int, src: int, scaling: float):
    """One step of the backward on the rank ``rank`` against the block of
    chunk ``src``: (its part of dq, of dk and dv of chunk ``src``, the
    d(bias) tile of its rows and the block's columns (summed over the
    batch)), in fp32."""
    lc = qf.shape[1]
    p = torch.exp(_logits(qf, kb, bias, pad, slice(rank * lc, (rank + 1) * lc), src, lc)
                  - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vb.float()) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scaling
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq, dk, dv, ds.sum(0)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, pad, scaling, shard, ranks):
        n, my = shard.size, shard.rank
        nxt, prv = ranks[(my + 1) % n], ranks[(my - 1) % n]
        qf = q.float() * scaling
        state = start_state(q)
        kb, vb = k.contiguous(), v.contiguous()
        for step in range(n):
            works = None
            if step < n - 1:
                works, (k_next, v_next) = _exchange([kb, vb], nxt, prv, shard.group)
            state = forward_block(state, qf, kb, vb, bias, pad, my, (my - step) % n)
            if works is not None:
                for w in works:
                    w.wait()
                kb, vb = k_next, v_next
        out, lse = finish_state(state)
        ctx.save_for_backward(q, k, v, out, lse, bias, pad)
        ctx.scaling, ctx.shard, ctx.ranks = scaling, shard, ranks
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse, bias, pad = ctx.saved_tensors
        shard, ranks, scaling = ctx.shard, ctx.ranks, ctx.scaling
        n, my = shard.size, shard.rank
        nxt, prv = ranks[(my + 1) % n], ranks[(my - 1) % n]
        lc = q.shape[1]
        qf = q.float() * scaling
        do = grad.float()
        delta = (do * out).sum(-1).transpose(1, 2)  # (B, H, Lc)
        dq = torch.zeros_like(qf)
        want_bias = bias is not None and ctx.needs_input_grad[3]
        dbias = (torch.zeros(bias.shape, dtype=torch.float32, device=bias.device)
                 if want_bias else None)
        kb, vb = k.contiguous(), v.contiguous()
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            works = None
            if step < n - 1:  # k / v for the next step, posted before the arithmetic
                works, (k_next, v_next) = _exchange([kb, vb], nxt, prv, shard.group)
            src = (my - step) % n
            dq_part, dk, dv, dbias_tile = backward_block(qf, do, delta, lse, kb, vb, bias, pad,
                                                         my, src, scaling)
            dq += dq_part
            dkb += dk
            dvb += dv
            if want_bias:
                dbias[:, my * lc:(my + 1) * lc, src * lc:(src + 1) * lc] = dbias_tile
            # the accumulators follow their chunk, the last hop included
            acc_works, (dkb, dvb) = _exchange([dkb, dvb], nxt, prv, shard.group)
            for w in acc_works:
                w.wait()
            if works is not None:
                for w in works:
                    w.wait()
                kb, vb = k_next, v_next
        if want_bias:  # each rank holds its own rows
            dist.all_reduce(dbias, group=shard.group)
            dbias = dbias.to(bias.dtype)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), dbias,
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rel_bias: Optional[torch.Tensor], key_padding_mask: Optional[torch.Tensor],
                   scaling: float, shard, ranks: List[int]) -> torch.Tensor:
    """q/k/v (B, L/sp, H, Dh): this rank's chunk of the sequence split over
    ``shard`` (the ``sp`` group, ``ranks`` its global ranks in ring order);
    rel_bias (H, L, L) and key_padding_mask (B, L) whole.  Returns this
    rank's (B, L/sp, H, Dh) chunk of the output."""
    return _RingAttention.apply(q, k, v, rel_bias, key_padding_mask, scaling, shard, ranks)
