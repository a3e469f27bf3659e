#!/usr/bin/env python3
"""The attention kernel's bf16 error against its plain version's, call by
call, inside phase 20(b)'s 4-layer full-width model on one card.

    python3 tools/bf16_attention_error.py [--task refcoco] [--seeds 2030 2031]

For each seed, phase 20(b)'s model and batch for ``--task`` (weights and
batch drawn from the seed) take one bf16 gradient on the kernel path, and
every attention call's bf16 inputs are kept.  On those inputs the kernel
(#1, called as the training path calls it, with q, k and v needing a
gradient, and as inference calls it) and its plain version
(``ops.attention.attention_plain``) are held against fp64 attention on the
same inputs, and so is the fp64 result rounded once to bf16 (the least
error a bf16 output can have).  Prints per call: whether the training and
inference calls are bit-equal, and for each output the rms error over all
elements, over row 0 (the CLS row the classify head reads), rows 1-63,
the middle rows and the last ragged tile's rows, the largest error, and
the signed bias (the error's mean times the sign of the exact value).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from one_peace_tpu_torch.ops import attention  # noqa: E402


def exact(q, k, v, rel_bias, mask, scaling) -> torch.Tensor:
    """fp64 attention on the bf16 inputs: (B, L, H, Dh)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scaling
    if rel_bias is not None:
        bias = rel_bias.double()
        logits = logits + (bias[None] if bias.ndim == 3 else bias)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v.double())


def errors(out: torch.Tensor, ref: torch.Tensor) -> str:
    err = out.double() - ref
    rows = err.pow(2).mean(dim=(0, 2, 3)).sqrt()  # per query row
    tail = (ref.shape[1] - 1) // 64 * 64
    return (f"rms {err.pow(2).mean().sqrt().item():.4e} (row 0 {rows[0].item():.4e}, rows 1-63 "
            f"{rows[1:64].mean().item():.4e}, 64-{tail - 1} {rows[64:tail].mean().item():.4e}, "
            f"tail {rows[tail:].mean().item():.4e}), max {err.abs().max().item():.3e}, "
            f"signed bias {(err * ref.sign()).mean().item():+.3e}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--task", default="refcoco", choices=sorted(cs.CLASSIFY_REST_HEADS))
    parser.add_argument("--seeds", type=int, nargs="+", default=[2030, 2031])
    args = parser.parse_args()
    print(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernel = attention.flash_attention
    calls = []

    def keep(q, k, v, rel_bias, mask, scaling):
        calls.append(tuple(x.detach().clone() if isinstance(x, torch.Tensor) else x
                           for x in (q, k, v, rel_bias, mask, scaling)))
        return kernel(q, k, v, rel_bias, mask, scaling)

    attention.flash_attention = keep
    try:
        for seed in args.seeds:
            trainer = cs.classify_rest_trainer(args.task, 4, True, seed)
            calls.clear()
            trainer.gradients(cs.classify_rest_batch(args.task, np.random.RandomState(seed)))
            del trainer
            for j, (q, k, v, rel_bias, mask, scaling) in enumerate(calls):
                ref = exact(q, k, v, rel_bias, mask, scaling)
                grad_in = [x.clone().requires_grad_() for x in (q, k, v)]
                train = kernel(*grad_in, rel_bias, mask, scaling).detach()
                infer = kernel(q, k, v, rel_bias, mask, scaling)
                outs = {"kernel": infer,
                        "plain": attention.attention_plain(q, k, v, rel_bias, mask, scaling),
                        "exact rounded to bf16": ref.to(torch.bfloat16)}
                print(f"{args.task} seed {seed} call {j} {tuple(q.shape)}: training call "
                      f"bit-equal to inference call: {torch.equal(train, infer)}")
                for name, out in outs.items():
                    print(f"  {name}: {errors(out, ref)}")
            calls.clear()
            torch.cuda.empty_cache()
    finally:
        attention.flash_attention = kernel


if __name__ == "__main__":
    main()
