#!/usr/bin/env python3
"""Time two or more versions of the retrieval attention kernels on one card,
in turns.

    git archive <commit> one_peace_tpu_torch | tar -x -C build/ab/parent
    python3 tools/flash_attention_ab.py parent=build/ab/parent this=.

Each ``NAME=DIR`` names a tree whose ``DIR/one_peace_tpu_torch`` holds
``ops/flash_attention.py``, ``ops/build.py`` and ``csrc/``.  Those are
copied into ``build/ab/pkgs/<NAME>/`` as a package of that name, so the
versions load side by side, each with its own libraries.  For every shape
the trees are timed in turns (a, b, ..., b, a), each turn the mean of
``--iters`` calls by CUDA events, with SDPA (the yardstick that
``chip_smoke.py`` times) in the same turns:

- the forward (``flash_attention_cuda``) with and without the row
  statistics, where the tree writes them;
- the backward (``flash_attention_bwd_cuda``), given the forward's
  statistics where the tree takes them, and each of its kernels alone by
  ``torch.profiler``'s device time per kernel name (any tree) and, where the
  tree has it, by ``passes``;
- with ``--two-walks``, each tree that has ``tile_plan`` a second time with
  its plan forced to two walks over the key tiles at every length (the
  kernels' other branch), as ``NAME-two-walks``.

Every line names the card and its power limit.  The compiler's register and
spill lines of each tree's flash libraries are printed first.  Prints one
JSON object as its last line: {tree: {case: {...ms...}}}.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ab_trees import load_tree, log  # noqa: E402
from chip_smoke import card_line, cuda_time_ms as cuda_ms, text_pad_mask  # noqa: E402

HEADS = 24
FWD_CASES = [  # (name, B, L, text pads)
    ("img", 256, 257, False), ("aud", 32, 500, False), ("txt", 32, 71, True),
    ("vl", 4, 850, False)]
BWD_CASES = [("img", 32, 257, False), ("txt", 32, 71, True), ("aud", 4, 500, False)]


def kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            out[ev.key[:48]] = ev.self_device_time_total / 1e3 / iters
    return out


def takes(fn, arg: str) -> bool:
    return arg in inspect.signature(fn).parameters


class TwoWalks:
    """A tree's wrappers with the plan forced to two walks over the key tiles
    (no resident row block) at every length: the same kernels' other
    branch, for measuring the one-walk design against it."""

    def __init__(self, fa):
        self._fa, self._tile_plan, self._bwd_plan = fa, fa.tile_plan, fa.bwd_plan
        self.NEG_INF, self._SOURCES, self.build_library = fa.NEG_INF, fa._SOURCES, fa.build_library

    def _plan(self, l):
        return self._tile_plan(l, False)

    def _call(self, fn, *args, **kwargs):
        fa = self._fa
        fa.tile_plan = self._plan
        fa.bwd_plan = lambda b, l, h, shared: self._bwd_plan(b, l, h, shared)._replace(
            tiles=self._plan(l))
        try:
            return fn(*args, **kwargs)
        finally:
            fa.tile_plan, fa.bwd_plan = self._tile_plan, self._bwd_plan

    def flash_attention_cuda(self, *args, with_stats=False):
        return self._call(self._fa.flash_attention_cuda, *args, with_stats=with_stats)

    def flash_attention_bwd_cuda(self, *args, stats=None, passes=3):
        return self._call(self._fa.flash_attention_bwd_cuda, *args, stats=stats, passes=passes)


def operands(gen, b, l, pads, neg):
    q, k, v, g = (torch.randn(b, l, HEADS * 64, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    bias = torch.randn(HEADS, l, l, generator=gen, device="cuda")
    kb = (torch.zeros(b, l, device="cuda").masked_fill(text_pad_mask(b, l), neg)
          if pads else None)
    return q, k, v, g, bias, kb


def run(trees: dict, iters: int, card: str) -> dict:
    names = list(trees)
    order = names + names[::-1]
    result = {name: {} for name in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    neg = next(iter(trees.values())).NEG_INF
    for case, b, l, pads in FWD_CASES:
        q, k, v, _, bias, kb = operands(gen, b, l, pads, neg)
        q4, k4, v4 = (x.view(b, l, HEADS, 64).transpose(1, 2) for x in (q, k, v))
        mask = bias[None] if kb is None else bias[None] + kb[:, None, None, :]
        mask = mask.to(torch.bfloat16)
        turns = {name: {"ms": [], "stats_ms": []} for name in names}
        sdpa = []
        for name in order:
            fa = trees[name]
            turns[name]["ms"].append(cuda_ms(
                lambda: fa.flash_attention_cuda(q, k, v, bias, kb, 0.125, HEADS), iters))
            if takes(fa.flash_attention_cuda, "with_stats"):
                turns[name]["stats_ms"].append(cuda_ms(lambda: fa.flash_attention_cuda(
                    q, k, v, bias, kb, 0.125, HEADS, with_stats=True), iters))
            sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=0.125), iters))
        sdpa_ms = sum(sdpa) / len(sdpa)
        for name in names:
            t = turns[name]
            ms = sum(t["ms"]) / len(t["ms"])
            plan = ""
            if hasattr(trees[name], "tile_plan"):
                plan = f", plan {trees[name].tile_plan(l)}"
            stats = (f", with statistics {sum(t['stats_ms']) / len(t['stats_ms']):.4f}"
                     if t["stats_ms"] else "")
            log(f"fwd {case} B={b} L={l} {name}: {ms:.4f} ms (turns "
                f"{', '.join(f'{x:.4f}' for x in t['ms'])}){stats}; SDPA {sdpa_ms:.4f} "
                f"({ms / sdpa_ms:.3f}x){plan} ({card})")
            result[name][f"fwd_{case}"] = {"ms": ms, "turns": t["ms"], "stats_ms": t["stats_ms"],
                                           "sdpa_ms": sdpa_ms}
        del q, k, v, bias, kb, mask, q4, k4, v4
        torch.cuda.empty_cache()
    for case, b, l, pads in BWD_CASES:
        q, k, v, g, bias, kb = operands(gen, b, l, pads, neg)
        leaves = [x.view(b, l, HEADS, 64).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        mask = (bias[None] if kb is None else bias[None] + kb[:, None, None, :])
        mask = mask.to(torch.bfloat16).expand(b, -1, -1, -1) if kb is None else mask.to(
            torch.bfloat16)
        mask = mask.detach().requires_grad_()
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                               scale=0.125)
        g4 = g.view(b, l, HEADS, 64).transpose(1, 2)
        calls = {}
        for name in names:
            fa = trees[name]
            kwargs = {}
            if takes(fa.flash_attention_bwd_cuda, "stats"):
                _, kwargs["stats"] = fa.flash_attention_cuda(q, k, v, bias, kb, 0.125, HEADS,
                                                             with_stats=True)
            calls[name] = (fa, kwargs)
        turns = {name: [] for name in names}
        sdpa = []
        for name in order:
            fa, kwargs = calls[name]
            turns[name].append(cuda_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, g, bias, kb, 0.125, HEADS, **kwargs), iters))
            sdpa.append(cuda_ms(lambda: torch.autograd.grad(out, [*leaves, mask], g4,
                                                            retain_graph=True), iters))
        sdpa_ms = sum(sdpa) / len(sdpa)
        for name in names:
            fa, kwargs = calls[name]
            ms = sum(turns[name]) / len(turns[name])
            per_kernel = kernel_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, g, bias, kb, 0.125, HEADS, **kwargs), iters)
            by_pass = {}
            if takes(fa.flash_attention_bwd_cuda, "passes"):
                for p in (1, 2):
                    by_pass[p] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(
                        q, k, v, g, bias, kb, 0.125, HEADS, passes=p, **kwargs), iters)
            plan = ""
            if hasattr(fa, "bwd_plan"):
                plan = f", plan {fa.bwd_plan(b, l, HEADS, True)}"
            log(f"bwd {case} B={b} L={l} {name}: {ms:.4f} ms (turns "
                f"{', '.join(f'{x:.4f}' for x in turns[name])}); SDPA's backward {sdpa_ms:.4f} "
                f"({ms / sdpa_ms:.3f}x); by kernel (profiler) "
                f"{', '.join(f'{k_}: {v_:.4f}' for k_, v_ in per_kernel.items())}"
                + (f"; passes=1 {by_pass[1]:.4f}, passes=2 {by_pass[2]:.4f}" if by_pass else "")
                + f"{plan} ({card})")
            result[name][f"bwd_{case}"] = {"ms": ms, "turns": turns[name], "sdpa_ms": sdpa_ms,
                                           "kernels": per_kernel, "passes": by_pass}
        del q, k, v, g, bias, kb, leaves, mask, out, g4, calls
        torch.cuda.empty_cache()
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="NAME=DIR, DIR holding one_peace_tpu_torch/")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--two-walks", action="store_true",
                        help="also time each tree with the plan forced to two walks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_ab: no CUDA card")
    card = card_line()
    log(card)
    trees = {}
    for spec in args.trees:
        name, _, src = spec.partition("=")
        trees[name] = load_tree(name, Path(src).resolve(), "flash_attention")
    if args.two_walks:
        for name in list(trees):
            if hasattr(trees[name], "tile_plan"):
                trees[f"{name}-two-walks"] = TwoWalks(trees[name])
    for name, fa in trees.items():
        if isinstance(fa, TwoWalks):
            continue
        for which in ("fwd", "bwd"):
            lib = fa.build_library(fa._SOURCES[which])
            for line in lib.with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line or "C7517" in line:
                    log(f"{name} {which} ptxas: {line.strip()}")
    result = run(trees, args.iters, card)
    log(json.dumps(result))


if __name__ == "__main__":
    main()
