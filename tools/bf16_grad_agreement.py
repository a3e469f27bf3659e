#!/usr/bin/env python3
"""Phase 7(a)'s bf16 agreement on one card, for several versions of the
retrieval attention kernels and several batches.

    git show <commit>:chip_smoke.py > build/ab/parent_smoke.py
    python3 tools/bf16_grad_agreement.py --smoke chip_smoke.py \\
        --smoke build/ab/parent_smoke.py parent=build/ab/parent this=.

For each ``--smoke`` file (a ``chip_smoke.py``), the generator of that
script's phases is brought to the state in which its phase 7(a) draws the
batch: phase 3's checks, phase 4's inputs, phase 6's checks and times.  On
that batch the 4-layer full-width vl model (phase 7(a)'s) takes gradients
on the plain path in fp32 and in bf16, then on the kernel path in bf16 with
each tree's kernels (``NAME=DIR`` as in ``tools/flash_attention_ab.py``; a
tree whose forward writes no statistics gets them from this tree's).  Prints
the loss and the cosine over all parameters together against the bf16
plain path (phase 7(a)'s bound: >= 0.999) and against fp32, and the bf16
plain path's own cosine to fp32.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke as cs  # noqa: E402
from ab_trees import load_tree  # noqa: E402
from one_peace_tpu_torch.models.one_peace import ModelConfig  # noqa: E402
from one_peace_tpu_torch.ops import flash_attention as fa  # noqa: E402


def load_smoke(path: Path):
    spec = importlib.util.spec_from_file_location(f"smoke_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernels(tree):
    """The tree's wrappers under this tree's calling convention."""
    fwd, bwd = tree.flash_attention_cuda, tree.flash_attention_bwd_cuda
    if "with_stats" in inspect.signature(fwd).parameters:
        return fwd, bwd
    new_fwd = fa.flash_attention_cuda

    def fwd_with_stats(*args, with_stats=False):
        out = fwd(*args)
        return (out, new_fwd(*args, with_stats=True)[1]) if with_stats else out

    return fwd_with_stats, lambda *args, stats=None: bwd(*args)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="NAME=DIR, DIR holding one_peace_tpu_torch/")
    parser.add_argument("--smoke", action="append", default=[],
                        help="a chip_smoke.py whose phases 3-6 set the batch (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bf16_grad_agreement: no CUDA card")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    this = (fa.flash_attention_cuda, fa.flash_attention_bwd_cuda)
    trees = {}
    for spec in args.trees:
        name, _, src = spec.partition("=")
        trees[name] = this if Path(src).resolve() == ROOT else kernels(
            load_tree(name, Path(src).resolve(), "flash_attention"))
    flat = lambda grads: [torch.cat([g.flatten() for g in grads])]  # noqa: E731
    for smoke_path in args.smoke or [str(ROOT / "chip_smoke.py")]:
        smoke = load_smoke(Path(smoke_path).resolve())
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = this
        gen = torch.Generator(device="cuda").manual_seed(0)
        smoke.check_kernel(gen)
        smoke.make_inputs(ModelConfig(head_type="val"), gen, 4, 2, 4)
        smoke.check_backward_kernel(gen)
        smoke.time_backward(gen, card)
        cfg = cs.train_config(layers=4, bf16=False, remat=False, drop_path=0.0)
        batch = cs.train_batch(cfg, gen, 8)
        trainer = cs.make_trainer(cfg)
        trainer.model.cfg.encoder.attn_impl = "xla"
        _, ref32 = trainer.gradients(batch)
        del trainer
        trainer = cs.make_trainer(cs.train_config(layers=4, bf16=True, remat=False,
                                                  drop_path=0.0))
        trainer.model.cfg.encoder.attn_impl = "xla"
        _, plain = trainer.gradients(batch)
        label = f"7(a)'s batch after {smoke_path}'s phases 3-6"
        print(f"[{label}] plain bf16 vs fp32: all parameters together "
              f"{cs.grad_cosines(flat(plain), flat(ref32))[0]:.9f} ({card})", flush=True)
        trainer.model.cfg.encoder.attn_impl = "pallas"
        for name, (fwd, bwd) in trees.items():
            fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = fwd, bwd
            metrics, grads = trainer.gradients(batch)
            print(f"[{label}] {name}'s kernels: loss {float(metrics['loss']):.7f}; all "
                  f"parameters together vs plain {cs.grad_cosines(flat(grads), flat(plain))[0]:.9f}"
                  f", vs fp32 {cs.grad_cosines(flat(grads), flat(ref32))[0]:.9f} ({card})",
                  flush=True)
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = this
        del trainer, plain, ref32, grads
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
