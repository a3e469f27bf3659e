#!/usr/bin/env python3
"""The depth-40 retrieval step in bf16 beside fp16 without and with the EMA,
on one card, with the CUDA caching allocator's counters over each run.

    python3 tools/fp16_step_split.py

Runs phase 7(b) of ``chip_smoke.py`` (the bf16 step over fp32 masters,
B=32, remat, drop path 0.5, its profile included), then phase 21(c)'s
configuration (fp16 with loss scaling) twice, without and with the EMA:
one warm-up step, then four timed steps on the same batch and masks.
Prints each run's ms per step, the memory reserved, and the allocator's
retries, device allocations and frees, and full synchronisations over the
timed steps (a retry frees the cache and synchronises the card).
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from one_peace_tpu_torch.ops import build  # noqa: E402

KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")


def stats():
    s = torch.cuda.memory_stats()
    return {k: s.get(k, 0) for k in KEYS}


def main():
    card = cs.card_line(); print(card, flush=True)
    build.build_libraries()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = stats(); cs.train_full_depth(gen, card); b = stats()
    print("7(b) allocator:", {k: b[k] - a[k] for k in KEYS}, flush=True)
    torch.cuda.empty_cache()
    gen21 = torch.Generator(device="cuda").manual_seed(216)
    cfg = cs.fp16_train_config(40, True, 0.5, ema=True)
    for ema in (False, True):
        cfg.ema.store_ema = ema
        trainer = cs.make_trainer(cfg)
        batch = cs.train_batch(cfg, gen21, 32)
        rng = trainer.generator.get_state()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        a = stats(); times = []
        for _ in range(4):
            trainer.generator.set_state(rng)
            torch.cuda.synchronize(); t0 = time.time()
            trainer.train_step(batch)
            torch.cuda.synchronize(); times.append(1e3 * (time.time() - t0))
        b = stats()
        print(f"21(c) fp16 ema={ema}: ms {[round(t, 1) for t in times]}, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB, allocator over 4 steps:",
              {k: b[k] - a[k] for k in KEYS}, flush=True)
        del trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
