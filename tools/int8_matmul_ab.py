#!/usr/bin/env python3
"""Time two or more versions of the int8 serving GEMM on one card, in turns.

    git archive <commit> one_peace_tpu_torch | tar -x -C build/ab/parent
    python3 tools/int8_matmul_ab.py parent=build/ab/parent this=.

Each ``NAME=DIR`` names a tree whose ``DIR/one_peace_tpu_torch`` holds
``ops/int8_matmul.py``, ``ops/build.py`` and ``csrc/``.  Those are copied
into ``build/ab/pkgs/<NAME>/`` as a package of that name, so the versions
load side by side, each with its own library.  At each of the serving
path's three FFN shapes (M = 65,792 image rows at B=256; (K, N) = (1536,
6144), (6144, 1536), (1536, 1536)) the trees' ``int8_matmul_cuda`` (bf16
out, no bias) are timed in turns (a, b, ..., b, a), each turn the mean of
``--iters`` calls by CUDA events, with bf16 ``torch.matmul`` on the same
product and ``torch._int_mm`` with the scales in the same turns (the
yardsticks ``chip_smoke.py`` times).  With ``--one-tile-per-block``, each
tree that has ``gemm_plan`` is also timed with one block per output tile
instead of its persistent grid, as ``NAME-one-tile``.  Every tree's result
is checked bit for bit against ``int8_matmul_plain`` once per shape.  With
``--sustain SECONDS``, each GEMM and bf16 ``torch.matmul`` then run back to
back at the first shape for that long while ``nvidia-smi`` samples the SM
clock and the power draw every 0.2 s (the card throttles under a long run).

Every line names the card and its power limit.  The compiler's register and
spill lines of each tree's library are printed first.  Prints one JSON
object as its last line: {tree: {shape: {...ms...}}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ab_trees import load_tree, log  # noqa: E402
from chip_smoke import (FFN_SHAPES, H100_INT8_PEAK_TOPS, card_line,  # noqa: E402
                        cuda_time_ms as cuda_ms, gemm_bound)


def one_tile_per_block(im):
    """The tree's GEMM planned for more SMs than the product has output
    tiles: one block per tile instead of one per SM."""
    def gemm(*args):
        saved = im._num_sms
        im._num_sms = lambda device_index: 2 ** 30
        try:
            return im.int8_matmul_cuda(*args)
        finally:
            im._num_sms = saved
    return gemm


def run(gemms: dict, plain, iters: int, card: str) -> dict:
    names = list(gemms)
    order = names + names[::-1]
    result = {name: {} for name in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in FFN_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
        xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        want = plain(x_q, w_q, sx, sw, None, torch.bfloat16)
        for name in names:
            if not torch.equal(gemms[name](x_q, w_q, sx, sw, None, torch.bfloat16), want):
                raise RuntimeError(f"{name} disagrees with int8_matmul_plain at {(m, k, n)}")
        del want
        turns = {name: [] for name in names}
        bf16, library = [], []
        for name in order:
            gemm = gemms[name]
            turns[name].append(cuda_ms(lambda: gemm(x_q, w_q, sx, sw, None, torch.bfloat16),
                                       iters))
            bf16.append(cuda_ms(lambda: xb @ wb.T, iters))
            library.append(cuda_ms(lambda: (torch._int_mm(x_q, w_q.t()) * sx[:, None]
                                            * sw[None, :]).to(torch.bfloat16), iters))
        bf16_ms, library_ms = sum(bf16) / len(bf16), sum(library) / len(library)
        bound = gemm_bound(m, k, n)
        for name in names:
            ms = sum(turns[name]) / len(turns[name])
            tops = 2 * m * k * n / ms / 1e9
            log(f"({m}, {k}, {n}) {name}: {ms:.4f} ms (turns "
                f"{', '.join(f'{x:.4f}' for x in turns[name])}); {tops:.1f} TOPS = "
                f"{100 * tops / H100_INT8_PEAK_TOPS:.1f}% of peak, "
                f"{100 * bound[0] / ms:.1f}% of its bound {bound[0]:.4f} ms; bf16 torch.matmul "
                f"{bf16_ms:.4f} ({ms / bf16_ms:.3f}x); torch._int_mm with the scales "
                f"{library_ms:.4f} ({ms / library_ms:.3f}x) ({card})")
            result[name][str((m, k, n))] = {"ms": ms, "turns": turns[name], "bf16_ms": bf16_ms,
                                            "library_ms": library_ms, "bound_ms": bound[0]}
        del x_q, w_q, xb, wb
        torch.cuda.empty_cache()
    return result


def sustain(gemms: dict, seconds: float, card: str) -> dict:
    """Each GEMM, then bf16 torch.matmul, back to back at the first FFN shape
    for ``seconds``: ms per call by the host clock over the whole run, and
    the SM clock (MHz) and power draw (W) sampled meanwhile."""
    m, k, n = FFN_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    sx = torch.rand(m, generator=gen, device="cuda") * 0.01 + 1e-4
    sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
    wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
    runs = {name: (lambda g=gemm: g(x_q, w_q, sx, sw, None, torch.bfloat16))
            for name, gemm in gemms.items()}
    runs["bf16 torch.matmul"] = lambda: xb @ wb.T
    result = {}
    for name, fn in runs.items():
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                      "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, timeout=30).stdout
                samples.append([float(x) for x in out.splitlines()[0].split(",")])
                time.sleep(0.2)

        fn()
        torch.cuda.synchronize()
        watcher = threading.Thread(target=sample)
        watcher.start()
        calls, t0 = 0, time.time()
        while time.time() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            calls += 20
        ms = (time.time() - t0) / calls * 1e3
        stop.set()
        watcher.join()
        clocks, watts = [x[0] for x in samples[1:]], [x[1] for x in samples[1:]]
        log(f"sustained {(m, k, n)} {name}: {ms:.4f} ms a call over {calls} calls; SM clock "
            f"{min(clocks):.0f}-{max(clocks):.0f} MHz (mean {sum(clocks) / len(clocks):.0f}), "
            f"power {min(watts):.1f}-{max(watts):.1f} W over {len(clocks)} samples ({card})")
        result[name] = {"ms": ms, "clocks_mhz": clocks, "power_w": watts}
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="NAME=DIR, DIR holding one_peace_tpu_torch/")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--one-tile-per-block", action="store_true",
                        help="also time each tree that has gemm_plan with one block per tile")
    parser.add_argument("--sustain", type=float, default=0.0,
                        help="seconds of back-to-back calls per GEMM with clocks sampled")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_matmul_ab: no CUDA card")
    card = card_line()
    log(card)
    modules, gemms = {}, {}
    for spec in args.trees:
        name, _, src = spec.partition("=")
        modules[name] = load_tree(name, Path(src).resolve(), "int8_matmul")
        gemms[name] = modules[name].int8_matmul_cuda
    for name, im in modules.items():
        if args.one_tile_per_block and hasattr(im, "gemm_plan"):
            gemms[f"{name}-one-tile"] = one_tile_per_block(im)
        lib = im.build_library("int8_matmul")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"{name} ptxas: {line.strip()}")
    plain = next(iter(modules.values())).int8_matmul_plain
    result = run(gemms, plain, args.iters, card)
    if args.sustain > 0:
        result["sustained"] = sustain(gemms, args.sustain, card)
    log(json.dumps(result))


if __name__ == "__main__":
    main()
