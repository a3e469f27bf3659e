#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card, its name and power limit (nvidia-smi);
2. build: every kernel source under ``one_peace_tpu_torch/csrc``, one nvcc
   each, started together;
3. the attention kernel against its plain PyTorch version, bf16 and fp32,
   at the main path's shapes (L = 257 image at B=2 and 256, 500 audio, 71
   text with pads, 850 VL concat), with the rows' softmax statistics that a
   gradient needs, so that both branches of ``tile_plan`` run (one walk with
   the row block resident, and two walks; logged per case);
4. the 4B retrieval model at full width (d 1536, FFN 6144, 24 heads, 40
   layers) on random weights from a seeded generator: text, image and audio
   embeddings through the kernel path (``attn_impl="pallas"``) against the
   plain path (``"xla"``), fp32 then bf16, and the kernel's launch count;
5. times (info lines): embeddings per second, kernel path and plain path,
   at bench.py's batches in bf16; attention ms per layer at L=257 (B=256),
   500 (B=32) and 71 (B=32, text pads), kernel and SDPA in turns;
6. the backward kernel against its plain version on the card, bf16 and fp32,
   at the training path's shapes (B=32 L=257 image, B=32 L=70 and 71 text
   with pads; with the forward kernel's statistics passed, as training
   does, and without) and at L=37 (batched bias), 500 and 850, each call
   twice and bit-equal, both branches of ``bwd_plan``; its time at L=257
   and 71 in turns with SDPA's backward, and each of its kernels alone;
7. the image-text retrieval fine-tuning step at full width through
   ``Trainer``: (a) 4 layers, kernel path against plain path on the same
   weights and batch -- loss and per-parameter gradient cosines in fp32 and
   bf16 compute, then 3 optimizer steps on each; (b) the depth-40 vl model,
   bf16 compute, fp32 master AdamW, remat, B=32: steps on the kernel path
   and then the plain path, ms per step, pairs per second, MFU, peak memory,
   the kernels' launch counts per step and a falling loss; one step under
   ``torch.profiler`` (its top ops go to ``chiprun_out/train_profile.txt``).
8. the int8 kernels (row quantize and GEMM) against their plain versions on
   the card, bit for bit, at the serving path's shapes, ragged ones and the
   edges of the GEMM's plan (M below one tile, a partial last wave of
   tiles, the audio rows); then
   the quantize's times at both FFN inputs and the GEMM's at the three FFN
   shapes, each beside its bound and plain version, the GEMM in turns with
   bf16 ``torch.matmul`` and ``torch._int_mm`` (its TOPS and share of the
   bound logged);
9. int8 serving at full width through the hub: ``from_pretrained`` on a
   2-layer full-width fairseq ``.pt`` written under ``build/``, quantize
   "ffn" and "ffn_attn", fp32 and bf16, text / image / audio embeddings on
   the kernel path against the plain int8 path, the launch counts per
   forward, ``process_image(on_device=True)``; then at depth 40 in bf16 the
   GEMM and quantize launches of one "ffn" and one "ffn_attn" image forward
   (120 / 80 and 280 / 160), and images/s and clips/s for the bf16, "ffn"
   and "ffn_attn" paths;
10. the depth-40 golden (``tests/fixtures/full_geometry_golden.npz``): the
   seeded 4B fairseq state regenerated, converted by the port's ``.pt``
   route, and the fp32 model on the kernel path held to the golden
   embeddings at cosine >= 1-1e-3;
11. detection serving: (a) the det attention kernel against its plain
   version, bf16 and fp32, with and without the LSE, at the 1024 px global
   grid (B=2, 64 x 64), its windows (B=32, 16 x 16; with each bias alone and
   none), a ragged 50 x 50 grid, a 1 x 64, an 8 x 8 and an 80 x 80 grid, so
   that each branch of the forward's plan runs (logged per case); (b)
   ``OnePeaceDetector`` at full width and depth 40, 1024 px, 80 classes,
   RPN and masks, on seeded random
   weights: the kernel path against the plain path (the stride-16 map, the
   pyramid, the cascade and mask heads on fixed proposals; cosine per image
   >= 1-1e-6 fp32, >= 0.999 bf16), 40 launches per trunk forward, then
   ``detect()``; (c) images/s of ``detect()`` at B=2 in bf16 on both paths,
   one profiled call (``detect_profile.txt`` beside phase 7's profile), and
   ms per global and windowed layer for the kernel, its plain version and
   SDPA with the bias materialised (kernel and SDPA in turns), the kernel's
   ratio to SDPA, and the kernel with no bias beside it;
12. detection fine-tuning: (a) the det attention backward kernels (pass 1
   with the dtoep pass, pass 2) against their plain version, bf16 and fp32,
   at the global grid (B=2, 64 x 64), its windows (B=32, 16 x 16) with each
   bias alone, both and none, and ragged, 32 x 32, 1 x 64 and 80 x 80 grids,
   each call twice and bit-equal, so that each branch of the backward's plan
   runs (logged per case); (b) the recipe's detector with 4 trunk
   layers at full width, 1024 px, B=2, drop path 0.6 and remat, RPN, cascade
   and masks: loss and per-parameter gradients, kernel path against plain
   path, fp32 and bf16 compute; (c) the recipe at depth 40 through
   ``load_config``, ``CocoDetectionTask.build_model``,
   ``DetectionCriterion`` and ``Trainer`` (bf16 over fp32 masters, AdamW
   with layer decay): ms per step, images/s, peak memory, launches per step
   (80 forward, 40 backward) and a falling loss on both paths, one profiled
   step (``det_train_profile.txt``); (d) ms per global and windowed layer of
   the backward by pass, each pass with no bias, toep only, bh + bw only and
   both, the plain backward and SDPA's backward with the materialised bias
   needing a gradient, and the backward's ratio to it;
13. retrieval fine-tuning from data through the CLIs: (a) 160 image-caption
   pairs as JPEG files under ``build/smoke_retrieval/``, TSVs, a valid JSON
   of 5 captions for each of 64 valid ids, and a byte-level BPE set; (b)
   ``cli.train`` at full width and depth 4 (bf16, remat, drop path 0.5,
   B=8, update_freq=2) straight to 4 updates, and again stopped at the end
   of epoch 1 (a save at update 2 with a micro-batch pending) and resumed
   to 4: the updates' losses within 1e-6 relative and the final masters'
   cosine >= 1-1e-6, then ``cli.evaluate`` on the run's
   ``checkpoint_best.npz`` (64 images, 320 texts); (c) the recipe at depth
   40 through ``cli.train`` from the config's init, B=32, 6 updates and one
   validation, no saves: ms per update from data beside phase 7(b)'s, pairs
   per second, peak memory, the attention kernels' launches per update and
   in validation, and one profiled update (``train_cli_profile.txt``);
14. detection from data through the CLIs: (a) a synthetic COCO tree under
   ``build/smoke_coco/``: 16 train and 8 valid JPEGs at 640 x 480, 480 x
   640, 1024 x 768 and 333 x 500, COCO's 80 non-contiguous category ids,
   objects as polygons, compressed and uncompressed RLE, a crowd region and
   a sub-pixel box in each image; (b) ``cli.train`` on the detection recipe
   at full width and depth 4 (1024 px, B=2, bf16 over fp32 masters, remat,
   drop path 0.6): 4 updates, one validation and ``checkpoint_best.npz``,
   whose ``params_from_jax`` read-back must equal the masters bit for bit;
   then ``cli.evaluate`` on it must detect what the validation detected and
   print its AP dict (to 1e-6); (c) the recipe at depth 40 through
   ``cli.train`` from the config's init, B=2, 6 updates and one validation
   over the 8 valid images, no saves: ms per update from data beside
   12(c)'s ms per step, images per second, peak memory, the det attention's
   launches per update (80 forward, 40 backward) and in validation (40),
   validation's wall time split between ``detect()``, the host's mask paste
   and AP records and the AP sweep, the host's share at 100 detections per
   image, and one profiled update (``det_cli_profile.txt``).

Every timed kernel also prints its bound: the larger of its bytes over the
HBM rate and its operations over the peak rate (NVIDIA's data sheet).  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from one_peace_tpu_torch import hub as port_hub
from one_peace_tpu_torch.core.config import FrameworkConfig, TaskConfig, load_config
from one_peace_tpu_torch.data.tokenizer import bytes_to_unicode
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.models.adapters.audio import conv_output_length
from one_peace_tpu_torch.models.one_peace import ModelConfig, OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import build
from one_peace_tpu_torch.ops import det_attention as da
from one_peace_tpu_torch.ops import flash_attention as fa
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops.attention import attention_plain
from one_peace_tpu_torch.ops.preprocess import resize_normalize
from one_peace_tpu_torch.ops.quant import quantize_ffn_
from one_peace_tpu_torch.tasks.vision_tasks import CocoDetectionTask
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint_convert import convert_retrieval_model
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "examples")]
import full_geometry_parity as golden  # noqa: E402  (its constants; it imports numpy only)
from torch_fixture import make_random_state_dict  # noqa: E402  (numpy)

H100_BF16_PEAK_TFLOPS = 989.0  # dense, NVIDIA data sheet (SXM, 700 W)
H100_INT8_PEAK_TOPS = 1979.0  # dense, the same sheet
H100_FP32_PEAK_TFLOPS = 67.0  # outside the tensor cores, the same sheet
H100_HBM_BYTES_PER_S = 3.35e12  # the same sheet
IMG_BATCH, AUD_BATCH, AUDIO_SECONDS = 256, 32, 10  # bench.py's workload
BF16_MAX_ERR, BF16_MEAN_ERR, FP32_MAX_ERR = 2e-2, 2e-3, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def analytic_flops(cfg, seq_len: int, batch: int, frontend: str, wav_samples: int = 0) -> float:
    """bench.py's closed form (2 FLOPs per MAC: trunk matmuls, attention,
    frontend convs), with the hMLP stem's real channels (d/4 -> d/4 -> d)."""
    enc = cfg.encoder
    d, f, L = enc.embed_dim, enc.ffn_embed_dim, seq_len
    flops = enc.layers * (2 * (4 * L * d * d) + 2 * (2 * L * L * d) + 2 * (3 * L * d * f))
    if frontend == "text":
        pass
    elif frontend == "image":
        hw = 256
        flops += 2 * ((hw // 4) ** 2 * (d // 4) * 3 * 16
                      + (hw // 8) ** 2 * (d // 4) * (d // 4) * 4
                      + (hw // 16) ** 2 * d * (d // 4) * 4)
    else:
        t, cin = wav_samples, 1
        for ch, k, s in enc.audio_adapter.feature_encoder_spec:
            t = (t - k) // s + 1
            flops += 2 * t * ch * cin * k
            cin = ch
        flops += 2 * t * d * cin
    return float(batch * flops)


def bound_ms(n_bytes: float, ops: float, peak_ops_per_s: float) -> tuple:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate; and which one it is."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Smallest cosine between matching rows, in fp64."""
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


FWD_BRANCHES = {True: "one walk, the row block's scores resident", False: "two walks"}


def check_kernel(gen) -> float:
    """Phase 3: kernel vs plain (fp32 on the same rounded inputs); returns
    the largest max |diff| seen.  Each case names the branch of
    ``tile_plan`` that the bf16 kernel took, and the phase fails unless both
    ran.  The rows' statistics (m, 1/l), written when a gradient will be
    taken, are held to the plain version's to 1e-4 relative, and the output
    written beside them must equal the one without."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, pad lengths per row, or "text", or None)
        (2, 257, "shared", None), (2, 257, "shared", [0, 0]),
        (2, 500, "shared", [0, 137]), (2, 37, "batched", [5, 0]),
        (1, 128, "shared", None), (1, 850, "shared", None),
        (32, 71, "shared", "text"), (256, 257, "shared", None)]
    # the last two cases draw from a generator of their own, so that `gen`
    # reaches the later phases (7(a)'s batch) in the state it always had
    extra = torch.Generator(device="cuda").manual_seed(1)
    branches = set()
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, l, form, pads) in enumerate(cases):
            rng = gen if i < 6 else extra
            q, k, v = (torch.randn(b, l, heads, 64, generator=rng, device="cuda").to(dtype)
                       for _ in range(3))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=rng, device="cuda")
            mask = None
            if pads == "text":
                mask = text_pad_mask(b, l)
            elif pads is not None:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads):
                    if n:
                        mask[row, l - n:] = True
            got = fa.flash_attention(q, k, v, bias, mask, 0.125).float()
            torch.cuda.synchronize()
            key_bias = None if mask is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            q3, k3, v3 = (x.reshape(b, l, heads * 64) for x in (q, k, v))
            want, want_stats = fa.flash_attention_plain(
                *(x.float() for x in (q3, k3, v3)), bias, key_bias, 0.125, heads,
                with_stats=True)
            want = want.reshape(b, l, heads, 64)
            out_s, stats = fa.flash_attention_cuda(q3, k3, v3, bias, key_bias, 0.125, heads,
                                                   with_stats=True)
            torch.cuda.synchronize()
            err = (got - want).abs()
            mx, mean = err.max().item(), err.mean().item()
            stats_err = max(((stats[0] - want_stats[0]).abs()
                             / want_stats[0].abs().clamp_min(1)).max().item(),
                            ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item())
            worst = max(worst, mx)
            plan = fa.tile_plan(l)
            if dtype == torch.bfloat16:
                branches.add(plan.resident)
            log(f"kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads="
                f"{'text' if pads == 'text' else pads}: max|d| {mx:.3e} mean|d| {mean:.3e}, "
                f"statistics {stats_err:.2e} relative; plan: {FWD_BRANCHES[plan.resident]}, "
                f"last tile {plan.tail} wide")
            if not torch.isfinite(got).all():
                raise RuntimeError("kernel output is not finite")
            if dtype == torch.bfloat16 and (mx > BF16_MAX_ERR or mean > BF16_MEAN_ERR):
                raise RuntimeError(f"bf16 kernel disagrees: max {mx} mean {mean}")
            if dtype == torch.float32 and mx > FP32_MAX_ERR:
                raise RuntimeError(f"fp32 kernel disagrees: max {mx}")
            if stats_err > 1e-4:
                raise RuntimeError(f"kernel statistics disagree: {stats_err}")
            if not torch.equal(out_s.reshape(b, l, heads, 64).float(), got):
                raise RuntimeError("the output written with the statistics differs")
            if pads == [0, 0]:  # an all-False mask must equal no mask
                same = fa.flash_attention(q, k, v, bias, None, 0.125).float()
                if not torch.equal(same, got):
                    raise RuntimeError("all-False mask and no mask disagree")
            del q, k, v, bias, got, want, want_stats, out_s, stats, q3, k3, v3, err
            torch.cuda.empty_cache()
    if branches != {True, False}:
        raise RuntimeError(f"phase 3 ran the forward plan's branches {branches}, not both")
    return worst


def text_pad_mask(b: int, l: int, device="cuda") -> torch.Tensor:
    """(b, l) True at pads: row i keeps CLS and 8 + 7i mod (l - 8) tokens."""
    mask = torch.zeros(b, l, dtype=torch.bool, device=device)
    for row in range(b):
        mask[row, 9 + (7 * row) % (l - 9):] = True
    return mask


DQ_BRANCHES = {True: "dq: p32 resident", False: "dq: two walks"}
DKV_BRANCHES = {True: "dk/dv: d(bias) slab", False: "dk/dv: d(bias) in device memory"}


def check_backward_kernel(gen) -> float:
    """Phase 6: the backward kernel against flash_attention_bwd_plain on the
    same inputs, bf16 and fp32; returns the largest max |diff| of dq, dk, dv
    and d(bias).  Each call runs twice and must be bit-equal.  The case
    marked "fwd" passes the forward kernel's statistics, as training does;
    the others let the wrapper launch the forward for them.  Each case names
    the branches of ``bwd_plan`` that the bf16 kernels took (the dq kernel's
    walks, and with a shared bias the dk/dv kernel's d(bias) sum), and the
    phase fails unless each branch ran.

    Bounds, relative to max |plain| (and mean |diff| to mean |plain|):
    fp32 1e-4 max -- both sides sum in fp32, in other orders, over at most
    850 terms (and 32 batch rows for d(bias)), and the kernel's exp is
    ex2.approx (2 ulp); bf16 2e-2 max, 5e-3 mean -- dq, dk, dv are rounded to
    bf16 (2^-8 relative), and where the kernel's fp32 p or ds*scaling lands
    on the other side of a bf16 rounding boundary than the plain version's,
    one product term moves by one bf16 ulp."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, key mask, the forward's statistics passed)
        (32, 257, "shared", None, False), (32, 70, "shared", "text", False),
        (2, 37, "batched", [5, 0], False), (4, 500, "shared", [0, 137, 0, 60], False),
        (1, 850, "shared", None, False), (32, 257, "shared", None, True),
        (32, 71, "shared", "text", True)]
    # the last two cases draw from a generator of their own (see check_kernel)
    extra = torch.Generator(device="cuda").manual_seed(2)
    branches = set()
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, l, form, pads, fwd_stats) in enumerate(cases):
            rng = gen if i < 5 else extra
            q, k, v, g = (torch.randn(b, l, heads * 64, generator=rng, device="cuda").to(dtype)
                          for _ in range(4))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=rng, device="cuda")
            if pads == "text":
                mask = text_pad_mask(b, l)
            else:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads or []):
                    if n:
                        mask[row, l - n:] = True
            key_bias = None if pads is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            stats = None
            if fwd_stats:
                _, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads,
                                                   with_stats=True)
            got = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads,
                                              stats=stats)
            again = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads,
                                                stats=stats)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
                raise RuntimeError(f"two backward calls differ: {str(dtype)[6:]} B={b} L={l}")
            want = fa.flash_attention_bwd_plain(q, k, v, g, bias, key_bias, 0.125, heads)
            parts = []
            for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"backward kernel {name} is not finite")
                err = (x.float() - y.float()).abs()
                rel_max = err.max().item() / y.float().abs().max().item()
                rel_mean = err.mean().item() / y.float().abs().mean().item()
                parts.append(f"{name} {rel_max:.2e}/{rel_mean:.2e}")
                worst = max(worst, err.max().item())
                bad = (rel_max > 1e-4 if dtype == torch.float32
                       else rel_max > 2e-2 or rel_mean > 5e-3)
                if bad:
                    raise RuntimeError(f"backward kernel {name} disagrees with the plain "
                                       f"version: {str(dtype)[6:]} B={b} L={l} {form} "
                                       f"{pads}: max {rel_max:.3e} mean {rel_mean:.3e}")
            plan = fa.bwd_plan(b, l, heads, form == "shared")
            branch = f"; plan: {DQ_BRANCHES[plan.tiles.resident]}"
            if dtype == torch.bfloat16:
                branches.add(("dq", plan.tiles.resident))
            if form == "shared":
                branch += (f", {DKV_BRANCHES[plan.dkv_slab]}, {plan.chunks} chunks of "
                           f"{plan.b_chunk}")
                if dtype == torch.bfloat16:
                    branches.add(("dkv", plan.dkv_slab))
            log(f"bwd kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads="
                f"{'text' if pads == 'text' else pads}"
                f"{', statistics from the forward' if fwd_stats else ''}: max/mean |d| "
                f"relative {', '.join(parts)}; two calls bit-equal{branch}")
            del q, k, v, g, bias, got, again, want, stats
            torch.cuda.empty_cache()
    if branches != {(kernel, x) for kernel in ("dq", "dkv") for x in (True, False)}:
        raise RuntimeError(f"phase 6 ran the backward plan's branches {branches}, not all")
    return worst


def in_turns(fns: dict, iters: int) -> dict:
    """Mean ms per call of each function, timed in turns (a, b, ..., b, a)."""
    names = list(fns)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(cuda_time_ms(fns[name], iters))
    return {name: float(np.mean(turns[name])) for name in names}


def sdpa_mask(bias, key_bias, b):
    """The additive bf16 mask SDPA gets: the bias, plus the key bias where
    there is one ((B, H, L, L) then, else broadcast over B)."""
    mask = bias[None] if key_bias is None else bias[None] + key_bias[:, None, None, :]
    return mask.to(torch.bfloat16).expand(b, -1, -1, -1)


def time_backward(gen, card: str) -> dict:
    """Phase 6 times: the backward kernel (given the forward's statistics,
    as in training) and SDPA's backward in turns, at the image training
    shape (B=32, L=257, shared bias) and the text one (B=32, L=71 with pads),
    bf16; each kernel alone (``passes``); the plain version; autograd
    through the plain attention as information at L=257.  Returns L=257's
    numbers with the text row under "shapes"."""
    heads, out = 24, {}
    extra = torch.Generator(device="cuda").manual_seed(3)  # the text row's (see check_kernel)
    for b, l, pads in ((32, 257, False), (32, 71, True)):
        rng = gen if l == 257 else extra
        q, k, v, g = (torch.randn(b, l, heads * 64, generator=rng, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        bias = torch.randn(heads, l, l, generator=rng, device="cuda")
        key_bias = (torch.zeros(b, l, device="cuda").masked_fill(text_pad_mask(b, l), fa.NEG_INF)
                    if pads else None)
        _, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads, with_stats=True)
        leaves = [x.reshape(b, l, heads, 64).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        mask = sdpa_mask(bias, key_bias, b).detach().requires_grad_()
        res = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                               scale=0.125)
        g4 = g.reshape(b, l, heads, 64).transpose(1, 2)
        args = (q, k, v, g, bias, key_bias, 0.125, heads)
        t = in_turns({
            "kernel": lambda: fa.flash_attention_bwd_cuda(*args, stats=stats),
            "sdpa": lambda: torch.autograd.grad(res, [*leaves, mask], g4, retain_graph=True)},
            iters=10)
        dq_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(*args, stats=stats, passes=1),
                             iters=10)
        dkv_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(*args, stats=stats, passes=2),
                              iters=10)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=5)
        # dq, dk, dv and d(bias) from q, k, v, g, the bias: S recomputed, dP, dV, dQ, dK
        flops = 10 * b * heads * l * l * 64
        bound = bound_ms(7 * q.numel() * 2 + 2 * bias.numel() * 4 + stats.numel() * 4, flops,
                         H100_BF16_PEAK_TFLOPS * 1e12)
        plan = fa.bwd_plan(b, l, heads, True)
        log(f"attention backward per layer B={b} L={l}{' text pads' if pads else ''} bf16: "
            f"kernel {t['kernel']:.4f} ms (dq kernel {dq_ms:.4f}, dk/dv kernel {dkv_ms:.4f}), "
            f"{t['kernel'] / t['sdpa']:.3f}x SDPA's backward {t['sdpa']:.4f} ms (in turns); "
            f"plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]}; plan "
            f"{DQ_BRANCHES[plan.tiles.resident]}, {DKV_BRANCHES[plan.dkv_slab]}, last tile "
            f"{plan.tiles.tail} wide, {plan.chunks} chunks of {plan.b_chunk} ({card})")
        row = {"ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
               "bound_ms": bound[0], "bound_by": bound[1], "dq_ms": dq_ms, "dkv_ms": dkv_ms}
        if l == 257:
            leaves32 = [x.detach().float().requires_grad_() for x in leaves]
            bias.requires_grad_()

            def autograd_plain():
                o = attention_plain(*(x.transpose(1, 2) for x in leaves32), bias, None, 0.125)
                torch.autograd.grad(o, [*leaves32, bias], g4.transpose(1, 2).float())

            log(f"attention backward B={b} L={l}: autograd through the plain attention "
                f"(forward included, fp32) {cuda_time_ms(autograd_plain, iters=3):.3f} ms")
            out.update(row)
        else:
            out.setdefault("shapes", {})[f"L={l} B={b} text pads"] = row
        del q, k, v, g, bias, key_bias, stats, leaves, mask, res, g4, args
        torch.cuda.empty_cache()
    return out


def train_config(layers: int, bf16: bool, remat: bool, drop_path: float) -> FrameworkConfig:
    """The image-text retrieval fine-tune (recipes/image_text_retrieval over
    recipes/finetune_4b_base): vl head at the 4B width, AdamW betas (0.9,
    0.999), weight decay 0.05, no clipping; constant lr 1e-5 for the few
    steps taken here (no warmup)."""
    cfg = FrameworkConfig()
    cfg.model = ModelConfig(head_type="vl")
    enc = cfg.model.encoder
    enc.layers, enc.checkpoint_activations, enc.drop_path_rate = layers, remat, drop_path
    cfg.criterion._name = "image_text_retrieval_criterion"
    cfg.common.bf16 = bf16
    cfg.optimizer.adam_betas = (0.9, 0.999)
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 1e-5
    cfg.optimization.clip_norm = 0.0
    cfg.lr_scheduler.min_lr = 1e-5
    return cfg


def train_batch(cfg, gen, b: int) -> dict:
    """b image-text pairs: 256 px images, 70-token texts with pads."""
    tokens = torch.randint(4, cfg.model.encoder.text_adapter.vocab_size, (b, 70),
                           generator=gen, device="cuda")
    tokens[text_pad_mask(b, 71)[:, 1:]] = cfg.model.encoder.text_adapter.padding_idx
    return {"src_tokens": tokens,
            "src_images": torch.randn(b, 3, 256, 256, generator=gen, device="cuda")}


def make_trainer(cfg, seed: int = 0) -> Trainer:
    model = OnePeaceRetrievalModel(cfg.model, device="cuda", dtype=torch.float32)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def grad_cosines(grads_a, grads_b) -> list:
    """Cosine between matching gradients (1 where both are zero), in fp64."""
    out = []
    for a, b in zip(grads_a, grads_b):
        a, b = a.double().flatten(), b.double().flatten()
        norm = a.norm() * b.norm()
        out.append(1.0 if norm == 0 else (a @ b / norm).item())
    return out


def check_train_paths(gen) -> None:
    """Phase 7(a): 4 layers at full width, kernel path against plain path on
    the same weights and batch.

    fp32: the losses within 1e-5 and every parameter's gradient cosine
    >= 1-1e-6 (the kernels agree with their plain versions to ~3e-7).
    bf16 compute: both paths round activations and the weights' copies to
    bf16, so each differs from the fp32 gradients by bf16 noise; small
    parameters fed by few positions (a last-layer LN bias) sit near cosine
    0.99 between any two bf16 runs.  The kernel path must be no further from
    the fp32 gradients than the plain path: per parameter, cosine to fp32 at
    least the plain path's minus 0.01, and over all parameters together
    kernel vs plain >= 0.999; losses within 2e-3.  Then 3 AdamW steps on
    each path: losses within 1e-4 (fp32) and 2e-2 (bf16) -- Adam's
    normalised update turns small gradient differences into parameter
    differences of order lr."""
    cfg = train_config(layers=4, bf16=False, remat=False, drop_path=0.0)
    batch = train_batch(cfg, gen, 8)
    runs, ref32 = {}, None
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        cfg = train_config(layers=4, bf16=bf16, remat=False, drop_path=0.0)
        trainer = make_trainer(cfg)
        enc = trainer.model.cfg.encoder
        for impl in ("pallas", "xla"):
            enc.attn_impl = impl
            fa.launches = fa.bwd_launches = 0
            metrics, grads = trainer.gradients(batch)
            torch.cuda.synchronize()
            launched = (fa.launches, fa.bwd_launches)
            want = (2 * 4, 2 * 4) if impl == "pallas" else (0, 0)
            if launched != want:
                raise RuntimeError(f"7(a) {name} {impl}: launches {launched}, expected {want}")
            if not all(torch.isfinite(g).all() for g in grads):
                raise RuntimeError(f"7(a) {name} {impl}: non-finite gradient")
            runs[name, impl] = (float(metrics["loss"]), grads)
        enc.attn_impl = "pallas"
        names = trainer._names
        del trainer
        (loss_k, grads_k), (loss_p, grads_p) = runs[name, "pallas"], runs[name, "xla"]
        cos = grad_cosines(grads_k, grads_p)
        worst = min(range(len(cos)), key=cos.__getitem__)
        log(f"7(a) {name} 4-layer vl B=8: loss kernel {loss_k:.7f} plain {loss_p:.7f}; "
            f"gradient cosine kernel vs plain per parameter min {cos[worst]:.9f} "
            f"({names[worst]}), median {sorted(cos)[len(cos) // 2]:.9f}, "
            f"{len(cos)} parameters")
        if not bf16:
            ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and cos[worst] >= 1 - 1e-6
            ref32 = grads_p
        else:
            cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
            gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
            total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                                 [torch.cat([g.flatten() for g in grads_p])])[0]
            log(f"7(a) bf16 vs the fp32 gradients: min cosine kernel path {min(cos_k):.6f}, "
                f"plain path {min(cos_p):.6f}; largest shortfall of the kernel path "
                f"{cos_p[gap] - cos_k[gap]:.2e} ({names[gap]}); all parameters together "
                f"kernel vs plain {total:.9f}")
            ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
                  and cos_p[gap] - cos_k[gap] <= 0.01)
        if not ok:
            raise RuntimeError(f"7(a) {name}: kernel and plain training paths disagree")
        runs.clear()
        del grads_k, grads_p
        losses = {}
        for impl in ("pallas", "xla"):
            trainer = make_trainer(cfg)
            trainer.model.cfg.encoder.attn_impl = impl
            losses[impl] = [trainer.train_step(batch)["loss"] for _ in range(3)]
            del trainer
        log(f"7(a) {name} 3 AdamW steps: losses kernel {losses['pallas']}, plain {losses['xla']}")
        tol = 2e-2 if bf16 else 1e-4
        for a, b in zip(losses["pallas"], losses["xla"]):
            if abs(a - b) > tol * abs(b):
                raise RuntimeError(f"7(a) {name}: step losses disagree")
        torch.cuda.empty_cache()


def train_full_depth(gen, card: str) -> dict:
    """Phase 7(b): the depth-40 vl model, bf16 compute, fp32 master AdamW,
    remat, drop path 0.5 (the recipe's); B=32, or 16 if 32 does not fit.
    Every step sees the same batch and the same drop-path masks (the
    trainer's generator is reset before each), so the loss must fall."""
    cfg = train_config(layers=40, bf16=True, remat=True, drop_path=0.5)
    trainer = make_trainer(cfg)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"7(b) 4B vl model: {n_params / 1e9:.3f}B parameters, fp32 master + AdamW state")
    enc = trainer.model.cfg.encoder
    rng_state = trainer.generator.get_state()
    for b in (32, 16):
        batch = train_batch(cfg, gen, b)
        try:
            torch.cuda.reset_peak_memory_stats()
            trainer.generator.set_state(rng_state)
            first = trainer.train_step(batch)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"7(b) B={b} does not fit on the card")
            if b == 16:
                raise
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"7(b) running B={b} (first step, warm-up: loss {first['loss']:.5f}, "
        f"{first['step_time'] * 1e3:.0f} ms)")
    flops = 4 * (analytic_flops(cfg.model, 257, b, "image")
                 + analytic_flops(cfg.model, 71, b, "text"))
    layers = cfg.model.encoder.layers
    result = {"batch": b}
    for impl, steps in (("pallas", 4), ("xla", 2)):
        enc.attn_impl = impl
        fa.launches = fa.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(metrics["loss"])
        launched = (fa.launches, fa.bwd_launches)
        want = (steps * 2 * layers * 2, steps * 2 * layers) if impl == "pallas" else (0, 0)
        ms = 1e3 * sum(times) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflops = flops / ms / 1e9
        log(f"7(b) {impl} B={b}: {ms:.1f} ms per step, {b / ms * 1e3:.1f} pairs/s, "
            f"{tflops:.1f} TFLOP/s = {100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU, peak "
            f"{peak:.1f} GiB, losses {[round(x, 5) for x in losses]}, launches fwd "
            f"{launched[0]} bwd {launched[1]} (expected {want[0]} and {want[1]}) ({card})")
        if launched != want:
            raise RuntimeError(f"7(b) {impl}: launches {launched}, expected {want}")
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"7(b) {impl}: non-finite loss")
        result[impl] = {"ms": ms, "peak_gib": peak, "losses": losses,
                        "launches": launched}
    losses = [first["loss"], *result["pallas"]["losses"], *result["xla"]["losses"]]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"7(b): the loss on a repeated batch did not fall: {losses}")
    enc.attn_impl = "pallas"
    trainer.generator.set_state(rng_state)
    profile_call(lambda: trainer.train_step(batch), result["pallas"]["ms"], "7(b)",
                 "train_profile.txt")
    return result


def profile_call(fn, wall_ms: float, label: str, file_name: str) -> None:
    """One kernel-path call under torch.profiler: device time by op, and
    the device's busy time against the unprofiled call's ``wall_ms`` (one
    stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / file_name).write_text(table)
    log(f"{label} profiled kernel-path call, top ops by device self time:")
    for line in table.splitlines()[:16]:
        log(f"  {line}")
    total = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    if total:
        busy = float(total.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[total.group(2)]
        log(f"{label} device busy {busy:.1f} ms of the unprofiled {wall_ms:.1f} ms: "
            f"idle {100 * (1 - busy / wall_ms):.0f}%")


def make_inputs(cfg, gen, n_img, n_aud, n_txt):
    """Images at 256 px, 10 s clips (the second padded to 6 s), 32-token
    texts with pads."""
    spec = cfg.encoder.audio_adapter.feature_encoder_spec
    imgs = torch.randn(n_img, 3, 256, 256, generator=gen, device="cuda")
    samples = 16000 * AUDIO_SECONDS
    wav = torch.randn(n_aud, samples, generator=gen, device="cuda")
    frames = conv_output_length(samples, spec)
    pad = torch.zeros(n_aud, frames + 1, dtype=torch.bool, device="cuda")
    if n_aud > 1:
        wav[1, 16000 * 6:] = 0
        pad[1, 1 + conv_output_length(16000 * 6, spec):] = True
    vocab = cfg.encoder.text_adapter.vocab_size
    tokens = torch.randint(4, vocab, (n_txt, 32), generator=gen, device="cuda")
    for row in range(1, n_txt):
        tokens[row, 32 - 5 * row:] = cfg.encoder.text_adapter.padding_idx
    return {"image": {"src_images": imgs},
            "audio": {"src_audios": wav, "audio_padding_masks": pad},
            "text": {"src_tokens": tokens}}


def check_slice(cfg, inputs, dtype, min_cos: float, reference=None) -> dict:
    """Phase 4 for one dtype: kernel path vs plain path on the same weights.
    Returns the plain path's embeddings; ``reference`` (the fp32 plain
    path's) is compared with both paths as information."""
    t0 = time.time()
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=dtype)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"4B model {str(dtype)[6:]}: {n_params / 1e9:.3f}B params on the card "
        f"({time.time() - t0:.1f} s to build and fill)")
    plain = {}
    with torch.inference_mode():
        for encoder_type, kwargs in inputs.items():
            outs = {}
            for impl in ("pallas", "xla"):
                model.cfg.encoder.attn_impl = impl
                before = fa.launches
                out = model(encoder_type=encoder_type, **kwargs)
                torch.cuda.synchronize()
                launched = fa.launches - before
                want = model.cfg.encoder.layers if impl == "pallas" else 0
                if launched != want:
                    raise RuntimeError(f"{encoder_type} {impl}: {launched} kernel "
                                       f"launches, expected {want}")
                outs[impl] = out.float()
            got, ref = outs["pallas"], outs["xla"]
            b = next(iter(kwargs.values())).shape[0]
            if got.shape != (b, cfg.encoder.embed_dim) or not torch.isfinite(got).all():
                raise RuntimeError(f"{encoder_type}: bad embeddings {tuple(got.shape)}")
            norm_err = (got.norm(dim=-1) - 1).abs().max().item()
            cos = min_cosine(got, ref)
            log(f"slice {str(dtype)[6:]} {encoder_type} B={b}: min cosine kernel vs plain "
                f"{cos:.9f} (bound {min_cos}), max |norm-1| {norm_err:.2e}, "
                f"{cfg.encoder.layers} launches per kernel-path forward")
            if reference is not None:
                ref32 = reference[encoder_type]
                log(f"  vs the fp32 plain path: min cosine kernel "
                    f"{min_cosine(got, ref32):.6f}, plain {min_cosine(ref, ref32):.6f}")
            plain[encoder_type] = ref
            if norm_err > 1e-2:
                raise RuntimeError(f"{encoder_type}: embedding norms off by {norm_err}")
            if cos < min_cos:
                raise RuntimeError(f"{encoder_type}: kernel and plain paths disagree")
    model.cfg.encoder.attn_impl = "pallas"
    return plain


def time_paths(cfg, card: str):
    """Phase 5: e2e and attention-only times, kernel path and plain path."""
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = make_inputs(cfg, gen, IMG_BATCH, AUD_BATCH, 1)
    inputs["audio"]["audio_padding_masks"].zero_()  # bench.py: unpadded clips
    inputs["image"]["src_images"] = inputs["image"]["src_images"].bfloat16()
    frames = inputs["audio"]["audio_padding_masks"].shape[1]
    work = {"image": (IMG_BATCH, 257, analytic_flops(cfg, 257, IMG_BATCH, "image")),
            "audio": (AUD_BATCH, frames, analytic_flops(
                cfg, frames, AUD_BATCH, "audio", 16000 * AUDIO_SECONDS))}
    with torch.inference_mode():
        for encoder_type in ("image", "audio"):
            b, _, flops = work[encoder_type]
            for impl in ("pallas", "xla", "pallas", "xla"):
                model.cfg.encoder.attn_impl = impl
                ms = cuda_time_ms(lambda: model(encoder_type=encoder_type,
                                                **inputs[encoder_type]), iters=3, warmup=1)
                tflops = flops / ms / 1e9
                log(f"e2e {encoder_type} B={b} bf16 {impl}: {ms:.1f} ms per batch, "
                    f"{b / ms * 1e3:.1f} {encoder_type}s/s, {tflops:.1f} TFLOP/s = "
                    f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% of {H100_BF16_PEAK_TFLOPS:.0f} "
                    f"({card})")
    model.cfg.encoder.attn_impl = "pallas"
    del model, inputs
    torch.cuda.empty_cache()
    return time_attention(gen, cfg.encoder.attention_heads, frames, card)


def time_attention(gen, heads: int, frames: int, card: str) -> dict:
    """Phase 5's attention times: ms per layer of the forward kernel and of
    SDPA with the additive mask, in turns, at the image (B=256, L=257),
    audio (B=32, L=frames) and text (B=32, L=71, pads) shapes; beside them
    the kernel writing the statistics a gradient needs, and the plain
    version.  Returns L=257's numbers with the others under "shapes"."""
    attn_ms = {}
    for b, l, pads in ((IMG_BATCH, 257, False), (AUD_BATCH, frames, False), (32, 71, True)):
        q, k, v = (torch.randn(b, l, heads * 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        bias = torch.randn(heads, l, l, generator=gen, device="cuda")
        key_bias = (torch.zeros(b, l, device="cuda").masked_fill(text_pad_mask(b, l), fa.NEG_INF)
                    if pads else None)
        q4, k4, v4 = (x.view(b, l, heads, 64).transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(bias, key_bias, b)
        t = in_turns({
            "kernel": lambda: fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=20)
        stats_ms = cuda_time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, bias, key_bias, 0.125, heads, with_stats=True), iters=20)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, bias, key_bias, 0.125, heads), iters=5)
        flops = 4 * b * heads * l * l * 64
        kb_bytes = 0 if key_bias is None else key_bias.numel() * 4
        bound = bound_ms(4 * q.numel() * 2 + bias.numel() * 4 + kb_bytes, flops,
                         H100_BF16_PEAK_TFLOPS * 1e12)
        plan = fa.tile_plan(l)
        log(f"attention per layer B={b} L={l}{' text pads' if pads else ''} bf16: kernel "
            f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} TFLOP/s; with the "
            f"statistics {stats_ms:.4f}), {t['kernel'] / t['sdpa']:.3f}x SDPA with the additive "
            f"mask {t['sdpa']:.4f} ms (in turns); plain {plain_ms:.3f} ms; bound "
            f"{bound[0]:.4f} ms by {bound[1]}; plan {FWD_BRANCHES[plan.resident]}, last tile "
            f"{plan.tail} wide ({card})")
        attn_ms[l] = {"ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
                      "bound_ms": bound[0], "bound_by": bound[1], "stats_ms": stats_ms,
                      "batch": b}
        del q, k, v, bias, key_bias, q4, k4, v4, mask
        torch.cuda.empty_cache()
    main = attn_ms.pop(257)
    main["shapes"] = {f"L={l} B={row.pop('batch')}" + (" text pads" if l == 71 else ""): row
                      for l, row in attn_ms.items()}
    return main


FFN_SHAPES = [(65792, 1536, 6144), (65792, 6144, 1536), (65792, 1536, 1536)]  # (M, K, N)
RAGGED_SHAPES = [(13, 100, 70), (260, 520, 515)]  # tests/test_quant.py:141's
# M below one tile; a tile count that leaves a partial last wave on 132 SMs;
# the audio rows (B=32 at L=501)
EDGE_SHAPES = [(64, 1536, 6144), (4100, 1536, 6144), (16032, 6144, 1536)]


def check_int8_kernels(gen) -> dict:
    """Phase 8 (a): the row quantize and the GEMM against their plain
    versions, bit for bit, at the serving path's shapes (M = 65,792 image
    rows at B=256, 16,032 audio rows at B=32), ragged ones and the GEMM
    plan's edges.  Returns the largest differences (0)."""
    worst = {"quantize": 0.0, "gemm": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for m, k in ((65792, 1536), (65792, 6144), (16032, 6144), (13, 100)):
            x = (torch.randn(m, k, generator=gen, device="cuda") * 2).to(dtype)
            got = im.int8_quantize_rows_cuda(x)
            torch.cuda.synchronize()
            want = im.int8_quantize_rows_plain(x)
            err = max((got[0].int() - want[0].int()).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            worst["quantize"] = max(worst["quantize"], float(err))
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            log(f"int8 quantize vs plain {str(dtype)[6:]} ({m} x {k}): "
                f"{'bit-equal' if same else f'DIFFERENT, max |d| {err}'}")
            if not same:
                raise RuntimeError(f"int8 quantize kernel disagrees at {dtype} ({m}, {k})")
            del x, got, want
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the plan's edges draw from a generator of their own, so that `gen`
    # reaches the later phases (11 and 12) in the state it always had
    extra = torch.Generator(device="cuda").manual_seed(4)
    for m, k, n in FFN_SHAPES + RAGGED_SHAPES + EDGE_SHAPES:
        rng = extra if (m, k, n) in EDGE_SHAPES else gen
        x_q = torch.randint(-127, 128, (m, k), generator=rng, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=rng, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=rng, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=rng, device="cuda") * 0.01 + 1e-4
        bias = torch.randn(n, generator=rng, device="cuda")
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                got = im.int8_matmul_cuda(x_q, w_q, sx, sw, b, out_dtype)
                torch.cuda.synchronize()
                want = im.int8_matmul_plain(x_q, w_q, sx, sw, b, out_dtype)
                err = (got.float() - want.float()).abs().max().item()
                worst["gemm"] = max(worst["gemm"], err)
                if not torch.equal(got, want):
                    raise RuntimeError(f"int8 GEMM disagrees at ({m}, {k}, {n}) "
                                       f"{out_dtype} bias={b is not None}: max {err}")
                del got, want
        plan = im.gemm_plan(m, n, k, sms)
        log(f"int8 GEMM vs plain ({m}, {k}, {n}): bit-equal in fp32 and bf16, with and "
            f"without bias ({plan.tiles_m * plan.tiles_n} tiles on a grid of {plan.grid})")
    torch.cuda.empty_cache()
    return worst


def gemm_bound(m: int, k: int, n: int) -> tuple:
    """x_q, w_q, the scales read once and y written once in bf16; 2MKN
    integer operations at the int8 peak."""
    return bound_ms(m * k + n * k + 4 * (m + n) + 2 * m * n, 2 * m * k * n,
                    H100_INT8_PEAK_TOPS * 1e12)


def time_int8_kernels(gen, card: str) -> dict:
    """Phase 8 (b): the row quantize at both FFN inputs and the GEMM at the
    three FFN shapes, each beside its plain version; the GEMM in turns with
    bf16 ``torch.matmul`` on the same product and ``torch._int_mm`` with the
    scales (information: neither is used by the port)."""
    times = {}
    extra = torch.Generator(device="cuda").manual_seed(5)  # the wo input's (see check_int8_kernels)
    for m, k in ((65792, 1536), (65792, 6144)):
        x = torch.randn(m, k, generator=gen if k == 1536 else extra, device="cuda",
                        dtype=torch.bfloat16)
        kernel_ms = cuda_time_ms(lambda: im.int8_quantize_rows_cuda(x), iters=20)
        plain_ms = cuda_time_ms(lambda: im.int8_quantize_rows_plain(x), iters=5)
        bound = bound_ms(x.numel() * 3 + m * 4, 3 * x.numel(), H100_FP32_PEAK_TFLOPS * 1e12)
        log(f"int8 quantize ({m} x {k}) bf16: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({100 * bound[0] / kernel_ms:.1f}% of it) ({card})")
        times[(m, k)] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "library_ms": None}
        del x
    for m, k, n in FFN_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(m, device="cuda"), torch.rand(n, device="cuda")
        xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        turns = in_turns({
            "kernel": lambda: im.int8_matmul_cuda(x_q, w_q, sx, sw, None, torch.bfloat16),
            "bf16": lambda: xb @ wb.T,
            "library": lambda: (torch._int_mm(x_q, w_q.t()) * sx[:, None]
                                * sw[None, :]).to(torch.bfloat16)}, iters=10)
        plain_ms = cuda_time_ms(lambda: im.int8_matmul_plain(x_q, w_q, sx, sw, None,
                                                             torch.bfloat16), iters=3, warmup=1)
        bound = gemm_bound(m, k, n)
        tops = 2 * m * k * n / turns["kernel"] / 1e9
        log(f"int8 GEMM ({m}, {k}, {n}) -> bf16: kernel {turns['kernel']:.4f} ms ({tops:.1f} "
            f"TOPS = {100 * tops / H100_INT8_PEAK_TOPS:.1f}% of {H100_INT8_PEAK_TOPS:.0f}; "
            f"{100 * bound[0] / turns['kernel']:.1f}% of its bound {bound[0]:.4f} ms by "
            f"{bound[1]}), plain {plain_ms:.3f} ms; bf16 torch.matmul {turns['bf16']:.4f} ms "
            f"({2 * m * k * n / turns['bf16'] / 1e9:.1f} TFLOP/s); torch._int_mm with the "
            f"scales {turns['library']:.4f} ms ({card})")
        times[(m, k, n)] = {"ms": turns["kernel"], "plain_ms": plain_ms,
                            "bf16_ms": turns["bf16"], "library_ms": turns["library"],
                            "bound_ms": bound[0], "bound_by": bound[1]}
        del x_q, w_q, xb, wb
    torch.cuda.empty_cache()
    return times


@contextlib.contextmanager
def plain_int8():
    """The int8 serving path on the plain versions (the comparison side of
    phase 9): ``ops.quant`` reaches the dispatchers through the module."""
    saved = im.int8_quantize_rows, im.int8_matmul
    im.int8_quantize_rows, im.int8_matmul = im.int8_quantize_rows_plain, im.int8_matmul_plain
    try:
        yield
    finally:
        im.int8_quantize_rows, im.int8_matmul = saved


def write_bpe_dir(path: Path) -> str:
    """A byte-level BPE set: encoder.json over the 256 byte symbols, no
    merges, a 256-row dict.txt (the GPT-2 assets are not in the repo)."""
    path.mkdir(parents=True, exist_ok=True)
    symbols = bytes_to_unicode()
    (path / "encoder.json").write_text(json.dumps({symbols[b]: b for b in range(256)}))
    (path / "vocab.bpe").write_text("#version: 0.2\n")
    (path / "dict.txt").write_text("".join(f"{i} 1\n" for i in range(256)))
    return str(path)


def smooth_images(n: int, rng) -> list:
    """n PIL RGB images of low-frequency patterns, sizes around 256 px."""
    from PIL import Image

    out = []
    for i in range(n):
        h, w = 300 + 37 * i, 260 + 53 * i
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (17 + 5 * c + rng.rand() * 9) + yy / (23 + 3 * c)) for c in range(3)]
        out.append(Image.fromarray(((np.stack(chans, -1) * 0.45 + 0.5) * 255).astype(np.uint8)))
    return out


def serve_int8(card: str) -> dict:
    """Phase 9: int8 serving at full width through the hub.  Returns the
    int8 kernels' launch counts over the kernel-path forwards."""
    work = ROOT / "build" / "smoke_hub"
    work.mkdir(parents=True, exist_ok=True)
    bpe = write_bpe_dir(work / "bpe")
    cfg = ModelConfig(head_type="val")
    cfg.encoder.layers = 2
    t0 = time.time()
    sd = make_random_state_dict(cfg, seed=0)
    pt = work / "model.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    log(f"9: wrote a 2-layer full-width fairseq .pt ({pt.stat().st_size / 2**30:.2f} GiB) "
        f"in {time.time() - t0:.1f} s")
    del sd

    rng = np.random.RandomState(0)
    texts = ["a dog barking in the rain", "two cats", "an orchestra tuning up before the show",
             "waves"]
    images = smooth_images(4, rng)
    wavs = [rng.randn(16000 * AUDIO_SECONDS).astype(np.float32) * 0.1,
            rng.randn(16000 * 6).astype(np.float32) * 0.1]
    launched = {"gemm": 0, "quantize": 0}
    task = TaskConfig()
    bounds = {"float32": 1 - 1e-6, "bf16": 0.999}
    for dtype in ("float32", "bf16"):
        reference, inputs = None, None
        for quantize in ("none", "ffn", "ffn_attn"):
            t0 = time.time()
            hub = port_hub.from_pretrained(str(pt), dtype=dtype, bpe_dir=bpe, model_cfg=cfg,
                                           task_cfg=task, quantize=quantize, device="cuda")
            log(f"9: from_pretrained {dtype} quantize={quantize}: {time.time() - t0:.1f} s")
            if inputs is None:
                inputs = {"text": {"src_tokens": hub.process_text(texts)},
                          "image": {"src_images": hub.process_image(images)},
                          "audio": dict(zip(("src_audios", "audio_padding_masks"),
                                            hub.process_audio(wavs)))}
                check_on_device_images(hub, images)
            extract = {"text": hub.extract_text_features, "image": hub.extract_image_features,
                       "audio": hub.extract_audio_features}
            if quantize == "none":
                reference = {m: extract[m](**kw).float() for m, kw in inputs.items()}
                del hub
                continue
            want = (6, 4) if quantize == "ffn" else (14, 8)
            for modality, kwargs in inputs.items():
                im.launches = im.quantize_launches = 0
                got = extract[modality](**kwargs).float()
                torch.cuda.synchronize()
                counts = (im.launches, im.quantize_launches)
                launched["gemm"] += counts[0]
                launched["quantize"] += counts[1]
                with plain_int8():
                    im.launches = im.quantize_launches = 0
                    plain = extract[modality](**kwargs).float()
                    if (im.launches, im.quantize_launches) != (0, 0):
                        raise RuntimeError("9: the plain int8 path launched a kernel")
                b = next(iter(kwargs.values())).shape[0]
                if got.shape != (b, cfg.encoder.embed_dim) or not torch.isfinite(got).all():
                    raise RuntimeError(f"9: bad {modality} embeddings {tuple(got.shape)}")
                cos = min_cosine(got, plain)
                log(f"9: {dtype} {quantize} {modality} B={b}: min cosine kernel vs plain int8 "
                    f"{cos:.9f} (bound {bounds[dtype]}); vs unquantized {dtype} "
                    f"{min_cosine(got, reference[modality]):.6f}; launches per forward "
                    f"{counts[0]} GEMM, {counts[1]} quantize (expected {want[0]}, {want[1]})")
                if counts != want:
                    raise RuntimeError(f"9: {quantize} launched {counts}, expected {want}")
                if cos < bounds[dtype]:
                    raise RuntimeError(f"9: {dtype} {quantize} {modality}: kernel and plain "
                                       f"int8 paths disagree")
            del hub
            torch.cuda.empty_cache()
    time_int8_paths(card, bpe)
    return launched


def check_on_device_images(hub, images) -> None:
    """process_image(on_device=True) against the host PIL path (the JAX
    package documents ~1e-2 in normalised units between the two), and the
    card's resize against the same function on the CPU."""
    host = hub.process_image(images).float()
    dev = hub.process_image(images, on_device=True).float()
    vs_cpu = 0.0
    for img in images:
        a, b = (resize_normalize(torch.from_numpy(np.array(img)).to(where), 256,
                                 port_hub.CLIP_MEAN,
                                 port_hub.CLIP_STD).cpu() for where in ("cuda", "cpu"))
        vs_cpu = max(vs_cpu, (a - b).abs().max().item())
    vs_host = (dev - host).abs()
    log(f"9: process_image(on_device=True) {hub.dtype}: vs the host PIL path max |d| "
        f"{vs_host.max().item():.3e} mean {vs_host.mean().item():.3e}; fp32 resize on the "
        f"card vs on the CPU max |d| {vs_cpu:.3e}")
    if vs_host.mean().item() > 2e-2 or vs_cpu > 1e-4:
        raise RuntimeError("9: the on-device image path disagrees")


def time_int8_paths(card: str, bpe: str) -> None:
    """Phase 9 times: the depth-40 model in bf16 through the hub at
    bench.py's batches, bf16 / "ffn" / "ffn_attn" (the int8 models are
    quantized copies of the same bf16 weights)."""
    cfg = ModelConfig(head_type="val")
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    hubs = {"bf16": port_hub.OnePeaceHubInterface(cfg, TaskConfig(), model,
                                                  dtype=torch.bfloat16, bpe_dir=bpe)}
    for mode in ("ffn", "ffn_attn"):
        hubs[mode] = port_hub.OnePeaceHubInterface(
            cfg, TaskConfig(), quantize_ffn_(copy.deepcopy(model), include_attn=mode == "ffn_attn"),
            dtype=torch.bfloat16, bpe_dir=bpe)
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = make_inputs(cfg, gen, IMG_BATCH, AUD_BATCH, 1)
    inputs["audio"]["audio_padding_masks"].zero_()
    images = inputs["image"]["src_images"].bfloat16()
    audio = (inputs["audio"]["src_audios"].bfloat16(), inputs["audio"]["audio_padding_masks"])
    per_layer = {"ffn": (3, 2), "ffn_attn": (7, 4)}  # (GEMM, quantize) launches per layer
    for mode, (gemms, quantizes) in per_layer.items():
        im.launches = im.quantize_launches = 0
        hubs[mode].extract_image_features(images)
        counts = (im.launches, im.quantize_launches)
        want = (gemms * cfg.encoder.layers, quantizes * cfg.encoder.layers)
        log(f"9: depth 40 image B={IMG_BATCH} {mode}: {counts[0]} GEMM and {counts[1]} "
            f"quantize launches per forward (expected {want[0]} and {want[1]})")
        if counts != want:
            raise RuntimeError(f"9: depth-40 {mode} launched {counts}, expected {want}")
    for modality, b in (("image", IMG_BATCH), ("audio", AUD_BATCH)):
        for mode in ("bf16", "ffn", "ffn_attn", "ffn_attn", "ffn", "bf16"):
            hub = hubs[mode]
            fn = ((lambda: hub.extract_image_features(images)) if modality == "image"
                  else (lambda: hub.extract_audio_features(*audio)))
            ms = cuda_time_ms(fn, iters=2, warmup=1)
            log(f"9: depth 40 {modality} B={b} {mode}: {ms:.1f} ms per batch, "
                f"{b / ms * 1e3:.1f} {modality}s/s ({card})")
    del hubs, model, inputs
    torch.cuda.empty_cache()


def check_golden() -> dict:
    """Phase 10: the depth-40 golden through the port's .pt route, fp32,
    kernel path.  Returns the cosines."""
    cfg = ModelConfig(head_type="val")  # the defaults are the golden's 4B geometry
    enc = cfg.encoder
    if (enc.embed_dim, enc.ffn_embed_dim, enc.layers, enc.attention_heads) != (1536, 6144, 40, 24):
        raise RuntimeError("10: the port's ModelConfig defaults are not the 4B geometry")
    t0 = time.time()
    sd = make_random_state_dict(cfg, seed=golden.SD_SEED)
    t_gen = time.time() - t0
    t0 = time.time()
    state = convert_retrieval_model(sd, cfg)
    t_conv = time.time() - t0
    t0 = time.time()
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    del state
    t_load = time.time() - t0
    log(f"10: 4B state from the seed in {t_gen:.1f} s, converted by the port in {t_conv:.1f} s, "
        f"on the card in {t_load:.1f} s")
    imgs = torch.from_numpy(np.random.RandomState(golden.IMAGE_SEED).randn(
        *golden.IMAGE_SHAPE).astype(np.float32)).cuda()
    wav = torch.from_numpy(np.random.RandomState(golden.AUDIO_SEED).randn(
        1, golden.AUDIO_LEN).astype(np.float32)).cuda()
    frames = conv_output_length(golden.AUDIO_LEN, cfg.encoder.audio_adapter.feature_encoder_spec)
    apad = torch.zeros(1, frames + 1, dtype=torch.bool, device="cuda")
    apad[0, -7:] = True
    tokens = torch.from_numpy(golden.TOKENS).cuda()
    fa.launches = 0
    with torch.inference_mode():
        out = {"text": model(src_tokens=tokens, encoder_type="text"),
               "image": model(src_images=imgs, encoder_type="image"),
               "audio": model(src_audios=wav, audio_padding_masks=apad, encoder_type="audio")}
        text_f, image_f, _ = model.encoder_wrapper(src_tokens=tokens[:1], src_images=imgs,
                                                   encoder_type="vl")
        out["vl"] = torch.cat([text_f, image_f], dim=1)
    torch.cuda.synchronize()
    if fa.launches != 4 * cfg.encoder.layers:
        raise RuntimeError(f"10: {fa.launches} attention launches, expected "
                           f"{4 * cfg.encoder.layers}")
    ref = np.load(golden.GOLDEN)
    report = {}
    for key, value in out.items():
        a = value.double().cpu().flatten()
        b = torch.from_numpy(ref[f"emb_{key}"]).double().flatten()
        report[key] = (a @ b / (a.norm() * b.norm())).item()
    log(f"10: depth-40 golden, fp32 kernel path, cosine: "
        + ", ".join(f"{k} {v:.9f}" for k, v in report.items()) + " (bound 1-1e-3)")
    if min(report.values()) < 1 - 1e-3:
        raise RuntimeError(f"10: the port misses the depth-40 golden: {report}")
    del model, out
    torch.cuda.empty_cache()
    return report


DET_HEADS = 24
DET_CASES = [  # (B, hg, wg, toep, decomp): the global grid at 1024 px, its 16 x 16
    # windows (16 per image, B=2), the windows with each bias alone and none,
    # the ragged 50 x 50 global grid of an 800 px image, a one-row grid, an
    # 8 x 8 grid (a 64-token tile holds 8 grid rows) and a wide 80 x 80 grid
    # (the forward's plan stages the bias where wg is even and divides 64, and
    # gathers it per score on the 50 x 50 and 80 x 80 grids)
    (2, 64, 64, True, True), (32, 16, 16, True, True), (32, 16, 16, True, False),
    (32, 16, 16, False, True), (32, 16, 16, False, False), (2, 50, 50, True, True),
    (2, 1, 64, True, True), (2, 8, 8, True, True), (1, 80, 80, True, True)]
DET_FWD_MODES = {da.FWD_GATHER: "gather", da.FWD_SLAB: "slab, bw in registers"}


def det_operands(gen, b, hg, wg, dtype, toep_on=True, decomp_on=True):
    """q/k/v (B, L, 24*64) and fp32 biases of the trunk's magnitudes."""
    l = hg * wg
    q, k, v = (torch.randn(b, l, DET_HEADS * 64, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    toep = (0.5 * torch.randn(DET_HEADS, 2 * hg - 1, wg, wg, generator=gen, device="cuda")
            if toep_on else None)
    bh = bw = None
    if decomp_on:
        bh = 0.5 * torch.randn(b, DET_HEADS, hg, l, generator=gen, device="cuda")
        bw = 0.5 * torch.randn(b, DET_HEADS, l, wg, generator=gen, device="cuda")
    return q, k, v, toep, bh, bw


def check_det_kernel(gen) -> float:
    """Phase 11(a): the det attention kernel against det_attention_plain on
    the same inputs, bf16 and fp32, with and without the LSE, at the
    detection trunk's shapes; returns the largest max |diff| of the output.
    Bounds as phase 3's: bf16 2e-2 max and 2e-3 mean, fp32 1e-4; LSE 1e-4."""
    worst, modes = 0.0, set()
    for dtype in (torch.bfloat16, torch.float32):
        for b, hg, wg, toep_on, decomp_on in DET_CASES:
            ops = det_operands(gen, b, hg, wg, dtype, toep_on, decomp_on)
            plan = da.fwd_plan(hg, wg, toep_on, decomp_on)
            modes.add(plan.mode)
            for with_lse in (False, True):
                got = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=with_lse)
                torch.cuda.synchronize()
                want = da.det_attention_plain(*ops, (hg, wg), 0.125, DET_HEADS,
                                              with_lse=with_lse)
                lse_err = 0.0
                if with_lse:
                    (got, lse), (want, want_lse) = got, want
                    if not torch.isfinite(lse).all():
                        raise RuntimeError("11(a): det kernel LSE is not finite")
                    lse_err = (lse - want_lse).abs().max().item()
                if not torch.isfinite(got).all():
                    raise RuntimeError("11(a): det kernel output is not finite")
                err = (got.float() - want.float()).abs()
                mx, mean = err.max().item(), err.mean().item()
                worst = max(worst, mx)
                branch = (f"plan: {DET_FWD_MODES[plan.mode]}, {plan.smem_bytes} B shared"
                          if dtype == torch.bfloat16 else "fp32 kernel: gather")
                log(f"11(a) det kernel vs plain {str(dtype)[6:]} B={b} grid {hg}x{wg} "
                    f"toep={toep_on} decomp={decomp_on} lse={with_lse} ({branch}): max|d| "
                    f"{mx:.3e} mean|d| {mean:.3e}"
                    + (f", LSE max|d| {lse_err:.3e}" if with_lse else ""))
                bad = (mx > BF16_MAX_ERR or mean > BF16_MEAN_ERR if dtype == torch.bfloat16
                       else mx > FP32_MAX_ERR)
                if bad or lse_err > 1e-4:
                    raise RuntimeError(f"11(a): the det kernel disagrees with its plain version "
                                       f"({dtype}, B={b}, {hg}x{wg}, lse={with_lse})")
                del got, want
            del ops
    if modes != set(DET_FWD_MODES):
        raise RuntimeError(f"11(a): the cases took the plan's branches {modes} only")
    q = torch.randn(2, 16, 4, 32, device="cuda")
    try:
        da.det_flash_attention(q, q, q, None, None, None, (4, 4), 32 ** -0.5)
    except ValueError as e:
        log(f"11(a) head dim 32 on the card raises, no plain fallback: {e}")
    else:
        raise RuntimeError("11(a): the det kernel path took head dim 32")
    torch.cuda.empty_cache()
    return worst


def check_detector(gen, card: str) -> int:
    """Phase 11(b): OnePeaceDetector at full width and depth 40 (1.5B trunk,
    d 1536, 24 heads, window 16, a global layer every 4th), 1024 px, 80
    classes, the RPN proposer and the mask head, on random weights from a
    seeded generator.  The kernel path against the plain path on the same
    weights: the stride-16 map, each pyramid level, the cascade scores and
    boxes and the mask logits on fixed proposals, cosine per image >=
    1-1e-6 in fp32 and >= 0.999 in bf16, 40 kernel launches per trunk
    forward (30 over 16 x 16 windows, 10 over the 64 x 64 grid).  Then
    ``detect()`` in bf16 and its images/s on both paths.  Returns the
    kernel's launches over this phase's runs (the counter is set to 0 here)."""
    t0 = time.time()
    det = OnePeaceDetector(proposer="rpn", device="cuda", dtype=torch.float32)
    fill_random_(det, torch.Generator(device="cuda").manual_seed(0))
    det.eval()
    n_trunk = sum(p.numel() for p in det.backbone.parameters())
    log(f"11(b) detector: {n_trunk / 1e9:.3f}B trunk parameters, "
        f"{sum(p.numel() for p in det.parameters()) / 1e9:.3f}B in all "
        f"({time.time() - t0:.1f} s to build and fill)")
    n_img, n_box, n_mask = 2, 512, 100
    images = torch.randn(n_img, 3, 1024, 1024, generator=gen, device="cuda")
    rs = np.random.RandomState(0)
    corner = rs.uniform(0, 900, (n_img * n_box, 2))
    boxes = np.concatenate([corner, corner + rs.uniform(16, 400, (n_img * n_box, 2))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).cuda()
    bidx = torch.arange(n_img, device="cuda").repeat_interleave(n_box)
    mboxes = boxes.reshape(n_img, n_box, 4)[:, :n_mask].reshape(-1, 4)
    mbidx = torch.arange(n_img, device="cuda").repeat_interleave(n_mask)

    grids, kernel = [], da.det_attention_cuda

    def recording(q, k, v, toep, bh, bw, hw, *args, **kwargs):
        grids.append(tuple(hw))  # observes only: the wrapper itself counts the launch
        return kernel(q, k, v, toep, bh, bw, hw, *args, **kwargs)

    da.launches = 0
    da.det_attention_cuda = recording
    try:
        for dtype, bound in ((torch.float32, 1 - 1e-6), (torch.bfloat16, 0.999)):
            det.to(dtype)
            outs = {}
            for impl in ("pallas", "xla"):
                det.backbone.attn_impl = impl
                grids.clear()
                with torch.no_grad():
                    f16 = det.backbone(images)
                    torch.cuda.synchronize()
                    want = ([(16, 16)] * 3 + [(64, 64)]) * 10 if impl == "pallas" else []
                    if grids != want:
                        raise RuntimeError(f"11(b) {impl}: kernel launches over grids {grids}")
                    pyr = det.fpn(f16)
                    feats = tuple(pyr[k] for k in det.PYRAMID_KEYS)
                    scores, refined = det.box_head(feats, boxes, bidx)
                    masks = det.mask_head(feats, mboxes, mbidx)
                out = {"f16": f16, **pyr, "scores": scores, "boxes": refined, "masks": masks}
                if not all(torch.isfinite(x).all() for x in out.values()):
                    raise RuntimeError(f"11(b) {str(dtype)[6:]} {impl}: non-finite output")
                outs[impl] = out
            report = {key: min_cosine(outs["pallas"][key].reshape(n_img, -1),
                                      outs["xla"][key].reshape(n_img, -1))
                      for key in outs["pallas"]}
            log(f"11(b) {str(dtype)[6:]} 1024 px B={n_img}, kernel vs plain path, min cosine "
                f"per image: " + ", ".join(f"{k} {v:.9f}" for k, v in report.items())
                + f" (bound {bound}); 40 launches per trunk forward: 30 windowed, 10 global")
            if min(report.values()) < bound:
                raise RuntimeError(f"11(b) {str(dtype)[6:]}: kernel and plain paths disagree")
            del outs
            torch.cuda.empty_cache()

        det.backbone.attn_impl = "pallas"
        with torch.no_grad():
            results = det.detect(images.bfloat16(), score_thresh=0.0, max_proposals=64)
        for r in results:
            n = len(r["boxes"])
            if (n == 0 or r["masks"].shape != (n, 28, 28) or not np.isfinite(r["boxes"]).all()
                    or not np.isfinite(r["masks"]).all()):
                raise RuntimeError(f"11(b) detect(): bad result {[(k, v.shape) for k, v in r.items()]}")
        log(f"11(b) detect() bf16 kernel path, score_thresh 0, 64 proposals: "
            f"{[len(r['boxes']) for r in results]} detections with 28x28 masks, all finite")

        # two settings: the recipe's (score_thresh 0.05, 512 proposals; on random
        # weights no class scores above 0.05, so the mask head does not run) and
        # 11(b)'s (score_thresh 0, 64 proposals: 100 detections with masks per
        # image, so every head runs); the median and spread of 10 calls each
        x = images.bfloat16()
        settings = {"recipe": {}, "masks": {"score_thresh": 0.0, "max_proposals": 64}}
        wall = {}
        for label, kwargs in settings.items():
            times, counts = {"pallas": [], "xla": []}, {}
            for impl in ("pallas", "xla", "pallas", "xla"):
                det.backbone.attn_impl = impl
                det.detect(x, **kwargs)
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    results = det.detect(x, **kwargs)
                    torch.cuda.synchronize()
                    times[impl].append(1e3 * (time.time() - t0))
                counts[impl] = [len(r["boxes"]) for r in results]
                if label == "masks" and any(
                        not len(r["boxes"]) or r["masks"].shape != (len(r["boxes"]), 28, 28)
                        for r in results):
                    raise RuntimeError(f"11(c) detect() {impl}: detections or masks missing")
            for impl, ms in times.items():
                med = wall[label, impl] = float(np.median(ms))
                log(f"11(c) detect() 1024 px B={n_img} bf16 {impl}, {label} setting {kwargs}: "
                    f"{counts[impl]} detections; median {med:.1f} ms per batch over {len(ms)} "
                    f"calls (min {min(ms):.1f}, max {max(ms):.1f}), "
                    f"{n_img / med * 1e3:.2f} images/s ({card})")
        det.backbone.attn_impl = "pallas"
        profile_call(lambda: det.detect(x, **settings["masks"]), wall["masks", "pallas"],
                     "11(c)", "detect_profile.txt")
    finally:
        da.det_attention_cuda = kernel
        det.backbone.attn_impl = "pallas"
    launched = da.launches
    del det
    torch.cuda.empty_cache()
    return launched


def time_det_attention(gen, card: str) -> dict:
    """Phase 11(c): ms per global and per windowed layer, bf16, for the
    kernel, its plain version, and SDPA with the bias materialised (as bf16)
    outside the timed region, kernel and SDPA in turns (kernel, SDPA, kernel,
    SDPA; the mean of the two); the kernel's ratio to SDPA; the bound from
    this run's operands.  Beside it the kernel on the same q/k/v with no bias,
    which shows what the bias costs."""
    times = {}
    for name, (b, hg, wg) in (("global", (2, 64, 64)), ("windowed", (32, 16, 16))):
        ops = det_operands(gen, b, hg, wg, torch.bfloat16)
        q, k, v, toep, bh, bw = ops
        l = hg * wg
        bias = (bh.transpose(2, 3)[..., None] + bw[..., None, :]).reshape(b, DET_HEADS, l, l)
        bias += da.bias_from_toeplitz(toep, hg, wg)[None]
        mask = bias.to(torch.bfloat16)
        del bias
        q4, k4, v4 = (x.view(b, l, DET_HEADS, 64).transpose(1, 2) for x in (q, k, v))
        turns = {"kernel": [], "sdpa": []}
        for _ in range(2):
            turns["kernel"].append(cuda_time_ms(
                lambda: da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS), iters=10))
            turns["sdpa"].append(cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=0.125), iters=10))
        kernel_ms, library_ms = (float(np.mean(turns[key])) for key in ("kernel", "sdpa"))
        no_bias_ms = cuda_time_ms(lambda: da.det_attention_cuda(
            q, k, v, None, None, None, (hg, wg), 0.125, DET_HEADS), iters=10)
        plain_ms = cuda_time_ms(lambda: da.det_attention_plain(*ops, (hg, wg), 0.125, DET_HEADS),
                                iters=3, warmup=1)
        flops = 4 * b * DET_HEADS * l * l * 64
        n_bytes = 4 * q.numel() * 2 + 4 * (toep.numel() + bh.numel() + bw.numel())
        bound = bound_ms(n_bytes, flops, H100_BF16_PEAK_TFLOPS * 1e12)
        plan = da.fwd_plan(hg, wg)
        log(f"11(c) det attention per {name} layer B={b} grid {hg}x{wg} bf16: kernel "
            f"{kernel_ms:.3f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s; turns "
            f"{turns['kernel'][0]:.3f}, {turns['kernel'][1]:.3f}), {kernel_ms / library_ms:.2f}x "
            f"SDPA with the materialised bias {library_ms:.3f} ms (turns {turns['sdpa'][0]:.3f}, "
            f"{turns['sdpa'][1]:.3f}); plain {plain_ms:.3f} ms; bound {bound[0]:.3f} ms by "
            f"{bound[1]}; plan: {DET_FWD_MODES[plan.mode]} ({card})")
        log(f"11(c) det attention per {name} layer, what the bias costs: the kernel with toep, "
            f"bh and bw {kernel_ms:.3f} ms, with no bias {no_bias_ms:.3f} ms: the bias takes "
            f"{kernel_ms - no_bias_ms:.3f} ms, {100 * (1 - no_bias_ms / kernel_ms):.0f}% ({card})")
        times[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound[0], "bound_by": bound[1], "no_bias_ms": no_bias_ms}
        del ops, q, k, v, toep, bh, bw, mask, q4, k4, v4
        torch.cuda.empty_cache()
    return times


DET_BWD_CASES = [  # (B, hg, wg, toep, decomp): the 1024 px global grid with each bias
    # alone, both and none; its 16 x 16 windows (16 per image, B=2) likewise; a
    # ragged 50 x 50 grid; a 32 x 32 grid (the dtoep pass's middle tile width); a
    # 1 x 64 grid (one displacement; toep only, since a one-row grid's dbh, the sum
    # of ds over all keys, is 0 up to rounding); an 80 x 80 grid (slab tiles of 64)
    (2, 64, 64, True, True), (2, 64, 64, True, False), (2, 64, 64, False, True),
    (2, 64, 64, False, False), (32, 16, 16, True, True), (32, 16, 16, True, False),
    (32, 16, 16, False, True), (32, 16, 16, False, False), (2, 50, 50, True, True),
    (2, 32, 32, True, True), (2, 1, 64, True, False), (1, 80, 80, True, True)]
DET_BWD_NAMES = ("dq", "dk", "dv", "dtoep", "dbh", "dbw")
DET_BWD_MODES = {da.BWD_GATHER: "gather", da.BWD_SLAB: "staged, bias sums in registers"}


def check_det_bwd_kernel(gen) -> dict:
    """Phase 12(a): the det attention backward kernels (pass 1 with the
    dtoep pass, #5; pass 2, #6) against det_attention_bwd_plain on the same
    inputs (the forward kernel's output and LSE), bf16 and fp32; the same
    call twice must be bit-equal.  Returns the largest max |diff| of #5's
    outputs (dq, dtoep, dbh, dbw) and of #6's (dk, dv).  Bounds relative to
    max |plain|, as phase 6's: fp32 1e-4, bf16 2e-2 max and 5e-3 mean.
    Each bf16 case logs the branch of ``det_attention.bwd_plan`` it took;
    the phase fails unless both ran."""
    worst = {"dq": 0.0, "dkv": 0.0}
    modes = set()
    for dtype in (torch.bfloat16, torch.float32):
        for b, hg, wg, toep_on, decomp_on in DET_BWD_CASES:
            plan = da.bwd_plan(hg, wg, toep_on, decomp_on)
            if dtype == torch.bfloat16:
                modes.add(plan.mode)
            ops = det_operands(gen, b, hg, wg, dtype, toep_on, decomp_on)
            out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
            got = da.det_attention_bwd_cuda(*args)
            again = da.det_attention_bwd_cuda(*args)
            torch.cuda.synchronize()
            want = da.det_attention_bwd_plain(*args)
            parts = []
            for name, x, y, z in zip(DET_BWD_NAMES, got, want, again):
                if (x is None) != (y is None):
                    raise RuntimeError(f"12(a): {name} is None on one side only")
                if x is None:
                    continue
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"12(a): det backward {name} is not finite")
                if not torch.equal(x, z):
                    raise RuntimeError(f"12(a): det backward {name} differs between two calls")
                err = (x.float() - y.float()).abs()
                scale = y.float().abs()
                rel_max = err.max().item() / max(scale.max().item(), 1e-30)
                rel_mean = err.mean().item() / max(scale.mean().item(), 1e-30)
                group = "dkv" if name in ("dk", "dv") else "dq"
                worst[group] = max(worst[group], err.max().item())
                parts.append(f"{name} {rel_max:.2e}/{rel_mean:.2e}")
                bad = (rel_max > 1e-4 if dtype == torch.float32
                       else rel_max > 2e-2 or rel_mean > 5e-3)
                if bad:
                    raise RuntimeError(f"12(a): det backward {name} disagrees with the plain "
                                       f"version: {str(dtype)[6:]} B={b} {hg}x{wg} "
                                       f"toep={toep_on} decomp={decomp_on}: max {rel_max:.3e} "
                                       f"mean {rel_mean:.3e}")
            branch = (f"plan: {DET_BWD_MODES[plan.mode]}, shared {plan.dq_smem}/"
                      f"{plan.dkv_smem}/{plan.dtoep_smem} B" if dtype == torch.bfloat16
                      else "fp32 kernels: gather")
            log(f"12(a) det bwd kernel vs plain {str(dtype)[6:]} B={b} grid {hg}x{wg} "
                f"toep={toep_on} decomp={decomp_on} ({branch}): max/mean |d| relative "
                f"{', '.join(parts)}; bit-equal over two calls")
            del ops, out, lse, dout, got, again, want
            torch.cuda.empty_cache()
    if modes != set(DET_BWD_MODES):
        raise RuntimeError(f"12(a): the cases took the plan's branches {modes} only")
    return worst


DET_RECIPE = ROOT / "recipes" / "detection" / "cascade_mask_rcnn_1024.yaml"


def det_config(overrides=()):
    """The detection recipe through the port's load_config, with
    ``overrides``; the criterion is the task's."""
    cfg = load_config(str(DET_RECIPE), list(overrides))
    cfg.criterion._name = cfg.criterion._name or CocoDetectionTask.criterion_name
    return cfg


def det_trainer(cfg, seed: int = 0) -> Trainer:
    model = CocoDetectionTask.build_model(cfg, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def det_batch(cfg, gen, b: int) -> dict:
    """b synthetic 1024 px images with cfg.task.max_boxes GT slots (the last
    quarter padded), 80 classes, and box-shaped instance masks at the
    recipe's stride 4 (uint8), as vision_collate gives them."""
    t = cfg.task
    size, m, stride = t.image_size, t.max_boxes, t.mask_stride
    rs = np.random.RandomState(int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda")))
    x0 = rs.uniform(0, size * 0.75, (b, m))
    y0 = rs.uniform(0, size * 0.75, (b, m))
    w = np.exp(rs.uniform(np.log(16), np.log(size / 2), (b, m)))
    h = w * np.exp(rs.uniform(-0.7, 0.7, (b, m)))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, size - 1), np.minimum(y0 + h, size - 1)], -1)
    valid = np.ones((b, m), bool)
    valid[:, 3 * m // 4:] = False
    boxes[~valid] = 0.0
    masks = np.zeros((b, m, size // stride, size // stride), np.uint8)
    for i in range(b):
        for j in range(m):
            if valid[i, j]:
                c0, r0, c1, r1 = (boxes[i, j] / stride).astype(int)
                masks[i, j, r0:r1 + 1, c0:c1 + 1] = 1
    return {"src_images": torch.randn(b, 3, size, size, generator=gen, device="cuda"),
            "gt_boxes": torch.from_numpy(boxes.astype(np.float32)).cuda(),
            "gt_labels": torch.from_numpy(rs.randint(0, t.num_classes, (b, m))).cuda(),
            "gt_valid": torch.from_numpy(valid).cuda(), "gt_masks": torch.from_numpy(masks).cuda()}


def check_det_train_paths(gen) -> None:
    """Phase 12(b): the detection fine-tuning objective at full width with 4
    trunk layers (3 windowed, 1 global), pyramid, RPN, cascade and masks, at
    1024 px and B=2, drop path 0.6 and remat as the recipe: the kernel path
    against the plain path on the same weights, batch and generator seed
    (the same drop-path masks, RPN sample and jitter).  fp32: losses within
    1e-5, the gradient cosine over all parameters together >= 1-1e-6 and
    every parameter's >= 1-1e-4 (the heads' ReLU units whose input lies within
    the two paths' ~1e-7 difference of 0 flip, and move an FC weight's
    gradient cosine to ~1-1e-5); bf16 compute: the kernel path no further
    from the fp32 gradients than the plain path, over all parameters
    together to 1e-3 and per parameter to 0.02, losses within 2e-3.  (Phase
    7(a)'s 0.999 between the two bf16 paths does not carry over: here the
    plain path itself sits at cosine ~0.9965 from fp32 over all parameters,
    and a parameter's distance to fp32 moves by up to ~0.01 from one batch
    to the next on either path.)  Launches: 8 forward (4 layers and their
    recompute), 4 backward."""
    batch, ref32 = None, None
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        cfg = det_config(["model.encoder.layers=4", f"common.bf16={str(bf16).lower()}"])
        trainer = det_trainer(cfg)
        batch = batch or det_batch(cfg, gen, 2)
        runs = {}
        for impl in ("pallas", "xla"):
            trainer.model.backbone.attn_impl = impl
            da.launches = da.bwd_launches = 0
            metrics, grads = trainer.gradients(batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            launched = (da.launches, da.bwd_launches)
            want = (8, 4) if impl == "pallas" else (0, 0)
            if launched != want:
                raise RuntimeError(f"12(b) {name} {impl}: launches {launched}, expected {want}")
            if not all(torch.isfinite(g).all() for g in grads):
                raise RuntimeError(f"12(b) {name} {impl}: non-finite gradient")
            runs[impl] = (float(metrics["loss"]), grads)
        names = trainer._names
        del trainer
        (loss_k, grads_k), (loss_p, grads_p) = runs["pallas"], runs["xla"]
        cos = grad_cosines(grads_k, grads_p)
        worst = min(range(len(cos)), key=cos.__getitem__)
        total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                             [torch.cat([g.flatten() for g in grads_p])])[0]
        log(f"12(b) {name} 4-layer detector 1024 px B=2: loss kernel {loss_k:.7f} plain "
            f"{loss_p:.7f}; gradient cosine kernel vs plain over all parameters {total:.9f}, "
            f"per parameter min {cos[worst]:.9f} ({names[worst]}), median "
            f"{sorted(cos)[len(cos) // 2]:.9f}, {sum(c < 1 - 1e-6 for c in cos)} of {len(cos)} "
            f"parameters below 1-1e-6")
        if not bf16:
            ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and total >= 1 - 1e-6
                  and cos[worst] >= 1 - 1e-4)
            ref32 = grads_p
        else:
            cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
            gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
            flat32 = [torch.cat([g.flatten() for g in ref32])]
            total_k = grad_cosines([torch.cat([g.flatten() for g in grads_k])], flat32)[0]
            total_p = grad_cosines([torch.cat([g.flatten() for g in grads_p])], flat32)[0]
            log(f"12(b) bf16 vs the fp32 gradients, all parameters together: kernel path "
                f"{total_k:.6f}, plain path {total_p:.6f}; per parameter min kernel path "
                f"{min(cos_k):.6f}, plain path {min(cos_p):.6f}, largest shortfall of the kernel "
                f"path {cos_p[gap] - cos_k[gap]:.2e} ({names[gap]})")
            ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total_k >= total_p - 1e-3
                  and cos_p[gap] - cos_k[gap] <= 0.02)
        if not ok:
            raise RuntimeError(f"12(b) {name}: kernel and plain training paths disagree")
        del runs, grads_k, grads_p
        torch.cuda.empty_cache()


def train_det_full_depth(gen, card: str) -> dict:
    """Phase 12(c): the recipe at depth 40 (load_config on the recipe,
    CocoDetectionTask.build_model, DetectionCriterion, Trainer): 1024 px,
    B=2, bf16 compute over fp32 masters, AdamW with layer decay, remat, drop
    path 0.6; the warm-up is cut to 0 so a few steps move the weights.  Each
    path gets a fresh trainer (the same seeded weights) and every step the
    same batch and generator state, so the loss must fall.  Returns the
    kernel path's launches per step and the times."""
    cfg = det_config(["lr_scheduler.warmup_updates=0"])
    batch = det_batch(cfg, gen, 2)
    result = {}
    for impl, steps in (("pallas", 4), ("xla", 2)):
        t0 = time.time()
        trainer = det_trainer(cfg)
        torch.cuda.synchronize()
        trainer.model.backbone.attn_impl = impl
        if impl == "pallas":
            n = sum(p.numel() for p in trainer.model.parameters())
            n_trunk = sum(p.numel() for p in trainer.model.backbone.parameters())
            log(f"12(c) detector from the recipe: {n_trunk / 1e9:.3f}B trunk parameters, "
                f"{n / 1e9:.3f}B in all, fp32 masters + AdamW ({time.time() - t0:.1f} s to "
                f"build and fill)")
        rng_state = trainer.generator.get_state()
        first = trainer.train_step(batch)
        torch.cuda.synchronize()
        da.launches = da.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times = [first["loss"]], []
        for _ in range(steps):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(metrics["loss"])
        launched = (da.launches // steps, da.bwd_launches // steps)
        want = (80, 40) if impl == "pallas" else (0, 0)
        ms = 1e3 * sum(times) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"12(c) {impl} depth 40 B=2 bf16: {ms:.1f} ms per step (steps "
            f"{[round(1e3 * x, 1) for x in times]}), {2 / ms * 1e3:.2f} images/s, peak "
            f"{peak:.1f} GiB, losses {[round(x, 5) for x in losses]} (the first a warm-up "
            f"step), launches per step: det attention forward {launched[0]}, backward "
            f"{launched[1]} (expected {want[0]} and {want[1]}) ({card})")
        if launched != want or da.launches != want[0] * steps:
            raise RuntimeError(f"12(c) {impl}: launches {launched} per step, expected {want}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"12(c) {impl}: the loss on a repeated batch did not fall: "
                               f"{losses}")
        result[impl] = {"ms": ms, "peak_gib": peak, "losses": losses, "launches": launched,
                        "total": (da.launches, da.bwd_launches)}
        if impl == "pallas":
            trainer.generator.set_state(rng_state)
            profile_call(lambda: trainer.train_step(batch), ms, "12(c)", "det_train_profile.txt")
        del trainer
        torch.cuda.empty_cache()
    return result


def time_det_backward(gen, card: str) -> dict:
    """Phase 12(d): ms per global and windowed layer of the backward, bf16:
    pass 1 with the dtoep pass (#5), pass 2 (#6) and the whole backward
    (with delta); the plain backward; SDPA with the materialised bf16 bias
    requiring a gradient (its backward alone, the library call set beside
    the kernels, and forward + backward), and the whole backward's ratio to
    it.  Bounds from this run's operands: #5 computes s, dp and dq (6 B H L^2
    64 operations), #6 s, dp, dv and dk (8), the whole backward at least 10.
    Beside them each kernel on the same q/k/v with no bias, toep only, bh +
    bw only and both: what each bias costs each kernel."""
    times = {}
    for name, (b, hg, wg) in (("global", (2, 64, 64)), ("windowed", (32, 16, 16))):
        by_bias = []
        for toep_on, decomp_on in ((False, False), (True, False), (False, True), (True, True)):
            ops = det_operands(gen, b, hg, wg, torch.bfloat16, toep_on, decomp_on)
            out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
            args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
            ms = [cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=p), iters=10)
                  if p != 2 or toep_on else None for p in (1, 2, 4)]
            by_bias.append(f"{'toep' if toep_on else 'no toep'}, "
                           f"{'bh + bw' if decomp_on else 'no bh/bw'}: pass 1 {ms[0]:.3f}, dtoep "
                           + ("-" if ms[1] is None else f"{ms[1]:.3f}") + f", pass 2 {ms[2]:.3f}")
            del ops, out, lse, dout, args
        log(f"12(d) det attention backward per {name} layer B={b} grid {hg}x{wg} bf16, what "
            f"each bias costs each kernel (ms): {'; '.join(by_bias)}; plan: "
            f"{DET_BWD_MODES[da.bwd_plan(hg, wg).mode]} ({card})")
        ops = det_operands(gen, b, hg, wg, torch.bfloat16)
        q, k, v, toep, bh, bw = ops
        l = hg * wg
        out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
        dq_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=3), iters=10)
        pass1_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=1), iters=10)
        dkv_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=4), iters=10)
        total_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args), iters=10)
        plain_ms = cuda_time_ms(lambda: da.det_attention_bwd_plain(*args), iters=3, warmup=1)
        bias = (bh.transpose(2, 3)[..., None] + bw[..., None, :]).reshape(b, DET_HEADS, l, l)
        bias += da.bias_from_toeplitz(toep, hg, wg)[None]
        mask = bias.to(torch.bfloat16).requires_grad_()
        del bias
        leaves = [x.view(b, l, DET_HEADS, 64).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        g4 = dout.view(b, l, DET_HEADS, 64).transpose(1, 2)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            *leaves, attn_mask=mask, scale=0.125)
        res = sdpa()
        library_ms = cuda_time_ms(lambda: torch.autograd.grad(res, [*leaves, mask], g4,
                                                              retain_graph=True), iters=5)
        fwd_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa(), [*leaves, mask], g4),
                                  iters=5)
        del res
        unit = b * DET_HEADS * l * l * 64
        qkv = q.numel() * 2
        biases = 4 * (toep.numel() + bh.numel() + bw.numel())
        stats = 2 * 4 * lse.numel()
        bound_dq = bound_ms(5 * qkv + stats + 2 * biases, 6 * unit, H100_BF16_PEAK_TFLOPS * 1e12)
        bound_dkv = bound_ms(6 * qkv + stats + biases, 8 * unit, H100_BF16_PEAK_TFLOPS * 1e12)
        bound_all = bound_ms(8 * qkv + stats + 2 * biases, 10 * unit,
                             H100_BF16_PEAK_TFLOPS * 1e12)
        log(f"12(d) det attention backward per {name} layer B={b} grid {hg}x{wg} bf16: pass 1 + "
            f"dtoep (#5) {dq_ms:.3f} ms (pass 1 alone {pass1_ms:.3f}; bound {bound_dq[0]:.3f} "
            f"by {bound_dq[1]}), pass 2 "
            f"(#6) {dkv_ms:.3f} ms (bound {bound_dkv[0]:.3f} by {bound_dkv[1]}), whole backward "
            f"{total_ms:.3f} ms (bound {bound_all[0]:.3f} by {bound_all[1]}; "
            f"{total_ms / library_ms:.2f}x SDPA's backward); plain "
            f"{plain_ms:.3f} ms; SDPA with the materialised bf16 bias: backward {library_ms:.3f}"
            f" ms, forward + backward {fwd_bwd_ms:.3f} ms ({card})")
        times[name] = {
            "dq": {"ms": dq_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_dq[0], "bound_by": bound_dq[1]},
            "dkv": {"ms": dkv_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_dkv[0], "bound_by": bound_dkv[1]}}
        del ops, q, k, v, toep, bh, bw, out, lse, dout, args, mask, leaves, g4
        torch.cuda.empty_cache()
    return times


RETRIEVAL_DIR = ROOT / "build" / "smoke_retrieval"
RETRIEVAL_RECIPE = ROOT / "recipes" / "image_text_retrieval" / "base.yaml"
WORDS = ("a the red green blue small large dog cat bird boat car tree house river field "
         "sky cloud two three old young running sitting near under over beside water "
         "grass road city beach snow mountain").split()


def retrieval_images(n: int, rng) -> list:
    """n PIL RGB images like ``smooth_images``, sizes kept within 256-399 px."""
    from PIL import Image

    out = []
    for i in range(n):
        h, w = 256 + (37 * i) % 144, 256 + (53 * i) % 144
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (17 + 5 * c + rng.rand() * 9) + yy / (23 + 3 * c)) for c in range(3)]
        out.append(Image.fromarray(((np.stack(chans, -1) * 0.45 + 0.5) * 255).astype(np.uint8)))
    return out


def write_retrieval_corpus(root: Path, pairs: int = 160, valid: int = 64) -> dict:
    """Phase 13(a): ``pairs`` image-caption pairs as JPEG files, a train
    TSV over all of them, a 40-row train TSV (5 micro-batches of 8 an
    epoch), a valid TSV of the first ``valid`` and ``valid.json`` with 5
    captions per valid id, and the byte-level BPE set."""
    rng = np.random.RandomState(13)
    root.mkdir(parents=True, exist_ok=True)
    rows, captions = ["id\timage\tcaption"], {}
    for i, img in enumerate(retrieval_images(pairs, rng)):
        img.save(root / f"img{i}.jpg", quality=92)
        captions[i] = [" ".join(WORDS[j] for j in row)
                       for row in rng.randint(0, len(WORDS), (5, 4 + i % 9))]
        rows.append(f"{i}\timg{i}.jpg\t{captions[i][0]}")
    (root / "train.tsv").write_text("\n".join(rows) + "\n")
    (root / "train40.tsv").write_text("\n".join(rows[:41]) + "\n")
    (root / "valid.tsv").write_text("\n".join(rows[:valid + 1]) + "\n")
    (root / "valid.json").write_text(json.dumps({str(i): captions[i] for i in range(valid)}))
    return {"root": root, "bpe": write_bpe_dir(root / "bpe")}


def retrieval_argv(data: dict, save_dir: Path, layers: int, batch: int, extra=()) -> list:
    """``cli.train`` arguments: the image-text retrieval recipe with the
    fine-tuning base's optimizer (recipes/finetune_4b_base.yaml) at the 4B
    width (d 1536, FFN 6144, 24 heads), ``layers`` deep, bf16 over fp32
    masters, remat, drop path 0.5; then ``extra``."""
    root = data["root"]
    return ["--config", str(RETRIEVAL_RECIPE), "--device", "cuda",
            f"task.data={root}/train.tsv", f"task.valid_data={root}/valid.tsv",
            f"task.valid_file={root}/valid.json", f"task.bpe_dir={data['bpe']}",
            "task.selected_cols=id,image,caption",
            f"model.encoder.layers={layers}", "model.encoder.drop_path_rate=0.5",
            "model.encoder.checkpoint_activations=true",
            "common.bf16=true", "common.log_interval=1", "common.seed=3407",
            "optimizer.adam_betas=(0.9,0.999)", "optimizer.weight_decay=0.05",
            "lr_scheduler.warmup_ratio=0.1", "lr_scheduler.min_lr=1e-6", "optimization.lr=1e-4",
            "optimization.clip_norm=0.0", f"dataset.batch_size={batch}",
            "dataset.batch_size_valid=32", f"checkpoint.save_dir={save_dir}",
            "checkpoint.reset_optimizer=false", "checkpoint.keep_last_epochs=1",
            *extra]


@contextlib.contextmanager
def recorded_steps(ops=fa):
    """Record every ``Trainer.train_step`` of the runs inside: its metrics,
    its start and end on the host clock (the card synchronised at the end),
    and the launches within it of the attention kernels of ``ops`` (the
    retrieval attention, or ``da``, the det attention)."""
    real = Trainer.train_step
    steps = []

    def step(self, batch):
        f0, b0 = ops.launches, ops.bwd_launches
        t0 = time.time()
        metrics = real(self, batch)
        torch.cuda.synchronize()
        steps.append({"metrics": metrics, "t0": t0, "t1": time.time(),
                      "fwd": ops.launches - f0, "bwd": ops.bwd_launches - b0})
        return metrics

    Trainer.train_step = step
    try:
        yield steps
    finally:
        Trainer.train_step = real


def run_train_cli(argv: list) -> None:
    from one_peace_tpu_torch.cli import train as train_cli

    if train_cli.main(argv) != 0:
        raise RuntimeError(f"cli.train exited non-zero: {argv}")
    gc.collect()
    torch.cuda.empty_cache()


def update_losses(log_file: Path) -> list:
    return [json.loads(line)["loss"] for line in log_file.read_text().splitlines()
            if json.loads(line)["tag"] == "train_inner"]


def check_cli_resume(data: dict, layers: int = 4) -> dict:
    """Phase 13(b): the recipe at full width, depth ``layers``, B=8,
    update_freq=2, LayerScale 0.1, on the 40-row TSV (5 micro-batches an
    epoch), three times:
    straight to 4 updates; to the end of epoch 1, whose save at update 2
    holds a pending micro-gradient; and resumed from that save to 4 updates.
    The updates' losses must agree to 1e-6 relative and the final masters to
    cosine 1-1e-6.  Then ``cli.evaluate`` reads the straight run's
    ``checkpoint_best.npz``: 64 images, 320 texts."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt

    root = data["root"]
    runs = {"straight": root / "straight", "resumed": root / "resumed"}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)
    # LayerScale at 0.1, not the recipe's 1e-6: at 1e-6 every embedding is
    # nearly the CLS token's own, each loss is ln(B) and a faulty resume would
    # agree with the straight run all the same
    common = [f"task.data={root}/train40.tsv", "optimization.update_freq=2",
              "optimization.max_update=4", "checkpoint.best_checkpoint_metric=txt_r1",
              "model.encoder.layer_scale_init_value=0.1"]

    def argv(name, log, *extra):
        return retrieval_argv(data, runs[name], layers, 8,
                              [*common, f"common.log_file={runs[name]}/{log}.jsonl", *extra])

    t0 = time.time()
    run_train_cli(argv("straight", "log"))
    run_train_cli(argv("resumed", "part1", "optimization.max_epoch=1"))
    mid = ckpt.restore_train_state(str(runs["resumed"] / "step_2"))["trainer"]
    if (mid["step"], mid["mini"]) != (2, 1):
        raise RuntimeError(f"13(b): the epoch-1 save is at step {mid['step']} with "
                           f"{mid['mini']} micro-gradients pending, not 2 and 1")
    del mid
    run_train_cli(argv("resumed", "part2"))
    straight = update_losses(runs["straight"] / "log.jsonl")
    resumed = (update_losses(runs["resumed"] / "part1.jsonl")
               + update_losses(runs["resumed"] / "part2.jsonl"))
    log(f"13(b) depth {layers}, B=8, update_freq=2: update losses straight {straight}, "
        f"stopped after update 2 (a micro-batch pending) and resumed {resumed} "
        f"({time.time() - t0:.1f} s for the three runs)")
    a = ckpt.restore_train_state(str(runs["straight"] / "step_4"))["trainer"]["params"]
    b = ckpt.restore_train_state(str(runs["resumed"] / "step_4"))["trainer"]["params"]
    dot = na = nb = 0.0
    diff, equal = 0.0, True
    for name in a:
        x, y = a[name].cuda().double(), b[name].cuda().double()
        dot, na, nb = dot + float(x.flatten() @ y.flatten()), na + float(x.norm() ** 2), \
            nb + float(y.norm() ** 2)
        diff = max(diff, float((x - y).abs().max()))
        equal = equal and torch.equal(a[name], b[name])
    cosine = dot / math.sqrt(na * nb)
    log(f"13(b) final masters, straight vs resumed: max |diff| {diff:.3e}, cosine "
        f"{cosine:.12f}, bit-equal {equal}")
    ok = (len(straight) == len(resumed) == 4 and all(map(math.isfinite, straight))
          and all(abs(x - y) <= 1e-6 * abs(x) for x, y in zip(straight, resumed))
          and cosine >= 1 - 1e-6)
    if not ok:
        raise RuntimeError("13(b): the resumed run does not end where the straight run does")
    del a, b
    out = runs["straight"] / "eval.json"
    evaluate_cli.main(["--config", str(RETRIEVAL_RECIPE), "--path",
                       str(runs["straight"] / "checkpoint_best.npz"), "--output", str(out),
                       *retrieval_argv(data, runs["straight"], layers, 8)[4:]])
    stats = json.loads(out.read_text())
    log(f"13(b) cli.evaluate on checkpoint_best.npz: {stats}")
    if (stats["img_count"], stats["txt_count"]) != (64, 320):
        raise RuntimeError(f"13(b): evaluation counted {stats['img_count']} images and "
                           f"{stats['txt_count']} texts, not 64 and 320")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": straight, "max_abs_diff": diff, "cosine": cosine, "bit_equal": equal}


@contextlib.contextmanager
def profiled_update(update: int):
    """Run update ``update`` of the runs inside under torch.profiler, from
    the end of the update before (so the batch's fetch and copy are inside).
    Yields a dict that gets the profiler ("p") and the update's wall ms
    ("wall")."""
    from torch.profiler import ProfilerActivity, profile

    prof = {}
    real_step = Trainer.train_step

    def profiled_step(self, batch):
        metrics = real_step(self, batch)
        if self.step == update - 1 and "p" not in prof:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.time()
        elif self.step == update and "t0" in prof and "wall" not in prof:
            torch.cuda.synchronize()
            prof["wall"] = 1e3 * (time.time() - prof["t0"])
            prof["p"].stop()
        return metrics

    Trainer.train_step = profiled_step
    try:
        yield prof
    finally:
        Trainer.train_step = real_step


def write_update_profile(prof: dict, ms: float, what: str, file_name: str, card: str) -> str:
    """The device's busy time and idle share of the profiled update, against
    the unprofiled steady ``ms`` and the profiled update's own wall time;
    the top ops go to ``chiprun_out/<file_name>``.  Returns the line."""
    table = prof["p"].key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    total = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    busy = (float(total.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[total.group(2)]
            if total else float("nan"))
    line = (f"{what}: device busy {busy:.1f} ms; idle {100 * (1 - busy / ms):.1f}% of the "
            f"unprofiled steady {ms:.1f} ms, {100 * (1 - busy / prof['wall']):.1f}% of this "
            f"profiled update's {prof['wall']:.1f} ms")
    (out / file_name).write_text(f"{card}\n{line}\n\n{table}")
    return line


def train_cli_full_depth(data: dict, card: str, ms_7b: float) -> dict:
    """Phase 13(c): the recipe at the 4B geometry (depth 40) through
    ``cli.train`` from no checkpoint (the config's init), B=32, 6 updates
    and one validation over the 64 valid rows; no step saves, no best
    export.  Update 4 runs under torch.profiler, from the end of update 3
    (so the batch's fetch and copy are inside)."""
    import one_peace_tpu_torch.cli.train as train_cli

    save_dir = data["root"] / "depth40"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = retrieval_argv(data, save_dir, 40, 32, [
        "optimization.max_update=6", "dataset.validate_interval=2",
        "checkpoint.save_interval=1000", "checkpoint.best_checkpoint_metric=",
        f"common.log_file={save_dir}/log.jsonl"])
    valid_launches = []
    real_validate = train_cli.validate

    def counted_validate(*args):
        f0, b0 = fa.launches, fa.bwd_launches
        stats = real_validate(*args)
        valid_launches.append((fa.launches - f0, fa.bwd_launches - b0, stats))
        return stats

    torch.cuda.reset_peak_memory_stats()
    train_cli.validate = counted_validate
    try:
        with profiled_update(4) as prof, recorded_steps() as steps:
            t0 = time.time()
            run_train_cli(argv)
            wall = time.time() - t0
    finally:
        train_cli.validate = real_validate
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    step_ms = [1e3 * (s["t1"] - s["t0"]) for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (4, 6)]  # not profiled or rolled over
    ms = sum(steady) / len(steady)
    log(f"13(c) cli.train at depth 40, B=32, 6 updates from the config's init in {wall:.1f} s "
        f"(model build, data and validation included) ({card})")
    log(f"13(c) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(x, 1) for x in step_ms]} (update 1 warms up)")
    log(f"13(c) updates 2-6 from data, each from the end of the last (the batch's fetch and "
        f"copy included; 4 profiled, 6 after the epoch's end): "
        f"{[round(x, 1) for x in update_ms]} ms, beside phase 7(b)'s {ms_7b:.1f} ms per step "
        f"on hand-built batches in this run; steady {ms:.1f} ms per update, "
        f"{32 / ms * 1e3:.1f} pairs/s, peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    log(f"13(c) launches per update (#1, #2): {per_update}; validation: "
        f"{[(f, b) for f, b, _ in valid_launches]} over 64 images and 320 texts; "
        f"its stats {[s for _, _, s in valid_launches]}")
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 4 of cli.train at depth 40, B=32, from "
                                    "the end of update 3", "train_cli_profile.txt", card)
        log(f"13(c) {line} (chiprun_out/train_cli_profile.txt)")
    if not all(map(math.isfinite, losses)) or len(losses) != 6:
        raise RuntimeError(f"13(c): losses {losses}")
    if min(s["fwd"] for s in steps) == 0 or min(s["bwd"] for s in steps) == 0:
        raise RuntimeError("13(c): an update launched no attention kernel")
    if len(valid_launches) != 1 or valid_launches[0][0] == 0 or valid_launches[0][1] != 0:
        raise RuntimeError(f"13(c): validation launches {valid_launches}")
    return {"ms": ms, "peak_gib": peak, "launches": per_update,
            "valid_launches": valid_launches[0][:2], "losses": losses}


COCO_DIR = ROOT / "build" / "smoke_coco"
# COCO's 80 category ids: 1..90 with gaps (instances_*.json "categories")
COCO_CATEGORY_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28]
                     + list(range(31, 45)) + list(range(46, 66)) + [67, 70]
                     + list(range(72, 83)) + list(range(84, 91)))
COCO_SIZES = ((640, 480), (480, 640), (1024, 768), (333, 500))  # (width, height)


def rle_encode(mask: np.ndarray, compressed: bool) -> dict:
    """A (h, w) 0/1 mask as COCO RLE: column-major runs starting with 0s,
    as a list, or in pycocotools' compressed string (each run less the one
    two back from the third on, 5 bits a character, offset 48)."""
    flat = mask.T.ravel().astype(np.int8)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    counts = np.diff(np.concatenate([[0], change])).tolist()
    if not compressed:
        return {"counts": counts, "size": list(mask.shape)}
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"counts": "".join(out), "size": list(mask.shape)}


def write_coco_corpus(root: Path, n_train: int, n_valid: int, sizes=COCO_SIZES,
                      category_ids=COCO_CATEGORY_IDS, ext: str = "jpg", seed: int = 14) -> dict:
    """Phase 14(a): a synthetic COCO tree under ``root``: ``train/`` and
    ``valid/`` images at ``sizes`` in turn, and ``instances_{train,valid}.json``
    with ``category_ids`` (COCO's non-contiguous 80 by default).  Each image
    holds 2-5 objects painted in a colour of their class, whose masks are in
    turn a polygon, compressed RLE and uncompressed RLE; one crowd region
    (uncompressed RLE, as COCO stores crowds); and a box 0.2 px wide, which
    every resize up to 5x drops.  Returns the paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    palette = rng.randint(40, 255, (len(category_ids), 3))
    paths = {}
    for split, n in (("train", n_train), ("valid", n_valid)):
        (root / split).mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            w, h = sizes[i % len(sizes)]
            img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            objects = []
            for j in range(rng.randint(2, 6)):
                bw, bh = rng.uniform(0.15, 0.5) * w, rng.uniform(0.15, 0.5) * h
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                cat = int(rng.randint(len(category_ids)))
                inside = (((xx + 0.5 - x0 - bw / 2) / (bw / 2)) ** 2
                          + ((yy + 0.5 - y0 - bh / 2) / (bh / 2)) ** 2) <= 1
                img[inside] = palette[cat]
                kind = j % 3
                if kind == 0:  # a diamond polygon
                    cx, cy = x0 + bw / 2, y0 + bh / 2
                    seg = [[cx, y0, x0 + bw, cy, cx, y0 + bh, x0, cy]]
                    area = bw * bh / 2
                else:
                    seg = rle_encode(inside.astype(np.uint8), compressed=kind == 1)
                    area = float(inside.sum())
                objects.append((cat, [x0, y0, bw, bh], seg, area, 0))
            cw, ch = 0.3 * w, 0.3 * h  # a crowd region in a corner
            crowd = (xx < cw) & (yy >= h - ch)
            objects.append((int(rng.randint(len(category_ids))), [0.0, h - ch, cw, ch],
                            rle_encode(crowd.astype(np.uint8), compressed=False),
                            float(crowd.sum()), 1))
            objects.append((0, [w / 2, h / 2, 0.2, 0.3 * h],
                            [[w / 2, h / 2, w / 2 + 0.2, h / 2, w / 2 + 0.2, h * 0.8]], 0.1, 0))
            name = f"{split}{i}.{ext}"
            Image.fromarray(img).save(root / split / name)
            image_id = 1000 * (split == "valid") + 7 * i + 3
            images.append({"id": image_id, "file_name": name, "width": w, "height": h})
            for cat, bbox, seg, area, iscrowd in objects:
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": category_ids[cat], "bbox": [float(v) for v in bbox],
                             "area": float(area), "iscrowd": iscrowd, "segmentation": seg})
        ann = root / f"instances_{split}.json"
        ann.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"class{c}"} for c in category_ids]}))
        paths[split] = {"ann": str(ann), "images": str(root / split)}
    return paths


def det_cli_argv(paths: dict, save_dir: Path, layers: int, extra=()) -> list:
    """``cli.train`` / ``cli.evaluate`` arguments: the detection recipe (1024
    px, RPN, cascade and masks, 80 classes; d 1536, FFN 6144, 24 heads; bf16
    over fp32 masters, remat, drop path 0.6, AdamW with layer decay) on the
    synthetic COCO tree, ``layers`` deep, B=2, the recipe's valid batch of 8,
    the warm-up cut to 0 (as in 12(c)), no epoch saves; then ``extra``."""
    return ["--config", str(DET_RECIPE), "--device", "cuda",
            f"task.data={paths['train']['ann']}", f"task.image_dir={paths['train']['images']}",
            f"task.valid_data={paths['valid']['ann']}",
            f"task.valid_image_dir={paths['valid']['images']}",
            f"model.encoder.layers={layers}", "dataset.batch_size=2",
            "lr_scheduler.warmup_updates=0", "common.log_interval=1", "common.seed=3407",
            f"checkpoint.save_dir={save_dir}", "checkpoint.save_interval=1000",
            f"common.log_file={save_dir}/log.jsonl", *extra]


@contextlib.contextmanager
def recorded_validation(keep_masters: bool = False):
    """Record each validation of ``cli.train``: its stats, wall time and det
    attention launches, and inside it the time of ``detect()`` (the card
    synchronised), of the rest of ``valid_step`` (the host's mask paste and
    per-image AP records) and of ``merge_results`` (the AP sweep), and
    ``detect()``'s outputs; with ``keep_masters``, a host copy of the
    masters."""
    import one_peace_tpu_torch.cli.train as train_cli

    runs, cur = [], {}
    real = (train_cli.validate, CocoDetectionTask.detect, CocoDetectionTask.valid_step,
            CocoDetectionTask.merge_results)

    def timed(key, fn, sync=False):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            cur[key] = cur.get(key, 0.0) + 1e3 * (time.time() - t0)
            if key == "detect_ms":
                cur["dets"] = cur.get("dets", 0) + sum(len(r["boxes"]) for r in out)
                cur.setdefault("outputs", []).append(out)
            return out
        return run

    def validate(cfg, task, model, trainer, progress):
        cur.clear()
        if keep_masters:
            cur["masters"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        f0, b0 = da.launches, da.bwd_launches
        stats = timed("wall_ms", real[0], sync=True)(cfg, task, model, trainer, progress)
        runs.append({**cur, "stats": stats, "fwd": da.launches - f0, "bwd": da.bwd_launches - b0})
        return stats

    train_cli.validate = validate
    CocoDetectionTask.detect = timed("detect_ms", real[1], sync=True)
    CocoDetectionTask.valid_step = timed("valid_step_ms", real[2])
    CocoDetectionTask.merge_results = timed("merge_ms", real[3])
    try:
        yield runs
    finally:
        (train_cli.validate, CocoDetectionTask.detect, CocoDetectionTask.valid_step,
         CocoDetectionTask.merge_results) = real


def validation_line(run: dict) -> str:
    paste = run["valid_step_ms"] - run["detect_ms"]
    rest = run["wall_ms"] - run["valid_step_ms"] - run["merge_ms"]
    return (f"{run['wall_ms']:.1f} ms: detect() {run['detect_ms']:.1f} ms over "
            f"{len(run['outputs'])} calls, the host's mask paste and per-image records "
            f"{paste:.1f} ms, the AP sweep {run['merge_ms']:.1f} ms, data and the rest "
            f"{rest:.1f} ms; {run['dets']} detections")


def check_det_cli(paths: dict, card: str, layers: int = 4) -> dict:
    """Phase 14(b): the recipe at full width, depth ``layers``, through
    ``cli.train``: 4 updates at B=2 from the config's init, one validation
    over the 8 valid images and ``checkpoint_best.npz``.  The export, read
    back through ``params_from_jax``, must equal the masters at the
    validation bit for bit; ``cli.evaluate`` on the export (bf16, as the
    recipe) must detect what the validation detected, bit for bit, and print
    its AP dict to 1e-6."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils.checkpoint import params_from_jax
    from one_peace_tpu_torch.utils.native_checkpoint import load_params

    save_dir = COCO_DIR / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = det_cli_argv(paths, save_dir, layers, ["optimization.max_update=4",
                                                  "dataset.validate_interval_updates=4"])
    t0 = time.time()
    with recorded_validation(keep_masters=True) as runs, recorded_steps(da) as steps:
        run_train_cli(argv)
    losses = update_losses(save_dir / "log.jsonl")
    log(f"14(b) cli.train, depth {layers}, B=2: update losses {losses}, launches per update "
        f"(#4, #5/#6) {sorted({(s['fwd'], s['bwd']) for s in steps})} "
        f"({time.time() - t0:.1f} s with the model's build)")
    if len(runs) != 1 or len(losses) != 4 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"14(b): {len(runs)} validations, losses {losses}")
    run = runs[0]
    log(f"14(b) validation: {validation_line(run)}; stats {run['stats']}")
    best = save_dir / "checkpoint_best.npz"
    export = params_from_jax(load_params(str(best)))
    masters = run["masters"]
    equal = export.keys() == masters.keys() and all(
        export[k].dtype == masters[k].dtype and torch.equal(export[k], masters[k]) for k in masters)
    log(f"14(b) checkpoint_best.npz through params_from_jax: {len(export)} tensors, bit-equal "
        f"to the masters at the validation: {equal}")
    if not equal:
        raise RuntimeError("14(b): the best export does not read back as the run's masters")
    out, outputs = save_dir / "eval.json", []
    real_detect = CocoDetectionTask.detect
    CocoDetectionTask.detect = lambda self, *args: outputs.append(real_detect(self, *args)) \
        or outputs[-1]
    try:
        evaluate_cli.main(["--path", str(best), "--output", str(out), *argv])
    finally:
        CocoDetectionTask.detect = real_detect
    stats = json.loads(out.read_text())
    keys = [k for k in stats if not k.startswith("eval_")]
    worst = max(abs(stats[k] - run["stats"][k]) for k in keys)
    same = len(outputs) == len(run["outputs"]) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for x, y in zip(outputs, run["outputs"]) for a, b in zip(x, y))
    log(f"14(b) cli.evaluate on checkpoint_best.npz: {stats}; largest difference from the "
        f"validation's {worst:.3e} over {len(keys)} numbers; its {run['dets']} detections "
        f"(boxes, scores, labels, masks) bit-equal to the validation's: {same}")
    if set(keys) - set(run["stats"]) or worst > 1e-6 or not same:
        raise RuntimeError("14(b): cli.evaluate disagrees with the run's validation")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ap": run["stats"], "eval_diff": worst}


def time_host_eval(paths: dict, card: str) -> str:
    """The host's share of validation at the most detections the recipe keeps
    (100 per image): ``valid_step`` on one valid batch of 8 with ``detect``
    replaced by 100 synthetic detections per image (random boxes, labels,
    scores and 28 x 28 mask probabilities), then ``merge_results``."""
    cfg = det_config([f"task.valid_data={paths['valid']['ann']}",
                      f"task.image_dir={paths['valid']['images']}"])
    task = CocoDetectionTask(cfg.task, cfg)
    task.load_dataset("valid")
    batch = next(iter(task.get_batch_iterator("valid", 8, ensure_equal_batch=False)
                      .next_epoch_itr()))
    rs = np.random.RandomState(14)
    size, n = cfg.task.image_size, 100
    dets = []
    for _ in range(len(batch["id"])):
        xy = rs.uniform(0, size * 0.8, (n, 2))
        wh = rs.uniform(16, size * 0.4, (n, 2))
        dets.append({"boxes": np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(np.float32),
                     "scores": rs.uniform(0.05, 1, n).astype(np.float32),
                     "labels": rs.randint(0, cfg.task.num_classes, n),
                     "masks": rs.uniform(0, 1, (n, 28, 28)).astype(np.float32)})
    task.detect = lambda model, params, images: dets
    task.begin_valid_epoch(None, None)
    t0 = time.time()
    task.valid_step(None, None, batch)
    t1 = time.time()
    task.merge_results()
    t2 = time.time()
    return (f"{1e3 * (t1 - t0):.1f} ms for the mask paste and per-image records of "
            f"{len(dets)} images at {n} detections each ({1e3 * (t1 - t0) / len(dets):.1f} ms an "
            f"image), {1e3 * (t2 - t1):.1f} ms for the AP sweep (host, beside {card})")


def train_det_cli_full_depth(paths: dict, card: str, ms_12c: float) -> dict:
    """Phase 14(c): the recipe at depth 40 through ``cli.train`` from the
    config's init (``init_detector_``), B=2, 6 updates and one validation
    over the 8 valid images; no saves, no best export.  Update 4 runs under
    torch.profiler from the end of update 3.  The det attention must launch
    80 forward (40 layers and their recompute) and 40 backward per update, as
    in 12(c), and 40 forward per ``detect()`` in validation (11(b)), no
    backward."""
    save_dir = COCO_DIR / "depth40"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = det_cli_argv(paths, save_dir, 40, ["optimization.max_update=6",
                                              "dataset.validate_interval_updates=6",
                                              "checkpoint.best_checkpoint_metric="])
    torch.cuda.reset_peak_memory_stats()
    with profiled_update(4) as prof, recorded_validation() as runs, \
            recorded_steps(da) as steps:
        t0 = time.time()
        run_train_cli(argv)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = [ms for i, ms in enumerate(update_ms, 2) if i != 4]  # 4 is profiled
    ms = sum(steady) / len(steady)
    log(f"14(c) cli.train at depth 40, B=2, 6 updates from the config's init in {wall:.1f} s "
        f"(model build, data and validation included) ({card})")
    log(f"14(c) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"14(c) updates 2-6 from data, each from the end of the last (the batch's fetch and "
        f"copy included; 4 profiled): {[round(x, 1) for x in update_ms]} ms, beside phase "
        f"12(c)'s {ms_12c:.1f} ms per step on a hand-built batch in this run; steady "
        f"{ms:.1f} ms per update, {2 / ms * 1e3:.2f} images/s, peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 4 of cli.train, detection recipe at "
                                    "depth 40, B=2, from the end of update 3",
                                    "det_cli_profile.txt", card)
        log(f"14(c) {line} (chiprun_out/det_cli_profile.txt)")
    calls = -(-8 // 8)  # detect() calls over 8 valid images at the recipe's valid batch
    log(f"14(c) launches per update (#4, #5/#6): {per_update} (expected [(80, 40)]); "
        f"validation: {[(r['fwd'], r['bwd']) for r in runs]} (expected {[(40 * calls, 0)]})")
    for r in runs:
        log(f"14(c) validation over 8 images: {validation_line(r)} ({card})")
        log(f"14(c) validation stats {r['stats']}")
    log(f"14(c) host evaluation at 100 detections per image: {time_host_eval(paths, card)}")
    if not all(map(math.isfinite, losses)) or len(losses) != 6:
        raise RuntimeError(f"14(c): losses {losses}")
    if per_update != [(80, 40)]:
        raise RuntimeError(f"14(c): det attention launches per update {per_update}, "
                           f"expected [(80, 40)]")
    if [(r["fwd"], r["bwd"]) for r in runs] != [(40 * calls, 0)]:
        raise RuntimeError("14(c): validation launches differ from 40 per detect() call")
    return {"ms": ms, "peak_gib": peak, "launches": per_update, "losses": losses,
            "valid": {k: v for k, v in runs[0].items() if k != "masters"}}


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: no card to run on")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build: one nvcc per kernel source, started together
    t0 = time.time()
    libs = build.build_libraries()
    log(f"built {', '.join(lib.name for lib in libs.values())} in {time.time() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "C75" in line:  # C7508, C7517
                log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernel(gen)

    # 4. the embedding slice at full width: fp32, then bf16
    cfg = ModelConfig(head_type="val")
    inputs = make_inputs(cfg, gen, 4, 2, 4)
    fa.launches = 0
    reference = check_slice(cfg, inputs, torch.float32, 1 - 1e-6)
    torch.cuda.empty_cache()
    check_slice(cfg, inputs, torch.bfloat16, 0.999, reference)
    embed_launches = fa.launches
    if embed_launches == 0:
        raise RuntimeError("the embedding path never launched the attention kernel")
    torch.cuda.empty_cache()

    # 5. times
    fwd_times = time_paths(cfg, card)

    # 6. the backward kernel vs plain
    bwd_worst = check_backward_kernel(gen)
    bwd_times = time_backward(gen, card)
    torch.cuda.empty_cache()

    # 7. the training slice
    check_train_paths(gen)
    train = train_full_depth(gen, card)
    fwd_train, bwd_train = train["pallas"]["launches"]
    if bwd_train == 0:
        raise RuntimeError("the training path never launched the backward kernel")
    torch.cuda.empty_cache()

    # 8. the int8 kernels vs plain, and their times
    int8_worst = check_int8_kernels(gen)
    int8_times = time_int8_kernels(gen, card)
    # 9. int8 serving through the hub (the counts are read over its kernel-path forwards)
    int8_launches = serve_int8(card)
    if min(int8_launches.values()) == 0:
        raise RuntimeError(f"the int8 serving path never launched a kernel: {int8_launches}")
    # 10. the depth-40 golden through the .pt route
    check_golden()

    # 11. detection serving: the det attention kernel vs plain, the 1024 px
    # detector at depth 40 through it (its launches counted from 0 here), and times
    det_worst = check_det_kernel(gen)
    det_launches = check_detector(gen, card)
    if det_launches == 0:
        raise RuntimeError("the detection path never launched the det attention kernel")
    det_times = time_det_attention(gen, card)

    # 12. detection fine-tuning: the backward kernels vs plain, the 4-layer
    # full-width objective on both paths, the depth-40 recipe through the
    # Trainer (its launches counted from 0 after a warm-up step), and times
    det_bwd_worst = check_det_bwd_kernel(gen)
    check_det_train_paths(gen)
    det_train = train_det_full_depth(gen, card)
    det_fwd_train, det_bwd_train = det_train["pallas"]["total"]
    det_bwd_times = time_det_backward(gen, card)

    # 13. retrieval fine-tuning from data: cli.train's resume at depth 4 and
    # cli.evaluate on its export, then the depth-40 recipe through cli.train
    # (the attention kernels' launches counted from 0 here)
    fa.launches = fa.bwd_launches = 0
    data = write_retrieval_corpus(RETRIEVAL_DIR)
    check_cli_resume(data)
    train_cli_full_depth(data, card, train["pallas"]["ms"])
    cli_fwd, cli_bwd = fa.launches, fa.bwd_launches
    log(f"13 launches over the phase: #1 {cli_fwd}, #2 {cli_bwd}")
    if cli_fwd == 0 or cli_bwd == 0:
        raise RuntimeError("the retrieval CLI path never launched an attention kernel")

    # 14. detection from data: the synthetic COCO tree, cli.train at depth 4
    # with its export read back and cli.evaluate, then the depth-40 recipe
    # (the det attention kernels' launches counted from 0 here)
    da.launches = da.bwd_launches = 0
    coco = write_coco_corpus(COCO_DIR, 16, 8)
    check_det_cli(coco, card)
    train_det_cli_full_depth(coco, card, det_train["pallas"]["ms"])
    coco_fwd, coco_bwd = da.launches, da.bwd_launches
    log(f"14 launches over the phase: #4 {coco_fwd}, #5/#6 {coco_bwd}")
    if coco_fwd == 0 or coco_bwd == 0:
        raise RuntimeError("the detection CLI path never launched a det attention kernel")

    imported = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "one_peace_tpu" or m.startswith("one_peace_tpu."))
    if imported:
        raise RuntimeError(f"the port imported jax or the JAX package: {imported[:5]}")

    def entry(name, replaces, launches, max_abs_err, times, source=None):
        return {"name": name, "route": "cuda",
                "source": f"one_peace_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                **{key: times[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "shapes") if key in times}}

    def with_shapes(rows: dict) -> dict:
        """The first shape's numbers, and every shape's under "shapes"."""
        return {**next(iter(rows.values())), "shapes": rows}

    gemm = with_shapes({f"(M, K, N) = {shape}": int8_times[shape] for shape in FFN_SHAPES})
    quantize = entry("int8_quantize_rows", "one_peace_tpu/ops/quant.py:46",
                     int8_launches["quantize"], int8_worst["quantize"],
                     with_shapes({f"(M, K) = {shape}": int8_times[shape]
                                  for shape in ((65792, 1536), (65792, 6144))}),
                     source="int8_matmul")
    log(json.dumps({"kernels": [
        entry("flash_attention_fwd", "one_peace_tpu/ops/flash_attention.py:239",
              embed_launches + fwd_train + cli_fwd, worst, fwd_times),
        entry("flash_attention_bwd", "one_peace_tpu/ops/flash_attention.py:409",
              bwd_train + cli_bwd, bwd_worst, bwd_times),
        entry("int8_matmul", "one_peace_tpu/ops/quant_pallas.py:75", int8_launches["gemm"],
              int8_worst["gemm"], gemm),
        quantize,
        entry("det_attention_fwd", "one_peace_tpu/ops/det_attention.py:277",
              det_launches + det_fwd_train + coco_fwd, det_worst, det_times["global"]),
        entry("det_attention_bwd_dq", "one_peace_tpu/ops/det_attention.py:618",
              det_bwd_train + coco_bwd, det_bwd_worst["dq"], det_bwd_times["global"]["dq"],
              source="det_attention_bwd"),
        entry("det_attention_bwd_dkv", "one_peace_tpu/ops/det_attention.py:642",
              det_bwd_train + coco_bwd, det_bwd_worst["dkv"], det_bwd_times["global"]["dkv"],
              source="det_attention_bwd")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
