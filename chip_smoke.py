#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card, its name and power limit (nvidia-smi);
2. build: the attention kernel from ``one_peace_tpu_torch/csrc`` by nvcc;
3. the kernel against its plain PyTorch version on the card, bf16 and fp32,
   at the main path's shapes (L = 257 image, 500 audio, 850 VL concat);
4. the 4B retrieval model at full width (d 1536, FFN 6144, 24 heads, 40
   layers) on random weights from a seeded generator: text, image and audio
   embeddings through the kernel path (``attn_impl="pallas"``) against the
   plain path (``"xla"``), fp32 then bf16, and the kernel's launch count;
5. times (info lines): embeddings per second and attention ms per layer,
   kernel path and plain path, at bench.py's batches in bf16;
6. the backward kernel against its plain version on the card, bf16 and fp32,
   at the training path's shapes (B=32 L=257 image, B=32 L=70 text with
   pads) and at L=37 (batched bias), 500 and 850, and its time;
7. the image-text retrieval fine-tuning step at full width through
   ``Trainer``: (a) 4 layers, kernel path against plain path on the same
   weights and batch -- loss and per-parameter gradient cosines in fp32 and
   bf16 compute, then 3 optimizer steps on each; (b) the depth-40 vl model,
   bf16 compute, fp32 master AdamW, remat, B=32: steps on the kernel path
   and then the plain path, ms per step, pairs per second, MFU, peak memory,
   the kernels' launch counts per step and a falling loss; one step under
   ``torch.profiler`` (its top ops go to ``chiprun_out/train_profile.txt``).
8. the int8 kernels (row quantize and GEMM) against their plain versions on
   the card, bit for bit, at the serving path's shapes and ragged ones, and
   their times beside the plain versions' and bf16 ``torch.matmul``'s;
9. int8 serving at full width through the hub: ``from_pretrained`` on a
   2-layer full-width fairseq ``.pt`` written under ``build/``, quantize
   "ffn" and "ffn_attn", fp32 and bf16, text / image / audio embeddings on
   the kernel path against the plain int8 path, the launch counts per
   forward, ``process_image(on_device=True)``; then images/s and clips/s at
   depth 40 in bf16 for the bf16, "ffn" and "ffn_attn" paths;
10. the depth-40 golden (``tests/fixtures/full_geometry_golden.npz``): the
   seeded 4B fairseq state regenerated, converted by the port's ``.pt``
   route, and the fp32 model on the kernel path held to the golden
   embeddings at cosine >= 1-1e-3.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from one_peace_tpu.core.config import FrameworkConfig, TaskConfig
from one_peace_tpu.data.tokenizer import bytes_to_unicode
from one_peace_tpu_torch import hub as port_hub
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.models.adapters.audio import conv_output_length
from one_peace_tpu_torch.models.one_peace import ModelConfig, OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import build
from one_peace_tpu_torch.ops import flash_attention as fa
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops.attention import attention_plain
from one_peace_tpu_torch.ops.preprocess import resize_normalize
from one_peace_tpu_torch.ops.quant import quantize_ffn_
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint_convert import convert_retrieval_model
from one_peace_tpu_torch.utils.random_weights import fill_random_

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "examples")]
import full_geometry_parity as golden  # noqa: E402  (numpy constants; no JAX at import)
from torch_fixture import make_random_state_dict  # noqa: E402  (numpy)

H100_BF16_PEAK_TFLOPS = 989.0  # dense, NVIDIA data sheet (SXM, 700 W)
H100_INT8_PEAK_TOPS = 1979.0  # dense, the same sheet
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


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Smallest cosine between matching rows, in fp64."""
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


def check_kernel(gen) -> float:
    """Phase 3: kernel vs plain (fp32 on the same rounded inputs); returns
    the largest max |diff| seen."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, pad lengths per row or None)
        (2, 257, "shared", None), (2, 257, "shared", [0, 0]),
        (2, 500, "shared", [0, 137]), (2, 37, "batched", [5, 0]),
        (1, 128, "shared", None), (1, 850, "shared", None)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, l, form, pads in cases:
            q, k, v = (torch.randn(b, l, heads, 64, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=gen, device="cuda")
            mask = None
            if pads is not None:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads):
                    if n:
                        mask[row, l - n:] = True
            got = fa.flash_attention(q, k, v, bias, mask, 0.125).float()
            torch.cuda.synchronize()
            key_bias = None if mask is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            want = fa.flash_attention_plain(
                *(x.float().reshape(b, l, heads * 64) for x in (q, k, v)),
                bias, key_bias, 0.125, heads).reshape(b, l, heads, 64)
            torch.cuda.synchronize()
            err = (got - want).abs()
            mx, mean = err.max().item(), err.mean().item()
            worst = max(worst, mx)
            log(f"kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads={pads}: "
                f"max|d| {mx:.3e} mean|d| {mean:.3e}")
            if not torch.isfinite(got).all():
                raise RuntimeError("kernel output is not finite")
            if dtype == torch.bfloat16 and (mx > BF16_MAX_ERR or mean > BF16_MEAN_ERR):
                raise RuntimeError(f"bf16 kernel disagrees: max {mx} mean {mean}")
            if dtype == torch.float32 and mx > FP32_MAX_ERR:
                raise RuntimeError(f"fp32 kernel disagrees: max {mx}")
            if pads == [0, 0]:  # an all-False mask must equal no mask
                same = fa.flash_attention(q, k, v, bias, None, 0.125).float()
                if not torch.equal(same, got):
                    raise RuntimeError("all-False mask and no mask disagree")
    return worst


def text_pad_mask(b: int, l: int, device="cuda") -> torch.Tensor:
    """(b, l) True at pads: row i keeps CLS and 8 + 7i mod (l - 8) tokens."""
    mask = torch.zeros(b, l, dtype=torch.bool, device=device)
    for row in range(b):
        mask[row, 9 + (7 * row) % (l - 9):] = True
    return mask


def check_backward_kernel(gen) -> float:
    """Phase 6: the backward kernel against flash_attention_bwd_plain on the
    same inputs, bf16 and fp32; returns the largest max |diff| of dq, dk, dv
    and d(bias).

    Bounds, relative to max |plain| (and mean |diff| to mean |plain|):
    fp32 1e-4 max -- both sides sum in fp32, in other orders, over at most
    850 terms (and 32 batch rows for d(bias)), and the kernel's exp is
    __expf (2 ulp); bf16 2e-2 max, 5e-3 mean -- dq, dk, dv are rounded to
    bf16 (2^-8 relative), and where the kernel's fp32 p or ds*scaling lands
    on the other side of a bf16 rounding boundary than the plain version's,
    one product term moves by one bf16 ulp."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, key mask)
        (32, 257, "shared", None), (32, 70, "shared", "text"), (2, 37, "batched", [5, 0]),
        (4, 500, "shared", [0, 137, 0, 60]), (1, 850, "shared", None)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, l, form, pads in cases:
            q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=gen, device="cuda")
            if pads == "text":
                mask = text_pad_mask(b, l)
            else:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads or []):
                    if n:
                        mask[row, l - n:] = True
            key_bias = None if pads is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            got = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads)
            torch.cuda.synchronize()
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
            log(f"bwd kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads={pads}: "
                f"max/mean |d| relative {', '.join(parts)}")
    return worst


def time_backward(gen, card: str):
    """Phase 6 times: the backward kernel and its plain version at the image
    training shape (B=32, L=257, shared bias, bf16), and autograd through
    the plain attention as information."""
    b, l, heads = 32, 257, 24
    q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    bias = torch.randn(heads, l, l, generator=gen, device="cuda")
    kernel_ms = cuda_time_ms(
        lambda: fa.flash_attention_bwd_cuda(q, k, v, g, bias, None, 0.125, heads), iters=10)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, g, bias, None, 0.125, heads), iters=10)
    leaves = [x.reshape(b, l, heads, 64).detach().requires_grad_() for x in (q, k, v)]
    bias.requires_grad_()

    def autograd_plain():
        out = attention_plain(*leaves, bias, None, 0.125)
        torch.autograd.grad(out, [*leaves, bias], g.reshape(b, l, heads, 64))

    autograd_ms = cuda_time_ms(autograd_plain, iters=5)
    log(f"attention backward per layer B={b} L={l} bf16: kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, autograd through the plain attention (forward included) "
        f"{autograd_ms:.3f} ms ({card})")
    return kernel_ms, plain_ms


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
    profile_step(trainer, batch, result["pallas"]["ms"])
    return result


def profile_step(trainer, batch, step_ms: float) -> None:
    """One kernel-path step under torch.profiler: device time by op, and
    the device's busy time against the unprofiled step's ``step_ms`` (one
    stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "train_profile.txt").write_text(table)
    log("7(b) profiled kernel-path step, top ops by device self time:")
    for line in table.splitlines()[:16]:
        log(f"  {line}")
    total = re.search(r"Self CUDA time total: ([0-9.]+)(us|ms|s)", table)
    if total:
        busy = float(total.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[total.group(2)]
        log(f"7(b) device busy {busy:.1f} ms of the unprofiled {step_ms:.1f} ms step: "
            f"idle {100 * (1 - busy / step_ms):.0f}%")


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

    heads = cfg.encoder.attention_heads
    attn_ms = {}
    for b, l in ((IMG_BATCH, 257), (AUD_BATCH, frames)):
        q, k, v = (torch.randn(b, l, heads * 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        bias = torch.randn(heads, l, l, generator=gen, device="cuda")
        kernel_ms = cuda_time_ms(
            lambda: fa.flash_attention_cuda(q, k, v, bias, None, 0.125, heads), iters=20)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, bias, None, 0.125, heads), iters=20)
        attn_tflops = 4 * b * heads * l * l * 64 / kernel_ms / 1e9
        log(f"attention per layer B={b} L={l} bf16: kernel {kernel_ms:.3f} ms "
            f"({attn_tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms ({card})")
        attn_ms[l] = (kernel_ms, plain_ms)
    return attn_ms[257]


FFN_SHAPES = [(65792, 1536, 6144), (65792, 6144, 1536), (65792, 1536, 1536)]  # (M, K, N)
RAGGED_SHAPES = [(13, 100, 70), (260, 520, 515)]  # tests/test_quant.py:141's


def check_int8_kernels(gen, card: str) -> dict:
    """Phase 8: the row quantize and the GEMM against their plain versions,
    bit for bit, at the serving path's shapes (M = 65,792 image rows at
    B=256, 16,032 audio rows at B=32) and ragged ones; then their times and
    bf16 ``torch.matmul``'s on the same product (information)."""
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
    for m, k, n in FFN_SHAPES + RAGGED_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
        bias = torch.randn(n, generator=gen, device="cuda")
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
        log(f"int8 GEMM vs plain ({m}, {k}, {n}): bit-equal in fp32 and bf16, "
            f"with and without bias")
    torch.cuda.empty_cache()

    times = {"max_abs_err": worst}
    x = torch.randn(65792, 1536, generator=gen, device="cuda", dtype=torch.bfloat16)
    times["quantize"] = (cuda_time_ms(lambda: im.int8_quantize_rows_cuda(x), iters=20),
                         cuda_time_ms(lambda: im.int8_quantize_rows_plain(x), iters=5))
    log(f"int8 quantize (65792 x 1536) bf16: kernel {times['quantize'][0]:.3f} ms, plain "
        f"{times['quantize'][1]:.3f} ms ({card})")
    del x
    for m, k, n in FFN_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(m, device="cuda"), torch.rand(n, device="cuda")
        xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        kernel_ms = cuda_time_ms(lambda: im.int8_matmul_cuda(x_q, w_q, sx, sw, None,
                                                             torch.bfloat16), iters=10)
        plain_ms = cuda_time_ms(lambda: im.int8_matmul_plain(x_q, w_q, sx, sw, None,
                                                             torch.bfloat16), iters=3, warmup=1)
        bf16_ms = cuda_time_ms(lambda: xb @ wb.T, iters=10)
        tops = 2 * m * k * n / kernel_ms / 1e9
        log(f"int8 GEMM ({m}, {k}, {n}) -> bf16: kernel {kernel_ms:.3f} ms ({tops:.1f} TOPS = "
            f"{100 * tops / H100_INT8_PEAK_TOPS:.1f}% of {H100_INT8_PEAK_TOPS:.0f}), plain "
            f"{plain_ms:.3f} ms; bf16 torch.matmul {bf16_ms:.3f} ms "
            f"({2 * m * k * n / bf16_ms / 1e9:.1f} TFLOP/s) ({card})")
        times[(m, k, n)] = (kernel_ms, plain_ms, bf16_ms)
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
    cfg = golden.real_config()
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
            if "registers" in line or "spill" in line:
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
    kernel_ms, plain_ms = time_paths(cfg, card)

    # 6. the backward kernel vs plain
    bwd_worst = check_backward_kernel(gen)
    bwd_ms, bwd_plain_ms = time_backward(gen, card)
    torch.cuda.empty_cache()

    # 7. the training slice
    check_train_paths(gen)
    train = train_full_depth(gen, card)
    fwd_train, bwd_train = train["pallas"]["launches"]
    if bwd_train == 0:
        raise RuntimeError("the training path never launched the backward kernel")
    torch.cuda.empty_cache()

    # 8. the int8 kernels vs plain, and their times
    int8_times = check_int8_kernels(gen, card)
    # 9. int8 serving through the hub (the counts are read over its kernel-path forwards)
    int8_launches = serve_int8(card)
    if min(int8_launches.values()) == 0:
        raise RuntimeError(f"the int8 serving path never launched a kernel: {int8_launches}")
    # 10. the depth-40 golden through the .pt route
    check_golden()
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    gemm_ms, gemm_plain_ms, _ = int8_times[FFN_SHAPES[0]]
    log(json.dumps({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "one_peace_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "one_peace_tpu/ops/flash_attention.py:239",
         "launches": embed_launches + fwd_train, "max_abs_err": worst,
         "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "one_peace_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "one_peace_tpu/ops/flash_attention.py:409",
         "launches": bwd_train, "max_abs_err": bwd_worst,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
        {"name": "int8_matmul", "route": "cuda",
         "source": "one_peace_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "one_peace_tpu/ops/quant_pallas.py:75",
         "launches": int8_launches["gemm"], "max_abs_err": int8_times["max_abs_err"]["gemm"],
         "ms": gemm_ms, "plain_ms": gemm_plain_ms},
        {"name": "int8_quantize_rows", "route": "cuda",
         "source": "one_peace_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "one_peace_tpu/ops/quant.py:46",
         "launches": int8_launches["quantize"],
         "max_abs_err": int8_times["max_abs_err"]["quantize"],
         "ms": int8_times["quantize"][0], "plain_ms": int8_times["quantize"][1]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
