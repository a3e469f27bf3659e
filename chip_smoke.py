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
   kernel path and plain path, at bench.py's batches in bf16.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from one_peace_tpu_torch.models.adapters.audio import conv_output_length
from one_peace_tpu_torch.models.one_peace import ModelConfig, OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import flash_attention as fa
from one_peace_tpu_torch.utils.random_weights import fill_random_

H100_BF16_PEAK_TFLOPS = 989.0  # dense, NVIDIA data sheet (SXM, 700 W)
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
    if frontend == "image":
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


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: no card to run on")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    lib = fa.build_library()
    log(f"built {lib.name} in {time.time() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernel(gen)

    # 4. the slice at full width: fp32, then bf16
    cfg = ModelConfig(head_type="val")
    inputs = make_inputs(cfg, gen, 4, 2, 4)
    fa.launches = 0
    reference = check_slice(cfg, inputs, torch.float32, 1 - 1e-6)
    torch.cuda.empty_cache()
    check_slice(cfg, inputs, torch.bfloat16, 0.999, reference)
    launches = fa.launches
    if launches == 0:
        raise RuntimeError("the main path never launched the attention kernel")
    torch.cuda.empty_cache()

    # 5. times
    kernel_ms, plain_ms = time_paths(cfg, card)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "one_peace_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "one_peace_tpu/ops/flash_attention.py:239",
        "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
