"""Fused bias-aware attention forward: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

Counterpart of ``one_peace_tpu/ops/flash_attention.py`` (the Pallas TPU
kernel ``_flash_fwd``).  The kernel source is ``csrc/flash_attention_fwd.cu``;
its header says what bounds it on an H100 and how the design answers that.

``flash_attention`` sends a CUDA tensor to the kernel and a CPU tensor to
the plain version.  On the card there is no fallback: an input the kernel
does not take (head dim other than 64, a dtype other than bf16 or fp32)
raises.  The kernel is compiled with ``nvcc`` at its first launch, into
``build/torch_kernels/`` beside the package, under a name keyed on a hash of
the source and the flags, and loaded through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30  # additive key bias at padded keys, as the TPU kernel's
HEAD_DIM = 64  # the only head dim the kernel takes (every shipped config)

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the caller last set it to 0.  Only the CUDA branch
# of flash_attention adds to it, once per launch that the runtime accepted.
launches = 0


def flash_attention_plain(q, k, v, rel_bias, key_bias, scaling: float, heads: int):
    """Plain version on the (B, L, H*Dh) layout (``_xla_reference``): fp32
    logits, ``* scaling``, + rel_bias (H, L, L) or (B, H, L, L), + key_bias
    (B, L), fp32 softmax, probabilities cast to q's dtype before p.v."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh = q.reshape(b, l, heads, dh).float()
    kh = k.reshape(b, l, heads, dh).float()
    vh = v.reshape(b, l, heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scaling
    if rel_bias is not None:
        logits = logits + (rel_bias if rel_bias.ndim == 4 else rel_bias[None])
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, l, hdim)


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the attention kernel cannot be built")


def build_library() -> Path:
    """Compile the kernel source into a shared library unless a library of
    the same source and flags is already built; return its path.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside it with a ``.log`` suffix."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"flash_attention_fwd-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.one_peace_flash_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = i
    lib.one_peace_cuda_error_string.argtypes = [i]
    lib.one_peace_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads: int) -> None:
    """Raise on anything the kernel does not take (it has no fallback)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16 or fp32, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, L, H*Dh) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, hdim = q.shape
    if hdim != heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIM} only; got "
                         f"{hdim} lanes over {heads} heads")
    if rel_bias is not None:
        if rel_bias.dtype != torch.float32 or rel_bias.shape not in (
                (heads, l, l), (b, heads, l, l)):
            raise ValueError(f"rel_bias must be fp32 (H, L, L) or (B, H, L, L), got "
                             f"{rel_bias.dtype} {tuple(rel_bias.shape)}")
    if key_bias is not None and (key_bias.dtype != torch.float32
                                 or key_bias.shape != (b, l)):
        raise ValueError(f"key_bias must be fp32 (B, L), got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)}")
    tensors = [x for x in (q, k, v, rel_bias, key_bias) if x is not None]
    for x in tensors:
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"attention kernel needs every input on one CUDA device; "
                             f"got {[str(t.device) for t in tensors]}")
        if not x.is_contiguous():
            raise ValueError("attention kernel needs contiguous inputs")
        if x.data_ptr() % 16:
            raise ValueError("attention kernel needs 16-byte aligned inputs")


def flash_attention_cuda(q, k, v, rel_bias, key_bias, scaling: float, heads: int):
    """Launch the kernel on the (B, L, H*64) layout; arguments as
    ``flash_attention_plain``.  Returns a new (B, L, H*64) tensor."""
    global launches
    _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads)
    lib = _library()
    b, l, _ = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.one_peace_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if rel_bias is None else rel_bias.data_ptr(),
        int(rel_bias is not None and rel_bias.ndim == 4),
        None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, l, heads, float(scaling),
        int(q.dtype == torch.bfloat16), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.one_peace_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    scaling: float,
) -> torch.Tensor:
    """Public entry; layouts match ``ops.attention.multihead_attention``:
    q/k/v (B, L, H, D), rel_bias (H, L, L)/(B, H, L, L)/None, mask (B, L)
    True at padding.  The (B, L, H, D) <-> (B, L, H*D) reshapes are views."""
    b, l, h, d = q.shape
    q3, k3, v3 = (x.reshape(b, l, h * d) for x in (q, k, v))
    key_bias = None
    if key_padding_mask is not None:
        key_bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                               device=key_padding_mask.device)
        key_bias.masked_fill_(key_padding_mask, NEG_INF)
    if rel_bias is not None:
        rel_bias = rel_bias.float().contiguous()
    if q.device.type == "cpu":
        out = flash_attention_plain(q3, k3, v3, rel_bias, key_bias, scaling, h)
    else:
        out = flash_attention_cuda(q3, k3, v3, rel_bias, key_bias, scaling, h)
    return out.reshape(b, l, h, d)
