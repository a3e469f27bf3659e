"""int8 serving GEMM and its row quantize: hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

Counterpart of ``one_peace_tpu/ops/quant_pallas.py`` (the Pallas TPU kernel
``int8_matmul``) and of the XLA fusion that quantizes the activation rows in
front of it (``ops/quant.py:46-49``).  The kernel source is
``csrc/int8_matmul.cu``; its header says what bounds the kernels on an H100
and how the design answers that.

- ``int8_quantize_rows(x)``: x (M, K) bf16, fp16 or fp32 -> x_q (M, K) int8 and
  sx (M,) fp32, ``sx = max(absmax / 127, 1e-8)``,
  ``x_q = clamp(round_half_even(x / sx), -127, 127)``.
- ``int8_matmul(x_q, w_q, sx, sw, bias, out_dtype)``: x_q (M, K) int8 times
  w_q (N, K) int8 (K contiguous), ``(float(acc) * sx[m]) * sw[n] + b[n]`` in
  fp32, one rounding to ``out_dtype``.  The kernel's launch follows
  ``gemm_plan`` (tile, ring stages, shared memory, persistent grid, raster
  group); ``tile_coords`` is its walk over the output tiles.

Each dispatcher sends CUDA tensors to its kernel and CPU tensors to its
plain version; on the card there is no fallback, and an input the kernel
does not take raises.  The plain GEMM sums in fp64, which is exact here
(|sum| <= K * 127^2 < 2^53), so the kernel must match it bit for bit.  The
kernels are compiled with ``nvcc`` at their first launch by ``ops/build.py``
and loaded through ``ctypes``.  Serving only: nothing here takes a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import DTYPE_CODES, build_library

# Kernel launches since the caller last set them to 0.  Only the CUDA
# wrappers add to them, once per launch that the runtime accepted:
# ``launches`` for the GEMM, ``quantize_launches`` for the row quantize.
launches = 0
quantize_launches = 0

_K_ALIGN = 16  # the TMA row stride of x_q and w_q is a multiple of 16 bytes

# The GEMM kernel's shape (csrc/int8_matmul.cu): 128 x 256 output tiles, two
# consumer warpgroups of 64 x 256; 128-byte K slabs of x_q (128 rows) and
# w_q (256 rows) in a ring of GEMM_STAGES stages; each consumer stages its
# outputs in 16 KB; the 128-byte swizzle wants 1024-byte aligned stages.
GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 128, 256, 128
GEMM_STAGES = 4
GEMM_RASTER_GROUP = 8  # M-tiles per raster group
_OUT_BYTES = 16384
_SWIZZLE_ALIGN = 1024
SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory


class GemmPlan(NamedTuple):
    """One launch of the GEMM kernel: its tile, ring depth and shared memory
    (the C side refuses any other), the output tiles, the persistent grid
    and the raster group of its walk."""
    tile_m: int
    tile_n: int
    stages: int
    smem_bytes: int
    tiles_m: int
    tiles_n: int
    grid: int
    group: int


def gemm_smem_bytes(stages: int = GEMM_STAGES) -> int:
    """The ring, two consumers' output staging, a full and an empty
    mbarrier per stage, and the slack to align the ring to 1024 bytes."""
    ring = stages * (GEMM_TILE_M + GEMM_TILE_N) * GEMM_TILE_K
    return ring + 2 * _OUT_BYTES + 2 * stages * 8 + _SWIZZLE_ALIGN


def gemm_plan(m: int, n: int, k: int, num_sms: int) -> GemmPlan:
    """Plan the GEMM on an (M, K) x (N, K) product: one block per SM at most,
    each walking tiles ``blockIdx.x + i * grid``."""
    if min(m, n, k) < 1 or num_sms < 1:
        raise ValueError(f"int8 GEMM plan needs positive M, N, K and SMs, got "
                         f"{(m, n, k)} on {num_sms} SMs")
    tiles_m, tiles_n = -(-m // GEMM_TILE_M), -(-n // GEMM_TILE_N)
    tiles = tiles_m * tiles_n
    return GemmPlan(GEMM_TILE_M, GEMM_TILE_N, GEMM_STAGES, gemm_smem_bytes(), tiles_m,
                    tiles_n, min(tiles, num_sms), min(GEMM_RASTER_GROUP, tiles_m))


def tile_coords(plan: GemmPlan, t: int) -> Tuple[int, int]:
    """(M-tile, N-tile) of the walk's tile t (the kernel's ``tile_origin``):
    raster groups of ``plan.group`` M-tiles, the last one shorter, M fastest
    inside a group."""
    per_group = plan.group * plan.tiles_n
    first = t // per_group * plan.group
    rows = min(plan.group, plan.tiles_m - first)
    r = t % per_group
    return first + r % rows, r // rows


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def int8_quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the row quantize (``quantized_linear``'s first
    lines): fp32 absmax, IEEE division, round half to even.  127 is a tensor
    on x's device: PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal, which moves some scales by one ulp."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device),
                         1e-8)
    x_q = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int8)
    return x_q, sx


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                      sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the GEMM: the int sums exactly (in fp64), then the
    JAX package's fp32 epilogue, ``(acc * sx) * sw + b``, and one cast."""
    acc = (x_q.double() @ w_q.double().T).float()
    y = acc * sx.float()[:, None] * sw.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("int8_matmul")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.one_peace_int8_quantize_rows.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.one_peace_int8_quantize_rows.restype = i
    lib.one_peace_int8_matmul.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.one_peace_int8_matmul.restype = i
    lib.one_peace_int8_error_string.argtypes = [i]
    lib.one_peace_int8_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.one_peace_int8_error_string(err).decode()} ({err})")


def _check_cuda(tensors, what: str) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{what} kernel needs every input on one CUDA device; "
                             f"got {[str(t.device) for t in tensors]}")
        if not x.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous inputs")


def int8_quantize_rows_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row quantize on x (M, K), bf16, fp16 or fp32; returns new
    x_q (M, K) int8 and sx (M,) fp32."""
    global quantize_launches
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"int8 quantize kernel takes bf16, fp16 or fp32, not {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"int8 quantize kernel takes (M, K), got {tuple(x.shape)}")
    _check_cuda([x], "int8 quantize")
    m, k = x.shape
    x_q = torch.empty(m, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(m, dtype=torch.float32, device=x.device)
    if m == 0:
        return x_q, sx
    per_vec = 16 // x.element_size()
    vec = k % per_vec == 0 and x.data_ptr() % 16 == 0
    lib = _library()
    err = lib.one_peace_int8_quantize_rows(
        x.data_ptr(), x_q.data_ptr(), sx.data_ptr(), m, k, DTYPE_CODES[x.dtype],
        int(vec), x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "int8 quantize")
    quantize_launches += 1
    return x_q, sx


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the GEMM on ``gemm_plan`` over the card's SMs; arguments and
    result as ``int8_matmul_plain``.  A K that is not a multiple of 16 is
    zero-padded here (exact: zeros add nothing to an integer sum); the main
    path never pads."""
    global launches
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 GEMM takes int8 x_q and w_q, not {x_q.dtype}, {w_q.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"int8 GEMM writes bf16, fp16 or fp32, not {out_dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8 GEMM takes x_q (M, K) and w_q (N, K), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[0]
    if sx.dtype != torch.float32 or sx.shape != (m,) or sw.dtype != torch.float32 \
            or sw.shape != (n,):
        raise ValueError(f"int8 GEMM takes fp32 scales sx ({m},) and sw ({n},), got "
                         f"{sx.dtype} {tuple(sx.shape)} and {sw.dtype} {tuple(sw.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError(f"int8 GEMM takes an fp32 bias ({n},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"int8 GEMM takes M, N and K below 2^31, got {(m, k, n)}")
    tensors = [x for x in (x_q, w_q, sx, sw, bias) if x is not None]
    _check_cuda(tensors, "int8 GEMM")
    if k % _K_ALIGN or k == 0:
        pad = _K_ALIGN - k % _K_ALIGN
        x_q, w_q = F.pad(x_q, (0, pad)), F.pad(w_q, (0, pad))
        k += pad
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8 GEMM needs 16-byte aligned x_q and w_q")
    out = torch.empty(m, n, dtype=out_dtype, device=x_q.device)
    if m == 0 or n == 0:
        return out
    plan = gemm_plan(m, n, k, _num_sms(x_q.device.index))
    lib = _library()
    err = lib.one_peace_int8_matmul(
        x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        DTYPE_CODES[out_dtype], plan.tile_m, plan.tile_n, plan.stages,
        plan.smem_bytes, plan.grid, plan.group, x_q.device.index,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    _raise_on(lib, err, "int8 GEMM")
    launches += 1
    return out


def int8_quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row quantize: the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.device.type == "cpu":
        return int8_quantize_rows_plain(x)
    return int8_quantize_rows_cuda(x)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The GEMM: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, sx, sw, bias, out_dtype)
    return int8_matmul_cuda(x_q, w_q, sx, sw, bias, out_dtype)
