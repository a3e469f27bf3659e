"""Shared building blocks (counterpart of ``one_peace_tpu/models/components.py``).

Numerics match the JAX package:

- ``layer_norm``: eps 1e-5, biased variance, statistics and the affine in
  fp32, result cast back to the input dtype.
- ``gelu``: exact (erf) GELU computed in fp32.
- ``conv2d``: NHWC, "VALID" or "SAME" (XLA's split: the smaller half of the
  padding before); a stride == kernel "VALID" conv runs as the exact
  patchify reshape plus one matmul, the patch flattened in (kh, kw, in)
  order.
- ``conv_transpose2d``: ``jax.lax.conv_transpose`` without
  ``transpose_kernel``: the input dilated by the stride, padded, and
  correlated with the kernel as it is (PyTorch's transposed conv flips it).
- ``group_norm`` and ``max_pool``: NHWC, statistics in fp32; the pool
  "VALID" or "SAME".
- ``resize_linear``: ``jax.image.resize(..., "bilinear")``, antialiased
  when it downsizes, by the weights of ``linear_resize_matrix``.
- ``conv1d``: NWC, with groups.
- ``dropout`` / ``drop_path``: the JAX package's masks and scales, drawn
  from an explicit ``torch.Generator`` on the tensor's device (JAX's keys
  become generators; ``split_generator`` plays ``jax.random.split``).

Weights are kept in PyTorch's layouts: dense (out, in), conv2d
(out, in, kh, kw), conv1d (out, in / groups, k).  The large products go to
``F.linear`` / ``torch.matmul`` / ``F.conv*``, as the JAX package leaves them
to XLA.  Parameters are created uninitialised; they are filled by loading
weights (``utils.checkpoint``) or by ``utils.random_weights``.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ..parallel.data import batch_rand


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with weight (out, in)."""
    return F.linear(x, weight, bias)


def shrink(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """x in value, its gradient scaled by alpha (the adapters'
    ``shrink_alpha``)."""
    return x if alpha == 1.0 else x * alpha + x.detach() * (1 - alpha)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), x.shape[-1:], w, b, eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, cast back to x's dtype."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, padding: str = "VALID") -> torch.Tensor:
    """NHWC conv with weight (out, in, kh, kw), padding "VALID" or "SAME";
    returns NHWC."""
    cout, cin, kh, kw = weight.shape
    b, h, wd, c = x.shape
    w = weight.to(x.dtype)
    if (padding == "VALID" and kh == stride and kw == stride
            and h % stride == 0 and wd % stride == 0):
        ho, wo = h // stride, wd // stride
        patches = x.reshape(b, ho, stride, wo, stride, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, ho, wo, stride * stride * c)
        y = patches @ w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    else:
        xc = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            (top, bottom), (left, right) = _same_pads(h, kh, stride), _same_pads(wd, kw, stride)
            xc = F.pad(xc, (left, right, top, bottom))
        elif padding != "VALID":
            raise ValueError(f"padding {padding!r}: VALID or SAME")
        y = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _transpose_pads(k: int, stride: int, padding: str) -> Tuple[int, int]:
    """``jax.lax.conv_transpose``'s padding of the dilated input."""
    if padding == "SAME":
        total = k + stride - 2
        before = k - 1 if stride > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + stride - 2 + max(k - stride, 0)
        before = k - 1
    else:
        raise ValueError(f"padding {padding!r}: VALID or SAME")
    return before, total - before


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     stride: int, padding: str = "VALID") -> torch.Tensor:
    """``jax.lax.conv_transpose(x, w_hwio, (s, s), padding)`` on NHWC, with the
    HWIO kernel held as (out, in, kh, kw).  PyTorch's transposed conv flips
    the kernel and pads the dilated input by k-1 on each side, so it runs
    with the kernel flipped back, and its output is cut (or zero-extended)
    to lax's padding."""
    cout, cin, kh, kw = weight.shape
    w = weight.to(x.dtype).flip(2, 3).transpose(0, 1)  # (in, out, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride)
    for dim, k, n in ((2, kh, x.shape[1]), (3, kw, x.shape[2])):
        before, after = _transpose_pads(k, stride, padding)
        length = (n - 1) * stride + 1 + before + after - k + 1
        start = k - 1 - before
        if start < 0 or start + length > y.shape[dim]:  # lax pads past PyTorch's extent
            extra = [0, 0] * (3 - dim) + [max(-start, 0), max(start + length - y.shape[dim], 0)]
            y = F.pad(y, extra)
            start = max(start, 0)
        y = y.narrow(dim, start, length)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """NHWC GroupNorm in fp32 (``vision/adapter.group_norm``): the largest
    group count <= ``groups`` that divides the channels."""
    b, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(b, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def linear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of ``jax.image.resize(method="linear")`` along one
    axis: half-pixel centres, the triangle kernel widened by src/dst when
    downsizing (antialiasing), weights renormalised at the edges; in fp32,
    as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (dst / src))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


def resize_linear(x: torch.Tensor, sizes: Tuple[int, ...], dims: Tuple[int, ...]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` over the axes ``dims`` (to
    ``sizes``), the others kept: one product with ``linear_resize_matrix``
    per axis whose size changes (so a downsize antialiases, as JAX's does;
    ``F.interpolate`` does not by default).  Computed in fp32, returned in
    x's dtype."""
    y = x.float()
    for dim, size in zip(dims, sizes):
        src = y.shape[dim]
        if src == size:
            continue
        w = torch.from_numpy(linear_resize_matrix(src, size)).to(y.device)
        y = torch.matmul(y.movedim(dim, -1), w.T).movedim(-1, dim)
    return y.to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool, "VALID" or "SAME" (XLA's split, -inf pads)."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pads(x.shape[1], window, stride),
                                        _same_pads(x.shape[2], window, stride))
        xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: VALID or SAME")
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NWC 1-D conv with weight (out, in / groups, k); returns NWC."""
    y = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), stride=stride,
                 padding=padding, groups=groups).transpose(1, 2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def bucket_order(idx: torch.Tensor, buckets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions of the (L, L) bucket indices ``idx`` sorted by bucket
    (a stable sort) and each bucket's count: what the bias gather's backward
    sums (``gather_rel_bias(..., sums=)``), computed once per index map."""
    flat = idx.flatten()
    return torch.argsort(flat, stable=True), torch.bincount(flat, minlength=buckets)


class _BucketGather(torch.autograd.Function):
    """The (L, L) gather of ``gather_rel_bias`` whose backward sums each
    bucket's gradient over its positions, in the bucket-sorted order of
    ``bucket_order``: a gather and a segment sum, deterministic.  PyTorch's
    index backward sorts the 9.8M indices of L = 3137 and sums each bucket's
    ~800 equal indices serially: 36.8 ms a layer on an H100, against 4.7."""

    @staticmethod
    def forward(ctx, table, idx, order, counts):
        ctx.save_for_backward(order, counts)
        ctx.table_shape = table.shape
        return table.transpose(1, 2).contiguous()[:, :, idx]

    @staticmethod
    def backward(ctx, grad):
        order, counts = ctx.saved_tensors
        t, r, h = ctx.table_shape
        with record_function("rel_bias_bucket_sum"):
            rows = grad.reshape(t * h, -1).t()[order]  # (L * L, tables * H), bucket-sorted
            sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=0, unsafe=True)
        return sums.reshape(r, t, h).transpose(0, 1), None, None, None


def gather_rel_bias(table: torch.Tensor, idx: torch.Tensor,
                    sums: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """A (tables, R, H) rel-pos table gathered at (L, L) bucket indices, as
    contiguous fp32 (tables, H, L, L), or at a student pass's per-sample
    (B, P, P) indices, as (tables, B, H, P, P): contiguous once here, so the
    kernel takes each layer's slice without a copy.  The (L, L) gather reads
    the table transposed to (tables, H, R), so that it writes the heads'
    planes in place: gathering (L, L, H) rows and transposing them cost ~12
    ms a table at L = 3137 on an H100.  With ``sums`` (``bucket_order`` of
    ``idx``) its backward is a sum per bucket instead of the index
    backward."""
    if idx.ndim == 2:
        if sums is not None:
            return _BucketGather.apply(table.float(), idx, *sums)
        return table.float().transpose(1, 2).contiguous()[:, :, idx]
    return table.float()[:, idx].movedim(-1, -3).contiguous()


def student_positions(preserve_ids: torch.Tensor, rp_bucket: Optional[torch.Tensor]):
    """A student pass's gather of the preserved positions (``preserve_ids``
    (B, P), right-padded with -1): (padding mask (B, P) True at the -1s,
    positions (B, P) with each -1 read as the last position P - 1, and the
    per-sample (B, P, P) rel-pos bucket indices, or None without
    ``rp_bucket``)."""
    pad = preserve_ids == -1
    pos = torch.where(pad, preserve_ids.shape[1] - 1, preserve_ids)
    idx = None if rp_bucket is None else rp_bucket[pos[:, :, None], pos[:, None, :]]
    return pad, pos, idx


def gather_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) at positions (B, P) -> (B, P, D) (``take_along_axis``)."""
    return x.gather(1, pos[..., None].expand(-1, -1, x.shape[-1]))


def scatter_preserved(mask_token: torch.Tensor, preserve_ids: torch.Tensor,
                      preserve_embed: torch.Tensor, seq_len: int) -> torch.Tensor:
    """The decoder's input (B, seq_len, D) in the mask token's dtype: the
    mask token everywhere, and each preserved embedding (B, P, D) put back
    at its position; a -1 of ``preserve_ids`` puts nothing.  Each position
    holds exactly one of the two, as the JAX package's one-hot merge gives
    it.  The -1s write into one extra column that is cut off."""
    b, p, d = preserve_embed.shape
    keep = preserve_ids >= 0
    pos = torch.where(keep, preserve_ids, seq_len)
    base = mask_token.expand(b, seq_len + 1, d)
    x = base.scatter(1, pos[..., None].expand(-1, -1, d), preserve_embed.to(mask_token.dtype))
    return x[:, :seq_len]


def split_generator(generator: Optional[torch.Generator], n: int) -> List[Optional[torch.Generator]]:
    """n CPU generators seeded from draws of ``generator`` (the role of
    ``jax.random.split``); n Nones without one."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator().manual_seed(s) for s in seeds.tolist()]


def generator_on(generator: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded from one draw of ``generator``."""
    if generator is None:
        return None
    seed = torch.randint(0, 2**62, (), generator=generator, device=generator.device).item()
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scale by 1 / keep.
    Identity when deterministic or at rate 0; otherwise ``generator`` (on
    x's device) draws the mask (for the global batch across data ranks,
    ``parallel.data.batch_rand``)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with rate > 0 needs a generator when not deterministic")
    keep = 1.0 - rate
    mask = batch_rand(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: one keep draw per leading index (a batch row of
    (B, L, D), an image of the trunk's (B, h, w, C) maps), shared over the
    rest, kept rows scaled by 1 / keep (in x's dtype).  The mask has shape
    (B,) + (1,) * (ndim - 1), so on (B, L, D) it draws as the JAX package's
    (B, 1, 1); across data ranks it is drawn for the global batch
    (``parallel.data.batch_rand``).  Identity when deterministic, without a
    generator, or at
    rate 0."""
    if deterministic or generator is None or rate == 0.0:
        return x
    keep = np.float32(1.0) - np.float32(rate)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = batch_rand(shape, generator, x.device) < float(keep)
    scale = np.float32(1.0) / max(keep, np.float32(1e-8)) if keep > 0 else 0.0
    scaled = x * torch.tensor(float(scale), dtype=x.dtype, device=x.device)
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


# The GEMMs whose outputs the ``qkv`` remat policies keep: what F.linear
# runs under autograd (a flattened addmm, or mm without a bias).
_GEMM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_remat_store = None  # (the active layer's _ProjectionStore, replaying) while a checkpoint runs


class _ProjectionStore:
    """The outputs of the GEMMs run inside ``saved_projections`` scopes of
    one checkpointed layer (the q/k/v projections), in order: kept on the
    card (``qkv``), or copied to pinned host memory (``offload_qkv``; a CPU
    tensor is already on the host and is kept as it is).  The forward
    records them, the recompute takes them back instead of running the
    GEMMs.  Nothing else is kept: the attention kernel fills its output
    outside aten dispatch, so its output and statistics must come from the
    replay, and they do, since only these GEMMs are ever taken back."""

    def __init__(self, offload: bool):
        self.offload, self.saved, self.taken = offload, [], 0

    @contextlib.contextmanager
    def active(self, replaying: bool):
        global _remat_store
        before, _remat_store = _remat_store, (self, replaying)
        self.taken = 0
        try:
            yield
        finally:
            _remat_store = before

    def put(self, out: torch.Tensor) -> None:
        if self.offload and out.device.type != "cpu":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.saved.append((host.copy_(out, non_blocking=True), None))
        else:  # an alias: its version must not move before the replay reads it
            self.saved.append((out.detach(), out._version))

    def take(self, like: torch.device) -> torch.Tensor:
        x, version = self.saved[self.taken]
        self.taken += 1
        if version is not None and x._version != version:
            raise RuntimeError("a kept q/k/v projection was modified in place before the "
                               "backward replayed it")
        return x.to(like, non_blocking=True) if x.device != like else x.detach()


class _ProjectionMode(TorchDispatchMode):
    """Records (forward) or takes back (recompute) the GEMMs of a scope."""

    def __init__(self, store: _ProjectionStore, replaying: bool):
        super().__init__()
        self.store, self.replaying = store, replaying

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _GEMM_OPS:
            return func(*args, **(kwargs or {}))
        if self.replaying:
            return self.store.take(args[0].device)
        out = func(*args, **(kwargs or {}))
        self.store.put(out)
        return out


@contextlib.contextmanager
def saved_projections():
    """Mark the GEMMs run inside as the q/k/v projections that the ``qkv``
    and ``offload_qkv`` remat policies keep across a layer's checkpoint (the
    JAX package's ``checkpoint_name(..., "qkv")``); a no-op elsewhere."""
    if _remat_store is None:
        yield
        return
    with _ProjectionMode(*_remat_store):
        yield


def checkpoint_module(module: nn.Module, *args, make_kwargs=None,
                      policy: str = "full") -> torch.Tensor:
    """``module(*args, **make_kwargs())`` under ``torch.utils.checkpoint``:
    only the inputs are kept, and the backward pass runs the module again.
    Its parameters enter the checkpoint as inputs, so that the recompute
    sees the tensors the forward saw, also when ``torch.func.functional_call``
    swapped them in (the trainer's compute-dtype copies) and has since put
    the masters back.  ``make_kwargs`` runs again in the recompute, so a
    generator it seeds draws the same masks.  ``policy`` "qkv" also keeps
    the outputs of the GEMMs in the module's ``saved_projections`` scopes
    on the card, "offload_qkv" in pinned host memory, and the recompute
    takes them back instead of running those GEMMs (the JAX package's
    ``save_only_these_names`` and ``save_and_offload_only_these_names``);
    any other policy keeps nothing, as "full" does.  FSDP's sharded
    parameters stay out: FSDP gathers them for the forward and again for the
    recompute, and a shard swapped in would replace what it gathered."""
    named = [(n, p) for n, p in module.named_parameters() if not hasattr(p, "device_mesh")]
    names, params = [n for n, _ in named], [p for _, p in named]

    def run(*inputs):
        kwargs = {} if make_kwargs is None else make_kwargs()
        return torch.func.functional_call(module, dict(zip(names, inputs[len(args):])),
                                          inputs[:len(args)], kwargs)

    kw = {}
    if policy in ("qkv", "offload_qkv"):
        store = _ProjectionStore(offload=policy == "offload_qkv")
        kw["context_fn"] = lambda: (store.active(False), store.active(True))
    return checkpoint(run, *args, *params, use_reentrant=False, preserve_rng_state=False, **kw)


def empty_param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=False)


class LayerNorm(nn.Module):
    """Affine LayerNorm (``scale``/``bias`` in the JAX tree)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(dim, device=device, dtype=dtype)
        self.bias = empty_param(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class GroupNorm(LayerNorm):
    """Affine NHWC GroupNorm (``scale``/``bias`` in the JAX tree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias)


class Linear(nn.Module):
    """Dense layer, weight (out, in) (``w`` (in, out) in the JAX tree)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(out_features, in_features, device=device, dtype=dtype)
        self.bias = empty_param(out_features, device=device, dtype=dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Weights of one conv, in PyTorch's layout: (out, in / groups, *kernel)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple, groups: int = 1,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(out_ch, in_ch // groups, *kernel, device=device, dtype=dtype)
        self.bias = empty_param(out_ch, device=device, dtype=dtype) if bias else None
