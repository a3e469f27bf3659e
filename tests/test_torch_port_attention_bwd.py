"""The port's attention backward against the JAX package: the plain version
``flash_attention_bwd_plain`` against the Pallas backward kernel
``_flash_bwd`` run through the Pallas interpreter and against ``jax.vjp`` of
``_xla_reference``; autograd through the port's ``flash_attention`` (the
autograd Function, on CPU its plain versions) against autograd through the
plain attention; and the rules of the backward kernel's wrapper.  fp32 on
both sides, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.ops.attention import attention_plain, multihead_attention

TOL = 1e-5
SCALING = 0.25


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpreter mode on CPU."""
    orig = jfa.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def _inputs(l, bias, mask, b=2, h=4, d=16, seed=0):
    """q, k, v, g (B, L, H*D); rel bias; fp32 key bias (-1e30 at pads)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, l, h * d).astype(np.float32) for _ in range(4))
    rel = None
    if bias == "shared":
        rel = rng.randn(h, l, l).astype(np.float32)
    elif bias == "batched":
        rel = rng.randn(b, h, l, l).astype(np.float32)
    key_bias = None
    if mask:
        key_bias = np.zeros((b, l), np.float32)
        key_bias[1, l - max(1, l // 3):] = jfa.NEG_INF
    return q, k, v, g, rel, key_bias


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.as_tensor(x)


CASES = [(l, bias, mask) for l in (16, 37, 130) for bias in ("shared", "batched", None)
         for mask in (True, False)]


def _check(got, want):
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("l,bias,mask", CASES)
def test_bwd_plain_matches_pallas_interpret(interpret, l, bias, mask):
    q, k, v, g, rel, kb = _inputs(l, bias, mask)
    want = jfa._flash_bwd(*map(_jax, (q, k, v, g, rel, kb)), SCALING, 4)
    got = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g, rel, kb)), SCALING, 4)
    _check(got, want)


@pytest.mark.parametrize("l,bias,mask", CASES)
def test_bwd_plain_matches_xla_vjp(l, bias, mask):
    q, k, v, g, rel, kb = _inputs(l, bias, mask)

    def f(q_, k_, v_, rel_):
        return jfa._xla_reference(q_, k_, v_, rel_, _jax(kb), SCALING, 4)

    _, vjp = jax.vjp(f, *map(_jax, (q, k, v, rel)))
    want = vjp(jnp.asarray(g))
    got = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g, rel, kb)), SCALING, 4)
    _check(got, want)


@pytest.mark.parametrize("l,bias,mask", [(37, "shared", True), (37, "batched", False),
                                         (130, None, True)])
def test_autograd_through_the_function(l, bias, mask):
    """Gradients through flash_attention (the autograd Function) equal those
    through the plain attention; the output's graph runs the Function."""
    b, h, d = 2, 4, 16
    q, k, v, g, rel, _ = _inputs(l, bias, False)
    pad = None
    if mask:
        pad = torch.zeros(b, l, dtype=torch.bool)
        pad[1, l - l // 3:] = True
    leaves = [torch.tensor(x.reshape(b, l, h, d), requires_grad=True) for x in (q, k, v)]
    if rel is not None:
        leaves.append(torch.tensor(rel, requires_grad=True))
    bias_t = leaves[3] if rel is not None else None
    out = tfa.flash_attention(*leaves[:3], bias_t, pad, SCALING)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionFunctionBackward"
    gt = torch.as_tensor(g.reshape(b, l, h, d))
    got = torch.autograd.grad(out, leaves, gt)
    want = torch.autograd.grad(attention_plain(*leaves[:3], bias_t, pad, SCALING), leaves, gt)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_multihead_attention_is_differentiable(monkeypatch, impl):
    """Both implementations carry gradients to q, k, v and the bias; on CPU
    tensors neither builds nor counts a kernel."""
    monkeypatch.setattr(tfa, "build_library", lambda which="fwd": pytest.fail("built"))
    monkeypatch.setattr(tfa, "bwd_launches", 0)
    q, k, v, _, rel, _ = _inputs(10, "shared", False, d=64)
    leaves = [torch.tensor(x.reshape(2, 10, 4, 64), requires_grad=True) for x in (q, k, v)]
    rel_t = torch.tensor(rel, requires_grad=True)
    out = multihead_attention(*leaves, rel_t, None, 0.125, impl=impl)
    grads = torch.autograd.grad(out.square().sum(), [*leaves, rel_t])
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in grads)
    assert tfa.bwd_launches == 0


def test_shared_bias_gradient_is_summed_over_batch():
    """A shared (H, L, L) bias gets the sum of the batched (B, H, L, L)
    cotangents, in fp32."""
    q, k, v, g, rel, kb = _inputs(37, "shared", True, b=3)
    shared = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g, rel, kb)), SCALING, 4)
    batched_rel = torch.as_tensor(np.broadcast_to(rel, (3,) + rel.shape).copy())
    batched = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g)), batched_rel,
                                            _torch(kb), SCALING, 4)
    assert shared[3].shape == rel.shape and shared[3].dtype == torch.float32
    torch.testing.assert_close(shared[3], batched[3].sum(0), rtol=TOL, atol=TOL)
    for x, y in zip(shared[:3], batched[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_bwd_plain_rounds_where_the_kernel_rounds():
    """In bf16, p and ds * scaling are rounded before their products: the
    plain version equals an fp32 recomputation with those two roundings."""
    q, k, v, g, rel, kb = _inputs(37, "shared", True)
    bf = [torch.as_tensor(x).bfloat16() for x in (q, k, v, g)]
    got = tfa.flash_attention_bwd_plain(*bf, _torch(rel), _torch(kb), SCALING, 4)
    assert all(x.dtype == torch.bfloat16 for x in got[:3]) and got[3].dtype == torch.float32
    b, l, h, d = 2, 37, 4, 16
    qh, kh, vh, gh = (x.float().reshape(b, l, h, d) for x in bf)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * SCALING + _torch(rel) + _torch(kb)[:, None,
                                                                                    None]
    p32 = torch.softmax(s, -1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p32.bfloat16().float(), gh)
    torch.testing.assert_close(got[2].float().reshape(b, l, h, d), dv.bfloat16().float(),
                               rtol=0, atol=0)


def test_bwd_wrapper_raises_without_fallback(monkeypatch):
    """Inputs the backward kernel cannot take raise before anything is
    built; here the tensors are on the meta device, not a CUDA device."""
    monkeypatch.setattr(tfa, "build_library", lambda which="fwd": pytest.fail("built"))
    q = torch.empty(2, 8, 128, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_cuda(q, q, q, q, None, None, 0.125, 2)
    double = torch.empty(2, 8, 128, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError):  # fp16 has a kernel arm; fp64 has none
        tfa.flash_attention_bwd_cuda(double, double, double, double, None, None, 0.125, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernel_matches_plain_on_card(dtype):
    """On the card: the backward kernel against its plain version, a shared
    bias summed over the batch and text pads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, h = 4, 70, 24
    q, k, v, g = (torch.randn(b, l, h * 64, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    rel = torch.randn(h, l, l, generator=gen, device="cuda")
    kb = torch.zeros(b, l, device="cuda")
    kb[1, 50:] = tfa.NEG_INF
    before = tfa.bwd_launches
    got = tfa.flash_attention_bwd_cuda(q, k, v, g, rel, kb, 0.125, h)
    torch.cuda.synchronize()
    assert tfa.bwd_launches == before + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, g, rel, kb, 0.125, h)
    for x, y in zip(got, want):
        rel_err = (x.float() - y.float()).abs().max() / y.float().abs().max()
        assert rel_err <= (2e-2 if dtype == torch.bfloat16 else 1e-4)
