"""one_peace_tpu_torch attention vs the JAX package: the plain version
against JAX ``multihead_attention(impl="xla")`` and against the Pallas
``flash_attention`` run through the Pallas interpreter, and the rules of the
kernel wrapper (CPU tensors never build or count; bad inputs raise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.ops.attention import multihead_attention as jax_mha
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.ops.attention import attention_plain, multihead_attention

TOL = 2e-5  # fp32 on both sides


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernel in interpreter mode on CPU."""
    orig = jfa.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def _inputs(l, bias, mask, b=2, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, l, h, d).astype(np.float32) for _ in range(3))
    rel = None
    if bias == "shared":
        rel = rng.randn(h, l, l).astype(np.float32)
    elif bias == "batched":
        rel = rng.randn(b, h, l, l).astype(np.float32)
    pad = None
    if mask is not None:
        pad = np.zeros((b, l), bool)
        if mask == "present":
            pad[1, l - max(1, l // 3):] = True
    return q, k, v, rel, pad


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.as_tensor(x)


CASES = [(l, bias, mask) for l in (10, 64, 257) for bias in ("shared", "batched", None)
         for mask in ("present", None, "all_false")]


@pytest.mark.parametrize("l,bias,mask", CASES)
def test_plain_matches_jax_xla(l, bias, mask):
    q, k, v, rel, pad = _inputs(l, bias, mask)
    want = np.asarray(jax_mha(*map(_jax, (q, k, v, rel, pad)), 0.25, impl="xla"))
    got = attention_plain(*map(_torch, (q, k, v, rel, pad)), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("l,bias,mask", CASES)
def test_flash_plain_matches_pallas_interpret(interpret, l, bias, mask):
    """The port's flash_attention on CPU tensors (its plain version) against
    the Pallas kernel itself, interpreted."""
    q, k, v, rel, pad = _inputs(l, bias, mask)
    want = np.asarray(jfa.flash_attention(*map(_jax, (q, k, v, rel, pad)), 0.25))
    before = tfa.launches
    got = tfa.flash_attention(*map(_torch, (q, k, v, rel, pad)), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert tfa.launches == before


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_cpu_never_builds_or_counts(monkeypatch, impl):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(tfa, "build_library", no_build)
    monkeypatch.setattr(tfa, "launches", 0)
    q, k, v, rel, pad = map(_torch, _inputs(10, "shared", "present", d=64))
    out = multihead_attention(q, k, v, rel, pad, 0.125, impl=impl)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert tfa.launches == 0


def test_key_mask_forms_agree():
    """No mask, an all-False mask and a None mask give the same output, and
    the kernel's -1e30 mask agrees with the plain finfo(fp32).min mask."""
    q, k, v, rel, _ = map(_torch, _inputs(37, "shared", None))
    none = tfa.flash_attention(q, k, v, rel, None, 0.25)
    false = tfa.flash_attention(q, k, v, rel, torch.zeros(2, 37, dtype=torch.bool), 0.25)
    torch.testing.assert_close(none, false, rtol=0, atol=0)
    pad = torch.zeros(2, 37, dtype=torch.bool)
    pad[0, 30:] = True
    torch.testing.assert_close(tfa.flash_attention(q, k, v, rel, pad, 0.25),
                               attention_plain(q, k, v, rel, pad, 0.25), rtol=0, atol=1e-6)


def test_ring_and_unknown_impl_raise():
    q, k, v, rel, pad = map(_torch, _inputs(10, None, None))
    with pytest.raises(NotImplementedError):
        multihead_attention(q, k, v, rel, pad, 0.25, impl="ring")
    with pytest.raises(ValueError):
        multihead_attention(q, k, v, rel, pad, 0.25, impl="sdpa")


@pytest.mark.parametrize("dtype,heads,hdim,err", [
    (torch.float16, 2, 128, TypeError),      # dtype the kernel does not take
    (torch.bfloat16, 4, 128, ValueError),    # head dim 32
    (torch.float32, 2, 128, ValueError),     # valid, but not on a CUDA device
])
def test_kernel_wrapper_raises_without_fallback(monkeypatch, dtype, heads, hdim, err):
    """Inputs the kernel cannot take raise before anything is built; here
    the tensors are on the meta device, which is not a CUDA device."""
    monkeypatch.setattr(tfa, "build_library", lambda: pytest.fail("built"))
    q = torch.empty(2, 8, hdim, dtype=dtype, device="meta")
    with pytest.raises(err):
        tfa.flash_attention_cuda(q, q, q, None, None, 0.125, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """On the card: the CUDA kernel against its plain version in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, l, h = 2, 257, 24
    q, k, v = (torch.randn(b, l, h, 64, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    rel = torch.randn(h, l, l, generator=g, device="cuda")
    pad = torch.zeros(b, l, dtype=torch.bool, device="cuda")
    pad[1, 200:] = True
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, rel, pad, 0.125)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = attention_plain(q.float(), k.float(), v.float(), rel, pad, 0.125)
    err = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        assert err.max() <= 2e-2 and err.mean() <= 2e-3
    else:
        assert err.max() <= 1e-4
