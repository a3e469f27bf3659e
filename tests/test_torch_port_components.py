"""one_peace_tpu_torch components and rel-pos tables vs the JAX package,
plus the rule that the port never imports JAX."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.models import components as jc
from one_peace_tpu.models import rel_pos as jrel
from one_peace_tpu_torch.models import components as tc
from one_peace_tpu_torch.models import rel_pos as trel

TOL = 1e-5  # fp32 on both sides; only summation order differs


@pytest.mark.parametrize("fn,args", [
    ("make_token_bucket_position", (8, 64)),
    ("make_token_bucket_position", (256, 1024)),
    ("make_token_bucket_position_with_cls", (8, 64)),
    ("make_token_bucket_position_with_cls", (512, 1024)),
    ("make_image_bucket_position", (2,)),
    ("make_image_bucket_position", (16,)),
])
def test_rel_pos_tables_equal(fn, args):
    np.testing.assert_array_equal(getattr(trel, fn)(*args), getattr(jrel, fn)(*args))


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_layer_norm_and_gelu():
    rng = np.random.RandomState(0)
    x = _rand(rng, 3, 5, 24, scale=3.0) + 2.0
    w, b = _rand(rng, 24) + 1.0, _rand(rng, 24)
    want = np.asarray(jc.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                                    jnp.asarray(x)))
    got = tc.layer_norm(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.layer_norm(torch.as_tensor(x)).numpy(),
                               np.asarray(jc.layer_norm(None, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.gelu(torch.as_tensor(x)).numpy(),
                               np.asarray(jc.gelu(jnp.asarray(x))), rtol=TOL, atol=TOL)


def test_layer_norm_keeps_bf16():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert tc.layer_norm(x, torch.ones(8), torch.zeros(8)).dtype == torch.bfloat16
    assert tc.gelu(x).dtype == torch.bfloat16


@pytest.mark.parametrize("kernel,stride,size", [(4, 4, 16), (2, 2, 8), (3, 2, 9)])
def test_conv2d(kernel, stride, size):
    """stride == kernel takes the patchify matmul; (3, 2) takes F.conv2d."""
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, size, size, 5)
    w_jax = _rand(rng, kernel, kernel, 5, 7)  # (kh, kw, in, out)
    b = _rand(rng, 7)
    want = np.asarray(jc.conv2d({"w": jnp.asarray(w_jax), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride))
    got = tc.conv2d(torch.as_tensor(x), torch.as_tensor(w_jax.transpose(3, 2, 0, 1)),
                    torch.as_tensor(b), stride=stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kernel,stride,padding,groups",
                         [(4, 2, 0, 1), (5, 1, 2, 4), (6, 1, 3, 4)])
def test_conv1d(kernel, stride, padding, groups):
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 23, 8)
    w_jax = _rand(rng, kernel, 8 // groups, 12)  # (k, in / groups, out)
    b = _rand(rng, 12)
    want = np.asarray(jc.conv1d({"w": jnp.asarray(w_jax), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride, padding=padding,
                                groups=groups))
    got = tc.conv1d(torch.as_tensor(x), torch.as_tensor(w_jax.transpose(2, 1, 0)),
                    torch.as_tensor(b), stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter: jax stays out."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        for p in (root / "one_peace_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 12, mods
