"""Ring attention over ``sp`` in the port against the JAX package, on the
CPU over gloo (``torch_ranks.run_ranks``; the ranks' side in
``tests/model_parallel_workers.py``, the JAX side in ``tests/mp_oracle.py``).

- The ring function (``ops.ring_attention.ring_attention``) at sp=2 (two
  rings of 2 ranks) and sp=4, with and without the rel-pos bias and key
  pads: the output chunks, concatenated, against JAX's
  ``ring_attention_sharded`` on a mesh of virtual devices and the plain
  attention; the gradients of q, k, v (chunks) and of the bias against
  ``jax.vjp`` of the plain attention, all in fp32 within 1e-5.
- The encoder with ``attn_impl="ring"`` at sp=2: the retrieval model's text
  tower (L=8: the ring engages in every layer), its image tower (L=5 does
  not divide: the ring does not engage and the plain path runs) and the vl
  classify model (L=12, a per-layer 3-D bias), each parameter's gradient
  against ``jax.grad`` of the serial JAX model; and the same at tp2 x sp2.

Each spawn of ranks takes ~10-25 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from jax.sharding import Mesh

import mp_oracle as mo
from one_peace_tpu.ops.attention import multihead_attention as jax_attention
from one_peace_tpu.ops.ring_attention import ring_attention_sharded
from torch_ranks import run_ranks

TOL = 1e-5
B, L, H, D = 2, 8, 2, 8


def _ring_case(sp, bias, pad, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, L, H, D).astype(np.float32) for _ in range(4))
    return {"sp": sp, "q": q, "k": k, "v": v, "do": do, "scaling": D ** -0.5,
            "bias": rs.randn(H, L, L).astype(np.float32) if bias else None,
            "pad": (np.arange(L)[None, :] >= np.array([[L], [L - 3]])) if pad else None}


RING_CASES = [_ring_case(sp, bias, pad, i) for i, (sp, bias, pad) in enumerate(
    [(2, False, False), (2, True, True), (4, False, True), (4, True, False), (4, True, True)])]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    return run_ranks(4, mo.mw.ring_cases, RING_CASES,
                     tmp_path=tmp_path_factory.mktemp("ring"), timeout=180)


def _jax_reference(case):
    """(ring_attention_sharded's output, the plain attention's output and
    its vjp on q, k, v and the bias)."""
    sp = case["sp"]
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    q, k, v = (jnp.asarray(case[n]) for n in ("q", "k", "v"))
    bias = None if case["bias"] is None else jnp.asarray(case["bias"])
    pad = None if case["pad"] is None else jnp.asarray(case["pad"])
    ring = ring_attention_sharded(mesh, q, k, v, bias, pad, case["scaling"], axis="sp")

    def plain(q_, k_, v_, b_):
        return jax_attention(q_, k_, v_, b_, pad, case["scaling"], impl="xla")

    out, vjp = jax.vjp(plain, q, k, v, bias if bias is not None else jnp.zeros((H, L, L)))
    grads = vjp(jnp.asarray(case["do"]))
    return np.asarray(ring), np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("index", range(len(RING_CASES)))
def test_ring_function_matches_jax(index, ring_runs):
    case = RING_CASES[index]
    sp = case["sp"]
    ring, plain, (dq, dk, dv, dbias) = _jax_reference(case)
    for start in range(0, 4, sp):  # each ring of sp consecutive ranks
        runs = [ring_runs[r][index] for r in range(start, start + sp)]
        got = {key: np.concatenate([r[key] for r in runs], axis=1)
               for key in ("out", "dq", "dk", "dv")}
        np.testing.assert_allclose(got["out"], ring, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["out"], plain, rtol=TOL, atol=TOL)
        for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(got[key], want, rtol=TOL, atol=TOL, err_msg=key)
        if case["bias"] is not None:
            for r in runs:  # summed over sp: every rank holds the whole gradient
                np.testing.assert_allclose(r["dbias"], dbias, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def cases():
    return {"text": mo.Case("retrieval", mo.retrieval_batch(4, 0)),
            "classify": mo.Case("classify", mo.classify_batch(4, 0))}


def _check(run, case):
    assert run["loss"] == pytest.approx(case.loss, rel=1e-5, abs=1e-5)
    mo.assert_grads_match(run["grads"], case)


@pytest.mark.parametrize("world,layout", [(2, dict(dp=1, sp=2)), (4, dict(dp=1, tp=2, sp=2))])
def test_encoder_with_ring_matches_jax(world, layout, cases, tmp_path):
    """The ring engages for the text tower (L=8, 2 layers) and the vl
    classify model (L=12), not for the image tower (L=5)."""
    runs = run_ranks(world, mo.mw.full_gradients,
                     [cases[n].on(layout, impl="ring") for n in ("text", "classify")],
                     tmp_path=tmp_path, timeout=240)
    text, classify = runs[0]
    _check(text, cases["text"])
    _check(classify, cases["classify"])
    assert text["ring_lengths"] == {8: 2}
    assert classify["ring_lengths"] == {12: 2}
    for rank in runs:
        assert [r["loss"] for r in rank] == [text["loss"], classify["loss"]]
