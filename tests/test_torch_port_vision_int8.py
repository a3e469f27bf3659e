"""Int8 serving of the vision trunks, the port against the JAX package on
the CPU at toy size: ``vision.zoo.quantize_serving_params`` (the port's,
in place on the model) against the JAX package's ``quantize_serving_params``
(on the ``params_to_jax`` tree of the same weights) on the detector, both
segmenters and the video classifier -- the same set of quantized
projections, ``w_q`` and ``w_scale`` bit-equal, and the int8 trunk features
(detection), logits (segmentation) and logits (video) within 1e-4 in fp32
of the JAX package's on its quantized tree; and ``DetFFN`` quantizing x's
rows once for ``wi_0`` and ``wi_1`` (3 GEMMs and 2 row quantizes a layer),
bit-equal to quantizing them twice.

One fault of the JAX package shows on the detector: its trunk stacks each
FFN weight on two leading axes (layer group, layer within the group), and
``quantize_ffn_params`` vmaps ``quantize_weight`` over one, so the
quantizer takes its per-output-channel absmax over the within-group axis:
every weight gets a scale of its own and ``w_q`` is +-127 throughout
(``one_peace_tpu/ops/quant.py:75-78`` on ``one_peace_tpu/vision/zoo.py:67``).
The port quantizes each layer's weight per output channel, as
``quantize_weight`` does on a 2-D weight, so on the detector both sides are
held to JAX's ``quantize_weight`` applied layer by layer
(``_per_layer``); on the segmenters and the video trunk, whose stacks
have one leading axis, that tree equals ``quantize_serving_params``'s bit
for bit.

The weights are drawn by the port (``fill_random_``, the video test's
``numpy_weights_``) and carried to JAX by ``params_to_jax``; on the CPU the
int8 path runs the kernels' plain versions (the row quantize and the GEMM,
bit-equal to JAX's, ``test_torch_port_quant.py``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import test_torch_port_seg_model as seg_tests
import test_torch_port_video_model as video_tests
from one_peace_tpu.ops import quant as jq
from one_peace_tpu.vision import zoo as jzoo
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch.models.components import gelu
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops import quant
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision import zoo as tzoo
from one_peace_tpu_torch.vision.det_backbone import DetFFN
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector
from test_torch_port_det_train import GEOMETRY

TOL = 1e-4


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * scale)


def _per_layer(tree):
    """``quantize_ffn_params``'s walk over a zoo tree with JAX's
    ``quantize_weight`` applied to each layer's (in, out) weight, whatever
    the number of leading stack axes."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, value in tree.items():
        if key.endswith("_ffn") and isinstance(value, dict) and "wi_0" in value:
            value = dict(value)
            for name in ("wi_0", "wi_1", "wo"):
                w = jnp.asarray(value[name]["w"])
                q = jax.vmap(jq.quantize_weight)(w.reshape(-1, *w.shape[-2:]))
                value[name] = {"w_q": q["w_q"].reshape(w.shape),
                               "w_scale": q["w_scale"].reshape(*w.shape[:-2], w.shape[-1]),
                               **({"b": value[name]["b"]} if "b" in value[name] else {})}
            out[key] = value
        else:
            out[key] = _per_layer(value)
    return out


def _quantized(model, stacked_twice: bool = False):
    """The port model quantized in place (a copy) and the JAX tree of the
    unquantized one quantized layer by layer (``_per_layer``), as numpy.
    The JAX package's ``quantize_serving_params`` quantizes the same
    leaves; where the trunk is stacked on one axis its tree is the same bit
    for bit, where on two (``stacked_twice``: the detector) its scales are
    per weight (the module's docstring)."""
    tree = jax.tree.map(jnp.asarray, model_to_jax(model))
    qtree = jax.tree.map(np.asarray, _per_layer(tree))
    served = jax.tree.map(np.asarray, jzoo.quantize_serving_params(tree))
    assert (jax.tree.structure(served) == jax.tree.structure(qtree))
    same = jax.tree.leaves(jax.tree.map(
        lambda a, b: a.shape == b.shape and np.array_equal(a, b), served, qtree))
    assert all(same) != stacked_twice
    qmodel = tzoo.quantize_serving_params(copy.deepcopy(model))
    return qmodel, qtree


def _check_quantized_paths(qmodel, qtree) -> int:
    """The port's quantized projections are the JAX tree's ``w_q`` leaves,
    with ``w_q`` and ``w_scale`` bit-equal; returns how many."""
    want = params_from_jax(qtree)
    state = qmodel.state_dict()
    got_paths = {n[:-len(".w_q")] for n in state if n.endswith(".w_q")}
    want_paths = {n[:-len(".w_q")] for n in want if n.endswith(".w_q")}
    assert got_paths == want_paths
    assert got_paths == {name for name, m in qmodel.named_modules() if quant.is_quantized(m)}
    for path in got_paths:
        assert path.rsplit(".", 2)[-2].endswith("_ffn"), path  # trunk FFNs only
        for leaf in ("w_q", "w_scale"):
            assert torch.equal(state[f"{path}.{leaf}"], want[f"{path}.{leaf}"]), (path, leaf)
    return len(got_paths)


@pytest.fixture(scope="module")
def detector():
    det = OnePeaceDetector(proposer="rpn", device="cpu", attn_impl="pallas",
                           checkpoint_activations=False, **GEOMETRY)
    return fill_random_(det, torch.Generator().manual_seed(7)).eval()


def test_detector_int8_matches_jax(detector):
    """Every trunk layer's ``image_ffn`` (and nothing else) quantized, and
    the stride-16 map of the int8 trunk against the JAX trunk on its
    quantized tree."""
    qdet, qtree = _quantized(detector, stacked_twice=True)
    assert _check_quantized_paths(qdet, qtree) == 3 * GEOMETRY["layers"]
    images = np.random.RandomState(8).randn(2, 3, 64, 64).astype(np.float32)
    jdet = JaxDetector(proposer="rpn", checkpoint_activations=False, attn_impl="xla",
                       **GEOMETRY)
    want = jax.jit(jdet.backbone)(qtree["backbone"], jnp.asarray(images))
    with torch.no_grad():
        got = qdet.backbone(torch.from_numpy(images))
        plain = detector.backbone(torch.from_numpy(images))
    _close(got, want)
    assert not torch.equal(got, plain)  # the int8 path ran


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
def test_segmenter_int8_matches_jax(head):
    """The seg stack's ``backbone.encoder`` FFNs quantized (the adapter, the
    heads and attention not), and the int8 logits against the JAX
    segmenter's on its quantized tree."""
    jseg, _, tseg = seg_tests.segmenters(head)
    qseg, qtree = _quantized(tseg)
    assert _check_quantized_paths(qseg, qtree) == 3 * 4
    x = seg_tests.images()
    want = jax.jit(jseg.logits)(qtree, jnp.asarray(x))
    with torch.no_grad():
        got = qseg.logits(torch.from_numpy(x))
    _close(got, want)


def test_video_int8_matches_jax():
    """Every video layer's ``image_ffn`` quantized (the adapters not), and
    the int8 logits against the JAX classifier's on its quantized tree."""
    jm, _, tm = video_tests.models()
    qm, qtree = _quantized(tm)
    assert _check_quantized_paths(qm, qtree) == 3 * video_tests.LAYERS
    x = video_tests.frames(9)
    want = jax.jit(jm)(qtree, jnp.asarray(x))
    with torch.no_grad():
        got = qm(torch.from_numpy(x))
    _close(got, want)


def test_det_ffn_quantizes_its_input_once(monkeypatch):
    """A quantized ``DetFFN`` quantizes x's rows once for ``wi_0`` and
    ``wi_1`` and once for ``wo``: 3 GEMMs and 2 row quantizes; the result is
    bit-equal to each projection quantizing its own input."""
    ffn = fill_random_(DetFFN(32, 64, device="cpu"), torch.Generator().manual_seed(9))
    quant.quantize_ffn_(torch.nn.ModuleDict({"image_ffn": ffn}))
    assert all(quant.is_quantized(getattr(ffn, n)) for n in ("wi_0", "wi_1", "wo"))
    calls = {"quantize": 0, "gemm": 0}
    rows, gemm = im.int8_quantize_rows, im.int8_matmul

    def counted_rows(*a, **kw):
        calls["quantize"] += 1
        return rows(*a, **kw)

    def counted_gemm(*a, **kw):
        calls["gemm"] += 1
        return gemm(*a, **kw)

    monkeypatch.setattr(im, "int8_quantize_rows", counted_rows)
    monkeypatch.setattr(im, "int8_matmul", counted_gemm)
    x = torch.from_numpy(np.random.RandomState(10).randn(2, 5, 32).astype(np.float32))
    with torch.no_grad():
        got = ffn(x)
        assert calls == {"quantize": 2, "gemm": 3}
        want = ffn.wo(ffn.ffn_ln(gelu(ffn.wi_0(x)) * ffn.wi_1(x)))
    assert torch.equal(got, want)
