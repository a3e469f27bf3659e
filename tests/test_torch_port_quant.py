"""one_peace_tpu_torch int8 serving vs the JAX package: the weight and row
quantizers bit for bit, the plain GEMM against ``quantized_linear``'s XLA arm
and the interpreted Pallas ``int8_matmul``, ``quantize_ffn_`` against
``quantize_ffn_params``, and the quantized model's embeddings; the rules of
the kernel wrappers (CPU tensors never build or count, bad inputs raise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as tf
from helpers import tiny_model_config

from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.ops import quant as jq
from one_peace_tpu.ops.quant_pallas import int8_matmul as jax_int8_matmul
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops import quant
from one_peace_tpu_torch.utils.checkpoint import params_from_jax

SHAPES = [(8, 64, 128), (13, 100, 70), (260, 520, 515)]  # tests/test_quant.py's


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)  # port layout (out, in)
    w[3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = jq.quantize_weight(jnp.asarray(w.T, jdtype))
    w_q, scale = quant.quantize_weight(torch.as_tensor(w).to(tdtype))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(want["w_q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["w_scale"]))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_quantize_bit_equal_to_jax(dtype):
    """The plain row quantize against the JAX arithmetic of
    ``quantized_linear`` (the weight quantizer on x^T reduces each row);
    bf16 rows put many quotients on .5 ties, which both round to even."""
    rng = np.random.RandomState(1)
    x = (rng.randn(37, 96) * 3).astype(np.float32)
    x[5] = 0.0
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = jq.quantize_weight(jnp.asarray(x.T, jdtype))
    before = im.quantize_launches
    x_q, sx = im.int8_quantize_rows(torch.as_tensor(x).to(tdtype))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(want["w_q"]).T)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(want["w_scale"]))
    assert im.quantize_launches == before


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_quantized_linear_matches_jax_xla(m, k, n, dtype, bias):
    """quantized_linear on CPU tensors (the plain quantize and GEMM) against
    the JAX package's XLA arm on the same weights: the same bits."""
    rng = np.random.RandomState(m + k)
    x = (rng.randn(2, m, k) * 2).astype(np.float32)
    w = (rng.randn(n, k) * 0.05).astype(np.float32)
    b = (rng.randn(n) * 0.1).astype(np.float32) if bias else None
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    params = jq.quantize_weight(jnp.asarray(w.T, jdtype))
    if bias:
        params["b"] = jnp.asarray(b, jdtype)
    want = np.asarray(jq.quantized_linear(params, jnp.asarray(x, jdtype)).astype(jnp.float32))
    w_q, scale = quant.quantize_weight(torch.as_tensor(w).to(tdtype))
    tb = None if b is None else torch.as_tensor(b).to(tdtype)
    before = im.launches
    got = quant.quantized_linear(torch.as_tensor(x).to(tdtype), w_q, scale, tb)
    assert got.dtype == tdtype and got.shape == (2, m, n)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert im.launches == before


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_gemm_matches_pallas_interpret(monkeypatch, m, k, n):
    """The plain GEMM against the Pallas kernel itself, interpreted, on
    tests/test_quant.py's three padding shapes."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    rng = np.random.RandomState(0)
    x_q = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sx = (rng.rand(m) * 0.01 + 1e-4).astype(np.float32)
    sw = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    want = np.asarray(jax_int8_matmul(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(sx),
                                      jnp.asarray(sw), out_dtype=jnp.float32))
    got = im.int8_matmul(torch.as_tensor(x_q), torch.as_tensor(w_q.T.copy()),
                         torch.as_tensor(sx), torch.as_tensor(sw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_shared_input_quantize_equals_separate_calls():
    """q/k/v (and wi_0/wi_1) sharing one row quantize give each projection's
    own result."""
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(2, 5, 16).astype(np.float32))
    lins = []
    for bias in (True, False, True):
        lin = torch.nn.Linear(16, 24, bias=bias)
        lins.append(quant.QuantizedLinear.from_linear(lin))
    lins.append(torch.nn.Linear(16, 8))  # a plain linear among them
    got = quant.shared_input_linears(x, *lins)
    for g, lin in zip(got, lins):
        torch.testing.assert_close(g, lin(x), rtol=0, atol=0)


def _trees(cfg, seed=0):
    tree = convert_retrieval_model(tf.make_random_state_dict(cfg, seed=seed), cfg)
    return tree, JaxModel(cfg)


@pytest.mark.parametrize("include_attn", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ffn_matches_quantize_ffn_params(include_attn, dtype):
    """``params_from_jax(quantize_ffn_params(tree))`` and ``quantize_ffn_`` on
    the port's module hold the same int8 bits, scales and biases."""
    cfg = tiny_model_config(head_type="val")
    tree, _ = _trees(cfg)
    jtree = to_jax(tree, getattr(jnp, dtype))
    jtree["encoder_wrapper"] = jq.quantize_ffn_params(jtree["encoder_wrapper"],
                                                     include_attn=include_attn)
    want = params_from_jax(jax.tree.map(np.asarray, jtree))
    model = OnePeaceRetrievalModel(cfg, dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(tree), strict=True)
    quant.quantize_ffn_(model, include_attn=include_attn)
    got = model.state_dict()
    assert got.keys() == want.keys()
    n_int8 = 0
    for name, tensor in got.items():
        if name == "logit_scale":  # fp32 in the port whatever the dtype
            continue
        assert tensor.dtype == want[name].dtype, name
        torch.testing.assert_close(tensor, want[name], rtol=0, atol=0, msg=name)
        n_int8 += tensor.dtype == torch.int8
    per_layer = 3 * 3 + (4 if include_attn else 0)
    assert n_int8 == cfg.encoder.layers * per_layer
    attn = model.encoder_wrapper.fusion.layers[0].self_attn
    assert quant.is_quantized(attn.q_proj) == include_attn
    assert attn.k_proj.bias is None


@pytest.fixture(scope="module")
def quantized_pairs():
    cfg = tiny_model_config(head_type="val")
    tree, jax_model = _trees(cfg, seed=5)
    out = {}
    for mode in ("ffn", "ffn_attn"):
        params = to_jax(tree)
        params["encoder_wrapper"] = jq.quantize_ffn_params(
            params["encoder_wrapper"], include_attn=mode == "ffn_attn")
        model = OnePeaceRetrievalModel(cfg)
        model.load_state_dict(params_from_jax(tree), strict=True)
        quant.quantize_ffn_(model, include_attn=mode == "ffn_attn")
        out[mode] = (params, model)
    return cfg, jax_model, out


def _inputs(cfg):
    rng = np.random.RandomState(1)
    wav = rng.randn(2, 100).astype(np.float32)
    pad = np.zeros((2, conv_output_length(100, cfg.encoder.audio_adapter.feature_encoder_spec)
                    + 1), bool)
    pad[1, -4:] = True
    return {"text": {"src_tokens": np.array([[5, 6, 7, 1, 1], [8, 9, 10, 11, 12]])},
            "image": {"src_images": rng.randn(2, 3, 32, 32).astype(np.float32)},
            "audio": {"src_audios": wav, "audio_padding_masks": pad}}


@pytest.mark.parametrize("mode", ["ffn", "ffn_attn"])
@pytest.mark.parametrize("encoder_type", ["text", "image", "audio"])
def test_quantized_embeddings_match_jax(quantized_pairs, mode, encoder_type):
    """The quantized retrieval model in fp32 against the JAX quantized model
    at 1e-4.  Both quantize the same fp32 activations; an activation that
    lands within rounding of a .5 tie can move one int8 step on one side
    only, which the 1e-4 bound absorbs at this size."""
    cfg, jax_model, pairs = quantized_pairs
    params, model = pairs[mode]
    kwargs = _inputs(cfg)[encoder_type]
    want = np.asarray(jax_model(params, encoder_type=encoder_type,
                                **{k: jnp.asarray(v) for k, v in kwargs.items()}))
    before = (im.launches, im.quantize_launches)
    with torch.inference_mode():
        got = model(encoder_type=encoder_type,
                    **{k: torch.as_tensor(v) for k, v in kwargs.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (im.launches, im.quantize_launches) == before


def test_quantized_vl_features_match_jax(quantized_pairs):
    """The vl concat path: the text and image FFNs each quantize their own
    segment."""
    cfg, jax_model, pairs = quantized_pairs
    params, model = pairs["ffn_attn"]
    inputs = {**_inputs(cfg)["text"], **_inputs(cfg)["image"]}
    want = jax_model.wrapper(params["encoder_wrapper"], encoder_type="vl",
                             **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.inference_mode():
        got = model.encoder_wrapper(encoder_type="vl",
                                    **{k: torch.as_tensor(v) for k, v in inputs.items()})
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_wrappers_raise_without_fallback(monkeypatch):
    """Inputs the kernels cannot take raise before anything is built; the
    tensors here are on the meta device, which is not a CUDA device."""
    monkeypatch.setattr(im, "build_library", lambda name: pytest.fail("built"))
    meta = dict(device="meta")
    with pytest.raises(TypeError):
        im.int8_quantize_rows_cuda(torch.empty(4, 16, dtype=torch.float16, **meta))
    with pytest.raises(ValueError):  # valid, but not on a CUDA device
        im.int8_quantize_rows_cuda(torch.empty(4, 16, dtype=torch.bfloat16, **meta))
    x_q = torch.empty(4, 32, dtype=torch.int8, **meta)
    w_q = torch.empty(8, 32, dtype=torch.int8, **meta)
    sx = torch.empty(4, **meta)
    sw = torch.empty(8, **meta)
    with pytest.raises(TypeError):
        im.int8_matmul_cuda(x_q.float(), w_q, sx, sw)
    with pytest.raises(TypeError):
        im.int8_matmul_cuda(x_q, w_q, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError):  # K mismatch
        im.int8_matmul_cuda(x_q, w_q[:, :16], sx, sw)
    with pytest.raises(ValueError):  # wrong scale shape
        im.int8_matmul_cuda(x_q, w_q, sw, sw)
    with pytest.raises(ValueError):  # not on a CUDA device
        im.int8_matmul_cuda(x_q, w_q, sx, sw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k in ((13, 100), (1028, 1536), (300, 6144)):
        x = (torch.randn(m, k, generator=g, device="cuda") * 3).to(dtype)
        before = im.quantize_launches
        got = im.int8_quantize_rows(x)
        torch.cuda.synchronize()
        assert im.quantize_launches == before + 1
        want = im.int8_quantize_rows_plain(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernel_matches_plain_on_card(out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES + [(1028, 1536, 6144)]:
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=g, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=g, device="cuda") * 0.01 + 1e-4
        bias = torch.randn(n, generator=g, device="cuda")
        before = im.launches
        got = im.int8_matmul(x_q, w_q, sx, sw, bias, out_dtype)
        torch.cuda.synchronize()
        assert im.launches == before + 1
        assert torch.equal(got, im.int8_matmul_plain(x_q, w_q, sx, sw, bias, out_dtype))
