"""one_peace_tpu_torch model vs the JAX package at toy geometry, on the same
weights: one encoder layer, the retrieval embeddings of each modality, the
wrapper's vl / al / val features and per-layer rel-pos tables.

Weights come from ``torch_fixture.make_random_state_dict``; the JAX side
gets them through ``convert_retrieval_model``, the port through
``params_from_jax`` of the same numpy tree.  Tolerance 1e-4 and cosine
> 1-1e-6, as the JAX package's own parity table (PARITY.md)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as tf
from helpers import tiny_model_config

from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.adapters.image import ImageAdapter as JaxImageAdapter
from one_peace_tpu.models.encoder import encoder_layer as jax_encoder_layer
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.models.adapters.image import ImageAdapter
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_

TOL = 1e-4


def _pair(cfg, seed):
    sd = tf.make_random_state_dict(cfg, seed=seed)
    tree = convert_retrieval_model(sd, cfg)
    jax_model = JaxModel(cfg)
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jax_model, to_jax(tree), model


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_model_config(head_type="val")
    return (cfg, *_pair(cfg, seed=0))


def _inputs(cfg):
    rng = np.random.RandomState(1)
    tokens = np.array([[5, 6, 7, 1, 1], [8, 9, 10, 11, 12]])
    imgs = rng.randn(2, 3, 32, 32).astype(np.float32)
    wav = rng.randn(2, 100).astype(np.float32)
    t_out = conv_output_length(100, cfg.encoder.audio_adapter.feature_encoder_spec)
    pad = np.zeros((2, t_out + 1), bool)
    pad[1, -4:] = True
    return {"src_tokens": tokens, "src_images": imgs, "src_audios": wav,
            "audio_padding_masks": pad}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    cos = np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 1 - 1e-6, cos


def _run_both(jax_model, params, model, encoder_type, **inputs):
    """Retrieval embeddings of both models on the same numpy inputs."""
    with torch.no_grad():
        got = model(encoder_type=encoder_type,
                    **{k: torch.as_tensor(v) for k, v in inputs.items()})
    want = jax_model(params, encoder_type=encoder_type,
                     **{k: jnp.asarray(v) for k, v in inputs.items()})
    return got, want


MODALITY_INPUTS = {"text": ("src_tokens",), "image": ("src_images",),
                   "audio": ("src_audios", "audio_padding_masks")}


@pytest.mark.parametrize("encoder_type", ["text", "image", "audio"])
def test_retrieval_embedding(setup, encoder_type):
    cfg, jax_model, params, model = setup
    inputs = {k: v for k, v in _inputs(cfg).items() if k in MODALITY_INPUTS[encoder_type]}
    got, want = _run_both(jax_model, params, model, encoder_type, **inputs)
    _close(got.numpy(), want)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("encoder_type", ["vl", "al", "val"])
def test_wrapper_features(setup, encoder_type):
    """Multi-modal concat paths: block-diagonal bias, per-modality FFN and
    final LN, features and padding masks split back per modality."""
    cfg, jax_model, params, model = setup
    keys = {"vl": ("src_tokens", "src_images"),
            "al": ("src_tokens", "src_audios", "audio_padding_masks"),
            "val": tuple(_inputs(cfg))}[encoder_type]
    inputs = {k: v for k, v in _inputs(cfg).items() if k in keys}
    jax_in = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = jax_model.wrapper(params["encoder_wrapper"], encoder_type=encoder_type,
                             return_padding_mask=True, **jax_in)
    with torch.no_grad():
        got = model.encoder_wrapper(encoder_type=encoder_type, return_padding_mask=True,
                                    **{k: torch.as_tensor(v) for k, v in inputs.items()})
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got[:3], want[:3]):
        if w is not None:
            _close(g.numpy(), w)
    for g, w in zip(got[3:], want[3:]):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("encoder_type,split_lens",
                         [("text", (12, 0, 0)), ("vl", (5, 7, 0)), ("val", (3, 5, 4))])
def test_encoder_layer(setup, encoder_type, split_lens):
    cfg, jax_model, params, model = setup
    rng = np.random.RandomState(3)
    l = sum(split_lens)
    x = rng.randn(2, l, cfg.encoder.embed_dim).astype(np.float32)
    bias = rng.randn(cfg.encoder.attention_heads, l, l).astype(np.float32) * 0.5
    pad = np.zeros((2, l), bool)
    pad[0, -2:] = True
    layer0 = jax.tree.map(lambda a: a[0], params["encoder_wrapper"]["fusion"]["layers"])
    want = jax_encoder_layer(layer0, cfg.encoder, jnp.asarray(x), jnp.asarray(pad),
                             jnp.asarray(bias), encoder_type, split_lens, 0.0)
    with torch.no_grad():
        got = model.encoder_wrapper.fusion.layers[0](
            torch.as_tensor(x), torch.as_tensor(pad), torch.as_tensor(bias),
            encoder_type, split_lens)
    _close(got.numpy(), want)


def test_per_layer_rel_tables():
    """copy_rel_pos_table=True: one rel table per layer flows through."""
    cfg = tiny_model_config(head_type="val", copy_rel_pos_table=True)
    jax_model, params, model = _pair(cfg, seed=4)
    assert model.encoder_wrapper.text_adapter.rel_pos_table.shape[0] == cfg.encoder.layers
    inputs = _inputs(cfg)
    for encoder_type in ("text", "audio"):
        sub = {k: v for k, v in inputs.items() if k in MODALITY_INPUTS[encoder_type]}
        got, want = _run_both(jax_model, params, model, encoder_type, **sub)
        _close(got.numpy(), want)


def test_alternate_attention_flags():
    """Per-head gains + post-attention LN, no Magneto LN, no LayerScale."""
    cfg = tiny_model_config(head_type="val")
    cfg.encoder.magneto_scale_attn = False
    cfg.encoder.scale_attn = True
    cfg.encoder.scale_heads = True
    cfg.encoder.use_layer_scale = False
    jax_model, params, model = _pair(cfg, seed=7)
    got, want = _run_both(jax_model, params, model, "text",
                          src_tokens=_inputs(cfg)["src_tokens"])
    _close(got.numpy(), want)


def test_image_pos_embed_resize():
    """A grid other than the native one resizes the pos embed bicubically
    (use_attn_bias off: the rel-pos grid is fixed to the native size)."""
    cfg = tiny_model_config(head_type="image").encoder.image_adapter
    cfg.use_attn_bias = False
    rng = np.random.RandomState(5)
    d = 32
    params = {"cls_embedding": rng.randn(1, 1, d), "pos_embed": rng.randn(5, d),
              "hmlp": {"conv1": {"w": rng.randn(4, 4, 3, 8), "b": rng.randn(8)},
                       "ln1": {"scale": rng.randn(8), "bias": rng.randn(8)},
                       "conv2": {"w": rng.randn(2, 2, 8, 8), "b": rng.randn(8)},
                       "ln2": {"scale": rng.randn(8), "bias": rng.randn(8)},
                       "conv3": {"w": rng.randn(2, 2, 8, d), "b": rng.randn(d)}}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    imgs = rng.randn(2, 3, 48, 48).astype(np.float32)
    want = JaxImageAdapter(cfg, d, 4)(to_jax(params), jnp.asarray(imgs))
    adapter = ImageAdapter(cfg, d, 4)
    adapter.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = adapter(torch.as_tensor(imgs))
    assert got[0].shape == (2, 10, d) and got[2] is None
    _close(got[0].numpy(), want[0])
    assert not got[1].any()


def test_random_weights_give_unit_embeddings():
    cfg = tiny_model_config(head_type="val")
    models = []
    for _ in range(2):
        model = OnePeaceRetrievalModel(cfg)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
        fill_random_(model, torch.Generator().manual_seed(0))
        assert all(torch.isfinite(p).all() for p in model.parameters())
        models.append(model)
    for (name, a), (_, b) in zip(models[0].state_dict().items(),
                                 models[1].state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    model = models[0]
    assert model.encoder_wrapper.fusion.layers[1].gamma_2.eq(0.1).all()
    assert model.encoder_wrapper.text_adapter.embed_tokens[1].eq(0).all()
    assert abs(model.logit_scale_exp().item() - 1 / 0.07) < 1e-3
    inputs = _inputs(cfg)
    with torch.no_grad():
        for encoder_type, keys in MODALITY_INPUTS.items():
            out = model(encoder_type=encoder_type,
                        **{k: torch.as_tensor(inputs[k]) for k in keys})
            assert torch.isfinite(out).all()
            torch.testing.assert_close(out.norm(dim=-1), torch.ones(2))


def test_logit_scale_exp_matches_jax(setup):
    cfg, jax_model, params, model = setup
    for value in (math.log(1 / 0.07), 5.0, -1.0):
        with torch.no_grad():
            model.logit_scale.fill_(value)
        want = jax_model.logit_scale_exp({"logit_scale": jnp.float32(value)})
        assert abs(model.logit_scale_exp().item() - float(want)) < 1e-4
    with torch.no_grad():
        model.logit_scale.fill_(math.log(1 / 0.07))


def test_inference_only_and_unknown_types_raise(setup):
    """``deterministic=False`` trains now: without a generator and at zero
    rates it is the inference output, and a dropout it cannot draw raises.
    Unknown encoder types raise."""
    cfg, jax_model, params, model = setup
    tokens = torch.as_tensor(_inputs(cfg)["src_tokens"])
    with torch.no_grad():
        torch.testing.assert_close(
            model(src_tokens=tokens, encoder_type="text", deterministic=False),
            model(src_tokens=tokens, encoder_type="text"), rtol=0, atol=0)
        model.encoder_wrapper.text_adapter.cfg.dropout = 0.1
        try:
            with pytest.raises(ValueError):
                model(src_tokens=tokens, encoder_type="text", deterministic=False)
        finally:
            model.encoder_wrapper.text_adapter.cfg.dropout = 0.0
    with pytest.raises(NotImplementedError):
        model.encoder_wrapper(src_tokens=tokens, encoder_type="bogus")
    with pytest.raises(NotImplementedError):
        model(src_tokens=tokens, encoder_type="vl")


def test_cpu_model_never_launches(setup):
    cfg, jax_model, params, model = setup
    before = tfa.launches
    with torch.no_grad():
        model(src_tokens=torch.as_tensor(_inputs(cfg)["src_tokens"]), encoder_type="text")
    assert model.cfg.encoder.attn_impl == "pallas" and tfa.launches == before
