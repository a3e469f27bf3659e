"""Weights carried from the JAX package into one_peace_tpu_torch:
``params_from_jax`` on a fresh JAX init tree, and the JAX package's flat
``.npz`` export read back by ``load_npz`` in fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as tf
from helpers import tiny_model_config

from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu.utils.native_checkpoint import save_params
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.utils.checkpoint import load_npz, params_from_jax


@pytest.mark.parametrize("copy_rel_pos_table", [False, True])
def test_jax_init_tree_loads_strictly(copy_rel_pos_table):
    """Every leaf of the JAX package's own init maps onto exactly one port
    parameter of the same size, laid out as PyTorch lays it out."""
    cfg = tiny_model_config(head_type="val", copy_rel_pos_table=copy_rel_pos_table)
    tree = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    sd = params_from_jax(tree)
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(sd, strict=True)
    layer = tree["encoder_wrapper"]["fusion"]["layers"]
    np.testing.assert_array_equal(
        sd["encoder_wrapper.fusion.layers.1.self_attn.q_proj.weight"].numpy(),
        layer["self_attn"]["q_proj"]["w"][1].T)
    conv = tree["encoder_wrapper"]["image_adapter"]["hmlp"]["conv1"]["w"]
    np.testing.assert_array_equal(
        sd["encoder_wrapper.image_adapter.hmlp.conv1.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    pos = tree["encoder_wrapper"]["audio_adapter"]["pos_convs"][0]["w"]
    np.testing.assert_array_equal(
        sd["encoder_wrapper.audio_adapter.pos_convs.0.weight"].numpy(), pos.transpose(2, 1, 0))
    assert sd["logit_scale"].shape == ()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_save_params_load_npz_round_trip(tmp_path, dtype):
    cfg = tiny_model_config(head_type="val")
    tree = convert_retrieval_model(tf.make_random_state_dict(cfg, seed=3), cfg)
    path = str(tmp_path / "params.npz")
    save_params(path, to_jax(tree, dtype), metadata={"note": "round trip"})
    got = load_npz(path)
    want = params_from_jax(jax.tree.map(np.asarray, to_jax(tree, dtype)))
    assert got.keys() == want.keys()
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    for name, tensor in got.items():
        assert tensor.dtype == tdtype, name
        torch.testing.assert_close(tensor, want[name], rtol=0, atol=0, msg=name)
    model = OnePeaceRetrievalModel(cfg, dtype=tdtype)
    model.load_state_dict(got, strict=True)
    tokens = torch.tensor([[5, 6, 7, 1, 1]])
    with torch.no_grad():
        out = model(src_tokens=tokens, encoder_type="text")
    assert out.dtype == tdtype and torch.isfinite(out.float()).all()


def _flag_variants():
    plain = tiny_model_config(head_type="val")
    embed = tiny_model_config(head_type="val")
    for ad in (embed.encoder.text_adapter, embed.encoder.image_adapter,
               embed.encoder.audio_adapter):
        ad.layernorm_embedding = True
        ad.add_type_embedding = True
    mlp = tiny_model_config(head_type="val")
    mlp.encoder.image_adapter.vision_encoder_type = "mlp"
    return {"released": plain, "embed_ln_and_type": embed, "mlp_stem": mlp}


@pytest.mark.parametrize("variant", ["released", "embed_ln_and_type", "mlp_stem"])
def test_jax_init_tree_forward_matches(variant):
    """The JAX package's own init (LayerScale raised to 0.1 and random
    rel-pos tables, so every layer shows) through both packages: covers
    the embedding LayerNorm, type embeddings and the 'mlp' patch stem."""
    cfg = _flag_variants()[variant]
    jax_model = JaxModel(cfg)
    tree = jax.tree.map(np.array, jax_model.init(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)
    layers = tree["encoder_wrapper"]["fusion"]["layers"]
    layers["gamma_1"][:] = layers["gamma_2"][:] = 0.1
    for name in ("text_adapter", "image_adapter", "audio_adapter"):
        table = tree["encoder_wrapper"][name]
        table["rel_pos_table"] = rng.randn(*table["rel_pos_table"].shape).astype(np.float32) * 0.05
        if "type_embedding" in table:
            table["type_embedding"] = rng.randn(*table["type_embedding"].shape).astype(np.float32)
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    params = to_jax(tree)
    inputs = {"text": {"src_tokens": np.array([[5, 6, 7, 1], [8, 9, 10, 11]])},
              "image": {"src_images": rng.randn(2, 3, 32, 32).astype(np.float32)},
              "audio": {"src_audios": rng.randn(2, 60).astype(np.float32),
                        "audio_padding_masks": np.zeros((2, 15), bool)}}
    for encoder_type, kwargs in inputs.items():
        want = np.asarray(jax_model(params, encoder_type=encoder_type,
                                    **{k: jnp.asarray(v) for k, v in kwargs.items()}))
        with torch.no_grad():
            got = model(encoder_type=encoder_type,
                        **{k: torch.as_tensor(v) for k, v in kwargs.items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=encoder_type)
