"""The port's jax-free fairseq ``.pt`` conversion against the JAX package's:
``one_peace_tpu_torch.utils.checkpoint_convert.convert_retrieval_model``
equals ``params_from_jax(convert_retrieval_model(...))`` bit for bit, for the
released layout, the legacy rel-table key, the broadcast to per-layer tables
and a changed image resolution."""

import copy

import numpy as np
import pytest
import torch

import torch_fixture as tf
from helpers import tiny_model_config

from one_peace_tpu.utils.checkpoint_convert import (
    convert_retrieval_model as jax_convert,
    load_torch_state_dict,
)
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.utils.checkpoint_convert import convert_retrieval_model


def _variant(name):
    """(state dict, model config) for one conversion case."""
    cfg = tiny_model_config(head_type="val")
    sd = tf.make_random_state_dict(cfg, seed=3)
    if name == "legacy_rel_key":  # pre-list checkpoints: rel_pos_table.weight
        for key in [k for k in sd if k.endswith("rel_pos_table_list.0.weight")]:
            sd[key.replace("rel_pos_table_list.0.weight", "rel_pos_table.weight")] = sd.pop(key)
    elif name == "per_layer_tables":  # one shared table broadcast to every layer
        cfg = copy.deepcopy(cfg)
        cfg.copy_rel_pos_table = True
    elif name == "image_resolution":  # a 48 px model from a 32 px checkpoint
        cfg = copy.deepcopy(cfg)
        cfg.encoder.image_adapter.bucket_size = 3
        cfg.encoder.image_adapter.rel_bucket_size = 3
    return sd, cfg


VARIANTS = ["released", "legacy_rel_key", "per_layer_tables", "image_resolution"]


@pytest.mark.parametrize("name", VARIANTS)
def test_convert_matches_jax(name):
    sd, cfg = _variant(name)
    want = params_from_jax(jax_convert(dict(sd), cfg))
    got = convert_retrieval_model(dict(sd), cfg)
    assert got.keys() == want.keys()
    for key, value in got.items():
        assert value.dtype == torch.float32, key
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(got, strict=True)
    if name == "per_layer_tables":
        assert model.encoder_wrapper.text_adapter.rel_pos_table.shape[0] == cfg.encoder.layers
    if name == "image_resolution":
        assert model.encoder_wrapper.image_adapter.pos_embed.shape[0] == 3 * 3 + 1


def test_convert_consumes_the_state_dict_and_reads_pt(tmp_path):
    """A ``.pt`` saved by torch (fairseq's ``{"model": ...}``) read through
    ``load_torch_state_dict``; the converter pops the caller's entries."""
    sd, cfg = _variant("released")
    path = tmp_path / "tiny.pt"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}}, path)
    loaded = load_torch_state_dict(str(path))
    assert loaded.keys() == sd.keys()
    got = convert_retrieval_model(loaded, cfg)
    assert loaded == {}
    want = params_from_jax(jax_convert(sd, cfg))
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)
