"""The port imports nothing of the JAX package, and its copies of that
package's JAX-free host modules stay equal to the originals: the config
dataclasses and ``load_config``, the BPE tokenizer, the FLAC reader, the
interpolation matrices and the fairseq conversion rules."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import tiny_model_config
from torch_fixture import make_random_state_dict

from one_peace_tpu.core import config as jax_config
from one_peace_tpu.data import flac as jax_flac
from one_peace_tpu.data import tokenizer as jax_tokenizer
from one_peace_tpu.utils import checkpoint_convert as jax_convert
from one_peace_tpu.utils import interpolate as jax_interpolate
from one_peace_tpu_torch.core import config as port_config
from one_peace_tpu_torch.data import flac as port_flac
from one_peace_tpu_torch.data import tokenizer as port_tokenizer
from one_peace_tpu_torch.utils import checkpoint_convert as port_convert
from one_peace_tpu_torch.utils import interpolate as port_interpolate

ROOT = Path(__file__).resolve().parents[1]
RECIPES = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("recipes/**/*.yaml"))
CONFIG_CLASSES = sorted(
    name for name, obj in vars(jax_config).items()
    if dataclasses.is_dataclass(obj) and obj.__module__ == jax_config.__name__)


def test_port_imports_nothing_of_the_jax_package():
    """In a fresh interpreter, importing every module of the port leaves no
    ``jax``, ``one_peace_tpu`` or ``one_peace_tpu.*`` in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import one_peace_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'one_peace_tpu' or m.startswith('one_peace_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    # every module was walked: the vision slice's, the data, task, metric,
    # checkpoint and CLI modules of the retrieval fine-tuning slice, and the
    # COCO dataset and mask paste of detection from data
    assert count >= 65, proc.stdout


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_equal(name):
    jax_cls, port_cls = getattr(jax_config, name), getattr(port_config, name)
    jax_fields = [(f.name, str(f.type)) for f in dataclasses.fields(jax_cls)]
    port_fields = [(f.name, str(f.type)) for f in dataclasses.fields(port_cls)]
    assert port_fields == jax_fields
    assert port_config.to_dict(port_cls()) == jax_config.to_dict(jax_cls())


@pytest.mark.parametrize("recipe", RECIPES)
def test_load_config_equal_on_recipes(recipe):
    overrides = ["optimization.lr=3e-5", "model.encoder.layers=4"]
    got = port_config.to_dict(port_config.load_config(str(ROOT / recipe), overrides))
    want = jax_config.to_dict(jax_config.load_config(str(ROOT / recipe), overrides))
    assert got == want


def test_config_coercion_errors_equal():
    for module in (port_config, jax_config):
        with pytest.raises(ValueError, match="dataset.batch_size|batch_size"):
            module.load_config(None, ["dataset.batch_size=1o0"])
        with pytest.raises(KeyError):
            module.load_config(None, ["model.no_such_key=1"])


def write_merging_bpe_dir(path: Path) -> str:
    """A byte-level BPE set with merges ("t h" -> "th", "th e" -> "the",
    "Ġ t" -> "Ġt", "Ġt he"...) and a dict.txt over every encoder id."""
    symbols = jax_tokenizer.bytes_to_unicode()
    encoder = {symbols[b]: b for b in range(256)}
    merges = [("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"), ("Ġ", "a"), ("o", "g")]
    for a, b in merges:
        encoder[a + b] = len(encoder)
    path.mkdir(parents=True, exist_ok=True)
    (path / "encoder.json").write_text(json.dumps(encoder))
    (path / "vocab.bpe").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    (path / "dict.txt").write_text("".join(f"{i} 1\n" for i in range(len(encoder))))
    return str(path)


@pytest.mark.parametrize("merges", [False, True])
def test_tokenizer_equal(tmp_path, merges):
    """``encode_batch`` on the byte-level BPE set the hub tests use, and on
    one with merges."""
    from chip_smoke import write_bpe_dir

    bpe = (write_merging_bpe_dir if merges else write_bpe_dir)(tmp_path / "bpe")
    texts = ["The dog, the cat and THE theatre", "a  tag 'twas 42 dogs!", "",
             "x" * 300, "naïve café — 東京"]
    for max_len in (70, 8):
        got = port_tokenizer.TextTokenizer(bpe, max_src_length=max_len).encode_batch(texts)
        want = jax_tokenizer.TextTokenizer(bpe, max_src_length=max_len).encode_batch(texts)
        np.testing.assert_array_equal(got, want)
    assert port_tokenizer.bytes_to_unicode() == jax_tokenizer.bytes_to_unicode()
    assert port_tokenizer.find_bpe_dir(bpe) == jax_tokenizer.find_bpe_dir(bpe)


def test_flac_reader_rejects_what_the_original_rejects():
    """Both builds of native/flac_decoder.cpp refuse malformed input with
    the same ValueError (the port's library lives under build/)."""
    assert "build" in Path(port_flac._SO).parts
    for data in (b"", b"fLaC", b"fLaC" + bytes(60), b"RIFF" + bytes(40)):
        errors = []
        for module in (port_flac, jax_flac):
            with pytest.raises(ValueError) as info:
                module.decode_flac_bytes(data)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("src,dst", [(16, 16), (16, 32), (16, 64), (32, 16), (7, 5), (2, 9)])
def test_interpolate_matrices_equal(src, dst):
    np.testing.assert_array_equal(port_interpolate.bicubic_resize_matrix(src, dst),
                                  jax_interpolate.bicubic_resize_matrix(src, dst))
    pos = np.random.RandomState(src * 100 + dst).randn(src * src, 6).astype(np.float32)
    np.testing.assert_array_equal(port_interpolate.resize_pos_embed_2d(pos, src, dst),
                                  jax_interpolate.resize_pos_embed_2d(pos, src, dst))


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_tree_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("rule", ["text", "image", "audio", "layers", "upgrade", "resolution",
                                  "load"])
def test_conversion_rules_equal(rule, tmp_path):
    cfg = tiny_model_config(head_type="val")
    sd = make_random_state_dict(cfg, seed=3)
    pre, enc = "encoder_wrapper", cfg.encoder
    if rule == "text":
        _assert_tree_equal(port_convert.convert_text_adapter(sd, f"{pre}.text_adapter"),
                           jax_convert.convert_text_adapter(sd, f"{pre}.text_adapter"))
    elif rule == "image":
        _assert_tree_equal(port_convert.convert_image_adapter(sd, f"{pre}.image_adapter"),
                           jax_convert.convert_image_adapter(sd, f"{pre}.image_adapter"))
    elif rule == "audio":
        args = (f"{pre}.audio_adapter", len(enc.audio_adapter.feature_encoder_spec),
                enc.audio_adapter.conv_pos_depth)
        _assert_tree_equal(port_convert.convert_audio_adapter(sd, *args),
                           jax_convert.convert_audio_adapter(sd, *args))
    elif rule == "layers":
        for i in range(enc.layers):
            name = f"{pre}.fusion_model.layers.{i}"
            _assert_tree_equal(port_convert.convert_encoder_layer(sd, name),
                               jax_convert.convert_encoder_layer(sd, name))
        _assert_tree_equal(port_convert._lin(sd, "image_proj"), jax_convert._lin(sd, "image_proj"))
        _assert_tree_equal(port_convert._ln(sd, f"{pre}.fusion_model.image_layer_norm"),
                           jax_convert._ln(sd, f"{pre}.fusion_model.image_layer_norm"))
    elif rule == "upgrade":
        legacy = {k.replace("rel_pos_table_list.0.weight", "rel_pos_table.weight"): v
                  for k, v in sd.items()}
        for n in (1, enc.layers):
            _assert_tree_equal(port_convert.upgrade_state_dict(legacy, n),
                               jax_convert.upgrade_state_dict(legacy, n))
    elif rule == "resolution":
        got, want = dict(sd), dict(sd)
        port_convert.upgrade_image_adapter_resolution(got, f"{pre}.image_adapter", 4, 3)
        jax_convert.upgrade_image_adapter_resolution(want, f"{pre}.image_adapter", 4, 3)
        assert got[f"{pre}.image_adapter.pos_embed"].shape[0] == 17
        _assert_tree_equal(got, want)
    else:
        path = tmp_path / "model.pt"
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
        _assert_tree_equal(port_convert.load_torch_state_dict(str(path)),
                           jax_convert.load_torch_state_dict(str(path)))
