"""The port imports nothing of the JAX package, and its copies of that
package's JAX-free host modules stay equal to the originals: the config
dataclasses and ``load_config``, the BPE tokenizer, the FLAC reader, the
interpolation matrices, the fairseq conversion rules (the classify model's
among them), the classification data path's verbatim copies (Mixup,
RandAugment, the VQA, VGGSound and image-classify datasets), whose
behaviour ``tests/test_torch_port_classify_data.py`` also holds equal, and
the pretrain data path's (the masking helpers and both pretrain datasets),
whose behaviour ``tests/test_torch_port_pretrain_data.py`` holds equal, and
the segmentation path's (the ADE20K dataset, the reference points, the
adaptive-pool matrix, the sine encoding, the slide window grid), whose
behaviour ``tests/test_torch_port_seg_*.py`` hold equal, and the video
path's (the rawframe dataset with its colour jitter, the sub-grid token
indices), whose behaviour ``tests/test_torch_port_video_*.py`` hold equal,
and the host leftovers: the BLEU scorer and the edit distance (their native
libraries built under ``build/native/``), the layer-diff harness and the
watchdog, each held to the same scores, distances, reports or source."""

import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_model_config
from torch_fixture import make_random_state_dict

from one_peace_tpu.core import config as jax_config
from one_peace_tpu.data import datasets as jax_datasets
from one_peace_tpu.data import flac as jax_flac
from one_peace_tpu.data import masking as jax_masking
from one_peace_tpu.data import mixup as jax_mixup
from one_peace_tpu.data import randaugment as jax_randaugment
from one_peace_tpu.data import tokenizer as jax_tokenizer
from one_peace_tpu.utils import checkpoint_convert as jax_convert
from one_peace_tpu.utils import interpolate as jax_interpolate
from one_peace_tpu.data import vision_datasets as jax_vision_datasets
from one_peace_tpu.metrics import bleu as jax_bleu
from one_peace_tpu.metrics import edit_distance as jax_edit_distance
from one_peace_tpu.utils import diff_harness as jax_diff_harness
from one_peace_tpu.utils import watchdog as jax_watchdog
from one_peace_tpu.vision import adapter as jax_adapter
from one_peace_tpu.vision import mask2former as jax_mask2former
from one_peace_tpu.vision import upernet as jax_upernet
from one_peace_tpu.vision import video_backbone as jax_video_backbone
from one_peace_tpu.vision import zoo as jax_zoo
from one_peace_tpu_torch.core import config as port_config
from one_peace_tpu_torch.data import datasets as port_datasets
from one_peace_tpu_torch.data import flac as port_flac
from one_peace_tpu_torch.data import masking as port_masking
from one_peace_tpu_torch.data import mixup as port_mixup
from one_peace_tpu_torch.data import randaugment as port_randaugment
from one_peace_tpu_torch.data import tokenizer as port_tokenizer
from one_peace_tpu_torch.utils import checkpoint_convert as port_convert
from one_peace_tpu_torch.utils import interpolate as port_interpolate
from one_peace_tpu_torch.data import vision_datasets as port_vision_datasets
from one_peace_tpu_torch.metrics import bleu as port_bleu
from one_peace_tpu_torch.metrics import edit_distance as port_edit_distance
from one_peace_tpu_torch.utils import diff_harness as port_diff_harness
from one_peace_tpu_torch.utils import watchdog as port_watchdog
from one_peace_tpu_torch.vision import adapter as port_adapter
from one_peace_tpu_torch.vision import mask2former as port_mask2former
from one_peace_tpu_torch.vision import upernet as port_upernet
from one_peace_tpu_torch.vision import video_backbone as port_video_backbone
from one_peace_tpu_torch.vision import zoo as port_zoo

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
        "print(len(names), bad, 'one_peace_tpu_torch.models.classify' in names,\n"
        "      'one_peace_tpu_torch.models.pretrain' in names,\n"
        "      'one_peace_tpu_torch.data.masking' in names,\n"
        "      all(f'one_peace_tpu_torch.vision.{m}' in names for m in\n"
        "          ('adapter', 'mask2former', 'ms_deform_attn', 'upernet', 'video_backbone'))\n"
        "      and all(f'one_peace_tpu_torch.{m}' in names for m in\n"
        "          ('parallel.mesh', 'parallel.sharding', 'parallel.data', 'metrics.gather',\n"
        "           'metrics.bleu', 'metrics.edit_distance', 'utils.watchdog',\n"
        "           'utils.diff_harness')))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    # every module was walked: the vision slice's, the data, task, metric,
    # checkpoint and CLI modules of the retrieval fine-tuning slice, the
    # COCO dataset and mask paste of detection from data, the classify
    # model with the Mixup and RandAugment copies, and the pretrain model
    # with the masking copy, the segmentation modules and the video trunk
    assert count >= 75, proc.stdout
    assert proc.stdout.split()[-4:] == ["True"] * 4, proc.stdout


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


VERBATIM_COPIES = [
    (port_mixup, jax_mixup, "one_hot"), (port_mixup, jax_mixup, "rand_bbox"),
    (port_mixup, jax_mixup, "rand_bbox_minmax"), (port_mixup, jax_mixup, "Mixup"),
    (port_randaugment, jax_randaugment, "apply_op"),
    (port_randaugment, jax_randaugment, "RandomAugment"),
    (port_randaugment, jax_randaugment, "RandomDistortion"),
    (port_randaugment, jax_randaugment, "GaussianBlur"),
    (port_datasets, jax_datasets, "VqaDataset"), (port_datasets, jax_datasets, "VggsoundDataset"),
    (port_datasets, jax_datasets, "ImageClassifyDataset"),
    (port_datasets, jax_datasets, "Nlvr2Dataset"), (port_datasets, jax_datasets, "RefCOCODataset"),
    (port_datasets, jax_datasets, "Fsd50kDataset"), (port_datasets, jax_datasets, "AqaDataset"),
    (port_datasets, jax_datasets, "ImageTextPretrainDataset"),
    (port_datasets, jax_datasets, "AudioTextPretrainDataset")] + [
    (port_masking, jax_masking, name) for name in (
        "whole_word_starts", "add_whole_word_mask", "nested_subset_mask", "random_patch_mask",
        "superset_patch_mask", "compute_block_mask_1d", "to_preserve_ids", "with_cls")] + [
    (port_vision_datasets, jax_vision_datasets, "Ade20kSegDataset"),
    (port_adapter, jax_adapter, "get_reference_points"),
    (port_upernet, jax_upernet, "_adaptive_pool_matrix"),
    (port_mask2former, jax_mask2former, "sine_positional_encoding")] + [
    (port_vision_datasets, jax_vision_datasets, name) for name in (
        "RawframeVideoDataset", "_jitter_brightness_contrast_saturation", "_jitter_hue")] + [
    (port_video_backbone, jax_video_backbone, "subgrid_token_indices")] + [
    (port_watchdog, jax_watchdog, name) for name in ("WatchdogTimeout", "Watchdog", "_Guard")] + [
    (port_diff_harness, jax_diff_harness, name)
    for name in ("diff_layer_states", "first_divergence")] + [
    (port_bleu, jax_bleu, name) for name in ("_BleuStat", "BleuScorer")] + [
    (port_edit_distance, jax_edit_distance, name)
    for name in ("edit_distance", "edit_distance_batch", "edit_alignment")]


@pytest.mark.parametrize("port,original,name", VERBATIM_COPIES,
                         ids=[f"{o.__name__.rsplit('.', 1)[-1]}.{n}" for _, o, n in VERBATIM_COPIES])
def test_verbatim_copies_equal(port, original, name):
    """The classification, pretrain, segmentation and video paths' copies
    keep the original's source."""
    assert inspect.getsource(getattr(port, name)) == inspect.getsource(getattr(original, name))


def test_slide_origins_copy_equal():
    """The segmenters' slide window grid keeps the original's source."""
    assert inspect.getsource(port_zoo.OnePeaceSegmenter._slide_origins) == \
        inspect.getsource(jax_zoo.OnePeaceSegmenter._slide_origins)


@pytest.mark.parametrize("rule", ["text", "image", "audio", "layers", "upgrade", "resolution",
                                  "load", "classify"])
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
    elif rule == "classify":
        from torch_fixture import add_classify_head_state

        from one_peace_tpu_torch.utils.checkpoint import params_from_jax

        for head, kw in (("image", dict(attn_pooling=True, use_pooler=True)), ("audio", {})):
            cfg = tiny_model_config(head_type=head)
            sd = add_classify_head_state(make_random_state_dict(cfg, seed=3), cfg, 7, **kw)
            got = port_convert.convert_classify_model(dict(sd), cfg)
            want = params_from_jax(jax_convert.convert_classify_model(dict(sd), cfg))
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())
            _assert_tree_equal(port_convert.convert_classify_head(sd),
                               jax_convert.convert_classify_model(dict(sd), cfg)["classify_head"])
    else:
        path = tmp_path / "model.pt"
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
        _assert_tree_equal(port_convert.load_torch_state_dict(str(path)),
                           jax_convert.load_torch_state_dict(str(path)))


def _sequences(rs, n, low=4, high=30):
    return [rs.randint(0, 12, rs.randint(low, high)).tolist() for _ in range(n)]


def test_bleu_copy_scores_equal():
    """Corpus BLEU of seeded token sequences, every order and smoothing; the
    port's library is built under build/."""
    assert "build" in Path(port_bleu._SO).parts
    rs = np.random.RandomState(0)
    refs, preds = _sequences(rs, 20), _sequences(rs, 20)
    preds[3] = refs[3]  # one exact match
    preds[5] = [1, 2]  # shorter than every order but two
    scorers = [module.BleuScorer() for module in (port_bleu, jax_bleu)]
    for scorer in scorers:
        for ref, pred in zip(refs, preds):
            scorer.add(ref, pred)
    got, want = scorers
    assert got.precisions() == want.precisions() and got.brevity() == want.brevity()
    for order in (1, 2, 4):
        for smooth in ("none", "exp", "add-1"):
            assert got.score(order, smooth) == want.score(order, smooth), (order, smooth)
    assert 0.0 < got.score(4, "exp") < 100.0


def test_edit_distance_copy_equal():
    """Distances one by one and batched (padded), and the alignments, of
    seeded sequences; the port's library is built under build/."""
    assert "build" in Path(port_edit_distance._SO).parts
    rs = np.random.RandomState(1)
    a, b = _sequences(rs, 16, 0, 12), _sequences(rs, 16, 0, 12)
    for x, y in zip(a, b):
        assert port_edit_distance.edit_distance(x, y) == jax_edit_distance.edit_distance(x, y)
        assert port_edit_distance.edit_alignment(x, y) == jax_edit_distance.edit_alignment(x, y)
    pad = 1
    width = max(len(s) for s in a + b) + 2
    pa = np.full((16, width), pad, np.int32)
    pb = np.full((16, width + 3), pad, np.int32)
    for i, (x, y) in enumerate(zip(a, b)):
        pa[i, :len(x)] = [v if v != pad else 0 for v in x]
        pb[i, :len(y)] = [v if v != pad else 0 for v in y]
    got = port_edit_distance.edit_distance_batch(pa, pb, pad_id=pad)
    np.testing.assert_array_equal(got, jax_edit_distance.edit_distance_batch(pa, pb, pad_id=pad))
    assert got.max() > 0


def test_diff_harness_copy_reports_equal():
    rs = np.random.RandomState(2)
    want = rs.randn(5, 3, 8)
    got = want + rs.randn(5, 3, 8) * np.array([0, 1e-7, 1e-3, 0.5, 2.0])[:, None, None]
    names = [f"layer{i}" for i in range(5)]
    reports = [m.diff_layer_states(got, want, names) for m in (port_diff_harness, jax_diff_harness)]
    assert reports[0] == reports[1]
    assert port_diff_harness.first_divergence(reports[0]) == \
        jax_diff_harness.first_divergence(reports[1]) == reports[0][3]
