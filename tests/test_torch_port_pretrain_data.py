"""Pretraining from files in the port against the JAX package, on CPU at
toy size, on one synthetic corpus (``chip_smoke.write_pretrain_corpus``:
JPEGs, WAV clips of 0.5-1.5 s, captions, both recipes' TSVs, a valid JSON
and a byte-level BPE set).

- Both pretrain datasets row by row (every mask, preserve id and the VL
  crop drawn from one ``RandomState`` in fetch order), and both tasks'
  first-epoch batches, bit-equal to the JAX tasks'.
- Validation: the VL task's Recall dict and embeddings against the JAX
  task's on one pretrain model; the AL task's against the JAX model run on
  the port's own batches (a clip's embedding depends on its padding, and
  the JAX evaluator pads to whole seconds).
- ``cli.train`` on the VL recipe against the JAX CLI from one ``.npz``
  (per-update losses within 1e-4, the same validation), its best export
  read by the JAX ``load_params``; then the AL stage-2 recipe restoring
  that export: the shared leaves carried bit-equal, ``logit_scale`` reset,
  and after two updates every frozen parameter bit-unchanged while the
  trainable ones moved."""

import json
import math

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import PRETRAIN_RECIPES, write_pretrain_corpus
from one_peace_tpu.cli import train as jax_train
from one_peace_tpu.core.config import load_config as jax_load_config
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.models.pretrain import OnePeacePretrainModel as JaxModel
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch.cli import train
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.models.pretrain import OnePeacePretrainModel
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_port_pretrain_model import redraw
from test_torch_port_retrieval_data import AUDIO_SPEC, _host_embeddings

LOSS_TOL, EMB_TOL = 1e-4, 1e-4
RECALL_KEYS = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "txt_count")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_pretrain_corpus(tmp_path_factory.mktemp("pretrain_corpus"), 12, 6, (0.5, 1.5))


def toy_overrides(stage):
    """Both towers at toy size: the encoder of ``helpers.tiny_model_config``
    and a 2-layer decoder 16 wide over 2 heads."""
    spec = str(AUDIO_SPEC).replace(" ", "")
    return ["model.encoder.embed_dim=32", "model.encoder.ffn_embed_dim=64",
            "model.encoder.layers=2", "model.encoder.attention_heads=4",
            "model.encoder.text_adapter.bucket_size=8", "model.encoder.image_adapter.bucket_size=2",
            f"model.encoder.audio_adapter.feature_encoder_spec={spec}",
            "model.encoder.audio_adapter.feature_embed_dim=16",
            "model.encoder.audio_adapter.bucket_size=8",
            "model.encoder.audio_adapter.conv_pos_depth=2",
            "model.encoder.audio_adapter.conv_pos_width=6",
            "model.encoder.audio_adapter.conv_pos_groups=4",
            "model.encoder.drop_path_rate=0.0", "model.encoder.checkpoint_activations=false",
            "model.decoder.embed_dim=16", "model.decoder.ffn_embed_dim=32",
            "model.decoder.attention_heads=2"]


def overrides(corpus, stage, save_dir, **extra):
    ov = {"task.data": corpus[stage]["train"], "task.valid_data": corpus[stage]["valid"],
          "task.valid_file": corpus["valid_json"], "task.bpe_dir": corpus["bpe"],
          "task.patch_image_size": "32", "common.bf16": "false", "common.log_interval": "1",
          "common.seed": "7", "common.log_file": f"{save_dir}/log.jsonl",
          "optimization.lr": "2e-3", "optimization.max_update": "3",
          "lr_scheduler.warmup_updates": "1", "lr_scheduler.warmup_ratio": "0.0",
          "dataset.batch_size": "8", "dataset.batch_size_valid": "4",
          "checkpoint.save_dir": f"{save_dir}/ckpt", "checkpoint.save_interval": "1000",
          "distributed.fsdp": "1", "distributed.tp": "1"}
    ov.update({k.replace("__", "."): str(v) for k, v in extra.items()})
    return ["--config", str(PRETRAIN_RECIPES[stage]), *toy_overrides(stage),
            *(f"{k}={v}" for k, v in ov.items())]


def framework_cfg(corpus, stage, tmp_path):
    argv = overrides(corpus, stage, tmp_path)
    cfg = jax_load_config(argv[1], argv[2:])
    cfg.model.encoder.image_adapter.rel_bucket_size = 2
    cfg.model.encoder.text_adapter.vocab_size = 260  # the BPE set's dict + 4 specials
    cfg.model.encoder.attn_impl = cfg.model.decoder.attn_impl = "xla"
    return cfg


def read_log(path, tag):
    return [line for line in map(json.loads, open(path)) if line["tag"] == tag]


@pytest.mark.parametrize("stage", ["vl", "al"])
def test_pretrain_dataset_rows_equal(corpus, stage, tmp_path):
    cfg = framework_cfg(corpus, stage, tmp_path)
    datasets = []
    for build in (build_task, jax_build_task):
        task = build(cfg.task, cfg)
        datasets.append(task.load_dataset("train"))
    assert type(datasets[0]).__name__ == ("ImageTextPretrainDataset" if stage == "vl"
                                          else "AudioTextPretrainDataset")
    for index in (0, 3, 1, 1, 11):
        got, want = datasets[0][index], datasets[1][index]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
        assert (got["text_preserve_ids" if stage == "vl" else "al_text_preserve_ids"] == 0).any()


@pytest.mark.parametrize("stage", ["vl", "al"])
def test_pretrain_task_batches_equal(corpus, stage, tmp_path):
    """The first epoch's batches, every key, -1 padded preserve ids and
    False padded masks included; validation runs the retrieval dataset."""
    cfg = framework_cfg(corpus, stage, tmp_path)
    iters, valid = [], []
    for build in (build_task, jax_build_task):
        task = build(cfg.task, cfg)
        task.load_dataset("train")
        valid.append(type(task.load_dataset("valid")).__name__)
        iters.append(task.get_batch_iterator("train", 5, seed=4))
    assert valid[0] == valid[1] == ("ImageTextRetrievalDataset" if stage == "vl"
                                    else "AudioTextRetrievalDataset")
    n = 0
    for got, want in zip(iters[0].next_epoch_itr(), iters[1].next_epoch_itr(), strict=True):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        ids = got["text_preserve_ids" if stage == "vl" else "audio_preserve_ids"]
        n += int((ids == -1).any())
    assert n > 0  # ragged preserve ids were padded


def _pretrain_pair(cfg, seed=3):
    jax_model = JaxModel(cfg.model)
    params = redraw(jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed))),
                    np.random.RandomState(seed))
    model = OnePeacePretrainModel(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return jax_model, params, model


@pytest.mark.parametrize("stage", ["vl", "al"])
def test_pretrain_validation_matches_jax(corpus, stage, tmp_path):
    cfg = framework_cfg(corpus, stage, tmp_path)
    jax_model, params, model = _pretrain_pair(cfg)
    task = build_task(cfg.task, cfg)
    task.load_dataset("valid")
    task.begin_valid_epoch(model, None)
    batches = list(task.get_batch_iterator("valid", 4, ensure_equal_batch=False).next_epoch_itr())
    for batch in batches:
        task.valid_step(model, None, batch)
    got_text = _host_embeddings(task.metric.text_logits)
    got_other = _host_embeddings(task.metric.image_logits_list)
    stats = task.merge_results()
    side = "img" if stage == "vl" else "audio"
    assert stats[f"{side}_count"] == 6 and stats["txt_count"] == 30

    # the JAX model on the same inputs
    text = [np.asarray(jax_model(params, src_tokens=tokens, encoder_type="text")[0])
            for tokens in (task.tokenizer.encode_batch(task.texts[i:i + 50])
                           for i in range(0, len(task.texts), 50))]
    other, ids = [], []
    for batch in batches:
        inputs = ({"src_images": batch["src_images"]} if stage == "vl" else
                  {"src_audios": batch["src_audios"],
                   "audio_padding_masks": batch["audio_padding_masks"]})
        other.append(np.asarray(jax_model(params, **inputs, encoder_type=
                                          "image" if stage == "vl" else "audio")[0]))
        ids.append(batch["id"])
    assert np.abs(got_text - np.concatenate(text)).max() <= EMB_TOL
    assert np.abs(got_other - np.concatenate(other)).max() <= EMB_TOL
    reference = jax_metrics.Recall()
    reference.initialize(np.asarray(task.text_ids), [np.concatenate(text)])
    reference.compute(np.concatenate(ids), np.concatenate(other))
    want = reference.merge_results()
    assert stats == {(side + k[3:] if k.startswith("img") else k): v for k, v in want.items()}
    if stage == "vl":  # and the JAX task itself
        jtask = jax_build_task(cfg.task, cfg)
        jtask.load_dataset("valid")
        jtask.begin_valid_epoch(jax_model, params)
        for batch in jtask.get_batch_iterator("valid", 4, ensure_equal_batch=False) \
                .next_epoch_itr():
            jtask.valid_step(jax_model, params, batch)
        assert jtask.merge_results() == stats


@pytest.fixture(scope="module")
def vl_runs(corpus, tmp_path_factory):
    """The VL recipe through both CLIs from one .npz of the JAX init (3
    updates of 8 pairs over two epochs of 12, validation and the best
    export at each epoch's end)."""
    root = tmp_path_factory.mktemp("vl_runs")
    cfg = framework_cfg(corpus, "vl", root)
    init = root / "init.npz"
    tree = redraw(jax.tree.map(np.asarray, JaxModel(cfg.model).init(jax.random.PRNGKey(11))),
                  np.random.RandomState(11))
    jax_ckpt.save_params(str(init), tree)
    out = {"init": init}
    for name, main, extra in (("port", train.main, ["--device", "cpu"]),
                              ("jax", jax_train.main, [])):
        save_dir = root / name
        argv = overrides(corpus, "vl", save_dir, checkpoint__restore_file=init,
                         model__encoder__attn_impl="xla", model__decoder__attn_impl="xla")
        assert main(extra + argv) == 0
        out[name] = save_dir
    jax_ckpt.wait_for_saves()
    return out


def test_vl_cli_matches_jax(vl_runs):
    logs = {name: vl_runs[name] / "log.jsonl" for name in ("port", "jax")}
    inner = {name: read_log(path, "train_inner") for name, path in logs.items()}
    assert [x["step"] for x in inner["port"]] == [x["step"] for x in inner["jax"]] == [1, 2, 3]
    for got, want in zip(inner["port"], inner["jax"]):
        for key in ("loss", "itc_loss", "dcl_text_loss", "dcl_image_loss", "dcl_vl_text_loss",
                    "dcl_vl_image_loss", "lr"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_TOL, abs=LOSS_TOL), (key, got)
    valid = {name: read_log(path, "valid") for name, path in logs.items()}
    assert len(valid["port"]) == len(valid["jax"]) == 2  # at each epoch's end
    for got, want in zip(valid["port"], valid["jax"]):
        assert {k: got[k] for k in RECALL_KEYS} == {k: want[k] for k in RECALL_KEYS}
    best = str(vl_runs["port"] / "ckpt" / "checkpoint_best.npz")
    ours, theirs = ckpt._flatten(ckpt.load_params(best)), jax_ckpt._flatten(
        jax_ckpt.load_params(best))
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(theirs[key]), err_msg=key)
    jax_best = jax_ckpt._flatten(jax_ckpt.load_params(
        str(vl_runs["jax"] / "ckpt" / "checkpoint_best.npz")))
    assert sorted(jax_best) == sorted(theirs)  # the same tree as the JAX CLI's export


def test_al_stage2_from_the_vl_export(corpus, vl_runs, tmp_path):
    """The AL recipe (stage2_pretrain, reset_logit_scale) restoring the
    port's VL export: ``load_weights`` carries every leaf the two trees
    share bit for bit and resets ``logit_scale``; two updates through
    ``cli.train`` leave every frozen parameter bit-unchanged and move the
    trainable ones."""
    best = vl_runs["port"] / "ckpt" / "checkpoint_best.npz"
    stage1 = params_from_jax(ckpt.load_params(str(best)))
    argv = overrides(corpus, "al", tmp_path, checkpoint__restore_file=best,
                     optimization__max_update=2)
    cfg = load_config(argv[1], argv[2:])
    task = build_task(cfg.task, cfg)
    model = train.build_model_for_task(cfg, task, device="cpu")
    train.load_weights(cfg, model, "cpu")
    loaded = {k: v.clone() for k, v in model.state_dict().items()}
    shared = [k for k in loaded if k in stage1 and stage1[k].shape == loaded[k].shape
              and k != "logit_scale"]
    assert len(shared) > len(loaded) / 2
    for name in shared:
        torch.testing.assert_close(loaded[name], stage1[name], rtol=0, atol=0, msg=name)
    assert loaded["logit_scale"].item() == pytest.approx(math.log(1 / 0.07), rel=1e-7)
    assert loaded["logit_scale"].item() != stage1["logit_scale"].item()
    assert not any(k.startswith(("encoder_wrapper.image_adapter", "image_")) for k in loaded)

    assert train.main(["--device", "cpu"] + argv) == 0
    inner = read_log(tmp_path / "log.jsonl", "train_inner")
    assert [x["step"] for x in inner] == [1, 2] and all(math.isfinite(x["loss"]) for x in inner)
    after = params_from_jax(ckpt.load_params(str(tmp_path / "ckpt" / "checkpoint_best.npz")))
    mask = model.trainable_mask()
    assert 0 < sum(mask.values()) < len(mask)
    moved = 0
    for name, value in after.items():
        if mask[name]:
            moved += not torch.equal(value, loaded[name])
        else:
            torch.testing.assert_close(value, loaded[name], rtol=0, atol=0, msg=name)
    assert moved > 0.9 * sum(mask.values())
