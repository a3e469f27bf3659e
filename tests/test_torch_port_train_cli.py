"""The port's training and evaluation CLIs against the JAX package's, on
one toy config and one tiny fairseq ``.pt`` (``torch_fixture``), with
synthetic TSVs, PNG images and a byte-level BPE set in ``tmp_path``.

- Both ``cli.train.main`` runs (2 epochs, validation at every update, a
  save at every update, the newest two kept, the two best exported): the
  per-update losses within 1e-4 through their JSONL sinks, equal Recall
  dicts, and the same file names in the save directory.
- Both ``cli.evaluate.main`` on the port's ``checkpoint_best.npz`` print the
  same dict; the JAX package's ``load_params`` reads the port's exports.
- ``params_to_jax`` inverts ``params_from_jax``.
- A resume under ``update_freq=2`` from a save in the middle of an
  accumulation ends bit-equal to the straight run; ``train_inner`` logs the
  update's weighted mean; a fresh run's init follows the config;
  ``Trainer.state_dict`` holds host copies only.

Dropout and drop path are 0 in the comparison with JAX, so both sides are
deterministic; fp32 throughout."""

import json

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from PIL import Image

import torch_fixture as tf
from chip_smoke import write_bpe_dir
from helpers import tiny_model_config
from one_peace_tpu.cli import evaluate as jax_evaluate
from one_peace_tpu.cli import train as jax_train
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch.cli import evaluate, train
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_, init_weights_
from test_torch_port_retrieval_data import AUDIO_SPEC, write_flac, write_wav

RECIPE = "recipes/image_text_retrieval/base.yaml"
AUDIO_RECIPE = "recipes/audio_text_retrieval/base.yaml"
LOSS_TOL = 1e-4
RECALL_KEYS = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_count", "img_r1", "img_r5",
               "img_r10", "img_r_mean", "txt_count", "r_mean")
CAPTIONS = ["a red square", "a green circle", "a blue dog", "the yellow cat", "an orange truck",
            "a purple house", "gray mountains", "white clouds", "a black bird", "two dogs",
            "three cats", "rain on a roof", "a tall tree", "the old car", "green grass",
            "a small boat"]


def model_config(head_type="vl"):
    cfg = tiny_model_config(head_type=head_type)
    cfg.encoder.text_adapter.vocab_size = 260  # the BPE set's dict + 4 specials
    if head_type == "al":
        cfg.encoder.audio_adapter.feature_encoder_spec = AUDIO_SPEC
    return cfg


def model_overrides(head_type="vl"):
    enc = model_config(head_type).encoder
    ad = enc.audio_adapter
    spec = str(tuple(tuple(x) for x in ad.feature_encoder_spec)).replace(" ", "")
    return [f"model.encoder.embed_dim={enc.embed_dim}",
            f"model.encoder.ffn_embed_dim={enc.ffn_embed_dim}",
            f"model.encoder.layers={enc.layers}",
            f"model.encoder.attention_heads={enc.attention_heads}",
            f"model.encoder.text_adapter.bucket_size={enc.text_adapter.bucket_size}",
            f"model.encoder.image_adapter.bucket_size={enc.image_adapter.bucket_size}",
            f"model.encoder.audio_adapter.feature_encoder_spec={spec}",
            f"model.encoder.audio_adapter.feature_embed_dim={ad.feature_embed_dim}",
            f"model.encoder.audio_adapter.bucket_size={ad.bucket_size}",
            f"model.encoder.audio_adapter.conv_pos_depth={ad.conv_pos_depth}",
            f"model.encoder.audio_adapter.conv_pos_width={ad.conv_pos_width}",
            f"model.encoder.audio_adapter.conv_pos_groups={ad.conv_pos_groups}"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rs = np.random.RandomState(0)
    rows = ["id\timage\tcaption"]
    for i, cap in enumerate(CAPTIONS):
        Image.fromarray(rs.randint(0, 255, (36 + i, 40, 3), dtype=np.uint8)).save(
            root / f"img{i}.png")
        rows.append(f"{100 + i}\timg{i}.png\t{cap}")
    (root / "train.tsv").write_text("\n".join(rows) + "\n")
    audio = ["id\taudio\tcaption\tduration"]
    for i, cap in enumerate(CAPTIONS):
        # the valid rows (the first 8) last whole seconds, the others do not
        n = 16000 * (1 + i % 2) if i < 8 else 9000 + 1700 * i
        wav = (np.sin(np.arange(n) * (0.01 + 0.003 * i)) * 6000 + rs.randn(n) * 800)
        name = f"clip{i}.flac" if i % 2 else f"clip{i}.wav"
        (write_flac if i % 2 else write_wav)(root / name, wav.astype(np.int16))
        audio.append(f"{100 + i}\t{name}\t{cap}\t{n / 16000:.3f}")
    (root / "audio_train.tsv").write_text("\n".join(audio) + "\n")
    (root / "audio_valid.tsv").write_text("\n".join(audio[:9]) + "\n")
    al = tf.make_random_state_dict(model_config("al"), seed=3)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in al.items()}}, root / "al.pt")
    (root / "train12.tsv").write_text("\n".join(rows[:13]) + "\n")
    (root / "valid.tsv").write_text("\n".join(rows[:9]) + "\n")
    (root / "valid.json").write_text(json.dumps(
        {str(100 + i): [cap, f"{cap} again"] for i, cap in enumerate(CAPTIONS[:8])}))
    sd = tf.make_random_state_dict(model_config(), seed=2)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, root / "model.pt")
    return {"root": root, "bpe": write_bpe_dir(root / "bpe")}


def overrides(corpus, save_dir, head_type="vl", **extra):
    root = corpus["root"]
    ov = {"task.data": f"{root}/train.tsv", "task.valid_data": f"{root}/valid.tsv",
          "task.valid_file": f"{root}/valid.json", "task.bpe_dir": corpus["bpe"],
          "task.selected_cols": "id,image,caption", "task.patch_image_size": "32",
          "common.bf16": "false", "common.log_interval": "1", "common.seed": "7",
          "common.log_file": f"{save_dir}/log.jsonl", "optimization.lr": "2e-3",
          "optimization.max_epoch": "2", "lr_scheduler.warmup_updates": "1",
          "dataset.batch_size": "8", "dataset.batch_size_valid": "4",
          "checkpoint.save_dir": f"{save_dir}/ckpt", "checkpoint.best_checkpoint_metric": "txt_r1",
          "distributed.fsdp": "1", "distributed.tp": "1"}
    ov.update({k.replace("__", "."): str(v) for k, v in extra.items()})
    recipe = RECIPE if head_type == "vl" else AUDIO_RECIPE
    return ["--config", recipe, *model_overrides(head_type), *(f"{k}={v}" for k, v in ov.items())]


def read_log(path, tag):
    lines = [json.loads(line) for line in open(path)]
    return [line for line in lines if line["tag"] == tag]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One training run of each CLI from the tiny .pt: saves at every
    update (so validation at every update too), the newest two kept, the two
    best exported."""
    out = {}
    for name, main, extra in (("port", train.main, ["--device", "cpu"]), ("jax", jax_train.main, [])):
        save_dir = tmp_path_factory.mktemp(f"run_{name}")
        argv = overrides(corpus, save_dir, checkpoint__restore_file=corpus["root"] / "model.pt",
                         checkpoint__save_interval_updates=1, checkpoint__keep_last_epochs=2,
                         checkpoint__keep_best_checkpoints=2)
        assert main(extra + argv) == 0
        out[name] = save_dir
    jax_ckpt.wait_for_saves()
    return out


def test_train_cli_matches_jax(runs):
    logs = {name: d / "log.jsonl" for name, d in runs.items()}
    inner = {name: read_log(path, "train_inner") for name, path in logs.items()}
    assert [x["step"] for x in inner["port"]] == [x["step"] for x in inner["jax"]] == [1, 2, 3, 4]
    for got, want in zip(inner["port"], inner["jax"]):
        for key in ("loss", "lr", "i2t_accuracy", "t2i_accuracy"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_TOL, abs=LOSS_TOL), (key, got)
    assert inner["port"][-1]["loss"] != inner["port"][0]["loss"]
    valid = {name: read_log(path, "valid") for name, path in logs.items()}
    assert len(valid["port"]) == len(valid["jax"]) == 4
    for got, want in zip(valid["port"], valid["jax"]):
        assert {k: got[k] for k in RECALL_KEYS} == {k: want[k] for k in RECALL_KEYS}
        assert got["eval_batched_fetches"] == 1
    assert [x["step"] for x in read_log(logs["port"], "train")] == \
        [x["step"] for x in read_log(logs["jax"], "train")] == [2, 4]


def test_save_directory_matches_jax(runs):
    """Interval saves pruned to the newest two, checkpoint_best.npz and the
    two best exports under the JAX package's names."""
    names = {name: sorted(p.name for p in (d / "ckpt").iterdir()) for name, d in runs.items()}
    steps = {name: sorted((n for n in found if n.startswith("step_")), key=lambda n: int(n[5:]))
             for name, found in names.items()}
    others = {name: [n for n in found if not n.startswith("step_")]
              for name, found in names.items()}
    assert others["port"] == others["jax"], names
    # the JAX package prunes while its async save of the same step is still
    # being written, so it can hold one bundle more than keep_last_epochs;
    # the port prunes once the bundle is on disk
    assert steps["port"] == ["step_3", "step_4"] == steps["jax"][-2:], names
    assert "checkpoint_best.npz" in names["port"]
    assert sum(n.startswith("checkpoint.best_txt_r1_") for n in names["port"]) == 2
    assert ckpt.latest_checkpoint(runs["port"] / "ckpt").endswith("step_4")
    for name in names["port"]:
        if name.endswith(".npz"):
            assert ckpt.load_metadata(str(runs["port"] / "ckpt" / name)) == \
                jax_ckpt.load_metadata(str(runs["jax"] / "ckpt" / name))


def test_evaluate_cli_matches_jax(corpus, runs, tmp_path):
    """Both evaluation CLIs on the port's checkpoint_best.npz."""
    best = runs["port"] / "ckpt" / "checkpoint_best.npz"
    dicts = []
    for name, main, extra in (("port", evaluate.main, ["--device", "cpu"]),
                              ("jax", jax_evaluate.main, [])):
        out = tmp_path / f"{name}.json"
        argv = overrides(corpus, tmp_path)
        assert main(extra + ["--path", str(best), "--output", str(out)] + argv) == 0
        dicts.append(json.loads(out.read_text()))
    assert {k: dicts[0][k] for k in RECALL_KEYS} == {k: dicts[1][k] for k in RECALL_KEYS}
    assert dicts[0]["img_count"] == 8 and dicts[0]["txt_count"] == 16
    assert dicts[0]["eval_compiled_programs"] == 0 and dicts[0]["eval_batched_fetches"] == 1


def test_exports_read_in_both_packages(runs):
    """The JAX package's load_params reads the port's export to the tree
    params_to_jax made, and the port reads it back to the masters' bits."""
    best = str(runs["port"] / "ckpt" / "checkpoint_best.npz")
    ours = ckpt.load_params(best)
    theirs = jax_ckpt.load_params(best)
    flat_ours, flat_theirs = ckpt._flatten(ours), jax_ckpt._flatten(theirs)
    assert sorted(flat_ours) == sorted(flat_theirs)
    for key, value in flat_ours.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(flat_theirs[key]), err_msg=key)
    state = params_from_jax(ours)
    model = OnePeaceRetrievalModel(model_config(), device="cpu")
    model.load_state_dict(state, strict=True)


def test_params_to_jax_inverts_params_from_jax():
    """Both ways, bit for bit: the port's state_dict through the JAX tree
    and back, and the JAX package's own init tree through the port and
    back (lists, stacked layers and all); bf16 leaves included."""
    cfg = tiny_model_config(head_type="val")
    model = fill_random_(OnePeaceRetrievalModel(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        sd = {k: v.to(dtype) for k, v in model.state_dict().items()}
        back = params_from_jax(params_to_jax(sd))
        assert sorted(back) == sorted(sd)
        for key, value in sd.items():
            assert back[key].dtype == dtype
            torch.testing.assert_close(back[key], value, rtol=0, atol=0, msg=key)
    tree = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(1)))
    again = params_to_jax(params_from_jax(tree))
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _bundle_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=where)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _bundle_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _bundle_equal(x, y, f"{where}/{i}")
    elif a != a and b != b:  # nan best metric
        return
    else:
        assert a == b, (where, a, b)


def test_resume_mid_accumulation_is_bit_equal(corpus, tmp_path, monkeypatch):
    """update_freq=2 over 3 micro-batches an epoch: the epoch-1 save holds
    a pending micro-gradient.  A run stopped after epoch 1 and resumed to 4
    updates ends with the straight run's bundle, bit for bit (masters, AdamW
    state, counters, generator, iterator position, best metric, logging
    window); drop path and dropout draw from the generator throughout.  The
    straight run's train_inner lines are the means of their updates' two
    micro-batches."""
    micro = []
    real_step = Trainer.train_step

    def recording_step(self, batch):
        metrics = real_step(self, batch)
        micro.append((len(batch["src_tokens"]), metrics["loss"]))
        return metrics

    monkeypatch.setattr(Trainer, "train_step", recording_step)
    common = dict(task__data=corpus["root"] / "train12.tsv", dataset__batch_size=4,
                  optimization__update_freq=2, optimization__max_update=4,
                  optimization__max_epoch=0, checkpoint__reset_optimizer="false",
                  model__encoder__drop_path_rate=0.3, model__encoder__dropout=0.1)
    straight, first = tmp_path / "straight", tmp_path / "resumed"
    assert train.main(["--device", "cpu"] + overrides(corpus, straight, **common)) == 0
    straight_micro = list(micro)
    stopped = dict(common, optimization__max_epoch=1)
    assert train.main(["--device", "cpu"] + overrides(corpus, first, **stopped)) == 0
    mid = ckpt.restore_train_state(str(first / "ckpt" / "step_1"))
    assert (mid["trainer"]["mini"], mid["trainer"]["micro"], mid["iterator"]["epoch"]) == (1, 3, 2)
    assert len(mid["window"]) == 1
    assert train.main(["--device", "cpu"] + overrides(corpus, first, **common)) == 0

    a = ckpt.restore_train_state(str(straight / "ckpt" / "step_4"))
    b = ckpt.restore_train_state(str(first / "ckpt" / "step_4"))
    assert (a["trainer"]["step"], a["trainer"]["micro"]) == (4, 8)
    a["trainer"].pop("train_time"), b["trainer"].pop("train_time")
    _bundle_equal(a, b)

    inner = read_log(straight / "log.jsonl", "train_inner")
    assert [x["step"] for x in inner] == [1, 2, 3, 4]
    for update, line in enumerate(inner):
        (w0, l0), (w1, l1) = straight_micro[2 * update:2 * update + 2]
        assert line["loss"] == pytest.approx((w0 * l0 + w1 * l1) / (w0 + w1), rel=1e-12)
    resumed = read_log(first / "log.jsonl", "train_inner")
    assert [x["loss"] for x in resumed] == [x["loss"] for x in inner]


def test_update_window_weights_by_samples():
    window = train.UpdateWindow()
    window.add({"loss": 1.0, "acc": 10.0}, 3)
    assert window.mean() == {"loss": 1.0, "acc": 10.0}
    window.add({"loss": 3.0, "acc": 50.0}, 1)
    assert window.mean() == {"loss": 1.5, "acc": 20.0}
    again = train.UpdateWindow()
    again.load_state_dict(window.state_dict())
    assert again.mean() == window.mean()


def test_fresh_init_follows_the_config(corpus):
    """No restore_file: fill_random_'s draws, with the LayerScale gammas at
    layer_scale_init_value and the rel-pos tables zero."""
    cfg = load_config(RECIPE, overrides(corpus, "/unused")[2:])
    cfg.model = model_config()
    cfg.model.encoder.layer_scale_init_value = 3e-3
    model = OnePeaceRetrievalModel(cfg.model, device="cpu")
    train.load_weights(cfg, model, torch.device("cpu"))
    reference = fill_random_(OnePeaceRetrievalModel(cfg.model, device="cpu"),
                             torch.Generator().manual_seed(cfg.common.seed))
    counts = {"gamma": 0, "rel": 0}
    for (name, p), (_, q) in zip(model.named_parameters(), reference.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma_1", "gamma_2"):
            counts["gamma"] += 1
            assert torch.all(p == 3e-3), name
        elif leaf == "rel_pos_table":
            counts["rel"] += 1
            assert torch.all(p == 0), name
        else:
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    assert counts == {"gamma": 4, "rel": 2}
    again = init_weights_(OnePeaceRetrievalModel(cfg.model, device="cpu"),
                          torch.Generator().manual_seed(cfg.common.seed), 3e-3)
    for p, q in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_state_dict_is_host_copies():
    """Every tensor of Trainer.state_dict lies on the CPU and shares no
    storage with a live parameter, moment or accumulated gradient."""
    cfg = load_config(RECIPE, ["common.bf16=false", "optimization.update_freq=2"])
    cfg.model = model_config()
    cfg.criterion._name = "image_text_retrieval_criterion"
    model = fill_random_(OnePeaceRetrievalModel(cfg.model, device="cpu"),
                         torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, build_criterion(cfg.criterion))
    rs = np.random.RandomState(0)
    batch = {"src_tokens": rs.randint(5, 200, (4, 6)),
             "src_images": rs.randn(4, 3, 32, 32).astype(np.float32)}
    for _ in range(3):  # one update applied, one micro-gradient pending
        trainer.train_step(batch)
    live = {p.untyped_storage().data_ptr() for p in trainer._params}
    live |= {a.untyped_storage().data_ptr() for a in trainer._acc}
    live |= {v.untyped_storage().data_ptr() for st in trainer.optimizer.state.values()
             for v in st.values() if isinstance(v, torch.Tensor)}
    seen = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            seen.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    state = trainer.state_dict()
    walk(state)
    assert len(seen) > 3 * len(trainer._params)
    for t in seen:
        assert t.device.type == "cpu"
        assert t.untyped_storage().data_ptr() not in live


def test_cli_entry_points_default_to_the_card(corpus, tmp_path, monkeypatch):
    """Both CLIs build on cuda unless --device says otherwise."""
    import one_peace_tpu_torch.hub as hub

    seen = {}

    def stop(name):
        def fn(*args, **kw):
            seen[name] = kw.get("device", args[-1] if args else None)
            raise RuntimeError("stop")
        return fn

    monkeypatch.setattr(train, "build_model_for_task", stop("train"))
    monkeypatch.setattr(hub, "from_pretrained", stop("evaluate"))
    with pytest.raises(RuntimeError, match="stop"):
        train.main(overrides(corpus, tmp_path))
    with pytest.raises(RuntimeError, match="stop"):
        evaluate.main(["--path", "x.npz"] + overrides(corpus, tmp_path))
    assert seen == {"train": torch.device("cuda"), "evaluate": "cuda"}


def test_audio_recipe_matches_jax(corpus, tmp_path):
    """The audio-text recipe from WAV and FLAC clips through both training
    CLIs (one epoch, two updates, one validation) and both evaluation CLIs
    on the port's export: losses within 1e-4, the same Recall dicts.  The
    valid clips last whole seconds, so the JAX evaluator's buckets pad no
    clip further than its batch does; with other lengths the two differ
    (ROADMAP section 3; ``test_torch_port_retrieval_data.py::
    test_task_evaluation_matches_jax[audio]``).  The train clips do not."""
    root = corpus["root"]
    audio = dict(task__data=root / "audio_train.tsv", task__valid_data=root / "audio_valid.tsv",
                 task__selected_cols="id,audio,caption,duration",
                 checkpoint__restore_file=root / "al.pt", optimization__max_epoch=1)
    logs, evals = {}, {}
    for name, main, extra in (("port", train.main, ["--device", "cpu"]),
                              ("jax", jax_train.main, [])):
        assert main(extra + overrides(corpus, tmp_path / name, "al", **audio)) == 0
        logs[name] = tmp_path / name / "log.jsonl"
    jax_ckpt.wait_for_saves()
    inner = {name: read_log(path, "train_inner") for name, path in logs.items()}
    assert [x["step"] for x in inner["port"]] == [x["step"] for x in inner["jax"]] == [1, 2]
    for got, want in zip(inner["port"], inner["jax"]):
        for key in ("loss", "a2t_accuracy", "t2a_accuracy"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_TOL, abs=LOSS_TOL), (key, got)
    keys = [k.replace("img", "audio") for k in RECALL_KEYS]
    valid = {name: read_log(path, "valid") for name, path in logs.items()}
    assert [{k: v[k] for k in keys} for v in valid["port"]] == \
        [{k: v[k] for k in keys} for v in valid["jax"]]
    assert valid["port"][0]["audio_count"] == 8 and valid["port"][0]["txt_count"] == 16
    best = tmp_path / "port" / "ckpt" / "checkpoint_best.npz"
    for name, main, extra in (("port", evaluate.main, ["--device", "cpu"]),
                              ("jax", jax_evaluate.main, [])):
        out = tmp_path / f"eval_{name}.json"
        argv = overrides(corpus, tmp_path / "eval", "al", **audio)
        assert main(extra + ["--path", str(best), "--output", str(out)] + argv) == 0
        evals[name] = json.loads(out.read_text())
    assert {k: evals["port"][k] for k in keys} == {k: evals["jax"][k] for k in keys}
