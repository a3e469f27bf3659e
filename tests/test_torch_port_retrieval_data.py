"""The port's retrieval data path against the JAX package's, on the same
synthetic files in ``tmp_path``: TSV shards, PNG images, WAV and FLAC clips
and a byte-level BPE set.

Copies held equal, bit for bit: the registry, ``load_tables``, ``collate``,
``EpochBatchIterator`` (shuffle, ``ensure_equal_batch`` cycling,
``skip_remainder_batch``, two shards, a mid-epoch resume), the text and
image transforms, both retrieval datasets row by row, ``Recall``'s ranking
with ties, and the training-metrics meters and sinks.  Task level: each
retrieval task's train batches, and its evaluation (``begin_valid_epoch``,
``valid_step``, ``merge_results``) on a tiny model whose weights
``params_from_jax`` carries across -- embeddings within 1e-4, the same
Recall dict.  The JAX side evaluates through its jitted, shape-bucketed
``JitEvaluator`` (waveforms padded to whole seconds with those frames
masked); the port runs each batch at its own length."""

import json
import struct
import wave

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from PIL import Image

import torch_fixture as tf
from chip_smoke import write_bpe_dir
from helpers import tiny_model_config
from one_peace_tpu.core import metrics as jax_meters
from one_peace_tpu.core import registry as jax_registry
from one_peace_tpu.core.config import FrameworkConfig, TaskConfig
from one_peace_tpu.data import base_dataset as jax_base
from one_peace_tpu.data import collate as jax_collate
from one_peace_tpu.data import datasets as jax_datasets
from one_peace_tpu.data import iterators as jax_iterators
from one_peace_tpu.data import tsv as jax_tsv
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.core import metrics as port_meters
from one_peace_tpu_torch.core import registry as port_registry
from one_peace_tpu_torch.data import base_dataset as port_base
from one_peace_tpu_torch.data import collate as port_collate
from one_peace_tpu_torch.data import datasets as port_datasets
from one_peace_tpu_torch.data import iterators as port_iterators
from one_peace_tpu_torch.data import tsv as port_tsv
from one_peace_tpu_torch.metrics import metrics as port_metrics
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.utils.checkpoint import params_from_jax

CAPTIONS = ["A red square", "a green  circle!", "the BLUE dog", ",yellow cat", "an orange truck",
            "a purple house", "gray mountains\tand sky", "white clouds", "a black bird",
            "two dogs", "three cats", "rain on a roof"]
AUDIO_SPEC = ((16, 10, 5), (16, 8, 8), (16, 8, 8))  # ~50 frames a second
EMB_TOL = 1e-4


# ---------------------------------------------------------------------------
# synthetic files
# ---------------------------------------------------------------------------


def write_flac(path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """A mono 16-bit FLAC file of VERBATIM subframes (frame CRCs left 0:
    the decoder does not check them)."""
    samples = np.asarray(samples, np.int16)
    block = 4096
    info = struct.pack(">HH", block, block) + bytes(6)
    packed = (sample_rate << 44) | (0 << 41) | (15 << 36) | len(samples)
    info += packed.to_bytes(8, "big") + bytes(16)
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    for n, start in enumerate(range(0, len(samples), block)):
        chunk = samples[start:start + block]
        bs_code = 12 if len(chunk) == block else 7  # 4096, or 16-bit size - 1 after the header
        out += bytes([0xFF, 0xF8, (bs_code << 4) | 5, (0 << 4) | (4 << 1), n])
        if bs_code == 7:
            out += (len(chunk) - 1).to_bytes(2, "big")
        out += bytes([0, 0x02]) + chunk.astype(">i2").tobytes() + bytes(2)
    path.write_bytes(bytes(out))


def write_wav(path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(np.asarray(samples, np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 image-caption rows and 12 audio-caption rows (WAV and FLAC, 0.6 to
    2.3 s), a valid JSON of two captions per id, and the BPE set."""
    root = tmp_path_factory.mktemp("retrieval_corpus")
    rs = np.random.RandomState(0)
    img_rows, aud_rows = ["id\timage\tcaption"], ["id\taudio\tcaption\tduration"]
    for i, cap in enumerate(CAPTIONS):
        Image.fromarray(rs.randint(0, 255, (30 + 3 * i, 44 - i, 3), dtype=np.uint8)).save(
            root / f"img{i}.png")
        img_rows.append(f"{10 + i}\timg{i}.png\t{cap}")
        n = 9600 + 2500 * i
        wav = (np.sin(np.arange(n) * (0.01 + 0.004 * i)) * 8000
               + rs.randn(n) * 500).astype(np.int16)
        name = f"clip{i}.flac" if i % 2 else f"clip{i}.wav"
        (write_flac if i % 2 else write_wav)(root / name, wav)
        aud_rows.append(f"{10 + i}\t{name}\t{cap}\t{n / 16000:.3f}")
    (root / "images.tsv").write_text("\n".join(img_rows) + "\n")
    (root / "audios.tsv").write_text("\n".join(aud_rows) + "\n")
    valid = {str(10 + i): [cap, f"{cap} again"] for i, cap in enumerate(CAPTIONS)}
    (root / "valid.json").write_text(json.dumps(valid))
    return {"root": root, "bpe": write_bpe_dir(root / "bpe")}


def test_flac_writer_round_trips(corpus):
    """The test's FLAC files decode to the samples written (port reader)."""
    from one_peace_tpu_torch.hub import load_audio

    samples = (np.arange(5000) % 300 - 150).astype(np.int16)
    path = corpus["root"] / "ramp.flac"
    write_flac(path, samples)
    np.testing.assert_array_equal(load_audio(str(path)), samples.astype(np.float32) / 32768)


# ---------------------------------------------------------------------------
# copies, bit for bit
# ---------------------------------------------------------------------------


def test_registry_equal():
    for module in (port_registry, jax_registry):
        reg = module.Registry("thing")

        @reg.register("a")
        class A:
            pass

        assert reg.get("a") is A and A.registry_name == "a" and "a" in reg
        assert reg.names() == ["a"]
        with pytest.raises(ValueError, match="already registered"):
            reg.register("a")(A)
        with pytest.raises(KeyError, match="unknown thing 'b'"):
            reg.get("b")
    assert [r.kind for r in (port_registry.TASKS, port_registry.MODELS)] == ["task", "model"]


def test_user_module_registers(tmp_path):
    plugin = tmp_path / "my_plugin"
    plugin.mkdir()
    (plugin / "__init__.py").write_text(
        "from one_peace_tpu_torch.core.registry import TASKS\n"
        "@TASKS.register('my_test_task')\nclass MyTask:\n    pass\n")
    port_registry.load_user_module(str(plugin))
    assert port_registry.TASKS.get("my_test_task").__name__ == "MyTask"


def test_load_tables_equal(tmp_path):
    """Two numbered shards and a third file, a '|' separator, columns
    picked and reordered by name, a last column that keeps the separator."""
    header = "id|caption|image|extra"
    for i, rows in enumerate((["1|a cat|x.png|p|q", "2|a dog|y.png|r"], ["3|rain||s"])):
        (tmp_path / f"part{i}.tsv").write_text("\n".join([header, *rows]) + "\n")
    (tmp_path / "more.tsv").write_text(header + "\n4|sun|z.png|t\n")
    spec = f"{tmp_path}/part[0-9].tsv, {tmp_path}/more.tsv"
    assert port_tsv.expand_paths(spec) == jax_tsv.expand_paths(spec)
    for cols in ("image,id,extra", None):
        got = port_tsv.load_tables(spec, cols, "|")
        want = jax_tsv.load_tables(spec, cols, "|")
        assert len(got) == len(want) == 4
        assert [got[i] for i in range(4)] == [want[i] for i in range(4)]
    with pytest.raises(IndexError):
        port_tsv.load_tables(spec, None, "|")[-5]


def _samples(rs, n=3):
    out = []
    for i in range(n):
        out.append({
            "id": 7 * i, "source_text": rs.randint(4, 50, 3 + 2 * i),
            "source_image": rs.randn(3, 4, 4).astype(np.float32),
            "source_audio": rs.randn(20 + 5 * i).astype(np.float32),
            "audio_padding_mask": np.zeros(3 + i, bool),
            "text_preserve_ids": np.arange(2 + i), "target": i % 2,
        })
    return out


def test_collate_equal():
    samples = _samples(np.random.RandomState(0))
    for kw in ({}, {"pad_idx": 5, "pad_to_length": {"src_tokens": 12}}):
        got, want = port_collate.collate(samples, **kw), jax_collate.collate(samples, **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    values = [np.arange(3), np.arange(7)]
    np.testing.assert_array_equal(port_collate.collate_tokens(values, 1, pad_to_multiple=4),
                                  jax_collate.collate_tokens(values, 1, pad_to_multiple=4))
    assert port_collate.collate([]) == jax_collate.collate([]) == {}


ITERATOR_CASES = {
    "shuffle": dict(n=23, batch_size=4),
    "smaller_than_a_batch": dict(n=3, batch_size=8),
    "skip_remainder": dict(n=23, batch_size=4, ensure_equal_batch=False,
                           skip_remainder_batch=True),
    "no_shuffle_ragged": dict(n=10, batch_size=4, shuffle=False, ensure_equal_batch=False),
    "two_shards": dict(n=21, batch_size=3, num_shards=2, shard_id=1),
}


@pytest.mark.parametrize("case", sorted(ITERATOR_CASES))
def test_epoch_batch_iterator_equal(case):
    """Batches over two epochs, then a resume from a mid-epoch state."""
    kw = dict(ITERATOR_CASES[case])
    n = kw.pop("n")
    dataset = list(range(100, 100 + n))

    def make(module, prefetch):
        return module.EpochBatchIterator(dataset, lambda s: list(s), seed=11,
                                         prefetch=prefetch, **kw)

    runs = []
    for module in (port_iterators, jax_iterators):
        for prefetch in (0, 2):
            itr = make(module, prefetch)
            batches = [b for _ in range(2) for b in itr.next_epoch_itr()]
            runs.append((len(itr), batches))
    assert all(r == runs[0] for r in runs), case
    assert runs[0][1], case

    states = []
    for module in (port_iterators, jax_iterators):
        itr = make(module, 2)
        it = itr.next_epoch_itr()
        next(it)
        state = itr.state_dict()
        resumed = make(module, 0)
        resumed.load_state_dict(state)
        states.append((state, resumed.first_batch_ids(),
                       list(resumed.next_epoch_itr()), resumed.epoch, resumed.end_of_epoch()))
    assert states[0] == states[1]


def test_text_and_image_transforms_equal():
    for text in ("  ,.Hello   World!\t tabs\n", "#A b c d e f", "", "x" * 3):
        for max_words in (None, 3):
            assert port_base.clean_text(text, max_words) == jax_base.clean_text(text, max_words)
    rs = np.random.RandomState(1)
    img = Image.fromarray(rs.randint(0, 255, (37, 53, 3), dtype=np.uint8))
    for size in (16, 64):
        got = np.asarray(port_base.resize_image(img, size))
        np.testing.assert_array_equal(got, np.asarray(jax_base.resize_image(img, size)))
        np.testing.assert_array_equal(port_base.normalize_image(got),
                                      jax_base.normalize_image(got))
    floats = rs.rand(5, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(port_base.normalize_image(floats),
                                  jax_base.normalize_image(floats))
    wav = rs.randn(9000).astype(np.float32)
    np.testing.assert_array_equal(port_base.audio_postprocess(wav, 16000, 1),
                                  jax_base.audio_postprocess(wav, 16000, 1))


@pytest.mark.parametrize("side", ["image", "audio"])
def test_retrieval_dataset_rows_equal(corpus, side):
    from one_peace_tpu.data.tokenizer import TextTokenizer as JaxTokenizer
    from one_peace_tpu_torch.data.tokenizer import TextTokenizer

    root = corpus["root"]
    table = f"{root}/{side}s.tsv"
    name = "ImageTextRetrievalDataset" if side == "image" else "AudioTextRetrievalDataset"
    kw = ({"max_src_length": 6, "patch_image_size": 32} if side == "image"
          else {"max_src_length": 6, "max_duration": 1, "feature_encoder_spec": AUDIO_SPEC})
    datasets = [getattr(mod, name)("valid", tsv.load_tables(table), tok(corpus["bpe"]),
                                   dataset_dir=str(root), **kw)
                for mod, tsv, tok in ((port_datasets, port_tsv, TextTokenizer),
                                      (jax_datasets, jax_tsv, JaxTokenizer))]
    assert len(datasets[0]) == len(datasets[1]) == len(CAPTIONS)
    for i in range(len(CAPTIONS)):
        got, want = datasets[0][i], datasets[1][i]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{side} {i} {key}")
    assert port_datasets.DEFAULT_SPEC == jax_datasets.DEFAULT_SPEC
    for uid in ("12", "x7", None):
        assert port_datasets.coerce_id(uid, 3) == jax_datasets.coerce_id(uid, 3)


def test_recall_ranking_equal():
    """Random scores rounded to few levels (many ties), duplicate ids on
    both sides, with and without the prediction dumps."""
    rs = np.random.RandomState(3)
    image_ids = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    text_ids = np.repeat(np.array([1, 2, 3, 4, 5, 6, 9, 8]), 2)
    scores = np.round(rs.rand(8, 16) * 4) / 4
    for predict in (False, True):
        got_r, want_r = port_metrics.Recall(), jax_metrics.Recall()
        got_r.text_ids, want_r.text_ids = text_ids, text_ids
        assert got_r.retrieval_eval(image_ids, scores, predict) == \
            want_r.retrieval_eval(image_ids, scores, predict)
    empty = []
    for module in (port_metrics, jax_metrics):
        recall = module.Recall()
        recall.initialize(text_ids, [])
        empty.append(recall.merge_results())
    assert empty[0] == empty[1]


def test_fetch_once_is_one_fetch():
    """Tensors of a tree arrive as numpy arrays (bf16 as fp32), others as
    they were, and each call counts once."""
    before = port_metrics.fetch_once.calls
    tree = {"a": [torch.arange(6).reshape(2, 3), torch.ones(2, dtype=torch.bfloat16)],
            "b": np.arange(3), "c": (torch.zeros(1), 5)}
    got = port_metrics.fetch_once(tree)
    assert port_metrics.fetch_once.calls == before + 1
    np.testing.assert_array_equal(got["a"][0], np.arange(6).reshape(2, 3))
    assert got["a"][1].dtype == np.float32 and got["a"][1].tolist() == [1.0, 1.0]
    assert got["b"] is tree["b"] and got["c"][1] == 5 and isinstance(got["c"], tuple)


def test_meters_and_sinks_equal(tmp_path):
    """The same log_scalar calls under nested aggregate() contexts give the
    same averages, and the JSONL sinks write the same lines."""
    outs = []
    for module in (port_meters, jax_meters):
        with module.aggregate(new_root=True) as outer:
            module.log_scalar("loss", 2.0, weight=3)
            with module.aggregate() as inner:
                module.log_scalar("loss", 1.0)
                module.log_scalar("acc", 0.12345, round_digits=2)
        path = tmp_path / f"{module.__name__}.jsonl"
        common = FrameworkConfig().common
        common.log_file = str(path)
        progress = module.ProgressLogger("json", 2, sinks=module.build_sinks(common),
                                         tag="valid")
        progress.log({"loss": 1.5, "name": "x", "skip": [1]}, step=4)
        progress.log({"loss": 9.0}, step=5)  # off the interval
        progress.close()
        outs.append((outer.as_dict(), inner.as_dict(), path.read_text()))
    assert outs[0] == outs[1]
    assert port_meters._is_logging_process()


# ---------------------------------------------------------------------------
# the tasks
# ---------------------------------------------------------------------------


def _framework_cfg(corpus, side):
    root = corpus["root"]
    cfg = FrameworkConfig()
    cfg.model = tiny_model_config(head_type="vl" if side == "image" else "al")
    cfg.model.encoder.text_adapter.vocab_size = 260  # the BPE set's dict + 4 specials
    cfg.model.encoder.audio_adapter.feature_encoder_spec = AUDIO_SPEC
    cfg.task = TaskConfig(_name=f"{side}_text_retrieval", data=f"{root}/{side}s.tsv",
                          valid_data=f"{root}/{side}s.tsv", valid_file=f"{root}/valid.json",
                          bpe_dir=corpus["bpe"], patch_image_size=32, max_duration=2,
                          head_type=cfg.model.head_type)
    return cfg


@pytest.mark.parametrize("side", ["image", "audio"])
def test_task_train_batches_equal(corpus, side):
    cfg = _framework_cfg(corpus, side)
    iters = []
    for build in (build_task, jax_build_task):
        task = build(cfg.task, cfg)
        task.load_dataset("train")
        iters.append(task.get_batch_iterator("train", 5, seed=4))
    for _ in range(2):
        for got, want in zip(iters[0].next_epoch_itr(), iters[1].next_epoch_itr(),
                             strict=True):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sharded_iterator_raises(corpus):
    """A sharded split no longer raises: rank 1 of 2 gets the second
    contiguous slice of each global batch (a ragged last batch splits as
    evenly as it can), and the task's reducer is set to merge the ranks'
    parts."""
    cfg = _framework_cfg(corpus, "image")
    task = build_task(cfg.task, cfg)
    task.load_dataset("valid")
    whole = list(task.get_batch_iterator("valid", 4, ensure_equal_batch=False).next_epoch_itr())
    assert task.metric.num_shards == 1
    itr = task.get_batch_iterator("valid", 4, num_shards=2, shard_id=1, ensure_equal_batch=False)
    assert task.metric.num_shards == 2 and itr.num_shards == 2 and len(itr) == len(whole)
    got = list(itr.next_epoch_itr())
    assert len(got) == len(whole)
    for part, full in zip(got, whole):
        n = len(full["id"])
        first = n - n // 2
        np.testing.assert_array_equal(part["id"], full["id"][first:])
        np.testing.assert_array_equal(part["src_images"], full["src_images"][first:])


def _host_embeddings(chunks) -> np.ndarray:
    return np.concatenate([np.asarray(c.float() if isinstance(c, torch.Tensor) else c,
                                      np.float32) for c in chunks])


@pytest.mark.parametrize("side", ["image", "audio"])
def test_task_evaluation_matches_jax(corpus, side):
    """begin_valid_epoch + valid_step + merge_results on one tiny model.

    Image: the text and image embeddings within 1e-4 of the JAX task's and
    the same Recall dict.  Audio: the audio adapter's positional conv sees
    the frames that pad a clip, so a clip's embedding depends on how far its
    batch pads it.  The JAX evaluator pads every batch to whole seconds; the
    port, like the reference's eager evaluation, pads to the batch's longest
    clip.  So the port is held to the JAX model run on the port's own
    batches (embeddings within 1e-4, the same Recall dict), and to the JAX
    task on every clip that the bucket pads no further than the batch: all
    but the longest clip of a batch whose length is not whole seconds."""
    cfg = _framework_cfg(corpus, side)
    tree = convert_retrieval_model(tf.make_random_state_dict(cfg.model, seed=5), cfg.model)
    jax_model = JaxModel(cfg.model)
    jax_params = to_jax({k: v for k, v in tree.items() if k in jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0)))})
    model = OnePeaceRetrievalModel(cfg.model, device="cpu")
    state = params_from_jax(tree)
    model.load_state_dict({k: state[k] for k in model.state_dict()}, strict=True)
    model.train()

    stats, embeddings, tasks = [], [], []
    for build, mdl, params in ((build_task, model, None), (jax_build_task, jax_model, jax_params)):
        task = build(cfg.task, cfg)
        task.load_dataset("valid")
        task.begin_valid_epoch(mdl, params)
        itr = task.get_batch_iterator("valid", 5, ensure_equal_batch=False)
        for batch in itr.next_epoch_itr():
            task.valid_step(mdl, params, batch)
        embeddings.append((_host_embeddings(task.metric.text_logits),
                           _host_embeddings(task.metric.image_logits_list)))
        stats.append(task.merge_results())
        tasks.append(task)
    assert model.training  # eval_model put the training mode back
    err = np.abs(embeddings[0][0] - embeddings[1][0]).max()
    assert err <= EMB_TOL, ("text", float(err))
    prefix = "img" if side == "image" else "audio"
    assert stats[0][f"{prefix}_count"] == len(CAPTIONS) and stats[0]["txt_count"] == 24
    if side == "image":
        err = np.abs(embeddings[0][1] - embeddings[1][1]).max()
        assert err <= EMB_TOL, ("image", float(err))
        assert stats[0] == stats[1]
        return

    embed_audio = jax.jit(lambda p, a, m: jax_model(p, src_audios=a, audio_padding_masks=m,
                                                    encoder_type="audio"))
    direct, ids, further = [], [], []
    for batch in tasks[0].get_batch_iterator("valid", 5, ensure_equal_batch=False) \
            .next_epoch_itr():
        direct.append(np.asarray(embed_audio(jax_params, batch["src_audios"],
                                             batch["audio_padding_masks"])))
        ids.append(batch["id"])
        # a clip that the bucket pads further than the batch did: the longest
        # of its batch, when that is not a whole number of seconds
        further.extend(~batch["audio_padding_masks"].any(axis=1)
                       & (batch["src_audios"].shape[1] % 16000 != 0))
    direct, further = np.concatenate(direct), np.asarray(further)
    err = np.abs(embeddings[0][1] - direct).max()
    assert err <= EMB_TOL, ("audio against the JAX model on the port's batches", float(err))
    reference = jax_metrics.Recall()
    reference.initialize(np.asarray(tasks[1].text_ids), [embeddings[1][0]])
    reference.compute(np.concatenate(ids), direct)
    want = reference.merge_results()
    assert stats[0] == {("audio" + k[3:] if k.startswith("img") else k): v
                        for k, v in want.items()}
    err = np.abs(embeddings[0][1] - embeddings[1][1]).max(axis=1)
    assert further.any() and err[~further].max() <= EMB_TOL, err.tolist()


@pytest.mark.parametrize("name,criterion", [("fsd50k", "classify_criterion"),
                                            ("nlvr2", "classify_criterion"),
                                            ("refcoco", "refcoco_criterion"),
                                            ("aqa", "hinge_criterion")])
def test_rest_of_classify_tasks_build(corpus, name, criterion):
    """Every task of the JAX package builds, naming the JAX task's dataset
    and criterion; the criterion builds too."""
    from one_peace_tpu.tasks import tasks as jax_tasks
    from one_peace_tpu_torch.criterions import build_criterion

    cfg = _framework_cfg(corpus, "image")
    cfg.task._name = name
    if name == "fsd50k":  # FSD50K refuses TaskConfig's default
        cfg.task.num_classes = 200
    task = build_task(cfg.task, cfg)
    want = jax_tasks.TASKS.get(name)
    assert type(task).dataset_cls.__name__ == want.dataset_cls.__name__
    assert type(task).criterion_name == want.criterion_name == criterion
    cfg.criterion._name = criterion
    assert type(build_criterion(cfg.criterion)).__name__ in ("ClassifyCriterion",
                                                             "RefCOCOCriterion", "HingeCriterion")


@pytest.mark.parametrize("name", ["one_peace_no_such_model"])
def test_unported_models_raise(corpus, name):
    """Every model of the JAX package is ported: a name neither package
    has raises."""
    from one_peace_tpu_torch.cli.train import build_model_for_task

    cfg = _framework_cfg(corpus, "image")
    cfg.model._name = name
    with pytest.raises(NotImplementedError, match="no such model"):
        build_model_for_task(cfg, build_task(cfg.task, cfg), device="cpu")


def test_detection_task_reaches_its_error(corpus):
    """coco_detection builds on a retrieval config, and its dataset reads
    task.data as COCO JSON: a TSV is refused by the JSON parser."""
    cfg = _framework_cfg(corpus, "image")
    cfg.task._name = "coco_detection"
    task = build_task(cfg.task, cfg)
    with pytest.raises(json.JSONDecodeError):
        task.load_dataset("train")
