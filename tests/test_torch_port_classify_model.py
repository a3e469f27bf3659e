"""The port's classify model against the JAX package's, on CPU at toy size.

One seeded fairseq state dict (``torch_fixture.make_random_state_dict`` +
``add_classify_head_state``) drives both sides: the JAX side through its
``convert_classify_model``, the port through its own.  Held at 1e-4
(PARITY.md): ``attention_pooling`` with pads; ``ClassifyHead`` in every
combination of attention pooling, pooler and two images; the whole model
for ``image``, ``vl`` (text features and ``use_image_features``), ``audio``
and a two-image head, on both ``attn_impl`` arms (the JAX Pallas arm
interpreted); ``freeze_finetune_updates`` through the criterion; the
gradients of ``ClassifyCriterion``'s three branches against ``jax.grad``;
the ``.pt`` conversion at 384 and 480 px; ``params_to_jax`` read by the JAX
package's ``load_params``; and the hub's classify logits with and without
int8 against the JAX hub."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import torch_fixture as tf
from chip_smoke import write_bpe_dir
from helpers import tiny_model_config

from one_peace_tpu import hub as jax_hub
from one_peace_tpu.core.config import CriterionConfig, TaskConfig
from one_peace_tpu.criterions.criterions import ClassifyCriterion as JaxCriterion
from one_peace_tpu.models import one_peace as jax_heads
from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.classify import OnePeaceClassifyModel as JaxModel
from one_peace_tpu.ops import attention as jax_attention
from one_peace_tpu.ops import flash_attention as jax_flash
from one_peace_tpu.utils import checkpoint_convert as jax_convert
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.criterions import ClassifyCriterion
from one_peace_tpu_torch.models.classify import OnePeaceClassifyModel
from one_peace_tpu_torch.models.one_peace import AttentionPooling, ClassifyHead
from one_peace_tpu_torch.utils import checkpoint_convert as port_convert
from one_peace_tpu_torch.utils import native_checkpoint as port_ckpt
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax

TOL = 1e-4
NUM_CLASSES = 5
D, HEADS = 32, 4


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _load(model, state):
    """The entries of ``state`` that ``model`` has (its head type's branches)."""
    wanted = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in state.items() if k in wanted}, strict=True)
    return model


def _state_dict(head_type, seed=0, **head_kw):
    cfg = tiny_model_config(head_type=head_type)
    sd = tf.make_random_state_dict(cfg, seed=seed)
    tf.add_classify_head_state(sd, cfg, NUM_CLASSES, attn_pooling=head_kw.get("attn_pooling", False),
                               use_pooler=head_kw.get("use_pooler", False))
    if head_kw.get("use_two_images"):  # fc1 reads both images' pooled features
        d = cfg.encoder.embed_dim
        sd["classify_head.classifier.0.weight"] = (
            np.random.RandomState(seed + 20).randn(d, 2 * d).astype(np.float32) * 0.05)
    return cfg, sd


def _pair(head_type, seed=0, **kw):
    """(cfg, JAX model, its params, port model) on one state dict."""
    cfg, sd = _state_dict(head_type, seed, **kw)
    params = jax_convert.to_jax(jax_convert.convert_classify_model(dict(sd), cfg))
    model = OnePeaceClassifyModel(cfg, NUM_CLASSES, device="cpu", **kw)
    _load(model, port_convert.convert_classify_model(dict(sd), cfg))
    return cfg, JaxModel(cfg, NUM_CLASSES, **kw), params, model


def _inputs(cfg, head_type, b=2, two_images=False):
    rng = np.random.RandomState(1)
    out = {}
    if head_type in ("text", "vl"):
        out["src_tokens"] = np.array([[5, 6, 7, 1, 1], [8, 9, 10, 11, 12], [13, 14, 1, 1, 1]])[:b]
    if head_type in ("image", "vl"):
        out["src_images"] = rng.randn(b, 3, 32, 32).astype(np.float32)
        if two_images:
            out["src_images_2"] = rng.randn(b, 3, 32, 32).astype(np.float32)
    if head_type == "audio":
        out["src_audios"] = rng.randn(b, 100).astype(np.float32)
        t = conv_output_length(100, cfg.encoder.audio_adapter.feature_encoder_spec)
        mask = np.zeros((b, t + 1), bool)
        mask[1, -4:] = True
        out["audio_padding_masks"] = mask
    return out


def _torch(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


@pytest.fixture
def interpret(monkeypatch):
    """The JAX model's Pallas arm on one CPU device: the kernel called
    directly, in interpreter mode."""
    orig = jax_flash.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jax_flash.pl, "pallas_call", patched)
    monkeypatch.setattr(jax_attention, "_flash_mode", lambda: "direct")


def _pooling_params(rng, d=D, heads=HEADS):
    return {"k_proj": {"w": rng.randn(d, d).astype(np.float32) * 0.2},
            "v_proj": {"w": rng.randn(d, d).astype(np.float32) * 0.2,
                       "b": rng.randn(d).astype(np.float32) * 0.1},
            "out_proj": {"w": rng.randn(d, d).astype(np.float32) * 0.2,
                         "b": rng.randn(d).astype(np.float32) * 0.1},
            "q": rng.randn(1, 1, heads, d // heads).astype(np.float32)}


def test_attention_pooling_with_pads():
    """No 1/sqrt(d) scaling, padded keys out, a fully padded row uniform."""
    rng = np.random.RandomState(0)
    params = _pooling_params(rng)
    x = rng.randn(3, 7, D).astype(np.float32)
    mask = np.zeros((3, 7), bool)
    mask[1, 4:] = True
    mask[2, :] = True
    pool = AttentionPooling(D, HEADS, device="cpu")
    pool.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = pool(torch.as_tensor(x), torch.as_tensor(mask))
    want = jax_heads.attention_pooling(jax_convert.to_jax(params), jnp.asarray(x),
                                       jnp.asarray(mask), HEADS)
    _close(got, want)
    # a padded key's value does not reach the output
    x2 = x.copy()
    x2[1, 5] += 100.0
    with torch.no_grad():
        _close(pool(torch.as_tensor(x2), torch.as_tensor(mask))[1], got[1].numpy(), 1e-6)


@pytest.mark.parametrize("attn_pooling", [False, True])
@pytest.mark.parametrize("use_pooler", [False, True])
@pytest.mark.parametrize("two_images", [False, True])
def test_classify_head_matches_jax(attn_pooling, use_pooler, two_images):
    kw = dict(attn_pooling=attn_pooling, use_pooler=use_pooler, pooler_dropout=0.1,
              input_dim=D, num_heads=HEADS, head_scale_ratio=1.5, num_classes=NUM_CLASSES,
              use_two_images=two_images)
    jhead = jax_heads.ClassifyHead(**kw)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)
    params["norm"]["scale"] = params["norm"]["scale"] + rng.randn(D).astype(np.float32) * 0.1
    f1, f2 = (rng.randn(3, 6, D).astype(np.float32) for _ in range(2))
    mask = np.zeros((3, 6), bool)
    mask[0, 3:] = True
    head = ClassifyHead(**kw, device="cpu")
    head.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = head(torch.as_tensor(f1), torch.as_tensor(f2) if two_images else None,
                   torch.as_tensor(mask))
    want = jhead(jax_convert.to_jax(params), jnp.asarray(f1),
                 jnp.asarray(f2) if two_images else None, jnp.asarray(mask))
    assert got.shape == (3, NUM_CLASSES)
    _close(got, want)


def test_head_dropout_is_seeded_and_shared_by_both_images():
    """The pooler's dropout draws from the caller's generator; both images
    take the same masks, as the JAX head passes one key to both."""
    head = ClassifyHead(False, True, 0.5, D, HEADS, 1.0, NUM_CLASSES, device="cpu")
    jparams = jax_heads.ClassifyHead(False, True, 0.5, D, HEADS, 1.0, NUM_CLASSES).init(
        jax.random.PRNGKey(0))
    head.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    f = torch.randn(4, 3, D, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(4, 3, dtype=torch.bool)
    with torch.no_grad():
        a = head.forward_features(f, mask, False, 7)
        b = head.forward_features(f, mask, False, 7)
        c = head.forward_features(f, mask, False, 8)
        runs = [head(f, None, mask, False, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


MODEL_CASES = {  # name: (head type, model kwargs, two images)
    "image": ("image", dict(attn_pooling=True, use_pooler=True), False),
    "vl_text": ("vl", dict(use_pooler=True), False),
    "vl_image_features": ("vl", dict(attn_pooling=True, use_image_features=True), False),
    "audio": ("audio", dict(attn_pooling=True), False),
    "image_two": ("image", dict(use_two_images=True, attn_pooling=True), True),
}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_classify_model_matches_jax(case, impl, request):
    head_type, kw, two = MODEL_CASES[case]
    cfg, jmodel, params, model = _pair(head_type, **kw)
    if impl == "pallas":
        request.getfixturevalue("interpret")
    for m in (jmodel, model):
        m.cfg.encoder.attn_impl = impl
    inputs = _inputs(cfg, head_type, b=3, two_images=two)
    with torch.no_grad():
        got = model(**_torch(inputs))
    want = jmodel(params, **_jax(inputs))
    assert got.shape == (3, NUM_CLASSES)
    _close(got, want)


def test_rel_tables_are_per_layer_whatever_the_config():
    cfg, _, _, model = _pair("image")
    assert not cfg.copy_rel_pos_table
    tables = model.encoder_wrapper.image_adapter.rel_pos_table
    assert tables.shape[0] == cfg.encoder.layers
    assert model.encoder_wrapper.text_adapter is None and model.encoder_wrapper.audio_adapter is None


def _batches(cfg, head_type, branch):
    inputs = _inputs(cfg, head_type, b=3)
    rng = np.random.RandomState(5)
    if branch == "soft":
        target = rng.dirichlet(np.ones(NUM_CLASSES), 3).astype(np.float32)
    elif branch == "multi_label":
        target = (rng.rand(3, NUM_CLASSES) * (rng.rand(3, NUM_CLASSES) < 0.5)).astype(np.float32)
    else:
        target = np.array([1, 4, 0])
    return ({**inputs, "target": target},
            {"net_input": _jax(inputs), "target": jnp.asarray(target)})


def _grads(cfg, jmodel, params, model, criterion_cfg, head_type, branch, num_updates=None):
    """(port loss, metrics, gradients by name), (JAX loss, metrics,
    gradients as the port's names), deterministic."""
    batch, jbatch = _batches(cfg, head_type, branch)
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = ClassifyCriterion(criterion_cfg)(model, _torch(batch), deterministic=True,
                                                     num_updates=num_updates)
    loss.backward()
    got = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}

    def f(p):
        return JaxCriterion(criterion_cfg)(jmodel, p, jbatch, deterministic=True,
                                           num_updates=num_updates)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    return (loss, metrics, got), (jloss, jmetrics, want)


@pytest.mark.parametrize("branch", ["label_smoothing", "soft", "multi_label"])
def test_criterion_gradients_match_jax(branch):
    head_type = "vl" if branch == "multi_label" else "image"
    cfg, jmodel, params, model = _pair(head_type, attn_pooling=True, use_pooler=True)
    ccfg = CriterionConfig(_name="classify_criterion", label_smoothing=0.1,
                           use_multi_label=branch == "multi_label")
    (loss, metrics, got), (jloss, jmetrics, want) = _grads(cfg, jmodel, params, model, ccfg,
                                                          head_type, branch)
    _close(loss, jloss, 1e-5)
    _close(metrics["accuracy"], jmetrics["accuracy"], 1e-4)
    assert got.keys() == {k for k in want if k in got}
    num = sum(float((got[k].double() * torch.as_tensor(want[k]).double()).sum()) for k in got)
    den = np.sqrt(sum(float(got[k].double().norm() ** 2) for k in got)
                  * sum(float(torch.as_tensor(want[k]).double().norm() ** 2) for k in got))
    assert num / den > 1 - 1e-6
    for k in got:
        _close(got[k], want[k])


def test_freeze_finetune_updates():
    """Before the threshold only the head has gradients; from it on the
    encoder's equal JAX's, through the criterion's ``num_updates``."""
    cfg, sd = _state_dict("image", attn_pooling=True)
    params = jax_convert.to_jax(jax_convert.convert_classify_model(dict(sd), cfg))
    kw = dict(attn_pooling=True, freeze_finetune_updates=2)
    model = _load(OnePeaceClassifyModel(cfg, NUM_CLASSES, device="cpu", **kw),
                  port_convert.convert_classify_model(dict(sd), cfg))
    jmodel = JaxModel(cfg, NUM_CLASSES, **kw)
    ccfg = CriterionConfig(_name="classify_criterion")
    for updates, frozen in ((1, True), (2, False)):
        (_, _, got), (_, _, want) = _grads(cfg, jmodel, params, model, ccfg, "image",
                                           "label_smoothing", num_updates=updates)
        for name, g in got.items():
            if name.startswith("encoder_wrapper."):
                if frozen:
                    assert float(g.abs().max()) == 0.0, name
                    assert float(want[name].abs().max()) == 0.0, name
                else:
                    _close(g, want[name])
            else:
                assert float(g.abs().max()) > 0.0, name
                _close(g, want[name])
        assert any(float(g.abs().max()) > 0 for n, g in got.items()
                   if n.startswith("encoder_wrapper.")) != frozen
    # without the trainer's count, the model's own (unfrozen by default)
    assert model.num_updates == 2
    model.set_num_updates(0)
    (_, _, got), _ = _grads(cfg, jmodel, params, model, ccfg, "image", "label_smoothing")
    assert all(float(g.abs().max()) == 0.0 for n, g in got.items()
               if n.startswith("encoder_wrapper."))


@pytest.mark.parametrize("size,grid", [(384, 24), (480, 30)])
def test_convert_classify_model_upgrades_tables(size, grid):
    """A pretrained 16 x 16 image grid's tables come out at the task's
    resolution: every layer's rel-pos table (2g-1)^2 + 3 rows, as the JAX
    conversion gives them."""
    cfg = tiny_model_config(head_type="image")
    cfg.encoder.image_adapter.bucket_size = cfg.encoder.image_adapter.rel_bucket_size = 16
    sd = tf.make_random_state_dict(cfg, seed=2)
    tf.add_classify_head_state(sd, cfg, NUM_CLASSES, attn_pooling=True)
    cfg.encoder.image_adapter.rel_bucket_size = size // 16
    got = port_convert.convert_classify_model(dict(sd), cfg)
    want = params_from_jax(jax_convert.convert_classify_model(dict(sd), cfg))
    table = got["encoder_wrapper.image_adapter.rel_pos_table"]
    assert table.shape == (cfg.encoder.layers, (2 * grid - 1) ** 2 + 3, cfg.encoder.attention_heads)
    assert sd["encoder_wrapper.image_adapter.rel_pos_table_list.0.weight"].shape[0] == 31 ** 2 + 3
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_export_loads_in_jax(tmp_path):
    """``params_to_jax`` of the classify tree, saved by the port, read by the
    JAX package's ``load_params``: the JAX model gives the port's logits, and
    the port reads its own export back bit-equal."""
    cfg, jmodel, _, model = _pair("vl", attn_pooling=True, use_pooler=True)
    path = tmp_path / "best.npz"
    port_ckpt.save_params(str(path), model_to_jax(model))
    back = params_from_jax(port_ckpt.load_params(str(path)))
    state = model.state_dict()
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    inputs = _inputs(cfg, "vl", b=3)
    with torch.no_grad():
        got = model(**_torch(inputs))
    _close(got, jmodel(jax_ckpt.load_params(str(path)), **_jax(inputs)))


@pytest.fixture(scope="module")
def hub_assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("classify_hub")
    cfg, sd = _state_dict("image", seed=6, attn_pooling=True, use_pooler=True)
    cfg.encoder.text_adapter.vocab_size = 300
    cfg._name = "one_peace_classify"  # the JAX hub's classify dispatch reads it
    pt = root / "classify.pt"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}}, pt)
    npz = root / "classify.npz"
    jax_ckpt.save_params(str(npz), jax_convert.convert_classify_model(dict(sd), cfg))
    return {"cfg": cfg, "pt": str(pt), "npz": str(npz), "bpe": write_bpe_dir(root / "bpe")}


@pytest.mark.parametrize("quantize", ["none", "ffn"])
@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_hub_classify_logits_match_jax(hub_assets, fmt, quantize):
    kw = dict(model_type="one_peace_classify", dtype="float32", bpe_dir=hub_assets["bpe"],
              model_cfg=hub_assets["cfg"], task_cfg=TaskConfig(patch_image_size=32),
              num_classes=NUM_CLASSES, classify_kwargs=dict(attn_pooling=True, use_pooler=True),
              quantize=quantize)
    jh = jax_hub.from_pretrained(hub_assets[fmt], **kw)
    th = hub.from_pretrained(hub_assets[fmt], device="cpu", **kw)
    assert isinstance(th.model, OnePeaceClassifyModel)
    images = np.random.RandomState(7).randn(3, 3, 32, 32).astype(np.float32)
    got = th.extract_image_features(images)
    assert got.shape == (3, NUM_CLASSES)
    _close(got, jh.extract_image_features(jnp.asarray(images)))


def test_classify_entry_points_default_to_the_card(hub_assets, monkeypatch):
    """The classify model, the training CLI's model builder and the
    evaluation CLI's load build on cuda unless the caller asks for another
    device; the evaluation CLI asks the hub for the task's classes."""
    import inspect

    from one_peace_tpu_torch.cli import evaluate, train

    for fn in (OnePeaceClassifyModel.__init__, train.build_model_for_task, hub.from_pretrained):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    seen = {}

    def fake_from_pretrained(path, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(hub, "from_pretrained", fake_from_pretrained)
    with pytest.raises(RuntimeError, match="stop"):
        evaluate.main(["--config", "recipes/vqa/base.yaml", "--path", "model.npz",
                       f"task.bpe_dir={hub_assets['bpe']}", "task.num_classes=3129"])
    assert seen["device"] == "cuda" and seen["model_type"] == "one_peace_classify"
    assert seen["num_classes"] == 3129 and seen["model_cfg"].head_type == "vl"


@pytest.mark.parametrize("update_freq", [1, 2])
def test_trainer_thaws_the_encoder(update_freq):
    """``Trainer`` passes the count of updates (not micro-batches) to the
    criterion: with ``freeze_finetune_updates=2`` the encoder stays as it
    was for two updates while the head trains, and moves from the third."""
    from one_peace_tpu_torch.core.config import FrameworkConfig
    from one_peace_tpu_torch.criterions import build_criterion
    from one_peace_tpu_torch.trainer import Trainer

    cfg, sd = _state_dict("image", attn_pooling=True)
    fcfg = FrameworkConfig()
    fcfg.model = cfg
    fcfg.criterion._name = "classify_criterion"
    fcfg.optimization.update_freq = update_freq
    fcfg.optimization.lr = 1e-3
    model = _load(OnePeaceClassifyModel(cfg, NUM_CLASSES, device="cpu", attn_pooling=True,
                                        freeze_finetune_updates=2),
                  port_convert.convert_classify_model(dict(sd), cfg))
    trainer = Trainer(fcfg, model, build_criterion(fcfg.criterion), total_updates=10)
    batch, _ = _batches(cfg, "image", "label_smoothing")
    enc = model.encoder_wrapper.image_adapter.cls_embedding
    head = model.classify_head.classifier.fc2.weight
    enc0, head0 = enc.detach().clone(), head.detach().clone()
    for _ in range(2 * update_freq):
        trainer.train_step(batch)
    assert trainer.step == 2
    assert torch.equal(enc, enc0) and not torch.equal(head, head0)
    for _ in range(update_freq):
        trainer.train_step(batch)
    assert trainer.step == 3 and not torch.equal(enc, enc0)
