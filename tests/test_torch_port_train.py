"""The port's training slice against the JAX package, on the same weights and
batches: the ITC loss and its gradients, the retrieval criterions through
the whole tiny model (port ``attn_impl`` pallas and xla against JAX xla),
the optimizer's decay mask and layer-decay scales, the LR schedules, and
the ``Trainer`` over several steps (AdamW with layer decay, clipping,
accumulation, the non-finite skip, ``state_dict``).

Weights come from ``torch_fixture.make_random_state_dict``; the JAX side
gets them through ``convert_retrieval_model``, the port through
``params_from_jax``.  fp32 throughout; dropout and drop path rates are 0, so
both sides are deterministic.  Tolerances: losses 1e-5, gradients 1e-4
relative to the largest entry of each parameter's gradient, parameters
after 3 steps 1e-5 relative to each parameter's norm."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as tf
from helpers import tiny_model_config
from one_peace_tpu.core.config import CriterionConfig, FrameworkConfig
from one_peace_tpu.criterions import losses as jlosses
from one_peace_tpu.criterions.criterions import (
    AudioTextRetrievalCriterion as JaxAudioITC, ImageTextRetrievalCriterion as JaxImageITC)
from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.optim import adamw as jadamw
from one_peace_tpu.optim.lr_schedule import build_lr_schedule as jax_schedule
from one_peace_tpu.parallel.mesh import make_mesh
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.criterions.losses import itc_loss
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.optim import adamw, build_lr_schedule
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import params_from_jax

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5


def _prune(tree, like):
    """``tree`` cut to the keys of ``like`` (the model's own init tree)."""
    if isinstance(like, dict):
        return {k: _prune(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_prune(t, v) for t, v in zip(tree, like)]
    return tree


def _weights(cfg, seed=0):
    """(JAX params, the port's state_dict) of one random fairseq state dict,
    cut to the branches of cfg's head type."""
    tree = convert_retrieval_model(tf.make_random_state_dict(cfg, seed=seed), cfg)
    tree = _prune(tree, jax.eval_shape(lambda: JaxModel(cfg).init(jax.random.PRNGKey(0))))
    return to_jax(tree), params_from_jax(tree)


def _port_model(cfg, state, impl="pallas"):
    model = OnePeaceRetrievalModel(cfg)
    model.load_state_dict(state, strict=True)
    model.cfg.encoder.attn_impl = impl
    return model


def _batch(cfg, b=4, seed=0, audio=False):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(5, 99, (b, 7))
    tokens[1, 4:] = 1  # text pads
    batch = {"src_tokens": tokens}
    if audio:
        spec = cfg.encoder.audio_adapter.feature_encoder_spec
        batch["src_audios"] = rs.randn(b, 100).astype(np.float32)
        pad = np.zeros((b, conv_output_length(100, spec) + 1), bool)
        pad[2, -4:] = True
        batch["audio_padding_masks"] = pad
    else:
        batch["src_images"] = rs.randn(b, 3, 32, 32).astype(np.float32)
    return batch


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grad_close(got, want, name):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-12) + 1e-12, (name, err)


# ---------------------------------------------------------------------------
# ITC loss and the criterions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_itc_loss_matches_jax(label_smoothing):
    rs = np.random.RandomState(0)
    a, b = (rs.randn(6, 16).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    scale = np.float32(1 / 0.07)

    def jax_loss(a_, b_, s_):
        return jlosses.itc_loss(a_, b_, s_, label_smoothing)[0]

    want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale))
    leaves = [torch.tensor(x, requires_grad=True) for x in (a, b, scale)]
    loss, metrics = itc_loss(*leaves, label_smoothing)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(want[0])) <= LOSS_TOL
    for g, w, name in zip(grads, want[1], ("emb_a", "emb_b", "logit_scale")):
        _assert_grad_close(g.numpy(), w, name)
    _, jm = jlosses.itc_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale))
    assert int(metrics["a2b_ncorrect"]) == int(jm["a2b_ncorrect"])


CRITERION_CASES = [("vl", 0.0, "pallas"), ("vl", 0.1, "xla"), ("al", 0.0, "pallas")]


@pytest.mark.parametrize("head_type,label_smoothing,impl", CRITERION_CASES)
def test_criterion_gradients_match_jax(head_type, label_smoothing, impl):
    """The tiny model through the retrieval criterion: the port (its
    attention through the autograd Function under ``pallas``) against
    ``jax.grad`` of the JAX criterion with ``attn_impl="xla"``."""
    cfg = tiny_model_config(head_type=head_type)
    cfg.encoder.attn_impl = "xla"
    params, state = _weights(cfg)
    audio = head_type == "al"
    ccfg = CriterionConfig(label_smoothing=label_smoothing)
    ccfg._name = "audio_text_retrieval_criterion" if audio else "image_text_retrieval_criterion"
    batch = _batch(cfg, audio=audio)
    jax_crit = (JaxAudioITC if audio else JaxImageITC)(ccfg)
    jax_model = JaxModel(cfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_crit(jax_model, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           rng=None, deterministic=True), has_aux=True)(params)
    want = params_from_jax(_np_tree(jgrads))

    model = _port_model(cfg, state, impl)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = build_criterion(ccfg)(
        model, {k: torch.as_tensor(v) for k, v in batch.items()}, deterministic=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    for key in jmetrics:
        assert abs(float(metrics[key].detach()) - float(jmetrics[key])) <= 1e-4, key
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        g = torch.zeros_like(model.get_parameter(name)) if g is None else g
        _assert_grad_close(g.numpy(), want[name].numpy(), name)


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_type,copy_tables", [("vl", False), ("val", True)])
def test_decay_mask_and_layer_scales_match_jax(head_type, copy_tables):
    cfg = tiny_model_config(head_type=head_type, copy_rel_pos_table=copy_tables)
    params, state = _weights(cfg)
    layers = cfg.encoder.layers
    model = _port_model(cfg, state)
    named = list(model.named_parameters())
    want_mask = params_from_jax(_np_tree(jadamw.decay_mask(params)), num_layers=layers)
    want_scale = params_from_jax(
        _np_tree(jadamw.layer_decay_scales(params, layers, 0.9)), num_layers=layers)
    got_mask = adamw.decay_mask(named)
    got_scale = adamw.layer_decay_scales(named, layers, 0.9)
    assert set(got_mask) == set(want_mask) == set(got_scale) == set(want_scale)
    for name, _ in named:
        assert got_mask[name] == bool(want_mask[name]), name
        np.testing.assert_allclose(np.asarray(got_scale[name], np.float64).ravel(),
                                   want_scale[name].numpy().astype(np.float64).ravel(),
                                   rtol=1e-6, err_msg=name)
    n_decay = sum(got_mask.values())
    assert 0 < n_decay < len(named)


@pytest.mark.parametrize("name,warmup_updates,warmup_ratio", [
    ("cosine", 3, 0.0), ("cosine", 0, 0.25), ("polynomial_decay", 2, 0.0)])
def test_lr_schedules_match_jax(name, warmup_updates, warmup_ratio):
    cfg = FrameworkConfig()
    cfg.lr_scheduler._name = name
    cfg.lr_scheduler.warmup_updates = warmup_updates
    cfg.lr_scheduler.warmup_ratio = warmup_ratio
    cfg.optimization.lr = 3e-4
    want = jax_schedule(cfg.lr_scheduler, cfg.optimization, 20)
    got = build_lr_schedule(cfg.lr_scheduler, cfg.optimization, 20)
    for step in range(25):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step


def test_adamw_groups_follow_the_optax_chain():
    """One update of the groups (layer scale s on a decayed and a no-decay
    parameter) equals adam -> add_decayed_weights -> scale s -> lr."""
    import optax

    rs = np.random.RandomState(0)
    w, b = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)
    gw, gb = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)
    s, lr, wd = 0.81, 1e-2, 0.05
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.98, eps=1e-8),
                     optax.add_decayed_weights(wd, mask={"w": True, "b": False}),
                     jadamw.scale_by_tree({"w": jnp.float32(s), "b": jnp.float32(s)}),
                     optax.scale_by_learning_rate(lr))
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    updates, _ = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, tx.init(params), params)
    want = optax.apply_updates(params, updates)

    tw, tb = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    opt = torch.optim.AdamW([{"params": [tw], "weight_decay": wd, "lr": lr * s},
                             {"params": [tb], "weight_decay": 0.0, "lr": lr * s}],
                            betas=(0.9, 0.98), eps=1e-8)
    tw.grad, tb.grad = torch.as_tensor(gw), torch.as_tensor(gb)
    opt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(want["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(want["b"]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------


def _framework_cfg(update_freq=1):
    cfg = FrameworkConfig()
    cfg.model = tiny_model_config(head_type="vl")
    cfg.criterion._name = "image_text_retrieval_criterion"
    cfg.common.bf16 = False
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.update_freq = update_freq
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 2
    return cfg


def _trainers(cfg, seed=0):
    """A port Trainer and a JAX Trainer (one CPU device) on the same weights."""
    params, state = _weights(cfg.model, seed=seed)
    jax_trainer = JaxTrainer(cfg, JaxModel(cfg.model), JaxImageITC(cfg.criterion),
                             params=params, mesh=make_mesh(1, 1, 1, devices=jax.devices()[:1]))
    port = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    return port, jax_trainer


def _assert_params_close(port, jax_trainer):
    want = params_from_jax(_np_tree(jax_trainer.params))
    for name, p in port.model.named_parameters():
        w = want[name].double()
        err = (p.detach().double() - w).norm() / max(w.norm(), 1e-12)
        assert err <= PARAM_TOL, (name, float(err))


def test_trainer_matches_jax_trainer():
    """Cosine warmup, weight decay 0.05, clip 1.0, layer decay 0.9: the
    metrics of every step and the parameters after 3 steps agree."""
    cfg = _framework_cfg()
    port, jax_trainer = _trainers(cfg)
    batches = [_batch(cfg.model, b=6, seed=s) for s in range(3)]
    for batch in batches:
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        for key in ("loss", "gnorm", "lr", "skipped", "i2t_accuracy", "t2i_accuracy"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_TOL, abs=LOSS_TOL), key
    assert port.step == jax_trainer.step == 3
    _assert_params_close(port, jax_trainer)


def test_trainer_accumulation_matches_jax():
    """update_freq=2: the port's running mean of micro-gradients steps with
    the JAX MultiSteps; and two micro-steps on one batch equal one step on
    it with update_freq=1 (ITC couples the rows of a batch, so two halves
    are not one doubled batch)."""
    cfg = _framework_cfg(update_freq=2)
    port, jax_trainer = _trainers(cfg)
    before = port.model.text_proj.weight.detach().clone()
    for i, seed in enumerate((0, 1, 2, 3)):
        batch = _batch(cfg.model, b=4, seed=seed)
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL, abs=LOSS_TOL)
        assert port.step == jax_trainer.step == (i + 1) // 2
        if i == 0:
            torch.testing.assert_close(port.model.text_proj.weight, before, rtol=0, atol=0)
    _assert_params_close(port, jax_trainer)

    batch = _batch(cfg.model, b=4, seed=7)
    twice, once = (Trainer(c, _port_model(c.model, _weights(c.model)[1]),
                           build_criterion(c.criterion))
                   for c in (_framework_cfg(update_freq=2), _framework_cfg()))
    for _ in range(2):
        twice.train_step(batch)
        twice.train_step(batch)
        once.train_step(batch)
    for (name, a), (_, b) in zip(twice.model.named_parameters(), once.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, msg=name)


def test_nonfinite_step_leaves_state_untouched():
    cfg = _framework_cfg(update_freq=2)
    params, state = _weights(cfg.model)
    port = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    good = _batch(cfg.model, b=4)
    for _ in range(3):  # one update applied, one micro-gradient accumulated
        port.train_step(good)
    before = port.state_dict()
    poison = dict(good, src_images=np.full_like(good["src_images"], np.nan))
    metrics = port.train_step(poison)
    assert metrics["skipped"] == 1.0 and not math.isfinite(metrics["gnorm"])
    after = port.state_dict()
    for name in before["params"]:
        torch.testing.assert_close(after["params"][name], before["params"][name], rtol=0, atol=0)
    for a, b in zip(after["acc"], before["acc"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for key, st in before["opt_state"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(after["opt_state"]["state"][key][k], v, rtol=0, atol=0)
    assert (after["mini"], after["updates"]) == (before["mini"], before["updates"])
    assert after["micro"] == before["micro"] + 1


def test_state_dict_round_trip():
    """Save after two steps, go on one step; a second trainer loaded from
    the bundle takes the same step to the same bits."""
    cfg = _framework_cfg(update_freq=2)
    cfg.model.encoder.drop_path_rate = 0.2  # the generator state travels too
    cfg.model.encoder.dropout = 0.1
    batches = [_batch(cfg.model, b=4, seed=s) for s in range(4)]
    _, state = _weights(cfg.model)
    first = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    for batch in batches[:3]:
        first.train_step(batch)
    bundle = first.state_dict()
    first.train_step(batches[3])

    _, other = _weights(cfg.model, seed=1)
    second = Trainer(cfg, _port_model(cfg.model, other), build_criterion(cfg.criterion))
    second.load_state_dict(bundle)
    assert (second.step, second._micro) == (1, 3)
    second.train_step(batches[3])
    for (name, a), (_, b) in zip(first.model.named_parameters(), second.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("field", ["fp16", "ema", "adan"])
def test_unported_trainer_options_raise(field):
    cfg = _framework_cfg()
    if field == "fp16":
        cfg.common.fp16 = True
    elif field == "ema":
        cfg.ema.store_ema = True
    else:
        cfg.optimizer._name = "adan"
    _, state = _weights(cfg.model)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
