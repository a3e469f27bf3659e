"""Pretraining's training path in the port against the JAX package, on CPU
at toy size, fp32: stage 2's frozen set against the JAX model's
``trainable_mask`` name by name; the port's ``Trainer`` on a stage-2 model
against the JAX ``Trainer`` (its ``optax.multi_transform`` freezing) over
two updates with AdamW, weight decay, clipping and layer decay -- the
trainable parameters agree within 1e-5 of their norm, the frozen ones stay
bit-unchanged on both sides, and the port's ``gnorm`` is the norm of the
trainable gradients only (the JAX ``Trainer`` logs every gradient's,
ROADMAP section 3); the optimizer's decay mask and layer scales on the
pretrain tree; and the plain attention forward and backward against the
Pallas kernels run by the interpreter with a per-sample bias at L > 304
(the two-walk length of the student passes on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.core.config import FrameworkConfig
from one_peace_tpu.criterions.criterions import AudioTextPretrainCriterion as JaxALCriterion
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.optim import adamw as jadamw
from one_peace_tpu.parallel.mesh import make_mesh
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.optim import adamw
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_port_pretrain_model import al_batch, pretrain_config, pretrain_pair

PARAM_TOL, LOSS_TOL = 1e-5, 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("stage2", [True, False])
def test_frozen_set_matches_jax_trainable_mask(stage2):
    cfg = pretrain_config(audio=True, stage2=stage2)
    jax_model, params, model = pretrain_pair(cfg)
    want = params_from_jax(_np_tree(jax_model.trainable_mask(params)),
                           num_layers=cfg.encoder.layers)
    got = model.trainable_mask()
    assert got.keys() == want.keys()
    for name in got:
        assert got[name] is bool(want[name]), name
    frozen = {n for n, t in got.items() if not t}
    if not stage2:
        assert not frozen
        return
    assert "text_proj.weight" in frozen and "audio_proj.weight" not in frozen
    assert "encoder_wrapper.fusion.layers.1.self_attn.q_proj.weight" in frozen
    assert "encoder_wrapper.fusion.layers.1.audio_ffn.wo.weight" not in frozen
    assert not any(n.startswith("decoder_wrapper.") for n in frozen)


def _stage2_cfg():
    cfg = FrameworkConfig()
    cfg.model = pretrain_config(audio=True, stage2=True)
    cfg.criterion._name = "audio_text_pretrain_loss"
    cfg.criterion.label_smoothing = 0.1
    cfg.common.bf16 = False
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 0.5
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 1
    return cfg


def test_stage2_trainer_matches_jax_trainer():
    cfg = _stage2_cfg()
    jax_model, params, model = pretrain_pair(cfg.model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    jax_crit = JaxALCriterion(cfg.criterion)
    jax_trainer = JaxTrainer(cfg, jax_model, jax_crit, params=jax.tree.map(jnp.asarray, params),
                             mesh=mesh)
    port = Trainer(cfg, model, build_criterion(cfg.criterion))
    mask = model.trainable_mask()
    assert port._names == [n for n, t in mask.items() if t]
    in_opt = {id(p) for g in port.optimizer.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in port._params}

    batches = [al_batch(np.random.RandomState(s)) for s in (21, 22)]
    # the trainable gradients' norm at the first batch, on the JAX side
    grads = jax.jit(jax.grad(lambda p: jax_crit(jax_model, p, jax.tree.map(
        jnp.asarray, batches[0]), deterministic=False)[0]))(jax.tree.map(jnp.asarray, params))
    grads = params_from_jax(_np_tree(grads))
    trainable_norm = float(torch.stack([grads[n].double().norm() for n in port._names]).norm())
    for i, batch in enumerate(batches):
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        for key in ("loss", "lr", "skipped", "dcl_audio_loss", "atc_loss", "logit_scale_exp"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_TOL, abs=LOSS_TOL), key
        assert got["gnorm"] < want["gnorm"]  # JAX counts the frozen gradients too
        if i == 0:
            assert got["gnorm"] == pytest.approx(trainable_norm, rel=1e-5)
    assert port.step == jax_trainer.step == 2

    after_jax = params_from_jax(_np_tree(jax_trainer.params))
    start = params_from_jax(params)
    moved = 0
    for name, p in model.named_parameters():
        if mask[name]:
            w = after_jax[name].double()
            err = (p.detach().double() - w).norm() / max(float(w.norm()), 1e-12)
            assert err <= PARAM_TOL, (name, float(err))
            moved += not torch.equal(p.detach(), before[name])
        else:
            assert not p.requires_grad and p.grad is None
            torch.testing.assert_close(p.detach(), before[name], rtol=0, atol=0, msg=name)
            torch.testing.assert_close(after_jax[name], start[name], rtol=0, atol=0, msg=name)
    assert moved > 0.9 * sum(mask.values())


def test_decay_mask_and_layer_scales_on_the_pretrain_tree_match_jax():
    """The decoder's layers take the encoder's scales of their index, as
    the JAX package scales any stacked ``fusion/layers``; its adapters and
    the heads the top scale."""
    cfg = pretrain_config()
    _, params, model = pretrain_pair(cfg)
    layers = cfg.encoder.layers
    named = list(model.named_parameters())
    want_mask = params_from_jax(_np_tree(jadamw.decay_mask(params)), num_layers=layers)
    want_scale = params_from_jax(_np_tree(jadamw.layer_decay_scales(params, layers, 0.9)),
                                 num_layers=layers)
    got_mask = adamw.decay_mask(named)
    got_scale = adamw.layer_decay_scales(named, layers, 0.9)
    assert set(got_mask) == set(want_mask) == set(got_scale) == set(want_scale)
    for name, _ in named:
        assert got_mask[name] == bool(want_mask[name]), name
        np.testing.assert_allclose(np.asarray(got_scale[name], np.float64).ravel(),
                                   want_scale[name].numpy().astype(np.float64).ravel(),
                                   rtol=1e-6, err_msg=name)
    assert got_scale["decoder_wrapper.fusion.layers.1.self_attn.q_proj.weight"] == \
        pytest.approx(0.9 ** (layers - 1))


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpreter mode on CPU."""
    orig = jfa.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


@pytest.mark.parametrize("mask", [True, False])
def test_plain_attention_matches_pallas_with_per_sample_bias(interpret, mask):
    """L = 320 (> 304: two walks on the card), B = 2, H = 2 of 64, a
    (B, H, L, L) bias and ragged key pads: the forward and dq, dk, dv,
    d(bias) of the plain versions against ``_flash_fwd`` / ``_flash_bwd``,
    fp32, within 1e-5."""
    b, l, h, d = 2, 320, 2, 64
    rs = np.random.RandomState(int(mask))
    q, k, v, g = (rs.randn(b, l, h * d).astype(np.float32) for _ in range(4))
    rel = rs.randn(b, h, l, l).astype(np.float32)
    kb = None
    if mask:
        kb = np.zeros((b, l), np.float32)
        kb[1, l - 57:] = jfa.NEG_INF
    jargs = [None if x is None else jnp.asarray(x) for x in (q, k, v, rel, kb)]
    targs = [None if x is None else torch.as_tensor(x) for x in (q, k, v, rel, kb)]
    want = jfa._flash_fwd(*jargs, 0.125, h)
    got = tfa.flash_attention_plain(*targs, 0.125, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jq, jk, jv, jrel, jkb = jargs
    want = jfa._flash_bwd(jq, jk, jv, jnp.asarray(g), jrel, jkb, 0.125, h)
    tq, tk, tv, trel, tkb = targs
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, torch.as_tensor(g), trel, tkb, 0.125, h)
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(x.shape) == tuple(y.shape), name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5, err_msg=name)
