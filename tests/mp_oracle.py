"""The JAX side of the model-parallel tests: weights for both packages from
one random fairseq state dict, and ``jax.grad`` of the serial JAX model
(``attn_impl="xla"``, fp32) through its criterion, named as the port's
parameters.  Used by ``tests/test_torch_port_{tensor_parallel,
ring_attention,pipeline}.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import model_parallel_workers as mw
import torch_fixture as tf
from helpers import tiny_model_config
from one_peace_tpu.core.config import CriterionConfig
from one_peace_tpu.criterions.criterions import ClassifyCriterion as JaxClassify
from one_peace_tpu.criterions.criterions import ImageTextPretrainCriterion as JaxVLPretrain
from one_peace_tpu.criterions.criterions import ImageTextRetrievalCriterion as JaxImageITC
from one_peace_tpu.models.classify import OnePeaceClassifyModel as JaxClassifyModel
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.utils import checkpoint_convert as jax_convert
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.utils import checkpoint_convert as port_convert
from one_peace_tpu_torch.utils.checkpoint import params_from_jax

GRAD_TOL = 1e-4  # relative to the largest entry of each parameter's gradient
NUM_CLASSES = 5
ITC = "image_text_retrieval_criterion"


def _prune(tree, like):
    if isinstance(like, dict):
        return {k: _prune(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_prune(t, v) for t, v in zip(tree, like)]
    return tree


def pretrain_batch(b, seed):
    """Masked VL samples (``test_torch_port_pretrain_model.vl_batch``)."""
    from test_torch_port_pretrain_model import vl_batch

    return vl_batch(np.random.RandomState(seed), bsz=b)


def retrieval_batch(b, seed, text_len=7):
    """Tokens (b, text_len): the text tower's L is text_len + 1 (the BOS);
    images of 32 px: the image tower's L is 5."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(5, 99, (b, text_len))
    tokens[1, text_len - 3:] = 1  # text pads
    return {"src_tokens": tokens, "src_images": rs.randn(b, 3, 32, 32).astype(np.float32)}


def classify_batch(b, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(5, 99, (b, 6))  # with the BOS and 5 image tokens: L = 12
    tokens[0, 4:] = 1
    return {"src_tokens": tokens, "src_images": rs.randn(b, 3, 32, 32).astype(np.float32),
            "target": rs.randint(0, NUM_CLASSES, (b,))}


class Case:
    """One model on one global batch, on both packages: ``port`` is the
    dict ``model_parallel_workers.build_trainer`` takes (less its layout),
    ``loss`` and ``grads`` are JAX's."""

    def __init__(self, kind: str, batch, seed: int = 0, **enc_kw):
        self.kind, self.batch = kind, batch
        if kind == "pretrain":
            self._pretrain(batch, seed)
            return
        cfg = tiny_model_config(head_type="vl")
        for k, v in enc_kw.items():
            setattr(cfg.encoder, k, v)
        cfg.encoder.attn_impl = "xla"
        sd = tf.make_random_state_dict(cfg, seed=seed)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if kind == "classify":
            tf.add_classify_head_state(sd, cfg, NUM_CLASSES, attn_pooling=True, use_pooler=True)
            params = to_jax(jax_convert.convert_classify_model(dict(sd), cfg))
            state = port_convert.convert_classify_model(dict(sd), cfg)
            model = JaxClassifyModel(cfg, NUM_CLASSES, attn_pooling=True, use_pooler=True)
            crit = JaxClassify(CriterionConfig(_name="classify_criterion"))
            net = {k: v for k, v in jbatch.items() if k != "target"}
            jbatch = {"net_input": net, "target": jbatch["target"]}
            criterion = "classify_criterion"
        else:
            tree = convert_retrieval_model(sd, cfg)
            tree = _prune(tree, jax.eval_shape(lambda: JaxModel(cfg).init(jax.random.PRNGKey(0))))
            params, state = to_jax(tree), params_from_jax(tree)
            model, crit = JaxModel(cfg), JaxImageITC(CriterionConfig(_name=ITC))
            criterion = ITC
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: crit(model, p, jbatch, rng=None, deterministic=True), has_aux=True))(params)
        self.loss = float(loss)
        grads = params_from_jax(jax.tree.map(np.asarray, grads))
        self.grads = {k: v.numpy() for k, v in grads.items()}
        self.params, self.cfg = params, cfg
        self.port = dict(model=mw.model_cfg(**enc_kw), kind=kind, criterion=criterion,
                         state=state, num_classes=NUM_CLASSES, batch=batch,
                         head=dict(attn_pooling=True, use_pooler=True) if kind == "classify"
                         else {})

    def _pretrain(self, batch, seed):
        """The VL pretrain model (encoder and decoder) through the VL
        pretrain criterion (ITC and DCL over its passes)."""
        from test_torch_port_pretrain_model import pretrain_config, pretrain_pair

        cfg = pretrain_config()
        model, params, port = pretrain_pair(cfg, seed)
        ccfg = CriterionConfig(_name="image_text_pretrain_loss")
        crit = JaxVLPretrain(ccfg)
        jbatch = jax.tree.map(jnp.asarray, batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: crit(model, p, jbatch, deterministic=True), has_aux=True))(params)
        self.loss = float(loss)
        self.grads = {k: v.numpy() for k, v in
                      params_from_jax(jax.tree.map(np.asarray, grads)).items()}
        self.params, self.cfg = params, cfg
        self.port = dict(model=mw.pretrain_model_cfg(), kind="pretrain", criterion=ccfg._name,
                         state={k: v.detach().clone() for k, v in port.state_dict().items()},
                         batch=batch)

    def on(self, layout: dict, **kw) -> dict:
        return dict(self.port, layout=layout, **kw)


DROPOUT = dict(dropout=0.1, drop_path_rate=0.2, activation_dropout=0.1)


def with_dropout(case: Case, layout: dict, **kw) -> dict:
    """``case`` on ``layout`` with dropout, activation dropout and drop path
    on, drawn from a seeded generator: held to the port's one-process run
    (the JAX package draws other masks)."""
    import model_parallel_workers as mw

    return dict(case.port, model=mw.model_cfg(**DROPOUT), layout=layout, seed=7, **kw)


def assert_same_run(got, want):
    """A layout's loss and gathered gradients against one process's."""
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        err = np.abs(got["grads"][name].astype(np.float64) - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-12) + 1e-12, (name, err)


def assert_grads_match(got, case: Case):
    """Every parameter's gradient gathered to full against ``jax.grad`` (the
    JAX classify tree keeps the branches its head type does not run: their
    gradients are zero)."""
    assert set(got) <= set(case.grads), sorted(set(got) - set(case.grads))
    for name in set(case.grads) - set(got):
        assert not np.any(case.grads[name]), name
    for name in got:
        want = np.asarray(case.grads[name], np.float64)
        err = np.abs(np.asarray(got[name], np.float64) - want).max()
        assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-12) + 1e-12, (name, err)
