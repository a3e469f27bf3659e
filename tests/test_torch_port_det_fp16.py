"""Detection in fp16, the port against the JAX package on the CPU at toy
size: the plain det attention forward and backward in fp16 (the oracle of
the fp16 arms of kernels #4-#6) against ``_xla_core`` and its ``jax.vjp``
in fp16, every bias combination on a non-square grid and both biases on a
square one, and against the interpreted Pallas ``_det_flash_fwd`` /
``_det_flash_bwd`` in fp16 with both biases on the non-square grid;
``DetAttentionFunction`` on fp16 CPU tensors; the toy detector's training
loss and gradients in fp16 against ``jax.value_and_grad`` of the JAX
detection loss in fp16; and two ``Trainer`` steps under ``common.fp16``
against the JAX ``Trainer`` under ``common.fp16`` (the loss,
``loss_scale``, ``skipped`` and the parameters' updates).  The weights come
from the port's ``fill_random_`` and reach JAX through ``params_to_jax``.

Tolerances, each set against how far the JAX package's own fp16 result
lies from its fp32 result on the same inputs:
- attention: JAX's fp16 outputs and gradients lie 3.6e-4 to 1.0e-3 of their
  largest entry from its fp32 ones here; the port's lie within 8e-4 of
  JAX's fp16 ones (and of the interpreted Pallas kernels'), so the bound is
  2e-3 of the largest entry, and the fp32 log-sum-exp 1e-5;
- the detector's loss is fp32 in both (the criterion sums in fp32): 1e-4
  relative.  Its gradients, relative L2: all of them together, the port's
  fp16 gradient no further from JAX's fp16 one, nor from the fp32 one, than
  twice JAX's fp16 gradient lies from the fp32 one (JAX 2.2e-2; the port
  1.5e-2 from JAX's, 1.9e-2 from fp32); each parameter's, the port's fp16
  gradient within twice JAX's own fp16-to-fp32 distance for that parameter
  plus 5e-2 of JAX's fp16 gradient.  The floor is set by the cascade's last
  stage, whose RoIs are the fp16-rounded boxes of the stage before: its fc2
  weight and bias lie 2.2e-2 and 2.1e-2 from JAX's fp16 gradients here,
  where JAX's own fp16 gradients lie 1.9e-3 and 1.1e-3 from fp32 (the next
  largest excess over twice JAX's distance is 3e-4).  A gradient that is
  zero lies 1 away, one of the wrong sign 2.  The port's fp32 gradient
  stands in for JAX's fp32 one: the two agree to 1.4e-5 here
  (``test_torch_port_det_train.py`` holds them to 1e-4);
- the ``Trainer`` steps: the loss scale and the skips are exact; the loss
  and the gradient norm to 3e-3 relative (``test_torch_port_fp16_train.py``'s
  bound).  The parameters' updates over the steps, relative L2: all of them
  together as the gradients; each parameter's, the port's fp16 update
  within twice JAX's own fp16-to-fp32 distance for that parameter plus 0.3
  of JAX's fp16 update.  AdamW's first steps move an element by about the
  learning rate whatever its gradient's size, so an element whose gradient
  is near 0 may move either way in fp16: the FPN's ``scale_4_0.up1.bias``
  lies 0.313 from JAX's fp16 update here where JAX's lies 3.3e-2 from fp32
  (the largest excess, 0.246; every other parameter is within 1.13 times
  JAX's distance).  An update that is zero lies 1 away, one of the wrong
  sign 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.core.config import FrameworkConfig
from one_peace_tpu.criterions.vision_criterions import DetectionCriterion as JaxDetectionCriterion
from one_peace_tpu.ops import det_attention as jda
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.parallel.mesh import make_mesh
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu.vision import det_train as jdt
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.ops import det_attention as tda
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision import det_train as tdt
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector
from test_torch_port_det_attention_bwd import DH, HEADS, SCALING, _operands
from test_torch_port_det_train import GEOMETRY, MASK_STRIDE, _batch

ATTN_TOL, LSE_TOL = 2e-3, 1e-5
LOSS_TOL, STEP_TOL = 1e-4, 3e-3
GRAD_FLOOR, UPDATE_FLOOR = 5e-2, 0.3  # each parameter's, beside twice JAX's own fp16 distance
GRAD_NAMES = ("dq", "dk", "dv", "dtoep", "dbh", "dbw")


@pytest.fixture(autouse=True, scope="module")
def _without_onednn():
    """PyTorch's own CPU kernels: oneDNN builds its fp16 kernels at their
    first use, ~55 s for the toy detector's first fp16 step on an 8-core
    CPU (the step after it takes ~1 s)."""
    saved, torch.backends.mkldnn.enabled = torch.backends.mkldnn.enabled, False
    yield
    torch.backends.mkldnn.enabled = saved


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_attention(q, k, v, g, toep, bh, bw, hw, dtype):
    """``_xla_core`` on q, k, v in ``dtype`` (the biases fp32) and its vjp
    of g in ``dtype``: the output and (dq, dk, dv, dtoep, dbh, dbw)."""
    jargs = [jnp.asarray(x, dtype) for x in (q, k, v)]
    jbias = [None if x is None else jnp.asarray(x) for x in (toep, bh, bw)]

    def core(q_, k_, v_, toep_, bh_, bw_):
        return jda._xla_core(q_, k_, v_, toep_, bh_, bw_, hw, SCALING, HEADS)

    out, vjp = jax.vjp(core, *jargs, *jbias)
    return out, vjp(jnp.asarray(g, dtype))


@pytest.mark.parametrize("hw,toep_on,decomp_on,pallas", [
    ((4, 6), True, True, True), ((4, 6), True, False, False), ((4, 6), False, True, False),
    ((4, 6), False, False, False), ((8, 8), True, True, False)])
def test_plain_fp16_matches_jax(monkeypatch, hw, toep_on, decomp_on, pallas):
    """``det_attention_plain`` and ``det_attention_bwd_plain`` on fp16 q, k,
    v, g (fp32 biases) against ``_xla_core`` and its vjp in fp16; with
    ``pallas``, also against the interpreted Pallas forward (output and
    LSE) and backward in fp16 from the same output and LSE."""
    hg, wg = hw
    q, k, v, g, toep, bh, bw = _operands(hg * 10 + wg + 1, hg, wg, toep_on, decomp_on)
    b, l = q.shape[:2]
    want_out, want_grads = _jax_attention(q, k, v, g, toep, bh, bw, hw, jnp.float16)
    tq, tk, tv, tg = (_t(x).half() for x in (q, k, v, g))
    tbias = [None if x is None else _t(x) for x in (toep, bh, bw)]
    out, lse = tda.det_attention_plain(tq, tk, tv, *tbias, hw, SCALING, HEADS, with_lse=True)
    grads = tda.det_attention_bwd_plain(tq, tk, tv, *tbias, out, tg, lse, hw, SCALING, HEADS)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert all(x.dtype == torch.float16 for x in grads[:3])
    assert all(x is None or x.dtype == torch.float32 for x in grads[3:])
    assert _rel_max(out, want_out) <= ATTN_TOL
    for name, x, y in zip(GRAD_NAMES, grads, want_grads):
        assert (x is None) == (y is None), name
        if x is not None:
            assert _rel_max(x, y) <= ATTN_TOL, name
    # the fp32 log-sum-exp of the fp16 inputs' logits
    logits = tda._biased_logits(*(x.reshape(b, l, HEADS, DH).float() for x in (tq, tk)),
                                *tbias, hw, SCALING)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(), rtol=LSE_TOL,
                               atol=LSE_TOL)
    if not pallas:
        return
    monkeypatch.setattr(jfa, "INTERPRET", True)
    jargs = [jnp.asarray(x, jnp.float16) for x in (q, k, v)]
    jbias = [None if x is None else jnp.asarray(x) for x in (toep, bh, bw)]
    p_out, p_lse = jda._det_flash_fwd(*jargs, *jbias, hw, SCALING, HEADS, with_lse=True)
    p_grads = jda._det_flash_bwd(*jargs, *jbias, p_out, jnp.asarray(g, jnp.float16), p_lse, hw,
                                 SCALING, HEADS)
    assert _rel_max(out, p_out) <= ATTN_TOL
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse).reshape(b, HEADS, l),
                               rtol=LSE_TOL, atol=LSE_TOL)
    for name, x, y in zip(GRAD_NAMES, grads, p_grads):
        if x is not None:
            assert _rel_max(x, y) <= ATTN_TOL, name


def test_function_on_fp16_cpu_tensors():
    """``det_flash_attention`` on fp16 CPU tensors runs
    ``DetAttentionFunction`` on the plain versions (no launch counted): its
    output is the plain forward's and autograd's gradients of q, k and v are
    the plain backward's (through ``compute_decomp`` for q), in fp16."""
    hg, wg = 3, 5
    q, k, v, g, toep, _, _ = _operands(35, hg, wg, True, False)
    b, l = q.shape[:2]
    rs = np.random.RandomState(36)
    rel_h = _t(rs.randn(2 * hg - 1, DH) * 0.3).float()
    rel_w = _t(rs.randn(2 * wg - 1, DH) * 0.3).float()
    leaves = [_t(x).half().reshape(b, l, HEADS, DH).requires_grad_() for x in (q, k, v)]
    before = (tda.launches, tda.bwd_launches)
    out = tda.det_flash_attention(*leaves, _t(toep), rel_h, rel_w, (hg, wg), SCALING)
    dq, dk, dv = torch.autograd.grad(out, leaves, _t(g).half().reshape(out.shape))
    assert (tda.launches, tda.bwd_launches) == before
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.float16

    flat = [x.detach().reshape(b, l, HEADS * DH) for x in leaves]
    bh, bw = tda.compute_decomp(leaves[0].detach(), rel_h, rel_w, (hg, wg))
    want, lse = tda.det_attention_plain(*flat, _t(toep), bh, bw, (hg, wg), SCALING, HEADS,
                                        with_lse=True)
    assert torch.equal(out.reshape(want.shape), want)
    grads = tda.det_attention_bwd_plain(*flat, _t(toep), bh, bw, want,
                                        _t(g).half(), lse, (hg, wg), SCALING, HEADS)
    assert torch.equal(dk.reshape(grads[1].shape), grads[1])
    assert torch.equal(dv.reshape(grads[2].shape), grads[2])
    # dq: the Function's dq plus the decomposed bias's share, dbh and dbw
    # chained through compute_decomp
    qd = leaves[0].detach().requires_grad_()
    share, = torch.autograd.grad(tda.compute_decomp(qd, rel_h, rel_w, (hg, wg)), qd,
                                 (grads[4], grads[5]))
    assert torch.equal(dq, grads[0].reshape(dq.shape) + share)


# ---------------------------------------------------------------------------
# the toy detector in fp16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def detector():
    """The toy RPN detector (kernel arm, no remat) filled by ``fill_random_``
    and its JAX tree."""
    det = OnePeaceDetector(proposer="rpn", device="cpu", attn_impl="pallas",
                           checkpoint_activations=False, **GEOMETRY)
    fill_random_(det, torch.Generator().manual_seed(3))
    return det, model_to_jax(det)


def _cast_tree(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype) if np.issubdtype(
        np.asarray(x).dtype, np.floating) else jnp.asarray(x), tree)


def _port_loss_and_grads(det, dtype, arrays):
    """The port's loss, metrics and {name: gradient} with the detector cast
    to ``dtype`` (a copy), deterministic, the balanced sampler."""
    model = OnePeaceDetector(proposer="rpn", device="cpu", attn_impl="pallas",
                             checkpoint_activations=False, **GEOMETRY)
    model.load_state_dict(det.state_dict())
    model.to(dtype).requires_grad_(True)
    imgs, boxes, labels, valid, masks = arrays
    loss, metrics = tdt.detector_training_loss(
        model, _t(imgs).to(dtype), *map(_t, (boxes, labels, valid, masks)),
        mask_stride=MASK_STRIDE, rpn_sampler="balanced", deterministic=True)
    loss.backward()
    return loss, metrics, {name: p.grad.double() for name, p in model.named_parameters()}


def _rel_l2(a, b):
    return float((a - b).norm() / max(b.norm(), 1e-30))


def test_detector_training_loss_fp16_matches_jax(detector):
    """The whole objective with masks in fp16 (weights and images cast to
    fp16, deterministic, the balanced sampler): the loss and metrics against
    ``jax.value_and_grad`` of the JAX loss in fp16, and the gradients, each
    parameter's and all together, within bounds set by JAX's own fp16
    distance from fp32 (the module's docstring)."""
    det, tree = detector
    arrays = _batch(13)
    imgs, boxes, labels, valid, masks = arrays
    jdet = JaxDetector(proposer="rpn", checkpoint_activations=False, attn_impl="xla",
                       **GEOMETRY)

    def jloss(p, x):
        return jdt.detector_training_loss(jdet, p, x, *map(jnp.asarray, (boxes, labels, valid,
                                                                         masks)),
                                          mask_stride=MASK_STRIDE, rpn_sampler="balanced")

    (want, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _cast_tree(tree, jnp.float16), jnp.asarray(imgs, jnp.float16))
    loss, metrics, grads = _port_loss_and_grads(det, torch.float16, arrays)
    _, _, grads32 = _port_loss_and_grads(det, torch.float32, arrays)
    assert loss.dtype == torch.float32
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_TOL)
    assert set(metrics) == set(jm)
    for key in jm:
        got = float(metrics[key].detach())
        assert got == pytest.approx(float(jm[key]), rel=STEP_TOL, abs=1e-3), key
    ref = {name: _t(x).double()
           for name, x in params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                       jg)).items()}
    assert set(ref) == set(grads)
    for name, g in grads.items():
        gap = _rel_l2(ref[name], grads32[name])
        assert _rel_l2(g, ref[name]) <= 2 * gap + GRAD_FLOOR, (name, _rel_l2(g, ref[name]), gap)
    names = sorted(grads)
    port, jax16, fp32 = (torch.cat([d[n].flatten() for n in names])
                         for d in (grads, ref, grads32))
    gap = _rel_l2(jax16, fp32)
    assert _rel_l2(port, jax16) <= 2 * gap and _rel_l2(port, fp32) <= 2 * gap


def _det_trainer_cfg(fp16: bool) -> FrameworkConfig:
    cfg = FrameworkConfig()
    cfg.model.encoder.layers = GEOMETRY["layers"]
    cfg.criterion._name = "detection_criterion"
    cfg.criterion.rpn_sampler = "balanced"
    cfg.common.fp16, cfg.common.bf16 = fp16, False
    cfg.optimization.lr, cfg.optimization.clip_norm = 1e-3, 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.lr_scheduler.warmup_updates = 0
    return cfg


def _port_trainer(det, cfg) -> Trainer:
    """The port's ``Trainer`` on a copy of ``det`` with the criterion's
    proposal jitter off (no generator reaches it), as on the JAX side."""
    model = OnePeaceDetector(proposer="rpn", device="cpu", attn_impl="pallas",
                             checkpoint_activations=False, **GEOMETRY)
    model.load_state_dict(det.state_dict())
    criterion = build_criterion(cfg.criterion)
    return Trainer(cfg, model, lambda model, batch, generator=None, deterministic=False:
                   criterion(model, batch, None, deterministic), total_updates=10)


def test_fp16_trainer_step_matches_jax_trainer(detector):
    """``Trainer`` steps under ``common.fp16`` on the toy detector against
    the JAX ``Trainer`` under ``common.fp16`` on the same weights and batch
    (the balanced sampler, no proposal jitter on either side): each step's
    loss, ``loss_scale``, ``skipped`` and gradient norm; and the parameters'
    updates over the steps, each parameter's and all together, within
    bounds set by JAX's own fp16 distance from the fp32 update (the
    module's docstring).  The port's fp32 ``Trainer`` stands in for JAX's
    fp32 one.  The images are fp16: on an fp32 batch (what the collate gives)
    the JAX model promotes its activations to fp32 against the fp16
    weights and its mask head's transposed conv raises on the mixed dtypes
    (``one_peace_tpu/vision/cascade_rcnn.py:279``), while the port casts the
    images to the weights' dtype and computes in fp16 either way."""
    det, tree = detector
    cfg = _det_trainer_cfg(fp16=True)
    jcrit = JaxDetectionCriterion(cfg.criterion)
    jdet = JaxDetector(proposer="rpn", checkpoint_activations=False, attn_impl="xla",
                       **GEOMETRY)
    jax_trainer = JaxTrainer(
        cfg, jdet, lambda model, params, batch, rng=None, deterministic=False: jcrit(
            model, params, batch, None, deterministic),
        params=_cast_tree(tree, jnp.float32), mesh=make_mesh(1, 1, 1, devices=jax.devices()[:1]),
        total_updates=10)
    port, port32 = _port_trainer(det, cfg), _port_trainer(det, _det_trainer_cfg(fp16=False))
    imgs, boxes, labels, valid, masks = _batch(21)
    batch = {"src_images": imgs.astype(np.float16), "gt_boxes": boxes, "gt_labels": labels,
             "gt_valid": valid, "gt_masks": masks}
    skipped = []
    for _ in range(2):
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        port32.train_step(batch)
        assert got["loss_scale"] == want["loss_scale"]
        assert got["skipped"] == want["skipped"]
        skipped.append(got["skipped"])
        for key in ("loss", "gnorm"):
            if np.isfinite(want[key]):
                assert got[key] == pytest.approx(want[key], rel=STEP_TOL), key
    assert skipped[-1] == 0.0  # the last step updated the parameters
    jparams = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                           jax_trainer.params))
    before, after16, after32 = (
        {n: p.detach().double() for n, p in m.named_parameters()}
        for m in (det, port.model, port32.model))
    updates = {name: (after16[name] - before[name], jparams[name].double() - before[name],
                      after32[name] - before[name]) for name in before}
    for name, (u16, j16, u32) in updates.items():
        assert port.model.get_parameter(name).dtype == torch.float32, name
        gap = _rel_l2(j16, u32)
        assert _rel_l2(u16, j16) <= 2 * gap + UPDATE_FLOOR, (name, _rel_l2(u16, j16), gap)
    u16, j16, u32 = (torch.cat([u[i].flatten() for u in updates.values()]) for i in range(3))
    gap = _rel_l2(j16, u32)
    assert _rel_l2(u16, j16) <= 2 * gap and _rel_l2(u16, u32) <= 2 * gap
