"""fp16 in the port against the JAX package, on CPU at toy size: the
dynamic loss scaler's state machine, the ``Trainer`` under ``common.fp16``
(loss scaling, skipped steps, accumulation), the plain attention forward and
backward in fp16 (the oracle of the kernels' fp16 arms), fp16 hub
embeddings, the int8 serving path writing fp16, and the detection
recipe's ``Trainer`` taking a step in fp16.

Tolerances: the scaler is exact (both hold the scale in fp32 and round
alike).  fp16 rounds every op's output to 11 significant bits (half an ulp
is 2^-11, 4.9e-4, relative), and the two frameworks round at other places
(XLA fuses elementwise chains and rounds once where PyTorch rounds per op),
so the fp16 losses, norms and outputs agree to a few of those units: 3e-3
relative for the losses, 5e-3 for the gradient norms, the parameters and
the embeddings; the loss scale and the skips are exact."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_model_config
from one_peace_tpu import hub as jax_hub
from one_peace_tpu.core.config import TaskConfig
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.ops import quant as jq
from one_peace_tpu.optim import loss_scaler as jls
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops import quant
from one_peace_tpu_torch.optim.loss_scaler import LossScaler
from one_peace_tpu_torch.tasks.vision_tasks import CocoDetectionTask
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from test_torch_port_hub import assets as hub_assets  # noqa: F401  (a fixture)
from test_torch_port_train import _batch, _framework_cfg, _np_tree, _port_model, _trainers, _weights

FP16_LOSS_TOL, FP16_TOL = 3e-3, 5e-3
DET_RECIPE = "recipes/detection/cascade_mask_rcnn_1024.yaml"


# ---------------------------------------------------------------------------
# the loss scaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init_scale,window,good", [(2.0**15, 2000, 0.8), (4.0, 3, 0.8),
                                                     (1e-3, 2, 0.4)])
def test_loss_scaler_matches_jax(init_scale, window, good):
    """Over a seeded sequence of finite and non-finite steps (a share
    ``good`` finite): growth after ``window`` good steps, halving, and the
    1e-4 floor (reached from init 1e-3), the scale and the good-step count
    equal to JAX's at every step."""
    flags = np.random.RandomState(int(window)).rand(300) < good
    port = LossScaler(init_scale=init_scale, scale_window=window)
    state = jls.init_loss_scale(init_scale)
    scales = set()
    for finite in flags:
        port.update(bool(finite))
        state = jls.update_loss_scale(state, jnp.asarray(finite), scale_window=window)
        assert np.float32(port.scale) == np.asarray(state.scale)
        assert port.good_steps == int(state.good_steps)
        scales.add(float(port.scale))
    assert len(scales) > 2  # the scale moved both ways
    if init_scale == 1e-3:
        assert float(np.float32(1e-4)) in scales


def test_scale_and_unscale_match_jax():
    """``scale_loss`` casts the scale to the loss's dtype (an fp16 loss of 3
    times 2^15 overflows to inf, as in JAX); ``unscale_`` multiplies the fp32
    gradients by the fp32 1 / scale."""
    port, state = LossScaler(init_scale=3.0), jls.init_loss_scale(3.0)
    grads = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    want = np.asarray(jls.unscale_grads(state, {"g": jnp.asarray(grads)})["g"])
    got = [torch.as_tensor(grads.copy())]
    port.unscale_(got)
    np.testing.assert_array_equal(got[0].numpy(), want)
    for dtype, jdtype in ((torch.float16, jnp.float16), (torch.float32, jnp.float32)):
        for loss in (0.7, 3.0):
            big = LossScaler()
            got = big.scale_loss(torch.tensor(loss, dtype=dtype))
            want = jls.scale_loss(jls.init_loss_scale(), jnp.asarray(loss, jdtype))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    assert math.isinf(float(LossScaler().scale_loss(torch.tensor(3.0, dtype=torch.float16))))


# ---------------------------------------------------------------------------
# the Trainer in fp16
# ---------------------------------------------------------------------------


def _fp16_cfg(update_freq=1):
    cfg = _framework_cfg(update_freq=update_freq)
    cfg.common.fp16 = True  # wins over common.bf16, as the recipes keep it
    cfg.common.bf16 = True
    return cfg


def _assert_params_close(port, jax_trainer, tol):
    want = params_from_jax(_np_tree(jax_trainer.params))
    for name, p in port.model.named_parameters():
        assert p.dtype == torch.float32, name  # the masters stay fp32
        w = want[name].double()
        err = (p.detach().double() - w).norm() / max(w.norm(), 1e-12)
        assert err <= tol, (name, float(err))


@pytest.mark.parametrize("update_freq", [1, 2])
def test_fp16_trainer_matches_jax_trainer(update_freq):
    """Three updates in fp16 with dynamic loss scaling, warmup, weight
    decay, clip and layer decay: the first micro-step overflows the initial
    scale of 2^15 in both (the loss is above 2), is skipped and halves the
    scale; then the losses, norms, scale, skips and the parameters agree."""
    cfg = _fp16_cfg(update_freq)
    port, jax_trainer = _trainers(cfg)
    assert port.compute_dtype == torch.float16
    for i in range(3 * update_freq + 1):
        batch = _batch(cfg.model, b=6, seed=i)
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        assert got["loss_scale"] == want["loss_scale"]
        assert got["skipped"] == want["skipped"]
        assert got["loss"] == pytest.approx(want["loss"], rel=FP16_LOSS_TOL)
        if math.isfinite(want["gnorm"]):
            assert got["gnorm"] == pytest.approx(want["gnorm"], rel=FP16_TOL)
        else:
            assert not math.isfinite(got["gnorm"])
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert port.step == jax_trainer.step
    assert port.scaler.scale == np.float32(2.0**14)
    _assert_params_close(port, jax_trainer, FP16_TOL)


def test_nan_batch_is_skipped_and_halves_the_scale():
    """As the JAX package's fp16 test: after a good step, a NaN batch is
    skipped (``skipped`` 1), the scale halves, and the parameters, the
    optimizer state and the accumulation stay bit for bit; the next good
    step trains on."""
    cfg = _fp16_cfg(update_freq=2)
    _, state = _weights(cfg.model)
    port = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    port.scaler.scale = np.float32(2.0**8)  # the toy loss fits: the good steps are finite
    good = _batch(cfg.model, b=4)
    for _ in range(3):
        assert port.train_step(good)["skipped"] == 0.0
    before, scale = port.state_dict(), port.scaler.scale
    poison = dict(good, src_images=np.full_like(good["src_images"], np.nan))
    metrics = port.train_step(poison)
    assert metrics["skipped"] == 1.0 and metrics["loss_scale"] == scale / 2
    after = port.state_dict()
    for name in before["params"]:
        torch.testing.assert_close(after["params"][name], before["params"][name], rtol=0, atol=0)
    for a, b in zip(after["acc"], before["acc"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for key, st in before["opt_state"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(after["opt_state"]["state"][key][k], v, rtol=0, atol=0)
    assert after["loss_scale"] == {"scale": float(scale / 2), "good_steps": 0}
    assert port.train_step(good)["skipped"] == 0.0


def test_fp16_state_round_trip_carries_the_scale():
    cfg = _fp16_cfg()
    _, state = _weights(cfg.model)
    first = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    first.train_step(_batch(cfg.model, b=6))  # the first step overflows: the scale halves
    bundle = first.state_dict()
    second = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    second.load_state_dict(bundle)
    assert second.scaler.state_dict() == first.scaler.state_dict() == {
        "scale": 2.0**14, "good_steps": 0}


def test_detection_fp16_builds_a_trainer_and_steps():
    """The detection recipe with common.fp16 builds a ``Trainer`` and takes
    a step in fp16 with loss scaling: the det attention runs its fp16
    arm (the plain version on the CPU; kernels #4-#6 on the card), the
    masters stay fp32 and the step is finite or skipped with the scale
    halved (``test_torch_port_det_fp16.py`` holds it to the JAX Trainer)."""
    cfg = load_config(DET_RECIPE, ["model.encoder.layers=4", "model.encoder.embed_dim=32",
                                   "model.encoder.ffn_embed_dim=64",
                                   "model.encoder.attention_heads=4", "task.image_size=64",
                                   "task.window_size=2", "task.num_classes=4",
                                   "task.max_proposals=16", "common.fp16=true",
                                   "distributed.fsdp=1"])  # one process
    det = CocoDetectionTask.build_model(cfg, device="cpu")
    fill_random_(det, torch.Generator().manual_seed(0))
    cfg.criterion._name = CocoDetectionTask.criterion_name
    trainer = Trainer(cfg, det, build_criterion(cfg.criterion), total_updates=4)
    assert trainer.compute_dtype == torch.float16
    rs = np.random.RandomState(0)
    boxes = np.array([[[4.0, 6.0, 40.0, 30.0], [20.0, 10.0, 60.0, 50.0]]] * 2, np.float32)
    masks = np.zeros((2, 2, 16, 16), np.uint8)
    masks[:, :, 2:8, 1:10] = 1
    batch = {"src_images": rs.randn(2, 3, 64, 64).astype(np.float32), "gt_boxes": boxes,
             "gt_labels": np.array([[1, 2], [0, 3]]), "gt_valid": np.ones((2, 2), bool),
             "gt_masks": masks}
    saved, torch.backends.mkldnn.enabled = torch.backends.mkldnn.enabled, False
    try:  # PyTorch's own CPU kernels: oneDNN builds its fp16 ones at first use, ~55 s
        metrics = trainer.train_step(batch)
    finally:
        torch.backends.mkldnn.enabled = saved
    assert metrics["skipped"] in (0.0, 1.0) and np.isfinite(metrics["loss"])
    assert metrics["loss_scale"] == 2.0**15 / (2.0 if metrics["skipped"] else 1.0)
    assert all(p.dtype == torch.float32 for p in det.parameters())


# ---------------------------------------------------------------------------
# the plain attention in fp16 (the kernels' fp16 oracle)
# ---------------------------------------------------------------------------


def _attention_inputs(l, bias, b=2, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, l, h * d).astype(np.float32) for _ in range(4))
    rel = {"shared": rng.randn(h, l, l), "batched": rng.randn(b, h, l, l),
           None: None}[bias]
    rel = None if rel is None else rel.astype(np.float32)
    key_bias = np.zeros((b, l), np.float32)
    key_bias[1, l - l // 3:] = jfa.NEG_INF
    return q, k, v, g, rel, key_bias


@pytest.mark.parametrize("l,bias", [(16, "shared"), (37, "batched"), (71, None)])
def test_plain_attention_fp16_matches_jax_xla(l, bias):
    """``flash_attention_plain`` and ``flash_attention_bwd_plain`` on fp16
    q, k, v, g against the JAX XLA arm (``_xla_reference`` and its vjp) in
    fp16: outputs and gradients relative to their largest entry, d(bias)
    in fp32."""
    q, k, v, g, rel, kb = _attention_inputs(l, bias)
    jq_, jk, jv, jg = (jnp.asarray(x, jnp.float16) for x in (q, k, v, g))
    jrel = None if rel is None else jnp.asarray(rel)

    def f(q_, k_, v_, rel_):
        return jfa._xla_reference(q_, k_, v_, rel_, jnp.asarray(kb), 0.25, 4)

    if jrel is None:
        want_out, vjp = jax.vjp(lambda q_, k_, v_: f(q_, k_, v_, None), jq_, jk, jv)
    else:
        want_out, vjp = jax.vjp(f, jq_, jk, jv, jrel)
    want = vjp(jg)
    tq, tk, tv, tg = (torch.as_tensor(x).half() for x in (q, k, v, g))
    trel = None if rel is None else torch.as_tensor(rel)
    out = tfa.flash_attention_plain(tq, tk, tv, trel, torch.as_tensor(kb), 0.25, 4)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tg, trel, torch.as_tensor(kb), 0.25, 4)
    assert out.dtype == torch.float16 and all(x.dtype == torch.float16 for x in got[:3])
    for x, y in zip((out, *got), (want_out, *want)):
        if x is None:
            continue
        y = np.asarray(y, np.float64)
        err = np.abs(x.double().numpy() - y).max() / np.abs(y).max()
        assert err <= FP16_TOL, err


# ---------------------------------------------------------------------------
# serving in fp16: the hub and the int8 path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "ffn"])
def test_fp16_hub_embeddings_match_jax(hub_assets, quantize):  # noqa: F811
    """Both ``from_pretrained``s with ``dtype="fp16"`` on one ``.pt``: text,
    image and audio embeddings agree, and stay near the fp32 ones."""
    kw = dict(bpe_dir=hub_assets["bpe"], model_cfg=hub_assets["cfg"],
              task_cfg=TaskConfig(patch_image_size=32), quantize=quantize)
    jh = jax_hub.from_pretrained(hub_assets["pt"], dtype="fp16", **kw)
    th = hub.from_pretrained(hub_assets["pt"], dtype="fp16", device="cpu", **kw)
    t32 = hub.from_pretrained(hub_assets["pt"], dtype="float32", device="cpu", **kw)
    texts = ["a dog barking", "A cow in a field, mooing loudly!"]
    for name, run in (
            ("text", lambda h: h.extract_text_features(h.process_text(texts))),
            ("image", lambda h: h.extract_image_features(h.process_image(hub_assets["images"]))),
            ("audio", lambda h: h.extract_audio_features(*h.process_audio(hub_assets["audios"])))):
        got, want, ref = run(th), np.asarray(run(jh), np.float32), run(t32)
        assert got.dtype == torch.float16, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=FP16_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=0, atol=4 * FP16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (13, 100, 70), (260, 520, 515)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_ffn_fp16_matches_jax_quantized_linear(m, k, n, bias):
    """``quantized_linear`` on fp16 CPU tensors (the plain row quantize and
    GEMM, the fp16 oracle of #3/3b) against the JAX package's on the same
    fp16 weights: the same bits, written in fp16."""
    rng = np.random.RandomState(m + k)
    x = (rng.randn(2, m, k) * 2).astype(np.float32)
    w = (rng.randn(n, k) * 0.05).astype(np.float32)
    b = (rng.randn(n) * 0.1).astype(np.float32) if bias else None
    params = jq.quantize_weight(jnp.asarray(w.T, jnp.float16))
    if bias:
        params["b"] = jnp.asarray(b, jnp.float16)
    want = np.asarray(jq.quantized_linear(params, jnp.asarray(x, jnp.float16)))
    w_q, scale = quant.quantize_weight(torch.as_tensor(w).half())
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(params["w_q"]).T)
    before = (im.launches, im.quantize_launches)
    got = quant.quantized_linear(torch.as_tensor(x).half(), w_q, scale,
                                 None if b is None else torch.as_tensor(b).half())
    assert got.dtype == torch.float16 and (im.launches, im.quantize_launches) == before
    np.testing.assert_array_equal(got.numpy(), want)
