"""The port's pretrain model against the JAX package's, on CPU at toy size.

One JAX ``OnePeacePretrainModel.init`` tree (rel-pos tables, LayerScale
gammas and type embeddings redrawn away from their zero / 1e-6 init, so
that they show) drives both sides through ``params_from_jax``; the JAX side
runs ``attn_impl="xla"``, fp32 throughout.  Held at 1e-4: each adapter's
student gather and decoder scatter (text and image with -1 padded preserve
ids; audio with the frame offset, the fixed positions and the decoder's
adapter without a frontend); the whole model for every ``encoder_type`` in
teacher and student mode on both of the port's ``attn_impl`` arms.
``dcl_loss`` and its gradients against ``jax.value_and_grad`` with padding,
label smoothing and one or two galleries.  Both pretrain criterions: the
loss within 1e-5 relative, the metrics, and the gradients of every
parameter (all together within 1e-4 relative L2, each within 1e-3).  The
export read by the JAX package's ``load_params``, and
``upgrade_stage1_params`` against the JAX model's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_model_config
from one_peace_tpu.core.config import CriterionConfig, decoder_default_config
from one_peace_tpu.criterions import losses as jlosses
from one_peace_tpu.criterions.criterions import (
    AudioTextPretrainCriterion as JaxALCriterion, ImageTextPretrainCriterion as JaxVLCriterion)
from one_peace_tpu.data.collate import collate
from one_peace_tpu.data.masking import (add_whole_word_mask, compute_block_mask_1d,
                                        nested_subset_mask, random_patch_mask,
                                        superset_patch_mask, to_preserve_ids, with_cls)
from one_peace_tpu.models.adapters.audio import AudioAdapter as JaxAudioAdapter
from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.adapters.image import ImageAdapter as JaxImageAdapter
from one_peace_tpu.models.adapters.text import TextAdapter as JaxTextAdapter
from one_peace_tpu.models.pretrain import OnePeacePretrainModel as JaxModel
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.criterions.losses import dcl_loss
from one_peace_tpu_torch.models.adapters.audio import AudioAdapter
from one_peace_tpu_torch.models.adapters.image import ImageAdapter
from one_peace_tpu_torch.models.adapters.text import TextAdapter
from one_peace_tpu_torch.models.pretrain import OnePeacePretrainModel
from one_peace_tpu_torch.utils import native_checkpoint as port_ckpt
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import init_weights_

TOL = 1e-4
LOSS_TOL, ALL_GRAD_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-3
SPEC = ((8, 4, 2), (8, 2, 2))  # 64 samples -> 15 frames
REDRAWN = ("rel_pos_table", "gamma_1", "gamma_2", "type_embedding", "type_embedding_2")


def pretrain_config(audio=False, stage2=False):
    """The toy encoder of ``helpers.tiny_model_config`` (vl or al) and a
    2-layer decoder 16 wide, 2 heads, from ``decoder_default_config``;
    ``attn_impl`` xla on both (the port's models set their own)."""
    cfg = tiny_model_config(head_type="al" if audio else "vl")
    cfg._name = "one_peace_pretrain"
    enc = cfg.encoder
    enc.use_audio_moe, enc.use_image_moe = audio, not audio
    enc.audio_adapter.feature_encoder_spec = SPEC
    enc.attn_impl = "xla"
    dec = decoder_default_config()
    dec.embed_dim, dec.ffn_embed_dim, dec.layers, dec.attention_heads = 16, 32, 2, 2
    dec.use_audio_moe, dec.use_image_moe = audio, not audio
    dec.text_adapter.vocab_size = enc.text_adapter.vocab_size
    dec.attn_impl = "xla"
    cfg.decoder = dec
    cfg.stage2_pretrain = cfg.reset_logit_scale = stage2
    return cfg


def redraw(tree, rs, leaf=""):
    """numpy copy of a JAX tree with the REDRAWN leaves N(0, 0.1^2)."""
    if isinstance(tree, dict):
        return {k: redraw(v, rs, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [redraw(v, rs, leaf) for v in tree]
    a = np.asarray(tree)
    return (rs.randn(*a.shape) * 0.1).astype(a.dtype) if leaf in REDRAWN else a


def pretrain_pair(cfg, seed=0, impl="pallas"):
    """(JAX model, its numpy params, the port's model on CPU with them)."""
    jax_model = JaxModel(cfg)
    params = redraw(jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed))),
                    np.random.RandomState(seed + 1))
    model = OnePeacePretrainModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    model.cfg.encoder.attn_impl = model.cfg.decoder.attn_impl = impl
    return jax_model, params, model


def vl_batch(rs, bsz=4, tok_len=8, num_patches=4):
    """Masked VL samples as the dataset builds them (text pads in row 1)."""
    starts = np.ones(100, bool)
    starts[rs.choice(100, 30, replace=False)] = False  # some continuation pieces
    samples = []
    for i in range(bsz):
        n = tok_len - 1 - (2 if i == 1 else 0)
        text = rs.randint(5, 99, n)
        text_mask = add_whole_word_mask(rs, text, starts, 0.3)
        vl_text_mask = nested_subset_mask(rs, text_mask, 0.4)
        image_mask = random_patch_mask(rs, num_patches, 0.75)
        vl_image_mask = superset_patch_mask(rs, image_mask, 0.5)
        tm, vtm = with_cls(text_mask, True), with_cls(vl_text_mask, True)
        im, vim = with_cls(image_mask), with_cls(vl_image_mask)
        samples.append({
            "id": i, "source_text": np.concatenate([text, [2]]),
            "source_image": rs.randn(3, 32, 32).astype(np.float32),
            "text_mask_indices": tm, "text_preserve_ids": to_preserve_ids(tm),
            "image_mask_indices": im, "image_preserve_ids": to_preserve_ids(im),
            "vl_text_mask_indices": vtm, "vl_text_preserve_ids": to_preserve_ids(vtm),
            "vl_image_mask_indices": vim, "vl_image_preserve_ids": to_preserve_ids(vim)})
    return collate(samples, pad_idx=1)


def al_batch(rs, bsz=4, tok_len=7, wav_lens=(64, 80, 56, 72)):
    """Masked AL samples of clips of different lengths (frame pads)."""
    samples = []
    for i in range(bsz):
        text = rs.randint(5, 99, tok_len - 1 - (i % 2))
        t = conv_output_length(wav_lens[i], SPEC)
        al_text_mask = add_whole_word_mask(rs, text, np.ones(100, bool), 0.4)
        am = with_cls(compute_block_mask_1d(rs, t, 0.55, 2, 0.1))
        alam = with_cls(compute_block_mask_1d(rs, t, 0.45, 2, 0.1))
        altm = with_cls(al_text_mask, True)
        samples.append({
            "id": i, "source_text": np.concatenate([text, [2]]),
            "source_audio": rs.randn(wav_lens[i]).astype(np.float32),
            "audio_padding_mask": np.zeros(t + 1, bool),
            "audio_mask_indices": am, "audio_preserve_ids": to_preserve_ids(am),
            "al_text_mask_indices": altm, "al_text_preserve_ids": to_preserve_ids(altm),
            "al_audio_mask_indices": alam, "al_audio_preserve_ids": to_preserve_ids(alam)})
    return collate(samples, pad_idx=1)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _jnp(d):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}


def _pt(d):
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# the adapters' preserve-id paths
# ---------------------------------------------------------------------------


def _adapter_pair(kind, enc_cfg, seed=0):
    jax_cls, port_cls = {"text": (JaxTextAdapter, TextAdapter),
                         "image": (JaxImageAdapter, ImageAdapter),
                         "audio": (JaxAudioAdapter, AudioAdapter)}[kind]
    cfg = getattr(enc_cfg, f"{kind}_adapter")
    jax_adapter = jax_cls(cfg, enc_cfg.embed_dim, enc_cfg.attention_heads)
    params = redraw(jax.tree.map(np.asarray, jax_adapter.init(jax.random.PRNGKey(seed))),
                    np.random.RandomState(seed))
    adapter = port_cls(cfg, enc_cfg.embed_dim, enc_cfg.attention_heads, device="cpu")
    adapter.load_state_dict(params_from_jax(params), strict=True)
    return jax_adapter, params, adapter


def _check_adapter(jax_adapter, params, adapter, args, kw):
    want = jax_adapter(params, *map(jnp.asarray, args), **_jnp(kw))
    got = adapter(*map(torch.as_tensor, args), **_pt(kw))
    for name, g, w in zip(("x", "padding_mask", "rel_bias"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert tuple(g.shape) == tuple(w.shape), (name, g.shape, w.shape)
            _close(g, w)
    return got


PRESERVE = np.array([[0, 2, 3, 5, 7], [0, 1, 4, -1, -1], [0, 6, -1, -1, -1]])
IMAGE_PRESERVE = np.array([[0, 1, 2, 3, 4], [0, 2, 4, -1, -1], [0, 3, -1, -1, -1]])  # 2 x 2 + 1


@pytest.mark.parametrize("kind", ["text", "image", "audio"])
def test_student_gather_matches_jax(kind):
    """Teacher and student passes of one adapter: the -1 padded ids become
    pads, the bias per sample (tables, B, H, P, P); audio ids count CLS +
    frames (id i is frame row i - 1) and the positional convs run over the
    kept frames."""
    cfg = pretrain_config(audio=kind == "audio")
    jax_adapter, params, adapter = _adapter_pair(kind, cfg.encoder)
    rs = np.random.RandomState(3)
    if kind == "text":
        args = (rs.randint(5, 99, (3, 8)),)
        args[0][2, 5:] = 1
    elif kind == "image":
        args = (rs.randn(3, 3, 32, 32).astype(np.float32),)
    else:
        pad = np.zeros((3, conv_output_length(64, SPEC) + 1), bool)
        pad[2, -4:] = True
        args = (rs.randn(3, 64).astype(np.float32), pad)
    ids = IMAGE_PRESERVE if kind == "image" else PRESERVE
    _check_adapter(jax_adapter, params, adapter, args, {})
    x, pad, bias = _check_adapter(jax_adapter, params, adapter, args, {"preserve_ids": ids})
    assert pad.tolist() == (ids == -1).tolist()
    assert bias.shape[:2] == (1, 3) and bias.is_contiguous()


@pytest.mark.parametrize("kind", ["text", "image", "audio"])
def test_decoder_scatter_matches_jax(kind):
    """The decoder's adapters (no rel-pos bias; image without a stem, audio
    without a frontend and with fixed positions): the student's embeddings
    go back to their positions over the mask token, -1s put nothing, and
    the gradients reach the mask token and the embeddings as in JAX."""
    cfg = pretrain_config(audio=kind == "audio")
    jax_adapter, params, adapter = _adapter_pair(kind, cfg.decoder)
    rs = np.random.RandomState(4)
    d = cfg.decoder.embed_dim
    if kind == "text":
        args = (rs.randint(5, 99, (3, 8)),)
    elif kind == "image":
        args = (rs.randn(3, 3, 32, 32).astype(np.float32),)
    else:
        args = (np.zeros((3, 64), np.float32),
                np.zeros((3, conv_output_length(64, SPEC) + 1), bool))
    ids = IMAGE_PRESERVE if kind == "image" else PRESERVE
    embed = rs.randn(3, 5, d).astype(np.float32)
    token = rs.randn(1, d).astype(np.float32)
    kw = {"preserve_ids": ids, "preserve_embed": embed, "mask_token": token}
    x, _, bias = _check_adapter(jax_adapter, params, adapter, args, kw)
    assert bias is None

    cot = rs.randn(*x.shape).astype(np.float32)

    def jax_fn(e, t):
        out = jax_adapter(params, *map(jnp.asarray, args), preserve_ids=jnp.asarray(ids),
                          preserve_embed=e, mask_token=t)[0]
        return jnp.sum(out * cot)

    want = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(embed), jnp.asarray(token))
    e, t = torch.tensor(embed, requires_grad=True), torch.tensor(token, requires_grad=True)
    out = adapter(*map(torch.as_tensor, args), preserve_ids=torch.as_tensor(ids),
                  preserve_embed=e, mask_token=t)[0]
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), [e, t])
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_audio_adapter_has_no_frontend():
    cfg = pretrain_config(audio=True)
    adapter = AudioAdapter(cfg.decoder.audio_adapter, 16, 2, device="cpu")
    assert adapter.feature_extractor is None and adapter.pos_convs is None
    assert tuple(adapter.embed_positions.shape) == (1024 + 2, 16)
    with pytest.raises(ValueError, match="no frontend"):
        adapter.extract_features(torch.zeros(1, 64))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _vl_inputs(b):
    base = {"src_tokens": b["src_tokens"], "src_images": b["src_images"]}
    return {
        "text": dict(src_tokens=b["src_tokens"], encoder_type="text"),
        "image": dict(src_images=b["src_images"], encoder_type="image"),
        "vl": dict(base, encoder_type="vl"),
        "text student": dict(src_tokens=b["src_tokens"], text_preserve_ids=b["text_preserve_ids"],
                             encoder_type="text"),
        "image student": dict(src_images=b["src_images"],
                              image_preserve_ids=b["image_preserve_ids"], encoder_type="image"),
        "vl student": dict(base, text_preserve_ids=b["vl_text_preserve_ids"],
                           image_preserve_ids=b["vl_image_preserve_ids"], encoder_type="vl")}


def _al_inputs(b):
    audio = {"src_audios": b["src_audios"], "audio_padding_masks": b["audio_padding_masks"]}
    return {
        "audio": dict(audio, encoder_type="audio"),
        "al": dict(audio, src_tokens=b["src_tokens"], encoder_type="al"),
        "audio student": dict(audio, audio_preserve_ids=b["audio_preserve_ids"],
                              encoder_type="audio"),
        "al student": dict(audio, src_tokens=b["src_tokens"],
                           text_preserve_ids=b["al_text_preserve_ids"],
                           audio_preserve_ids=b["al_audio_preserve_ids"], encoder_type="al")}


MODEL_CASES = ([("vl", name) for name in ("text", "image", "vl", "text student",
                                          "image student", "vl student")]
               + [("al", name) for name in ("audio", "al", "audio student", "al student")])


@pytest.fixture(scope="module")
def pairs():
    return {side: pretrain_pair(pretrain_config(audio=side == "al")) for side in ("vl", "al")}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("side,case", MODEL_CASES)
def test_pretrain_model_matches_jax(pairs, side, case, impl):
    """Every encoder type, teacher and student, within 1e-4; a teacher pass
    gives unit-norm logits and features, a student pass the mask heads'
    outputs over each modality's whole sequence."""
    jax_model, params, model = pairs[side]
    model.cfg.encoder.attn_impl = model.cfg.decoder.attn_impl = impl
    rs = np.random.RandomState(7)
    batch = vl_batch(rs) if side == "vl" else al_batch(rs)
    inputs = (_vl_inputs if side == "vl" else _al_inputs)(batch)[case]
    want = jax_model(params, **_jnp(inputs))
    with torch.no_grad():
        got = model(**_pt(inputs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w)


def test_logit_scale_clamp_passes_the_gradient():
    cfg = pretrain_config()
    _, _, model = pretrain_pair(cfg)
    for value in (-1.0, 2.0, 6.0):
        model.logit_scale.data.fill_(value)
        model.logit_scale.requires_grad_(True)
        scale = model.logit_scale_exp()
        assert scale.item() == pytest.approx(float(np.exp(np.clip(value, 0, np.log(100)))),
                                             rel=1e-6)
        (grad,) = torch.autograd.grad(scale, model.logit_scale)
        assert grad.item() == pytest.approx(scale.item(), rel=1e-6)


# ---------------------------------------------------------------------------
# DCL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("chunks", [1, 2])
def test_dcl_loss_matches_jax(label_smoothing, chunks):
    """Padding columns leave the softmax, unscored and padded rows drop
    out, the teacher takes no gradient; loss and the student's gradient
    against ``jax.value_and_grad``, finite at the padded rows."""
    rs = np.random.RandomState(chunks)
    b, l, d = 4, 6, 8
    student, teacher = (rs.randn(b, l, d).astype(np.float32) for _ in range(2))
    mask = rs.rand(b, l) < 0.5
    mask[:, 1] = True
    pad = np.zeros((b, l - 1), bool)
    pad[1, 3:] = True
    pad[3, 1:] = True

    def jax_loss(s, t):
        return jlosses.dcl_loss(s, t, jnp.asarray(mask), jnp.asarray(pad), 2.5,
                                label_smoothing, gallery_chunks=chunks)

    want, (wgrad, tgrad) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(student), jnp.asarray(teacher))
    assert not np.asarray(tgrad).any()
    s = torch.tensor(student, requires_grad=True)
    t = torch.tensor(teacher, requires_grad=True)
    loss = dcl_loss(s, t, torch.as_tensor(mask), torch.as_tensor(pad), 2.5, label_smoothing,
                    gallery_chunks=chunks)
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=LOSS_TOL)
    assert t.grad is None
    assert torch.isfinite(s.grad).all()
    _close(s.grad, wgrad, 1e-5)
    assert not s.grad[1, 4:].any() and not s.grad[3, 2:].any()  # padded rows
    with pytest.raises(ValueError, match="galleries"):
        dcl_loss(s, t, torch.as_tensor(mask), None, gallery_chunks=3)


# ---------------------------------------------------------------------------
# the criterions
# ---------------------------------------------------------------------------


def _criterion_cfg(side):
    cfg = CriterionConfig()
    cfg._name = "image_text_pretrain_loss" if side == "vl" else "audio_text_pretrain_loss"
    cfg.label_smoothing = 0.1
    cfg.dcl_gallery_chunks = 2
    return cfg


def _flat_grads(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("side", ["vl", "al"])
def test_criterion_matches_jax_value_and_grad(pairs, side):
    """Loss within 1e-5 relative, every metric, and the gradient of every
    parameter: all together within 1e-4 relative L2, each within 1e-3
    (a parameter without gradient has none on both sides)."""
    jax_model, params, model = pairs[side]
    model.cfg.encoder.attn_impl = model.cfg.decoder.attn_impl = "pallas"
    rs = np.random.RandomState(11)
    batch = vl_batch(rs) if side == "vl" else al_batch(rs)
    ccfg = _criterion_cfg(side)
    jax_crit = (JaxVLCriterion if side == "vl" else JaxALCriterion)(ccfg)

    def jax_loss(p):
        return jax_crit(jax_model, p, _jnp(batch), rng=None, deterministic=False)

    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want_grads = _flat_grads(want_grads)

    for p in model.parameters():
        p.requires_grad_(True)
    try:
        loss, metrics = build_criterion(ccfg)(model, _pt(batch), deterministic=False)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_TOL)
    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        assert float(metrics[key].detach()) == pytest.approx(float(value), rel=LOSS_TOL, abs=1e-6), key
    num = den = 0.0
    for name, g in zip(names, grads):
        w = want_grads[name].double()
        g = torch.zeros_like(w) if g is None else g.double()
        num += float((g - w).norm() ** 2)
        den += float(w.norm() ** 2)
        err = float((g - w).norm()) / max(float(w.norm()), 1e-12)
        assert err <= GRAD_TOL or float(w.norm()) < 1e-12 and float(g.norm()) < 1e-9, \
            (name, err)
    assert (num / den) ** 0.5 <= ALL_GRAD_TOL


# ---------------------------------------------------------------------------
# weights across the packages
# ---------------------------------------------------------------------------


def test_export_loads_in_jax(tmp_path):
    """``model_to_jax`` of the port's pretrain model, saved by the port, is
    the JAX init tree it came from, read by the JAX ``load_params``."""
    cfg = pretrain_config()
    _, params, model = pretrain_pair(cfg)
    path = tmp_path / "export.npz"
    port_ckpt.save_params(str(path), model_to_jax(model))
    got = jax_ckpt.load_params(str(path))
    flat_got, tree_got = jax.tree.flatten(jax.tree.map(np.asarray, got))
    flat_want, tree_want = jax.tree.flatten(params)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)


def _carried(state, src, fresh):
    """Names whose value is the checkpoint's and not the fresh init's (a
    leaf equal in both, such as a LayerNorm's ones, tells neither); fails
    on a value that is neither."""
    out = set()
    for name, value in state.items():
        if torch.equal(value, fresh[name]):
            continue
        assert name in src and torch.equal(value, src[name].to(value.dtype)), name
        out.add(name)
    return out


@pytest.mark.parametrize("reset", [True, False])
def test_upgrade_stage1_params_follows_jax(reset):
    """A stage-1 (VL) tree onto a stage-2 (AL) model: each package takes the
    same leaves from the checkpoint (the text branch and the trunk's shared
    weights in both towers; ``logit_scale`` unless ``reset_logit_scale``)
    and keeps its own fresh init everywhere else (the audio branch)."""
    stage1 = redraw(jax.tree.map(np.asarray, JaxModel(pretrain_config()).init(
        jax.random.PRNGKey(5))), np.random.RandomState(5))
    stage1["logit_scale"] = np.float32(3.0)
    cfg = pretrain_config(audio=True, stage2=True)
    cfg.reset_logit_scale = reset
    layers = cfg.encoder.layers
    jax_model = JaxModel(cfg)
    src = params_from_jax(stage1, num_layers=layers)
    want = _carried(params_from_jax(jax.tree.map(np.asarray, jax_model.upgrade_stage1_params(
        stage1, seed=0))), src, params_from_jax(jax.tree.map(np.asarray, jax_model.init(
            jax.random.PRNGKey(0)))))

    model = OnePeacePretrainModel(cfg, device="cpu")
    init_weights_(model, torch.Generator().manual_seed(0), cfg.encoder.layer_scale_init_value)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    state = model.upgrade_stage1_params(jax.tree.map(lambda x: torch.tensor(np.array(x)), stage1))
    assert state.keys() == fresh.keys()
    got = _carried(state, src, fresh)
    assert got == want
    assert ("logit_scale" in got) is (not reset)
    assert any(n.startswith("encoder_wrapper.text_adapter.") for n in got)
    assert any(n.startswith("decoder_wrapper.fusion.layers.1.text_ffn.") for n in got)
    assert not any(".audio_" in n or n.startswith(("audio_", "decoder_audio")) for n in got)


def test_upgrade_carries_list_subtrees():
    """A decided difference (ROADMAP section 3): the JAX package's overlay
    takes a list-valued subtree (the audio adapter's ``pos_convs`` and
    ``feature_extractor``) for a leaf without a shape and re-initialises it
    even when the checkpoint has it; the port carries it, as the
    reference's load by name does."""
    cfg = pretrain_config(audio=True, stage2=True)
    tree = redraw(jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(6))),
                  np.random.RandomState(6))
    jax_out = JaxModel(cfg).upgrade_stage1_params(tree, seed=0)
    adapter = ("encoder_wrapper", "audio_adapter")
    jax_convs = jax_out[adapter[0]][adapter[1]]["pos_convs"][0]["w"]
    assert not np.array_equal(np.asarray(jax_convs), tree[adapter[0]][adapter[1]]["pos_convs"][0]["w"])
    model = OnePeacePretrainModel(cfg, device="cpu")
    init_weights_(model, torch.Generator().manual_seed(0), cfg.encoder.layer_scale_init_value)
    state = model.upgrade_stage1_params(jax.tree.map(lambda x: torch.tensor(np.array(x)), tree))
    src = params_from_jax(tree)
    for name in ("encoder_wrapper.audio_adapter.pos_convs.0.weight",
                 "encoder_wrapper.audio_adapter.feature_extractor.1.conv.weight"):
        torch.testing.assert_close(state[name], src[name], rtol=0, atol=0)
