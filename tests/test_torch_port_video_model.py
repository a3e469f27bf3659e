"""The port's K400 video trunk and classifier against the JAX package's, on
the CPU at a small size (d 128, 2 heads of 64, FFN 256, 2 layers, bucket 4,
4 frames, 64 px, B=2).

Every weight is drawn from ``np.random.RandomState`` (the adapters' ``fc2``,
the temporal embedding and the rel-pos table non-zero, so every branch shows
in the output) into the port's model and carried to the JAX tree by
``params_to_jax``.  In fp32 at 1e-4: one ``video_layer``, the backbone, the
classifier's logits (remat on and off) and the trainable parameters'
gradients against ``jax.grad`` under ``trainable_mask``.  Equal to JAX: the
trainable names, the layer ids, scales and decay mask, the trunk of
``convert_video_backbone``, ``quantize_ffn_`` against
``quantize_serving_params``, and ``params_to_jax`` after ``params_from_jax``.
The image-branch ``VisionBackbone`` (its map and parameterless pyramid) and
the round-1 mean-pool ``VideoClassifier`` against the JAX package's at the
same size.  Inside the port: remat on and off, drop path one draw per frame,
the init's constants, that a frozen trunk's attention still runs its
backward (the plain one here; kernel #2 on the card, ``chip_smoke.py``
phase 19), and that the entry points build on ``cuda`` by default."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.optim import adamw as jadamw
from one_peace_tpu.vision import backbone as jbackbone
from one_peace_tpu.utils import vision_checkpoint as jvc
from one_peace_tpu.vision import video_backbone as jvb
from one_peace_tpu.vision import zoo as jzoo
from one_peace_tpu_torch.ops import flash_attention as tfa
from one_peace_tpu_torch.ops.quant import quantize_ffn_
from one_peace_tpu_torch.optim import adamw
from one_peace_tpu_torch.utils import vision_checkpoint as tvc
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax, params_to_jax
from one_peace_tpu_torch.utils.random_weights import init_video_classifier_
from one_peace_tpu_torch.vision import backbone as tbackbone
from one_peace_tpu_torch.vision import video_backbone as tvb
from one_peace_tpu_torch.vision import zoo as tzoo

D, F, HEADS, LAYERS, BUCKET, FRAMES, PX, B, CLASSES = 128, 256, 2, 2, 4, 4, 64, 2, 5
GEOM = dict(embed_dim=D, ffn_embed_dim=F, heads=HEADS, layers=LAYERS, bucket_size=BUCKET,
            num_frames=FRAMES)
TOL = 1e-4


def numpy_weights_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Every parameter drawn from ``np.random.RandomState(seed)`` in the
    order of ``named_parameters``: LayerNorm scales around 1, biases and
    dense weights small, the LayerScale gammas around 0.1, the conv stem
    within sqrt(1 / fan_in), and the adapters, the temporal embedding and
    the rel-pos table non-zero."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            x = rs.randn(*p.shape)
            if leaf == "weight" and p.ndim == 1:
                x = 1.0 + 0.1 * x
            elif leaf in ("gamma_1", "gamma_2"):
                x = 0.1 + 0.02 * x
            elif leaf == "rel_pos_table":
                x = 0.5 * x
            elif leaf == "weight" and p.ndim == 4:
                x = x / np.sqrt(p[0].numel())
            elif leaf == "weight":
                x = x / np.sqrt(p.shape[1])
            else:
                x = 0.05 * x
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    return model


_BUILT = {}


def models(remat: bool = False):
    """(JAX classifier, the JAX tree of the port's weights, the port
    classifier), built once per remat setting."""
    if remat not in _BUILT:
        jm = jvb.VideoClassifierV2(CLASSES, checkpoint_activations=remat, **GEOM)
        tm = numpy_weights_(tzoo.OnePeaceVideoClassifier(
            CLASSES, device="cpu", checkpoint_activations=remat, attn_impl="xla", **GEOM))
        _BUILT[remat] = (jm, jax.tree.map(jnp.asarray, model_to_jax(tm)), tm)
    return _BUILT[remat]


def frames(seed: int = 1, b: int = B) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, FRAMES, 3, PX, PX).astype(np.float32)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * scale)


def _rel_bias(tree, h: int = PX // 16):
    tok = jvb.subgrid_token_indices(h, h, BUCKET)
    from one_peace_tpu.models.rel_pos import make_image_bucket_position

    rp = make_image_bucket_position(BUCKET)[np.ix_(tok, tok)]
    return tree["backbone"]["rel_pos_table"][rp].transpose(2, 0, 1)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_video_layer_matches_jax(impl):
    """One layer on (B*T, N, D) tokens: the temporal, spatial and joint
    branches against ``video_layer``; both ``attn_impl`` arms (on the CPU
    the kernel's arm runs its plain version)."""
    _, tree, tm = models()
    layer_tree = jax.tree.map(lambda x: x[1], tree["backbone"]["layers"])
    x = np.random.RandomState(2).randn(B * FRAMES, (PX // 16) ** 2 + 1, D).astype(np.float32)
    bias = _rel_bias(tree)
    want = jvb.video_layer(layer_tree, HEADS, FRAMES, 0.5, jnp.asarray(x), bias, 0.0)
    got = tm.backbone.layers[1](torch.from_numpy(x), torch.from_numpy(np.asarray(bias)),
                                FRAMES, 0.5, impl)
    _close(got, want)


def test_backbone_matches_jax():
    jm, tree, tm = models()
    x = frames()
    want = jm.backbone(tree["backbone"], jnp.asarray(x))
    got = tm.backbone(torch.from_numpy(x))
    assert got.shape == (B * FRAMES, (PX // 16) ** 2 + 1, D)
    _close(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_classifier_logits_match_jax(remat):
    jm, tree, tm = models(remat)
    x = frames(3)
    _close(tm(torch.from_numpy(x)), jm(tree, jnp.asarray(x)))


def test_subgrid_positions_on_a_smaller_grid():
    """A 48 px clip (3 x 3 grid) in the bucket-4 model takes the 2-D
    sub-grid of the position tables, as the JAX package does."""
    jm, tree, tm = models()
    x = np.random.RandomState(4).randn(1, FRAMES, 3, 48, 48).astype(np.float32)
    _close(tm(torch.from_numpy(x)), jm(tree, jnp.asarray(x)))


def _trainable_names(tree):
    mask = jvb.VideoClassifierV2(CLASSES, **GEOM).trainable_mask(tree)
    flat = params_from_jax(jax.tree.map(np.asarray, mask), num_layers=LAYERS)
    return {k for k, v in flat.items() if bool(v)}, set(flat)


def test_trainable_mask_names_equal_jax():
    _, tree, tm = models()
    want, every = _trainable_names(tree)
    got = tm.trainable_mask()
    assert set(got) == every == {n for n, _ in tm.named_parameters()}
    assert {n for n, train in got.items() if train} == want
    assert all(not got[n] for n in got if ".self_attn." in n or ".image_ffn." in n)
    assert got["backbone.temporal_embedding"] and got["backbone.rel_pos_table"]
    assert got["head.weight"] and not got["backbone.pos_embed"]


def test_trainable_gradients_match_jax_grad():
    """The gradients of a fixed projection of the logits, with the trunk
    frozen, against ``jax.grad``: every trainable leaf to 1e-4 of its own
    scale.  Remat on: the recompute runs inside the backward."""
    jm, tree, tm = models(remat=True)
    x = frames(5)
    proj = np.random.RandomState(6).randn(B, CLASSES).astype(np.float32)
    train = tm.trainable_mask()
    for name, p in tm.named_parameters():
        p.requires_grad_(train[name])
    try:
        params = [p for n, p in tm.named_parameters() if train[n]]
        loss = (tm(torch.from_numpy(x)) * torch.from_numpy(proj)).sum()
        grads = torch.autograd.grad(loss, params)
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
    jgrad = jax.jit(jax.grad(lambda t: (jm(t, jnp.asarray(x)) * proj).sum()))(tree)
    want = params_from_jax(jax.tree.map(np.asarray, jgrad))
    names = [n for n, _ in tm.named_parameters() if train[n]]
    assert len(names) == LAYERS * 12 + 6
    for name, g in zip(names, grads):
        _close(g, want[name].numpy())
    assert float(grads[names.index("backbone.rel_pos_table")].abs().max()) > 0


def test_layer_ids_scales_and_decay_mask_match_jax():
    _, tree, tm = models()
    named = list(tm.named_parameters())
    np_tree = jax.tree.map(np.asarray, tree)
    want_scale = params_from_jax(jax.tree.map(np.asarray, jadamw.layer_decay_scales(
        np_tree, LAYERS, 0.9)), num_layers=LAYERS)
    want_mask = params_from_jax(jax.tree.map(np.asarray, jadamw.decay_mask(np_tree)),
                                num_layers=LAYERS)
    got_scale = adamw.layer_decay_scales(named, LAYERS, 0.9)
    got_mask = adamw.decay_mask(named)
    assert set(got_scale) == set(want_scale) == set(got_mask) == set(want_mask)
    for name, _ in named:
        assert got_mask[name] == bool(want_mask[name]), name
        np.testing.assert_allclose(float(got_scale[name]), float(want_scale[name]),
                                   rtol=1e-6, err_msg=name)
    ids = {name: adamw.layer_id_for_path(name, LAYERS) for name, _ in named}
    assert ids["backbone.layers.1.t_adapter.fc1.weight"] == 2
    assert ids["backbone.layers.0.self_attn.q_proj.weight"] == 1
    for name in ("backbone.temporal_embedding", "backbone.rel_pos_table", "backbone.pos_embed",
                 "backbone.hmlp.conv1.weight", "norm.weight", "head.weight"):
        assert ids[name] == LAYERS + 1, name
    assert got_mask["backbone.layers.0.t_adapter.fc1.weight"]
    assert not got_mask["backbone.layers.0.gamma_1"]
    assert got_mask["backbone.temporal_embedding"] and not got_mask["backbone.pos_embed"]


def _fake_pretrain_sd(rs, d=D, f=F, heads=HEADS, layers=LAYERS, bucket=BUCKET):
    """A flat state dict in the vision naming (``convert_to_vision.py``)."""
    sd, q = {}, d // 4
    sd["image_adapter.embed_images.0.weight"] = rs.randn(q, 3, 4, 4).astype("f")
    sd["image_adapter.embed_images.0.bias"] = rs.randn(q).astype("f")
    sd["image_adapter.embed_images.3.weight"] = rs.randn(q, q, 2, 2).astype("f")
    sd["image_adapter.embed_images.3.bias"] = rs.randn(q).astype("f")
    sd["image_adapter.embed_images.6.weight"] = rs.randn(d, q, 2, 2).astype("f")
    sd["image_adapter.embed_images.6.bias"] = rs.randn(d).astype("f")
    for i in (1, 4):
        sd[f"image_adapter.embed_images.{i}.layer_norm.weight"] = rs.randn(q).astype("f")
        sd[f"image_adapter.embed_images.{i}.layer_norm.bias"] = rs.randn(q).astype("f")
    sd["image_adapter.pos_embed"] = rs.randn(bucket ** 2 + 1, d).astype("f")
    sd["image_adapter.cls_embedding"] = rs.randn(1, 1, d).astype("f")
    sd["image_adapter.rel_pos_table_list.0.weight"] = rs.randn(
        (2 * bucket - 1) ** 2 + 3, heads).astype("f")
    for i in range(layers):
        p = f"encoder.layers.{i}"
        for proj in ("q_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = rs.randn(d, d).astype("f")
            sd[f"{p}.self_attn.{proj}.bias"] = rs.randn(d).astype("f")
        sd[f"{p}.self_attn.k_proj.weight"] = rs.randn(d, d).astype("f")
        for ln in ("self_attn.ln", "self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}.{ln}.weight"] = rs.randn(d).astype("f")
            sd[f"{p}.{ln}.bias"] = rs.randn(d).astype("f")
        sd[f"{p}.image_ffn.0.wi_0.weight"] = rs.randn(f, d).astype("f")
        sd[f"{p}.image_ffn.0.wi_1.weight"] = rs.randn(f, d).astype("f")
        sd[f"{p}.image_ffn.2.weight"] = rs.randn(f).astype("f")
        sd[f"{p}.image_ffn.2.bias"] = rs.randn(f).astype("f")
        sd[f"{p}.image_ffn.3.weight"] = rs.randn(d, f).astype("f")
        sd[f"{p}.image_ffn.3.bias"] = rs.randn(d).astype("f")
        sd[f"{p}.gamma_1"] = rs.randn(d).astype("f")
        sd[f"{p}.gamma_2"] = rs.randn(d).astype("f")
    return sd


def _without_adapters(tree):
    layers = {k: v for k, v in tree["layers"].items() if not k.endswith("_adapter")}
    return {**tree, "layers": layers}


@pytest.mark.parametrize("table_bucket", [BUCKET, 3])
def test_convert_video_backbone_trunk_equals_jax(table_bucket):
    """The trunk from a pretrain state dict equals the JAX conversion's, bit
    for bit (the rel-pos table zero where its size differs); the adapters
    keep ``init_video_classifier_``'s draws, their ``fc2`` zero, and the
    temporal embedding is zero."""
    sd = _fake_pretrain_sd(np.random.RandomState(7))
    sd["image_adapter.rel_pos_table_list.0.weight"] = np.random.RandomState(8).randn(
        (2 * table_bucket - 1) ** 2 + 3, HEADS).astype("f")
    want = jvc.convert_video_backbone(sd, jvb.VideoBackbone(**GEOM), key=jax.random.PRNGKey(0))
    want = jax.tree.map(np.asarray, _without_adapters(want))
    model = tzoo.OnePeaceVideoClassifier(CLASSES, device="cpu", **GEOM)
    got = tvc.convert_video_backbone(sd, model.backbone)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    init_video_classifier_(model, torch.Generator().manual_seed(0))
    head = model.head.weight.clone()
    model.load_pretrained(sd)
    tree = model_to_jax(model)["backbone"]
    jax.tree.map(np.testing.assert_array_equal, _without_adapters(tree), want)
    assert float(np.abs(want["rel_pos_table"]).max()) == (0.0 if table_bucket != BUCKET
                                                          else float(np.abs(sd[
                                                              "image_adapter.rel_pos_table_list"
                                                              ".0.weight"]).max()))
    for name in ("t_adapter", "s_adapter", "mlp_adapter"):
        assert np.abs(tree["layers"][name]["fc2"]["w"]).max() == 0
        assert np.abs(tree["layers"][name]["fc1"]["w"]).max() > 0
    assert torch.equal(model.head.weight, head)
    with pytest.raises(ValueError, match="checkpoint"):
        tzoo.OnePeaceVideoClassifier(CLASSES, device="cpu", **{**GEOM, "ffn_embed_dim": 2 * F}
                                     ).load_pretrained(sd)


def test_init_matches_the_jax_init():
    """``init_video_classifier_`` draws what ``VideoClassifierV2.init``
    draws: the same constants bit for bit, and each random leaf from the
    same distribution (its std within 10% of the JAX draw's where it has
    more than 4096 values, within 50% for the few smaller ones)."""
    jm, _, _ = models()
    want = params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    model = init_video_classifier_(tzoo.OnePeaceVideoClassifier(CLASSES, device="cpu", **GEOM),
                                   torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if float(w.std()) == 0 or w.numel() == 1:
            assert torch.equal(g, w), name
        else:  # a 32-value conv bias's std varies by ~1 / sqrt(64) = 12% a draw
            assert abs(float(g.std()) / float(w.std()) - 1) < (0.1 if w.numel() > 4096
                                                               else 0.5), name


def test_quantize_ffn_matches_quantize_serving_params():
    """``quantize_ffn_`` on the video model swaps every layer's ``image_ffn``
    as the JAX serving quantizer does (the same int8 weights and scales), and
    the int8 logits agree with the JAX package's."""
    import copy

    jm, tree, tm = models()
    qtree = jzoo.quantize_serving_params(jax.tree.map(jnp.asarray, tree))
    qm = quantize_ffn_(copy.deepcopy(tm))
    got = model_to_jax(qm)
    for name in ("wi_0", "wi_1", "wo"):
        lin = got["backbone"]["layers"]["image_ffn"][name]
        want = qtree["backbone"]["layers"]["image_ffn"][name]
        np.testing.assert_array_equal(lin["w_q"], np.asarray(want["w_q"]))
        np.testing.assert_array_equal(lin["w_scale"], np.asarray(want["w_scale"]).reshape(
            lin["w_scale"].shape))
    x = frames(9)
    _close(qm(torch.from_numpy(x)), jm(qtree, jnp.asarray(x)), tol=1e-3)


def test_params_to_jax_inverts_params_from_jax():
    """The JAX tree of the port's weights carried back is the state dict,
    bit for bit, and its stacked layer leaves are ``backbone/layers``."""
    _, tree, tm = models()
    np_tree = jax.tree.map(np.asarray, tree)
    assert np_tree["backbone"]["layers"]["t_adapter"]["fc1"]["w"].shape == (LAYERS, D, D // 4)
    back = params_from_jax(np_tree)
    state = tm.state_dict()
    assert set(back) == set(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name
    again = params_to_jax(back, **tm.jax_layout())
    jax.tree.map(np.testing.assert_array_equal, again, np_tree)


def test_remat_on_and_off_equal():
    """Logits and the trainable gradients with and without remat, drop path
    on: the recompute draws the masks the forward drew."""
    _, _, tm = models()
    x = torch.from_numpy(frames(10))
    train = tm.trainable_mask()
    outs = []
    for remat in (False, True):
        tm.backbone.checkpoint_activations = remat
        tm.backbone.dpr = np.full(LAYERS, 0.5, np.float32)
        for name, p in tm.named_parameters():
            p.requires_grad_(train[name])
        try:
            logits = tm(x, deterministic=False, generator=torch.Generator().manual_seed(3))
            grads = torch.autograd.grad(logits.square().sum(),
                                        [p for p in tm.parameters() if p.requires_grad])
        finally:
            tm.backbone.checkpoint_activations = False
            tm.backbone.dpr = np.zeros(LAYERS, np.float32)
            for p in tm.parameters():
                p.requires_grad_(False)
        outs.append((logits.detach(), grads))
    (l0, g0), (l1, g1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_drop_path_one_draw_per_frame(monkeypatch):
    """Drop path acts on the three branches of every layer on (B*T, N, D)
    tensors, so one keep draw per frame (the JAX (B*T, 1, 1) mask); at rate
    0.5 about half the frames keep a branch, all of a frame's tokens
    together, and a kept branch is scaled by 2."""
    seen = []
    real = tvb.drop_path

    def recording(x, rate, deterministic, generator=None):
        seen.append((tuple(x.shape), rate, deterministic, generator is not None))
        return real(x, rate, deterministic, generator)

    monkeypatch.setattr(tvb, "drop_path", recording)
    _, _, tm = models()
    tm.backbone.dpr = np.full(LAYERS, 0.5, np.float32)
    try:
        with torch.no_grad():
            tm(torch.from_numpy(frames(10)), deterministic=False,
               generator=torch.Generator().manual_seed(3))
    finally:
        tm.backbone.dpr = np.zeros(LAYERS, np.float32)
    n = (PX // 16) ** 2 + 1
    assert seen == [((B * FRAMES, n, D), 0.5, False, True)] * (3 * LAYERS)
    ones = torch.ones(2000 * FRAMES, n, 4)
    out = real(ones, 0.5, False, torch.Generator().manual_seed(4))
    frame_kept = out[:, 0, 0] > 0
    assert bool((out == 2.0 * frame_kept[:, None, None]).all())
    assert abs(float(frame_kept.float().mean()) - 0.5) < 0.02


def test_frozen_trunk_attention_still_runs_its_backward(monkeypatch):
    """With only the trainable leaves needing a gradient, each layer's two
    attentions run their backward (the plain version on the CPU, kernel #2
    on the card): the adapters' gradients pass through every frozen layer."""
    calls = []
    plain = tfa.flash_attention_bwd_plain

    def counting(q, *args, **kw):
        calls.append(q.shape[1])
        return plain(q, *args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", counting)
    model = numpy_weights_(tzoo.OnePeaceVideoClassifier(CLASSES, device="cpu", **GEOM))
    train = model.trainable_mask()
    for name, p in model.named_parameters():
        p.requires_grad_(train[name])
    model(torch.from_numpy(frames(13))).sum().backward()
    assert sorted(calls) == [FRAMES] * LAYERS + [(PX // 16) ** 2 + 1] * LAYERS
    assert model.backbone.layers[0].t_adapter.fc1.weight.grad.abs().max() > 0
    assert model.backbone.layers[0].self_attn.q_proj.weight.grad is None


def test_entry_points_default_to_cuda():
    """The video classifier and the task's ``build_model`` build on ``cuda``
    unless told otherwise (the JAX package runs where JAX runs)."""
    from one_peace_tpu_torch.cli.train import build_model_for_task
    from one_peace_tpu_torch.tasks.vision_tasks import K400VideoTask

    for fn in (tzoo.OnePeaceVideoClassifier.__init__, K400VideoTask.build_model,
               build_model_for_task, tbackbone.VisionBackbone.__init__,
               tbackbone.VideoClassifier.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _branch_config():
    from helpers import tiny_encoder_config

    cfg = tiny_encoder_config(embed_dim=D, ffn_embed_dim=F, attention_heads=HEADS)
    cfg.image_adapter.bucket_size = cfg.image_adapter.rel_bucket_size = PX // 16
    return cfg


def test_vision_backbone_and_pyramid_match_jax():
    """The image branch's stride-16 map and the parameterless pyramid (the
    bilinear ups of ``jax.image.resize``, the 2 x 2 max pool) at 1e-4."""
    model = numpy_weights_(tbackbone.VisionBackbone(_branch_config(), device="cpu"), 14)
    tree = jax.tree.map(jnp.asarray, model_to_jax(model))
    jmodel = jbackbone.VisionBackbone(_branch_config())
    x = np.random.RandomState(15).randn(B, 3, PX, PX).astype(np.float32)
    got = model.pyramid(torch.from_numpy(x))
    want = jmodel.pyramid(tree, jnp.asarray(x))
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key])
    assert tuple(got["p4"].shape) == (B, PX // 4, PX // 4, D)


def test_round1_video_classifier_matches_jax():
    """The mean over frames of the image branch's CLS and the head."""
    model = numpy_weights_(tbackbone.VideoClassifier(_branch_config(), CLASSES, device="cpu"),
                           16)
    tree = jax.tree.map(jnp.asarray, model_to_jax(model))
    assert set(tree) == {"encoder_wrapper", "head"}
    jmodel = jbackbone.VideoClassifier(_branch_config(), CLASSES)
    x = frames(17)
    _close(model(torch.from_numpy(x)), jmodel(tree, jnp.asarray(x)))
