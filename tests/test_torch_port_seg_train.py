"""Segmentation training in the port against the JAX package, on the CPU in
fp32 at toy size (d 32, 4 layers in four interaction groups, 4 heads, 64 px
crops on a 4 x 4 grid, 5 classes; Mask2Former with 8 queries, 2 decoder
rounds, 1 pixel-decoder layer, 32 points): the segmenter's layer ids, layer
scales and decay mask against ``layer_decay_scales`` and ``decay_mask``, and
one AdamW step with one lr per rel-pos table against the optax chain; the
host Hungarian matching against ``auction_assign``; ``point_sample``,
``_bce_logits``, ``_dice``, ``_match_costs``, ``uncertainty_points``,
``seg_cross_entropy`` and ``mask2former_loss`` on arrays, with JAX's random draws injected into the
port's ``_uniforms``; both arms of ``SegmentationCriterion`` through the
segmenters against ``jax.value_and_grad`` (the loss at 1e-5, all gradients
together at 1e-4 and each parameter's at 1e-3, relative L2); the port's
``Trainer`` on the UperNet segmenter against the JAX ``Trainer`` with layer
decay; the trunk's remat, whose gradients equal those without it and
which keeps no layer's (H, L, L) bias for the backward; and the bias
gather's per-bucket backward against PyTorch's index backward."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_encoder_config

from one_peace_tpu.core.config import FrameworkConfig
from one_peace_tpu.criterions.vision_criterions import SegmentationCriterion as JaxCriterion
from one_peace_tpu.optim import adamw as jadamw
from one_peace_tpu.parallel.mesh import make_mesh
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu.vision import mask2former_loss as jloss
from one_peace_tpu.vision import zoo as jzoo
from one_peace_tpu.vision.matching import auction_assign
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.models.components import bucket_order, gather_rel_bias
from one_peace_tpu_torch.models.rel_pos import make_image_bucket_position
from one_peace_tpu_torch.optim import adamw
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision import mask2former_loss as tloss
from one_peace_tpu_torch.vision import zoo as tzoo
from one_peace_tpu_torch.vision.matching import hungarian_assign

GRID, SIZE, CLASSES, LAYERS = 4, 64, 5, 4
ADAPTER_KW = dict(conv_inplane=8, deform_num_heads=4)
M2F_KW = dict(feat_channels=16, num_queries=8, dec_layers=2, dec_heads=4, pixel_layers=1,
              pixel_heads=4)
HEADS = {"upernet": (jzoo.OnePeaceSegmenter, tzoo.OnePeaceSegmenter, dict(channels=64)),
         "mask2former": (jzoo.OnePeaceMask2FormerSegmenter, tzoo.OnePeaceMask2FormerSegmenter,
                         M2F_KW)}
MAX_INSTANCES, NUM_POINTS = 4, 32


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seg_config(remat=False):
    cfg = tiny_encoder_config(layers=LAYERS, checkpoint_activations=remat)
    cfg.image_adapter.bucket_size = GRID
    cfg.image_adapter.rel_bucket_size = GRID
    return cfg


_BUILT = {}


def segmenters(head: str):
    """(JAX segmenter, the port's seeded weights as the JAX tree (numpy), the
    port segmenter with gradients on), built once per head."""
    if head not in _BUILT:
        jcls, tcls, kw = HEADS[head]
        jseg = jcls(seg_config(), num_classes=CLASSES, **ADAPTER_KW, **kw)
        tseg = fill_random_(tcls(seg_config(), num_classes=CLASSES, device="cpu", **ADAPTER_KW,
                                 **kw), torch.Generator().manual_seed(3))
        for seg in (jseg, tseg):
            seg.max_instances, seg.num_points = MAX_INSTANCES, NUM_POINTS
        for p in tseg.parameters():
            p.requires_grad_(True)
        _BUILT[head] = (jseg, model_to_jax(tseg), tseg)
    return _BUILT[head]


def seg_batch(seed=4, b=2):
    """Images and label maps of a few rectangular regions per image, with
    ignored pixels (255)."""
    rs = np.random.RandomState(seed)
    target = np.zeros((b, SIZE, SIZE), np.int32)
    for i in range(b):
        for _ in range(6):
            y, x = rs.randint(0, SIZE - 8, 2)
            target[i, y:y + rs.randint(8, 40), x:x + rs.randint(8, 40)] = rs.randint(0, CLASSES)
        target[i, :6] = 255
    return {"src_images": rs.randn(b, 3, SIZE, SIZE).astype(np.float32), "target": target}


# ---------------------------------------------------------------------------
# layer ids, scales and the per-table lr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
def test_layer_ids_scales_and_decay_mask_match_jax(head):
    _, tree, tseg = segmenters(head)
    named = list(tseg.named_parameters())
    want_scale = params_from_jax(_np(jadamw.layer_decay_scales(tree, LAYERS, 0.9)),
                                 num_layers=LAYERS)
    want_mask = params_from_jax(_np(jadamw.decay_mask(tree)), num_layers=LAYERS)
    got_scale = adamw.layer_decay_scales(named, LAYERS, 0.9)
    got_mask = adamw.decay_mask(named)
    assert set(got_scale) == set(want_scale) == set(got_mask) == set(want_mask)
    # the JAX mask takes one off the ndim of any leaf under a "layers/" path,
    # meant for the stacked trunk; the Mask2Former head's decoder layers are
    # lists, so their 2-D weights lose their decay there (ROADMAP section 3).
    # The port decays them, as the reference's optimizer constructor does.
    differ = {name for name, _ in named if got_mask[name] != bool(want_mask[name])}
    assert differ == {name for name, p in named if p.ndim == 2 and re.match(
        r"head\.(pixel_decoder\.)?layers\.", name)}
    assert all(got_mask[name] for name in differ)
    for name, _ in named:
        np.testing.assert_allclose(np.asarray(got_scale[name], np.float64).ravel(),
                                   want_scale[name].numpy().astype(np.float64).ravel(),
                                   rtol=1e-6, err_msg=name)
    ids = {name: adamw.layer_id_for_path(name, LAYERS) for name, _ in named}
    assert ids["backbone.image_adapter.rel_pos_table"] is None
    assert got_scale["backbone.image_adapter.rel_pos_table"].shape == (LAYERS, 1, 1)
    assert ids["backbone.image_adapter.pos_embed"] == 0
    assert ids["backbone.encoder.layers.2.self_attn.q_proj.weight"] == 3
    for name in ("backbone.encoder.image_layer_norm.weight", "backbone.spm.stem1.conv.weight",
                 "backbone.level_embed", "backbone.norm4.weight",
                 "backbone.injectors.0.gamma"):
        assert ids[name] == LAYERS + 1, name
    assert {ids[n] for n in ids if n.startswith("head.")} == {LAYERS + 1}


def test_per_table_lr_step_matches_the_optax_chain():
    """One AdamW step with weight decay of a (tables, R, H) table whose
    tables carry their own layer scale, beside a parameter of one scale,
    equals adam -> add_decayed_weights -> scale_by_tree -> lr."""
    from one_peace_tpu.core.config import OptimizationConfig, OptimizerConfig

    rs = np.random.RandomState(0)
    table, w = rs.randn(3, 7, 2).astype(np.float32), rs.randn(4, 5).astype(np.float32)
    g_table, g_w = rs.randn(*table.shape).astype(np.float32), rs.randn(4, 5).astype(np.float32)
    lr, wd = 1e-2, 0.05
    # 2 layers: table i carries layer i's scale 0.9 ** (3 - (i + 1)), the
    # last table the top's; q_proj of layer 1 is 0.9 ** (3 - 2)
    scales = np.asarray([0.9 ** 2, 0.9, 1.0], np.float32).reshape(3, 1, 1)
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.98, eps=1e-8),
                     optax.add_decayed_weights(wd),
                     jadamw.scale_by_tree({"t": jnp.asarray(scales), "w": jnp.float32(0.9)}),
                     optax.scale_by_learning_rate(lr))
    params = {"t": jnp.asarray(table), "w": jnp.asarray(w)}
    updates, _ = tx.update({"t": jnp.asarray(g_table), "w": jnp.asarray(g_w)}, tx.init(params),
                           params)
    want = optax.apply_updates(params, updates)

    tt, tw = torch.tensor(table), torch.tensor(w)
    named = [("encoder_wrapper.image_adapter.rel_pos_table", tt),
             ("encoder_wrapper.fusion.layers.1.self_attn.q_proj.weight", tw)]
    opt = adamw.build_optimizer(OptimizerConfig(weight_decay=wd, adam_betas=(0.9, 0.98),
                                                adam_eps=1e-8),
                                OptimizationConfig(layer_decay=0.9), named, num_layers=2)
    assert len(opt.slice_scales) == 1 and opt.slice_scales[0][0] is tt
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_scale"]
    tt.grad, tw.grad = torch.as_tensor(g_table), torch.as_tensor(g_w)
    opt.step()
    np.testing.assert_allclose(tt.numpy(), np.asarray(want["t"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(want["w"]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the matching
# ---------------------------------------------------------------------------


def _auction(cost, valid):
    return np.asarray(jax.jit(auction_assign)(jnp.asarray(np.where(valid[:, None], cost, 0.0)),
                                              jnp.asarray(valid)))


@pytest.mark.parametrize("k,n,seed", [(5, 9, 0), (6, 6, 1), (12, 40, 2)])
def test_matching_equals_the_auction_on_unique_optima(k, n, seed):
    """Continuous random costs (a unique optimum), padded rows included:
    the valid rows' columns equal the auction's; every column distinct, the
    padded rows on the leftover columns in ascending order."""
    rs = np.random.RandomState(seed)
    costs = rs.randn(3, k, n).astype(np.float32)
    valid = rs.rand(3, k) < 0.7
    valid[:, 0] = True
    valid[2] = False  # no valid row at all
    cols = hungarian_assign(torch.from_numpy(costs), torch.from_numpy(valid)).numpy()
    assert cols.shape == (3, k) and cols.dtype == np.int64
    for c, v, col in zip(costs, valid, cols):
        assert len(set(col.tolist())) == k
        np.testing.assert_array_equal(col[v], _auction(c, v)[v])
        left = np.setdiff1d(np.arange(n), col[v])
        np.testing.assert_array_equal(col[~v], left[:(~v).sum()])


def test_matching_total_within_the_auctions_precision_on_ties():
    """Integer costs (many optima): the same total cost as the auction's,
    within its K * eps_final."""
    rs = np.random.RandomState(3)
    k, n = 7, 10
    for _ in range(4):
        cost = rs.randint(0, 3, (k, n)).astype(np.float32)
        valid = np.ones(k, bool)
        valid[-1] = False
        col = hungarian_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
        want = _auction(cost, valid)
        masked = np.where(valid[:, None], cost, 0.0)
        eps_final = (masked.max() - masked.min()) * 1e-5 / (n + 1)
        total = masked[np.arange(k), col].sum()
        assert total <= masked[np.arange(k), want].sum() + k * eps_final
        assert len(set(col.tolist())) == k


# ---------------------------------------------------------------------------
# the set loss on arrays
# ---------------------------------------------------------------------------


def jax_draws(rng, lvls, b, k, num_points):
    """The draws ``mask2former_loss`` makes from ``rng``, in the port's
    ``_uniforms`` layout: ((L, B, P, 2), (L, B, K, 3P, 2), (L, B, K, P/4, 2))."""
    n_cand, _, n_rand = tloss.point_counts(num_points)
    pts, cand, rand = [], [], []
    for rng_l in jax.random.split(rng, lvls):
        for rng_i in jax.random.split(rng_l, b):
            r1, r2 = jax.random.split(rng_i)
            k1, k2 = jax.random.split(r2)
            pts.append(jax.random.uniform(r1, (num_points, 2)))
            cand.append(jax.random.uniform(k1, (k, n_cand, 2)))
            rand.append(jax.random.uniform(k2, (k, n_rand, 2)))
    return [_t(np.stack(x).reshape((lvls, b) + np.shape(x[0]))) for x in (pts, cand, rand)]


def inject(monkeypatch, draws):
    """The port's ``_uniforms`` returns ``draws`` (checking the shapes)."""
    def uniforms(generator, shapes, device):
        assert [tuple(s) for s in shapes] == [tuple(d.shape) for d in draws]
        return [d.to(device) for d in draws]

    monkeypatch.setattr(tloss, "_uniforms", uniforms)


def set_arrays(seed=5, lvls=3, b=2, q=8, c=5, h=12, w=10, k=4):
    rs = np.random.RandomState(seed)
    all_cls = rs.randn(lvls, b, q, c + 1).astype(np.float32)
    all_masks = (2 * rs.randn(lvls, b, q, h, w)).astype(np.float32)
    gt_masks = (rs.rand(b, k, h, w) < 0.3).astype(np.float32)
    gt_labels = rs.randint(0, c, (b, k)).astype(np.int32)
    gt_valid = np.ones((b, k), bool)
    gt_valid[1, -1] = False
    return all_cls, all_masks, gt_masks, gt_labels, gt_valid


def test_point_sample_bce_dice_and_costs_match_jax():
    rs = np.random.RandomState(6)
    mask = rs.randn(3, 5, 7).astype(np.float32)
    pts = rs.uniform(-0.1, 1.1, (11, 2)).astype(np.float32)  # taps outside read 0
    np.testing.assert_allclose(tloss.point_sample(_t(mask), _t(pts)).numpy(),
                               jloss.point_sample(jnp.asarray(mask), jnp.asarray(pts)),
                               rtol=1e-6, atol=1e-6)
    per = rs.uniform(0, 1, (3, 11, 2)).astype(np.float32)  # one point set per mask
    want = jax.vmap(lambda m, p: jloss.point_sample(m[None], p)[0])(mask, per)
    np.testing.assert_allclose(tloss.point_sample(_t(mask), _t(per)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    logits, target = rs.randn(4, 9).astype(np.float32) * 3, (rs.rand(4, 9) < 0.5) * 1.0
    np.testing.assert_allclose(tloss._bce_logits(_t(logits), _t(target)).numpy(),
                               jloss._bce_logits(logits, target), rtol=1e-6, atol=1e-6)
    sig = 1 / (1 + np.exp(-logits))
    np.testing.assert_allclose(tloss._dice(_t(sig), _t(target)).numpy(),
                               jloss._dice(sig, target), rtol=1e-6, atol=1e-6)
    cls = rs.randn(6, 5).astype(np.float32)
    mp = rs.randn(6, 9).astype(np.float32)
    labels = rs.randint(0, 4, (3,))
    gp = (rs.rand(3, 9) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tloss._match_costs(_t(cls), _t(mp), torch.from_numpy(labels), _t(gp)).numpy(),
        jloss._match_costs(cls, mp, labels, gp), rtol=1e-5, atol=1e-6)


def test_seg_cross_entropy_matches_jax():
    """UperNet's pixel CE: the stride-4 logits resized to the labels by
    JAX's bilinear weights, the ignored pixels out of the mean."""
    from one_peace_tpu.vision.upernet import seg_cross_entropy as jax_ce
    from one_peace_tpu_torch.vision.upernet import seg_cross_entropy

    rs = np.random.RandomState(17)
    logits = rs.randn(2, 8, 8, 5).astype(np.float32)
    labels = rs.randint(0, 5, (2, 32, 32)).astype(np.int32)
    labels[:, :3] = 255
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = seg_cross_entropy(_t(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_uncertainty_points_match_jax():
    rs = np.random.RandomState(7)
    logits = rs.randn(2, 3, 6, 5).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    want = jloss.uncertainty_points(rng, jnp.asarray(logits), 16)
    n_cand, _, n_rand = tloss.point_counts(16)
    k1, k2 = jax.random.split(rng)
    cand = jax.random.uniform(k1, (2, 3, n_cand, 2))
    rand = jax.random.uniform(k2, (6, n_rand, 2)).reshape(2, 3, n_rand, 2)
    got = tloss.uncertainty_points(_t(cand), _t(rand), _t(logits), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask2former_loss_matches_jax(monkeypatch):
    """The loss and its six metrics at 1e-5, the gradients of the class and
    mask logits at 1e-4, over 3 levels with a padded GT row."""
    arrays = set_arrays()
    all_cls, all_masks, gt_masks, gt_labels, gt_valid = arrays
    rng = jax.random.PRNGKey(9)

    def jfn(c, m):
        return jloss.mask2former_loss(c, m, *map(jnp.asarray, arrays[2:]), rng,
                                      num_points=NUM_POINTS)

    (want, jm), (jgc, jgm) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(all_cls), jnp.asarray(all_masks))
    inject(monkeypatch, jax_draws(rng, 3, 2, gt_masks.shape[1], NUM_POINTS))
    tc, tm = _t(all_cls).requires_grad_(), _t(all_masks).requires_grad_()
    got, m = tloss.mask2former_loss(tc, tm, _t(gt_masks), torch.from_numpy(gt_labels),
                                    torch.from_numpy(gt_valid), None, num_points=NUM_POINTS)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(m) == set(jm)
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, err_msg=key)
    for g, w in ((tc.grad, jgc), (tm.grad, jgm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(w)).max())


# ---------------------------------------------------------------------------
# the criterion's two arms on arrays
# ---------------------------------------------------------------------------


def _criterion_cfg(loss_at="full", label_smoothing=0.0):
    cfg = FrameworkConfig().criterion
    cfg._name = "segmentation_criterion"
    cfg.seg_loss_at = loss_at
    cfg.label_smoothing = label_smoothing
    return cfg


class JaxHead:
    """The model contract of the JAX criterion over given outputs: UperNet's
    ``logits`` or Mask2Former's ``forward_sets`` return the parameters."""

    def __init__(self, mask2former: bool):
        self.is_mask2former = mask2former
        self.max_instances, self.num_queries, self.num_points = MAX_INSTANCES, 8, NUM_POINTS

    def logits(self, params, images):
        return params["logits"]

    def forward_sets(self, params, images):
        return params["cls"], params["masks"]


class PortHead(torch.nn.Module):
    """The port's counterpart of ``JaxHead``: the outputs are parameters."""

    def __init__(self, mask2former: bool, outputs: dict):
        super().__init__()
        self.is_mask2former = mask2former
        self.max_instances, self.num_queries, self.num_points = MAX_INSTANCES, 8, NUM_POINTS
        self.out = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v)) for k, v in
                                           outputs.items()})

    def logits(self, images):
        return self.out["logits"]

    def forward_sets(self, images):
        return self.out["cls"], self.out["masks"]


@pytest.mark.parametrize("head,loss_at,smoothing", [("upernet", "full", 0.0),
                                                    ("upernet", "stride", 0.1),
                                                    ("mask2former", "full", 0.0)])
def test_criterion_arms_match_jax(head, loss_at, smoothing, monkeypatch):
    """Each arm of the criterion on the segmenter's outputs (UperNet's
    stride-4 logits; Mask2Former's 3 levels of 8 queries over 5 classes at
    stride 4) for a batch of label maps: the loss and metrics at 1e-5 and
    the outputs' gradients at 1e-4 against ``jax.value_and_grad``."""
    rs = np.random.RandomState(13)
    lvls, q = 3, 8
    if head == "upernet":
        outputs = {"logits": rs.randn(2, SIZE // 4, SIZE // 4, CLASSES).astype(np.float32)}
    else:
        outputs = {"cls": rs.randn(lvls, 2, q, CLASSES + 1).astype(np.float32),
                   "masks": (2 * rs.randn(lvls, 2, q, SIZE // 4, SIZE // 4)).astype(np.float32)}
    cfg = _criterion_cfg(loss_at, smoothing)
    batch = seg_batch()
    rng = jax.random.PRNGKey(10)
    jhead = JaxHead(head == "mask2former")

    def jfn(p):
        return JaxCriterion(cfg)(jhead, p, jax.tree.map(jnp.asarray, batch), rng)

    (want, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree.map(jnp.asarray, outputs))
    if head == "mask2former":
        inject(monkeypatch, jax_draws(rng, lvls, 2, MAX_INSTANCES, NUM_POINTS))
    port = PortHead(head == "mask2former", outputs)
    got, m = build_criterion(cfg)(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  generator=torch.Generator().manual_seed(0))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(m) == set(jm)
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for key, p in port.out.items():
        w = np.asarray(jg[key])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


def test_mask2former_gt_masks_keep_the_largest_classes(monkeypatch):
    """The GT masks the criterion hands the loss: the top
    min(max_instances, queries, C) classes by pixel count, ties to the lower
    class id, on the stride-subsampled labels, zero-count slots padded."""
    seen = {}

    def loss(all_cls, all_masks, gt_masks, gt_labels, gt_valid, generator, num_points):
        seen.update(masks=gt_masks, labels=gt_labels, valid=gt_valid)
        return all_cls.sum(), {}

    monkeypatch.setattr("one_peace_tpu_torch.criterions.vision_criterions.mask2former_loss",
                        loss)
    tseg = PortHead(True, {"cls": np.zeros((3, 1, 8, CLASSES + 1), np.float32),
                           "masks": np.zeros((3, 1, 8, SIZE // 4, SIZE // 4), np.float32)})
    target = np.full((1, SIZE, SIZE), 255, np.int32)
    target[0, :16] = 3          # the most pixels
    target[0, 16:24] = 1        # a tie with 4 at 8 rows each
    target[0, 24:32] = 4
    target[0, 32:36] = 2        # the fewest
    target[0, 36:44] = CLASSES + 2  # out of range: no class
    batch = {"src_images": torch.zeros(1, 3, SIZE, SIZE), "target": torch.from_numpy(target)}
    with torch.no_grad():
        build_criterion(_criterion_cfg())(tseg, batch)
    assert seen["labels"].tolist() == [[3, 1, 4, 2]]
    assert seen["valid"].tolist() == [[True, True, True, True]]
    masks = seen["masks"][0]
    assert masks.shape == (MAX_INSTANCES, SIZE // 4, SIZE // 4)
    assert masks.sum((1, 2)).tolist() == [64.0, 32.0, 32.0, 16.0]
    target[0, 32:36] = 255
    with torch.no_grad():
        build_criterion(_criterion_cfg())(tseg, {**batch, "target": torch.from_numpy(target)})
    assert seen["labels"].tolist() == [[3, 1, 4, 0]]
    assert seen["valid"].tolist() == [[True, True, True, False]]


# ---------------------------------------------------------------------------
# the Trainer, and the trunk's remat
# ---------------------------------------------------------------------------


def _trainer_cfg():
    cfg = FrameworkConfig()
    cfg.model.encoder = seg_config()
    cfg.criterion = _criterion_cfg()
    cfg.common.bf16 = False
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 1
    return cfg


def test_trainer_matches_jax_trainer():
    """Two updates of the UperNet segmenter with AdamW, weight decay,
    clipping and layer decay (one lr per rel-pos table): the losses at
    1e-5, the gnorms at 1e-4, and the parameters after the updates as the
    gradients are held: all together within 1e-4 of their norm, each within
    1e-3 of its own."""
    cfg = _trainer_cfg()
    jseg, tree, _ = segmenters("upernet")
    model = tzoo.OnePeaceSegmenter(seg_config(), num_classes=CLASSES, device="cpu",
                                   **ADAPTER_KW, **HEADS["upernet"][2])
    model.load_state_dict(params_from_jax(tree), strict=True)
    jax_trainer = JaxTrainer(cfg, jseg, JaxCriterion(cfg.criterion),
                             params=jax.tree.map(jnp.asarray, tree),
                             mesh=make_mesh(1, 1, 1, devices=jax.devices()[:1]))
    port = Trainer(cfg, model, build_criterion(cfg.criterion))
    assert [p for p, _ in port.optimizer.slice_scales] == [
        model.backbone.image_adapter.rel_pos_table]
    for seed in (11, 12):
        batch = seg_batch(seed)
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        for key in ("loss", "lr", "pixel_acc"):
            assert got[key] == pytest.approx(float(want[key]), rel=1e-5, abs=1e-6), key
        # the gradients agree to 1e-4 together (the criterion test's bound)
        assert got["gnorm"] == pytest.approx(float(want["gnorm"]), rel=1e-4)
    after = params_from_jax(_np(jax_trainer.params))
    diffs, norms = [], []
    for name, p in model.named_parameters():
        w = after[name].double()
        diffs.append((p.detach().double() - w).norm())
        norms.append(w.norm())
        # over a floor at fp32 rounding (a zero-initialised bias that only
        # rounding moves)
        assert diffs[-1] <= 1e-3 * norms[-1] + 1e-7 * w.numel() ** 0.5, (name, float(diffs[-1]))
    assert torch.stack(diffs).norm() <= 1e-4 * torch.stack(norms).norm()
    table = model.backbone.image_adapter.rel_pos_table.detach()
    start = params_from_jax(tree)["backbone.image_adapter.rel_pos_table"]
    moved = (table - start).flatten(1).norm(dim=1)
    assert (moved > 0).all()


def _saved_bias_shapes(model, images):
    """The loss's gradients, and the shapes of the (H, L, L) fp32 tensors
    kept for the backward outside any checkpointed region."""
    heads, l = model.backbone.cfg.attention_heads, GRID * GRID + 1
    kept = []

    def pack(t):
        if t.dtype == torch.float32 and tuple(t.shape[-3:]) == (heads, l, l):
            kept.append(tuple(t.shape))
        return t

    model.zero_grad(set_to_none=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.logits(images).square().mean()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}, kept


def test_remat_gives_equal_gradients_and_keeps_no_bias():
    """The trunk with ``checkpoint_activations`` recomputes each layer with
    its bias gathered inside the region: the gradients equal those without
    remat, and no (H, L, L) bias is kept for the backward (without remat,
    each layer's is)."""
    images = _t(seg_batch()["src_images"])
    grads = {}
    for remat in (False, True):
        model = fill_random_(tzoo.OnePeaceSegmenter(seg_config(remat), num_classes=CLASSES,
                                                    device="cpu", **ADAPTER_KW, channels=16),
                             torch.Generator().manual_seed(3))
        for p in model.parameters():
            p.requires_grad_(True)
        grads[remat], kept = _saved_bias_shapes(model, images)
        assert (len(kept) >= LAYERS) if not remat else not kept, (remat, kept)
    assert grads[False]["backbone.image_adapter.rel_pos_table"].abs().sum() > 0
    for name, g in grads[False].items():
        if g is None:  # the layers' text and audio experts
            assert grads[True][name] is None, name
            continue
        torch.testing.assert_close(grads[True][name], g, rtol=1e-6, atol=1e-7, msg=name)


def test_bucket_gather_backward_equals_the_index_backward():
    """The (L, L) rel-pos gather with its per-bucket backward (the segmenter
    trunk's, L = 257 here): the same forward, and the gradient of each
    table equal to PyTorch's index backward to fp32 rounding, bit-equal from
    one call to the next."""
    idx = torch.from_numpy(make_image_bucket_position(16))
    r = (2 * 16 - 1) ** 2 + 3
    gen = torch.Generator().manual_seed(16)
    table = torch.randn(3, r, 4, generator=gen, requires_grad=True)
    grad = torch.randn(3, 4, 257, 257, generator=gen)
    sums = bucket_order(idx, r)
    assert int(sums[1].sum()) == 257 * 257 and int(sums[1].min()) > 0
    out = gather_rel_bias(table, idx, sums)
    torch.testing.assert_close(out, gather_rel_bias(table, idx), rtol=0, atol=0)
    got = torch.autograd.grad(out, table, grad)[0]
    again = torch.autograd.grad(gather_rel_bias(table, idx, sums), table, grad)[0]
    want = torch.autograd.grad(gather_rel_bias(table, idx), table, grad)[0]
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
