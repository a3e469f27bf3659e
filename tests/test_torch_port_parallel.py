"""Data parallelism and FSDP in the port against the JAX package, on the CPU
over gloo (``torch_ranks.run_ranks``: spawned ranks, a ``FileStore`` under
``tmp_path``, a timeout on every group and on the join).

- The mesh: ``mesh_shape`` against the JAX ``make_mesh`` on virtual devices,
  shapes and refusals, and the ``DeviceMesh`` over 4 ranks.
- The sharding rules: every parameter path of the retrieval, classify and
  detector trees gets, dimension by dimension, the spec that the JAX rules
  give its counterpart in the JAX tree (through ``params_to_jax`` and back).
- The slice: the tiny vl retrieval model with the settings of
  ``test_torch_port_train.py::test_trainer_matches_jax_trainer`` (warmup,
  clip 1.0, layer decay 0.9, weight decay) takes 3 ``train_step``s on global
  batches of 8 at 2 ranks (fsdp 2) and 4 ranks (dp 2 x fsdp 2), each rank on
  its slice.  Per step ``loss``, ``gnorm``, ``lr`` and ``skipped``, and the
  parameters after the steps, match the JAX ``Trainer`` on a mesh of the same
  shape and the port in one process, within that test's ``LOSS_TOL`` and
  ``PARAM_TOL``; so does ``update_freq=2``; in fp16 an inf on one rank skips
  the step on every rank and halves the scale on every rank.
- Saving and resuming: a bundle saved at 2 ranks resumes in one process,
  and one saved in one process resumes at 2 ranks, each with the loss of the
  next update equal to the straight run's.

Each spawn of ranks takes ~10-25 s (the processes' start and imports)."""

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import parallel_workers as pw
import torch_fixture as tf
from helpers import tiny_model_config
from torch_ranks import run_ranks
from one_peace_tpu.core.config import FrameworkConfig
from one_peace_tpu.criterions.criterions import ImageTextRetrievalCriterion as JaxImageITC
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.parallel import mesh as jax_mesh
from one_peace_tpu.parallel import sharding as jax_sharding
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu.utils.checkpoint_convert import convert_retrieval_model, to_jax
from one_peace_tpu_torch.models.classify import OnePeaceClassifyModel
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.parallel import mesh as port_mesh
from one_peace_tpu_torch.parallel import sharding as port_sharding
from one_peace_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

LOSS_TOL, PARAM_TOL = 1e-5, 1e-5  # test_torch_port_train.py's
GLOBAL_BATCH = 8
KEYS = ("loss", "gnorm", "lr", "skipped")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

MESH_CASES = [  # (dp, fsdp, tp, pp, sp, world)
    (-1, 1, 1, 1, 1, 1), (-1, 2, 1, 1, 1, 4), (2, 2, 1, 1, 1, 4), (-1, 4, 1, 1, 1, 4),
    (1, 8, 1, 1, 1, 8), (-1, 1, 2, 1, 1, 4), (-1, 2, 1, 2, 1, 8), (-1, 1, 1, 1, 2, 4),
    (1, 8, 1, 1, 1, 1), (-1, 8, 1, 1, 1, 1), (2, 2, 1, 1, 1, 8), (-1, 3, 1, 1, 1, 4)]


@pytest.mark.parametrize("dp,fsdp,tp,pp,sp,world", MESH_CASES)
def test_mesh_shape_matches_jax(dp, fsdp, tp, pp, sp, world):
    """The shape and axis names of the JAX mesh over ``world`` virtual
    devices, or a refusal where the JAX function refuses."""
    try:
        want = jax_mesh.make_mesh(dp, fsdp, tp, pp, devices=jax.devices()[:world], sp=sp)
    except AssertionError:
        with pytest.raises(ValueError, match="processes"):
            port_mesh.mesh_shape(dp, fsdp, tp, pp, sp, world)
        return
    shape, names = port_mesh.mesh_shape(dp, fsdp, tp, pp, sp, world)
    assert names == tuple(want.axis_names)
    assert shape == tuple(want.devices.shape)


def test_one_process_names_the_override(monkeypatch):
    """The detection recipe's fsdp: 8 in one process raises and names the
    override, without a process group; a tp, pp or sp layout is accepted,
    and one that does not split the model raises naming the divisibility
    it needs."""
    with pytest.raises(ValueError, match="distributed.fsdp=1"):
        port_mesh.make_mesh(1, 8, device_type="cpu")
    assert port_mesh.make_mesh(-1, 1, device_type="cpu") is None
    # valid layouts over 2 processes, with tp, pp or sp: no group, no mesh
    monkeypatch.setattr(port_mesh, "world_size", lambda: 2)
    for kw in (dict(tp=2), dict(pp=2), dict(sp=2)):
        assert port_mesh.make_mesh(1, 1, device_type="cpu", **kw) is None
    enc = tiny_model_config().encoder  # 4 heads, FFN 64, 2 layers
    with pytest.raises(ValueError, match="distributed.tp=8 does not divide the 4 attention"):
        port_mesh.check_split([enc], tp=8)
    with pytest.raises(ValueError, match="distributed.pp=4 does not divide the encoder's 2"):
        port_mesh.check_split([enc], pp=4)


def test_device_mesh_over_four_ranks(tmp_path):
    shapes = run_ranks(4, pw.device_mesh_layout, tmp_path=tmp_path)
    for rank, got in enumerate(shapes):
        assert got["names"] == ("dp", "fsdp", "tp") and got["shape"] == (2, 2, 1)
        assert got["mismatch_refused"]
        assert got["fsdp_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        # (dp 2, tp 2): tp the inner axis, the data ranks across it
        pair = [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert got["tp_layout"] == {"data": ([rank % 2, rank % 2 + 2], rank // 2),
                                    "tp": (pair, rank % 2), "sp": ([rank], 0),
                                    "pp": ([rank], 0)}


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

_CODES = {None: 1.0, "fsdp": 100.0, "tp": 10000.0}


def _encode(spec, shape):
    """A leaf whose value moves by ``code(axis name)`` along each dimension,
    so that the walk into the port's layout (unstacking, transposes) shows
    which mesh axis each port dimension carries."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = np.zeros(shape, np.float64)
    for axis, name in enumerate(spec):
        idx = np.arange(shape[axis], dtype=np.float64).reshape(
            (1,) * axis + (-1,) + (1,) * (len(shape) - axis - 1))
        out = out + _CODES[name] * idx
    return out


def _decode(t: torch.Tensor):
    inv = {v: k for k, v in _CODES.items()}
    spec = []
    for axis in range(t.ndim):
        if t.shape[axis] < 2:
            spec.append("?")  # a size-1 dimension shows nothing
            continue
        step = float(t.select(axis, 1).flatten()[0] - t.select(axis, 0).flatten()[0])
        spec.append(inv[step])
    return tuple(spec)


def _jax_specs_in_port_layout(model):
    """Each port parameter's spec by the JAX rules on its JAX path."""
    layout = model.jax_layout() if hasattr(model, "jax_layout") else {}
    tree = params_to_jax({k: v.detach().float() for k, v in model.state_dict().items()}, **layout)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        leaf = np.asarray(node)
        spec = jax_sharding.spec_for_path("/".join(path), leaf.ndim)
        return _encode(spec, leaf.shape)

    return {k: _decode(v) for k, v in params_from_jax(walk(tree, ())).items()}


def _models():
    cfg = tiny_model_config(head_type="val")
    return {
        "retrieval": OnePeaceRetrievalModel(cfg, device="cpu"),
        "classify": OnePeaceClassifyModel(tiny_model_config(head_type="vl"), num_classes=5,
                                          device="cpu"),
        "detector": OnePeaceDetector(proposer="rpn", device="cpu", num_classes=4,
                                     image_size=64, fpn_channels=16, embed_dim=32,
                                     ffn_embed_dim=64, heads=4, layers=4,
                                     pretrain_bucket_size=4, window_size=2, global_period=2),
    }


@pytest.mark.parametrize("tree", ["retrieval", "classify", "detector"])
def test_sharding_rules_match_jax(tree):
    model = _models()[tree]
    want = _jax_specs_in_port_layout(model)
    got = port_sharding.param_specs(model)
    assert sorted(got) == sorted(want)
    sharded = 0
    for name, p in model.named_parameters():
        spec = tuple(got[name]) + (None,) * (p.ndim - len(got[name]))
        for axis, (g, w) in enumerate(zip(spec, want[name])):
            if w != "?":
                assert g == w, (name, axis, spec, want[name])
        sharded += "fsdp" in spec
    assert sharded >= 14, sharded
    if tree == "detector":  # the windowed layers stay replicated, as in JAX
        dims = port_sharding.fsdp_dims(model)
        assert "backbone.layers.1.self_attn.q_proj.weight" in dims
        assert not any(n.startswith("backbone.layers.0.") for n in dims)


# ---------------------------------------------------------------------------
# the slice: the trainer at 2 and 4 ranks
# ---------------------------------------------------------------------------


def _prune(tree, like):
    if isinstance(like, dict):
        return {k: _prune(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_prune(t, v) for t, v in zip(tree, like)]
    return tree


def _jax_cfg(update_freq=1):
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


def _batch(b, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(5, 99, (b, 7))
    tokens[1, 4:] = 1
    return {"src_tokens": tokens, "src_images": rs.randn(b, 3, 32, 32).astype(np.float32)}


@pytest.fixture(scope="module")
def weights():
    mc = tiny_model_config(head_type="vl")
    tree = convert_retrieval_model(tf.make_random_state_dict(mc, seed=0), mc)
    tree = _prune(tree, jax.eval_shape(lambda: JaxModel(mc).init(jax.random.PRNGKey(0))))
    return to_jax(tree), params_from_jax(tree)


BATCHES = [_batch(GLOBAL_BATCH, s) for s in range(5)]


def _scenarios(one_rank_bundle=None):
    """What each spawn of ranks runs: 3 steps, then a save and a fourth step
    (and a resume from ``one_rank_bundle`` on the fourth batch); 4 micro-steps
    at update_freq=2; fp16 with an inf on rank 1 at step 2."""
    return [("plain", dict(update_freq=1), BATCHES[:4], None, one_rank_bundle),
            ("accumulate", dict(update_freq=2), BATCHES[:4], None, None),
            ("fp16", dict(update_freq=1, fp16=True), BATCHES[:4], (2, 1), None)]


@pytest.fixture(scope="module")
def one_process(weights):
    """The port in one process (no process group): the same scenarios."""
    _, state = weights
    out = {}
    for name, kw, batches, _, _ in _scenarios():  # fp16 without the inf
        trainer = pw.retrieval_trainer(pw.retrieval_cfg(**kw), state)
        metrics = []
        for i, batch in enumerate(batches):
            if name == "plain" and i == 3:
                out["plain_bundle"] = trainer.state_dict()
            metrics.append(trainer.train_step(batch))
        out[name] = {"metrics": metrics,
                     "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}
    return out


@pytest.fixture(scope="module")
def ranks(weights, one_process, tmp_path_factory):
    _, state = weights
    out = {}
    for world, (dp, fsdp) in ((2, (1, 2)), (4, (2, 2))):
        runs = run_ranks(world, pw.train_scenarios, state, _scenarios(one_process["plain_bundle"]),
                         dp, fsdp, tmp_path=tmp_path_factory.mktemp(f"ranks{world}"),
                         timeout=240)
        out[world] = runs
    return out


@pytest.fixture(scope="module")
def jax_mesh_runs(weights):
    """The JAX ``Trainer`` on a (dp 2, fsdp 2) mesh over 4 virtual devices."""
    params, _ = weights
    out = {}
    for name, update_freq in (("plain", 1), ("accumulate", 2)):
        cfg = _jax_cfg(update_freq)
        trainer = JaxTrainer(cfg, JaxModel(cfg.model), JaxImageITC(cfg.criterion),
                             params=jax.tree.map(np.array, params),  # it donates them
                             mesh=jax_mesh.make_mesh(2, 2, 1, devices=jax.devices()[:4]))
        steps = 3 if name == "plain" else 4
        metrics = [trainer.train_step(b) for b in BATCHES[:steps]]
        out[name] = {"metrics": metrics,
                     "params": params_from_jax(jax.tree.map(np.asarray, trainer.params))}
    return out


def _assert_metrics(got, want, keys=KEYS):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for key in keys:
            assert g[key] == pytest.approx(w[key], rel=LOSS_TOL, abs=LOSS_TOL), (i, key)


def _assert_params(got, want):
    for name, w in want.items():
        w = torch.as_tensor(w).double()
        err = (torch.as_tensor(got[name]).double() - w).norm() / max(float(w.norm()), 1e-12)
        assert err <= PARAM_TOL, (name, float(err))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_trainer_matches_jax_mesh_trainer(world, ranks, jax_mesh_runs):
    for name in ("plain", "accumulate"):
        got = ranks[world][0][name]
        steps = len(jax_mesh_runs[name]["metrics"])
        _assert_metrics(got["metrics"][:steps], jax_mesh_runs[name]["metrics"])
        _assert_params(got["params_after" if name == "plain" else "params"],
                       jax_mesh_runs[name]["params"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_trainer_matches_one_process(world, ranks, one_process):
    for name in ("plain", "accumulate"):
        for rank, run in enumerate(ranks[world]):  # every rank logs the global values
            _assert_metrics(run[name]["metrics"], one_process[name]["metrics"])
        _assert_params(ranks[world][0][name]["params"], one_process[name]["params"])
    assert [m["skipped"] for m in ranks[world][0]["accumulate"]["metrics"]] == [0.0] * 4


@pytest.mark.parametrize("world", [2, 4])
def test_fp16_inf_on_one_rank_skips_on_every_rank(world, ranks, one_process):
    """The inf on rank 1 at step 2 skips that step on every rank, where one
    process without it does not skip, and halves every rank's scale; every
    rank logs the same skips and scales.  (Whether the first step overflows
    at 2^15 depends on how the fp16 backward is split: a rank sums its own
    rows' gradients in fp16, one process all of them, so it is not held.)"""
    straight = one_process["fp16"]["metrics"]
    assert straight[2]["skipped"] == 0.0
    logs = [[(x["skipped"], x["loss_scale"]) for x in run["fp16"]["metrics"]]
            for run in ranks[world]]
    assert all(log == logs[0] for log in logs)
    (_, scale1), (s2, scale2) = logs[0][1], logs[0][2]
    assert s2 == 1.0 and scale2 == scale1 / 2
    assert logs[0][3] == (0.0, scale2)


@pytest.mark.parametrize("world", [2, 4])
def test_only_the_rules_fsdp_leaves_are_sharded(world, ranks):
    model = OnePeaceRetrievalModel(tiny_model_config(head_type="vl"), device="cpu")
    assert ranks[world][0]["sharded"] == sorted(port_sharding.fsdp_dims(model))


@pytest.mark.parametrize("world", [2, 4])
def test_bundle_moves_between_one_process_and_ranks(world, ranks, one_process, weights):
    """Saved at ``world`` ranks after 3 steps: one process resumes and takes
    the fourth step with the loss the ranks took; saved in one process, the
    ranks resume and take it with the loss one process took."""
    _, state = weights
    run = ranks[world][0]["plain"]
    trainer = pw.retrieval_trainer(pw.retrieval_cfg(), state)
    trainer.load_state_dict(run["bundle"])
    assert trainer.train_step(BATCHES[3])["loss"] == pytest.approx(
        run["metrics"][3]["loss"], rel=LOSS_TOL, abs=LOSS_TOL)
    straight = one_process["plain"]["metrics"][3]["loss"]
    for r in ranks[world]:
        assert r["plain"]["resumed_loss"] == pytest.approx(straight, rel=LOSS_TOL, abs=LOSS_TOL)
