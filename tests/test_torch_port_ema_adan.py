"""The rest of the port's training loop against the JAX package, on CPU at
toy size: the EMA (its arithmetic, and in the ``Trainer`` with a start
delay, an update frequency, accumulation and a skipped step), the CLI's
EMA validation source and best export, a resume through ``cli.train``
with fp16, the EMA and Adan bit-equal to the straight run, Adan against
the JAX ``build_optimizer``'s Adan arm through both ``Trainer``s,
``Trainer.valid_step`` and ``utils/nan_guard.py``.

Tolerances: the EMA's update is bit-equal to JAX's on the same inputs
(``s * decay`` rounded, then one fused multiply-add); through the
trainers, the parameters differ by the fp32 order of the two frameworks'
sums (1e-5 relative to each parameter's norm, as
``test_torch_port_train.py``), and the shadow with them.  Adan's bias
corrections and lr are fp32 in JAX and fp64 scalars here: 1e-5 again.
``valid_step``'s metrics 1e-5; ``grad_norms_by_subtree`` 1e-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_model_config
from one_peace_tpu.core.config import EMAConfig as JaxEMAConfig
from one_peace_tpu.utils import nan_guard as jax_nan_guard
from one_peace_tpu.utils.ema import EMA as JaxEMA
from one_peace_tpu_torch.cli import train
from one_peace_tpu_torch.core.config import EMAConfig
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.optim.adan import Adan
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils import nan_guard
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import load_npz, params_from_jax
from one_peace_tpu_torch.utils.ema import EMA
from test_torch_port_train import (PARAM_TOL, _batch, _framework_cfg, _np_tree, _port_model,
                                   _trainers, _weights)
from test_torch_port_train_cli import _bundle_equal, overrides
from test_torch_port_train_cli import corpus as cli_corpus  # noqa: F401  (a fixture)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(b.norm(), 1e-12))


# ---------------------------------------------------------------------------
# the EMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ema_fp32", [True, False])
def test_ema_arithmetic_matches_jax(ema_fp32):
    """The same fp32 parameter sequence (the trainer's masters) through both
    EMAs: copy-through before ``ema_start_update``, an update every
    ``ema_update_freq`` updates, a skipped step that holds the shadow; bit
    for bit, under ``ema_fp32`` both ways (the shadow keeps the masters'
    fp32 either way)."""
    dtype, jdtype = torch.float32, jnp.float32
    kw = dict(store_ema=True, ema_decay=0.9, ema_start_update=2, ema_update_freq=2,
              ema_fp32=ema_fp32)
    rs = np.random.RandomState(0)
    shapes = {"w": (5, 7), "b": (7,)}
    draw = lambda: {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}  # noqa: E731
    params = draw()
    port = EMA(EMAConfig(**kw), [(k, torch.as_tensor(v).to(dtype)) for k, v in params.items()])
    jax_ema = JaxEMA(JaxEMAConfig(**kw), {k: jnp.asarray(v, jdtype) for k, v in params.items()})
    for num_updates in range(1, 9):
        params = draw()
        skipped = num_updates == 6
        port.step([(k, torch.as_tensor(v).to(dtype)) for k, v in params.items()], num_updates,
                  skipped=skipped)
        jax_ema.step({k: jnp.asarray(v, jdtype) for k, v in params.items()}, num_updates,
                     skipped=float(skipped))
        for k in shapes:
            want = np.asarray(jax_ema.shadow[k].astype(jnp.float32))
            assert port.shadow[k].dtype == torch.float32
            np.testing.assert_array_equal(port.shadow[k].float().numpy(), want,
                                          err_msg=f"{k} at {num_updates}")


def _ema_cfg(update_freq=2, ema_fp32=True):
    cfg = _framework_cfg(update_freq=update_freq)
    cfg.ema.store_ema = True
    cfg.ema.ema_decay = 0.5  # a large step: the shadow visibly lags the masters
    cfg.ema.ema_start_update = 2
    cfg.ema.ema_update_freq = 2
    cfg.ema.ema_fp32 = ema_fp32
    return cfg


@pytest.mark.parametrize("ema_fp32", [True, False])
def test_trainer_ema_matches_jax_trainer(ema_fp32):
    """update_freq=2 over 10 micro-steps, the 5th a NaN batch: the shadow
    steps on accumulation boundaries only, after the update, holds on the
    skipped step, and follows the JAX ``Trainer``'s shadow, which covers
    every parameter."""
    cfg = _ema_cfg(ema_fp32=ema_fp32)
    port, jax_trainer = _trainers(cfg)
    assert set(port.ema.shadow) == {n for n, _ in port.model.named_parameters()}
    for i in range(10):
        batch = _batch(cfg.model, b=4, seed=i)
        if i == 4:
            batch = dict(batch, src_images=np.full_like(batch["src_images"], np.nan))
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        assert got["skipped"] == want["skipped"] == float(i == 4)
        shadow = params_from_jax(_np_tree(jax_trainer.ema.shadow))
        for name, s in port.ema.shadow.items():
            assert _rel(s, shadow[name]) <= PARAM_TOL, (i, name)
    masters = dict(port.model.named_parameters())
    assert any(_rel(s, masters[n]) > 1e-3 for n, s in port.ema.shadow.items())


class _RecordingTask:
    """A task whose validation records the parameters it was given."""

    def __init__(self):
        self.seen = None

    def begin_valid_epoch(self, model, params):
        self.seen = {k: v.clone() for k, v in params.items()}

    def get_batch_iterator(self, *args, **kwargs):
        class _Empty:
            @staticmethod
            def next_epoch_itr():
                return iter(())

        return _Empty()

    def valid_step(self, model, params, batch):
        raise AssertionError("no batches")

    def merge_results(self):
        return {"r_mean": 1.0}


def test_ema_eval_source_and_best_export(tmp_path):
    """As the JAX CLI's test: with ``ema.store_ema`` validation scores the
    compute-dtype copies of the shadow and ``checkpoint_best.npz`` exports
    the shadow; ``ema.ema_eval=false`` or a task's ``uses_ema=False``
    brings back the masters."""
    cfg = _ema_cfg(update_freq=1)
    cfg.ema.ema_start_update = 0
    cfg.common.bf16 = True
    cfg.checkpoint.save_dir = str(tmp_path)
    cfg.checkpoint.best_checkpoint_metric = "r_mean"
    _, state = _weights(cfg.model)
    trainer = Trainer(cfg, _port_model(cfg.model, state), build_criterion(cfg.criterion))
    for i in range(3):
        trainer.train_step(_batch(cfg.model, b=6, seed=i))
    name = "encoder_wrapper.fusion.layers.0.text_ffn.wi_0.weight"
    shadow, master = trainer.ema.shadow[name], dict(trainer.model.named_parameters())[name]
    assert not torch.allclose(shadow, master)

    task = _RecordingTask()
    assert train._eval_params_source(cfg, task, trainer) is trainer.ema.shadow

    class Progress:
        @staticmethod
        def print(stats, step):
            pass

    stats = train.validate(cfg, task, trainer.model, trainer, Progress())
    torch.testing.assert_close(task.seen[name], shadow.bfloat16(), rtol=0, atol=0)
    train._maybe_save_best(cfg, task, trainer, stats, {"value": None})
    saved = load_npz(str(tmp_path / "checkpoint_best.npz"))
    torch.testing.assert_close(saved[name], shadow, rtol=0, atol=0)

    cfg.ema.ema_eval = False
    assert train._eval_params_source(cfg, task, trainer) is None
    cfg.ema.ema_eval = True
    task.uses_ema = False  # the task's choice beats the config's default
    assert train._eval_params_source(cfg, task, trainer) is None
    train.validate(cfg, task, trainer.model, trainer, Progress())
    torch.testing.assert_close(task.seen[name], master.bfloat16(), rtol=0, atol=0)


def test_cli_resume_with_fp16_ema_and_adan_is_bit_equal(cli_corpus, tmp_path):  # noqa: F811
    """``cli.train`` with ``common.fp16=true ema.store_ema=true
    optimizer._name=adan``: a run stopped after epoch 1 and resumed to 4
    updates ends with the straight run's bundle, bit for bit (masters, Adan
    state, the EMA shadow, the loss scale, counters, generator, iterator),
    and the bundles carry the shadow and the scale."""
    common = dict(task__data=cli_corpus["root"] / "train12.tsv", dataset__batch_size=4,
                  optimization__update_freq=2, optimization__max_update=4,
                  optimization__max_epoch=0, checkpoint__reset_optimizer="false",
                  model__encoder__drop_path_rate=0.3, common__fp16="true",
                  ema__store_ema="true", ema__ema_decay=0.9, optimizer___name="adan")
    straight, first = tmp_path / "straight", tmp_path / "resumed"
    assert train.main(["--device", "cpu"] + overrides(cli_corpus, straight, **common)) == 0
    stopped = dict(common, optimization__max_epoch=1)
    assert train.main(["--device", "cpu"] + overrides(cli_corpus, first, **stopped)) == 0
    assert train.main(["--device", "cpu"] + overrides(cli_corpus, first, **common)) == 0
    a = ckpt.restore_train_state(str(straight / "ckpt" / "step_4"))
    b = ckpt.restore_train_state(str(first / "ckpt" / "step_4"))
    assert set(a["trainer"]["ema_shadow"]) == set(a["trainer"]["params"])
    assert a["trainer"]["loss_scale"]["scale"] > 0
    assert all("prev_grad" in st for st in a["trainer"]["opt_state"]["state"].values())
    a["trainer"].pop("train_time"), b["trainer"].pop("train_time")
    _bundle_equal(a, b)


# ---------------------------------------------------------------------------
# Adan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("select", ["_name", "use_adan"])
def test_adan_matches_jax_trainer(select):
    """Four updates of Adan through both ``Trainer``s: clip 1.0, layer decay
    0.9 (the val model's per-layer rel-pos tables, each at its layer's
    scale), the proximal weight decay 0.05 on every parameter, cosine
    warmup; the metrics and the parameters agree."""
    cfg = _framework_cfg()
    cfg.model = tiny_model_config(head_type="vl", copy_rel_pos_table=True)
    if select == "_name":
        cfg.optimizer._name = "adan"
    else:
        cfg.optimizer.use_adan = True
    port, jax_trainer = _trainers(cfg)
    assert isinstance(port.optimizer, Adan)
    tables = [p for n, p in port.model.named_parameters() if "rel_pos_table" in n
              and p.shape[0] > 1]
    assert tables and all(isinstance(port.optimizer.scales[p], torch.Tensor) for p in tables)
    for i in range(4):
        batch = _batch(cfg.model, b=6, seed=i)
        got, want = port.train_step(batch), jax_trainer.train_step(batch)
        for key in ("loss", "gnorm", "lr"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), (i, key)
    want = params_from_jax(_np_tree(jax_trainer.params))
    for name, p in port.model.named_parameters():
        assert _rel(p.detach(), want[name]) <= PARAM_TOL, name


def test_adan_first_step_and_proximal_decay():
    """One Adan step by hand: the first step's difference is 0, so m, d and
    v take (1 - b) g, (1 - b2) 0 and (1 - b3) g^2, the update is
    m / bc1 / (sqrt(v / bc3) + eps) * s * -lr, and the decay divides
    p + u by 1 + lr wd."""
    p = torch.tensor([1.0, -2.0, 3.0])
    g = torch.tensor([0.5, 0.25, -1.0])
    opt = Adan([{"params": [p]}], {p: 0.5}, betas=(0.98, 0.92, 0.99), eps=1e-8,
               weight_decay=0.1)
    opt.param_groups[0]["schedule_lr"] = 0.01
    p.grad = g.clone()
    want = p.clone()
    m, v = 0.02 * g, 0.01 * g * g
    u = (m / 0.02) / (torch.sqrt(v / 0.01) + 1e-8) * 0.5 * -0.01
    want = (want + u) / (1 + 0.01 * 0.1)
    opt.step()
    torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(opt.state[p]["prev_grad"], g, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# valid_step and nan_guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_valid_step_matches_jax(bf16):
    """The criterion's metrics without a gradient, deterministic (drop path
    and dropout set but off), on the compute-dtype copies; nothing moves."""
    cfg = _framework_cfg()
    cfg.common.bf16 = bf16
    cfg.model.encoder.drop_path_rate = 0.3
    cfg.model.encoder.dropout = 0.1
    port, jax_trainer = _trainers(cfg)
    before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    batch = _batch(cfg.model, b=6, seed=3)
    got = port.valid_step(batch, fetch=True)
    want = jax_trainer.valid_step(batch, fetch=True)
    tol = 1e-5 if not bf16 else 2e-2  # bf16 rounds to 8 bits (3.9e-3 relative) per op
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=tol, abs=tol), key
    again = port.valid_step(batch)
    assert all(isinstance(v, torch.Tensor) and float(v) == got[k] for k, v in again.items())
    for n, p in port.model.named_parameters():
        torch.testing.assert_close(p, before[n], rtol=0, atol=0)


def test_nan_guard_matches_jax():
    """``probe_modules`` stops at the first non-finite stage with the same
    report (finiteness, absmax, NaN share per floating output, dicts in key
    order); ``grad_norms_by_subtree`` gives JAX's norms."""
    rs = np.random.RandomState(0)
    a = rs.randn(4, 5).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    bad = a.copy()
    bad[1, 2] = np.nan
    bad[0, 0] = np.inf
    stages = [("embed", lambda x: {"z": x(a), "a": x(b), "ids": x(np.arange(3))}),
              ("layer", lambda x: (x(a) * 2, x(bad))), ("head", lambda x: x(b))]
    jax_report = jax_nan_guard.probe_modules(
        [(n, lambda f=f: f(jnp.asarray)) for n, f in stages])
    port_report = nan_guard.probe_modules(
        [(n, lambda f=f: f(torch.as_tensor)) for n, f in stages])
    assert [r["name"] for r in port_report] == ["embed", "layer"]
    assert len(port_report) == len(jax_report)
    for got, want in zip(port_report, jax_report):
        assert (got["name"], got["bad"], list(got["stats"])) == (
            want["name"], want["bad"], list(want["stats"]))
        for key, st in want["stats"].items():
            for k, v in st.items():
                same = (math.isnan(v) and math.isnan(got["stats"][key][k])) or \
                    got["stats"][key][k] == pytest.approx(v, rel=1e-6)
                assert same, (got["name"], key, k)

    grads = {"encoder": {"w": a, "layers": [b, a[:2]]}, "head": b, "empty": {}}
    want = jax_nan_guard.grad_norms_by_subtree(jax.tree.map(jnp.asarray, grads))
    got = nan_guard.grad_norms_by_subtree(
        {"encoder": {"w": torch.as_tensor(a), "layers": [torch.as_tensor(b),
                                                          torch.as_tensor(a[:2])]},
         "head": torch.as_tensor(b), "empty": {}})
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(float(want[key]), rel=1e-6), key
