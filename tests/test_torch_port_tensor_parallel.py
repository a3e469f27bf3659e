"""Tensor parallelism in the port against the JAX package, on the CPU over
gloo (``torch_ranks.run_ranks``; what the ranks run is in
``tests/model_parallel_workers.py``, the JAX side in ``tests/mp_oracle.py``).

- tp=2: the tiny vl retrieval model through the ITC criterion, one with the
  per-head gains (``scale_heads``), and the vl classify model (attention
  pooling, pooler, per-layer rel-pos tables) through the classify criterion,
  and the VL pretrain model (its decoder split too) through ITC and DCL
  (and, with dropout and drop path on, the one-process run's):
  the loss and every parameter's gradient, gathered to full, against
  ``jax.grad`` of the serial JAX model (``attn_impl="xla"``, fp32) within
  1e-4 of each gradient's largest entry.  Gradients, not updated
  parameters: AdamW's first update does not see a gradient's scale, so a
  ``tp`` times too large gradient would pass a comparison of parameters.
- dp1 x fsdp2 x tp2: the same gradients, and ``loss`` and ``gnorm`` over 3
  ``train_step``s against the JAX ``Trainer`` on a (1, 2, 2) mesh.
- dp2 x tp2: the global-batch ITC loss equals one process's, and the
  evaluation reducers merged over the data ranks count each row once.
- The refusals: a layout that does not split the heads or the FFN raises
  ``ValueError``; the detection trunk, the video classifier (which holds
  an ``encoder_wrapper`` too) and int8 layers under ``tp``, and ``sp``
  without the ring or on a vision trunk, raise ``NotImplementedError``.

Each spawn of ranks takes ~10-25 s."""

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import mp_oracle as mo
from helpers import tiny_model_config
from one_peace_tpu.core.config import FrameworkConfig
from one_peace_tpu.criterions.criterions import ImageTextRetrievalCriterion as JaxImageITC
from one_peace_tpu.models.one_peace import OnePeaceRetrievalModel as JaxModel
from one_peace_tpu.parallel import mesh as jax_mesh
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.ops.quant import quantize_ffn_
from one_peace_tpu_torch.parallel import mesh as port_mesh
from one_peace_tpu_torch.parallel import tensor_parallel
from one_peace_tpu_torch.vision.backbone import VideoClassifier
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector
from torch_ranks import run_ranks

LOSS_TOL = 1e-5
BATCHES = [mo.retrieval_batch(8, s) for s in range(3)]


@pytest.fixture(scope="module")
def cases():
    return {"vl": mo.Case("retrieval", BATCHES[0]),
            "heads": mo.Case("retrieval", BATCHES[1], seed=1, scale_heads=True),
            "classify": mo.Case("classify", mo.classify_batch(4, 0)),
            "pretrain": mo.Case("pretrain", mo.pretrain_batch(4, 0))}


def _check(run, case):
    assert run["loss"] == pytest.approx(case.loss, rel=LOSS_TOL, abs=LOSS_TOL)
    mo.assert_grads_match(run["grads"], case)


def test_tp2_gradients_match_jax(cases, tmp_path):
    """Also, with dropout, activation dropout (drawn for the whole FFN width
    and cut to a rank's columns) and drop path on, the one-process run's
    loss and gradients."""
    layout = dict(dp=1, tp=2)
    names = ("vl", "heads", "classify", "pretrain")
    dropped = mo.with_dropout(cases["vl"], layout)
    runs = run_ranks(2, mo.mw.full_gradients, [cases[n].on(layout) for n in names] + [dropped],
                     tmp_path=tmp_path, timeout=240)
    for name, run in zip(names, runs[0]):
        _check(run, cases[name])
    mo.assert_same_run(runs[0][4], mo.mw.full_gradients(0, 1, [dict(dropped, layout={})])[0])
    for rank in runs:  # every rank logs the whole loss
        assert [r["loss"] for r in rank] == [r["loss"] for r in runs[0]]
    # each rank keeps its half of a column-parallel weight, by name
    assert runs[0][0]["local_names"] == runs[1][0]["local_names"]


@pytest.fixture(scope="module")
def jax_tp_trainer(cases):
    """The JAX ``Trainer`` on a (dp 1, fsdp 2, tp 2) mesh: 3 steps."""
    cfg = FrameworkConfig()
    cfg.model = tiny_model_config(head_type="vl")
    cfg.criterion._name = mo.ITC
    cfg.common.bf16 = False
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 2
    trainer = JaxTrainer(cfg, JaxModel(cfg.model), JaxImageITC(cfg.criterion),
                         params=jax.tree.map(np.array, cases["vl"].params),
                         mesh=jax_mesh.make_mesh(1, 2, 2, devices=jax.devices()[:4]))
    return [trainer.train_step(b) for b in BATCHES]


def test_fsdp2_tp2_matches_jax_trainer(cases, jax_tp_trainer, tmp_path):
    layout = dict(dp=1, fsdp=2, tp=2)
    runs = run_ranks(4, mo.mw.run_jobs, [
        ("full_gradients", ([cases["vl"].on(layout)],)),
        ("train_steps", (cases["vl"].on(layout), BATCHES))], tmp_path=tmp_path, timeout=240)
    (grads,), steps = runs[0]
    _check(grads, cases["vl"])
    for rank in runs:
        for got, want in zip(rank[1]["metrics"], jax_tp_trainer, strict=True):
            for key in ("loss", "gnorm"):
                assert got[key] == pytest.approx(float(want[key]), rel=LOSS_TOL,
                                                 abs=LOSS_TOL), key


def _eval_feeds():
    rs = np.random.RandomState(3)
    n, c = 10, 4
    batches = []
    for start in (0, 6):
        b = min(6, n - start)
        batches.append({"id": np.arange(start, start + b),
                        "image_logits": rs.randn(b, 16).astype(np.float32),
                        "logits": rs.randn(b, c).astype(np.float32),
                        "target": rs.randint(0, c, b)})
    return {"text_ids": np.arange(n), "text_logits": rs.randn(n, 16).astype(np.float32),
            "batches": batches}


def test_dp2_tp2_counts_each_row_once(cases, tmp_path):
    """The ITC loss over 2 data ranks x 2 tp ranks is the global batch's,
    and the reducers merged over the data ranks equal one process's."""
    layout = dict(dp=2, tp=2)
    feeds = _eval_feeds()
    one = mo.mw.merge_eval(0, 1, cases["vl"].on({}), feeds)
    runs = run_ranks(4, mo.mw.run_jobs, [
        ("full_gradients", ([cases["vl"].on(layout)],)),
        ("merge_eval", (cases["vl"].on(layout), feeds))], tmp_path=tmp_path, timeout=240)
    _check(runs[0][0][0], cases["vl"])
    for rank in runs:
        assert rank[0][0]["loss"] == runs[0][0][0]["loss"]
        for key in ("recall", "accuracy"):
            got, want = rank[1][key], one[key]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k]), (key, k)


def test_layouts_that_do_not_split_raise():
    enc = tiny_model_config().encoder  # 4 heads, FFN 64, 2 layers
    port_mesh.check_split([enc], tp=2, pp=2)
    with pytest.raises(ValueError, match="attention heads"):
        port_mesh.check_split([enc], tp=8)
    enc.ffn_embed_dim = 66
    with pytest.raises(ValueError, match="FFN width"):
        port_mesh.check_split([enc], tp=4)
    with pytest.raises(ValueError, match="layers"):
        port_mesh.check_split([tiny_model_config().encoder], pp=4)


def test_vision_trunks_int8_and_sp_without_ring_are_refused():
    det = OnePeaceDetector(proposer="rpn", device="cpu", num_classes=4, image_size=64,
                           fpn_channels=16, embed_dim=32, ffn_embed_dim=64, heads=4, layers=2,
                           pretrain_bucket_size=4, window_size=2, global_period=2)
    video = VideoClassifier(tiny_model_config().encoder, num_classes=3, device="cpu")
    for trunk in (det, video):  # the video classifier holds an encoder_wrapper too
        with pytest.raises(NotImplementedError, match="detection, segmentation and video"):
            tensor_parallel.check_model(trunk)
        with pytest.raises(NotImplementedError, match="sequence-sharded layer stack"):
            tensor_parallel.check_sequence_parallel(trunk)
    model = OnePeaceRetrievalModel(tiny_model_config(head_type="vl"), device="cpu")
    tensor_parallel.check_model(model)
    for p in model.parameters():
        p.data.normal_()
    quantize_ffn_(model)
    with pytest.raises(NotImplementedError, match="int8"):
        tensor_parallel.check_model(model)
    # sp without the ring: a sequence-sharded layer stack is not ported
    with pytest.raises(NotImplementedError, match="sequence-sharded layer stack"):
        tensor_parallel.check_sequence_parallel(model)
    model.cfg.encoder.attn_impl = "ring"
    tensor_parallel.check_sequence_parallel(model)


def test_layer_norm_split_matches_whole(monkeypatch):
    """The distributed LayerNorm's forward and hand-written backward with
    its collectives made no-ops (one rank holding the whole axis) against
    autograd of the plain LayerNorm (both compute in fp32: 1e-5)."""
    from one_peace_tpu_torch.models.components import layer_norm

    rs = np.random.RandomState(0)
    x, w, b = (torch.tensor(rs.randn(*shape), dtype=torch.float64, requires_grad=True)
               for shape in ((3, 5, 8), (8,), (8,)))
    dy = torch.tensor(rs.randn(3, 5, 8), dtype=torch.float64)
    monkeypatch.setattr(tensor_parallel, "_all_reduce", lambda t, shard: t.clone())
    y = tensor_parallel._LayerNorm.apply(x, w, b, tensor_parallel.Shard(None, 0, 1), 1e-5)
    want = layer_norm(x, w, b)
    got = (y,) + torch.autograd.grad(y, (x, w, b), dy)
    for g, h in zip(got, (want,) + torch.autograd.grad(want, (x, w, b), dy)):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-5)


def test_slices_are_aligned_copies():
    """The kernels get 16-byte aligned copies of what they are handed at an
    unaligned start: ``flash_attention`` copies such a bias, a rank's heads
    of a shared bias (a contiguous view: 3 of 12 heads at L=5, ranks 1-3
    start at bytes 300, 600 and 900) or a layer's table."""
    from one_peace_tpu_torch.ops import flash_attention as fa

    bias = torch.randn(12, 5, 5)
    q, k, v = (torch.randn(2, 5, 3, 64) for _ in range(3))
    handed = []
    real = fa.FlashAttentionFunction.apply

    def spy(q3, k3, v3, rel_bias, *rest):
        handed.append(rel_bias)
        return real(q3, k3, v3, rel_bias, *rest)

    fa.FlashAttentionFunction.apply = spy
    try:
        for rank in range(4):
            part = tensor_parallel.chunk_of(bias, 0, rank, 4)
            assert torch.equal(part, bias[3 * rank:3 * rank + 3])
            assert bool(part.data_ptr() % 16) == (rank > 0)
            torch.testing.assert_close(fa.flash_attention(q, k, v, part, None, 0.125),
                                       fa.flash_attention(q, k, v, part.clone(), None, 0.125))
        tables = torch.randn(2, 3, 5, 5)  # layer 1's table starts at byte 300
        assert tables[1].data_ptr() % 16
        torch.testing.assert_close(fa.flash_attention(q, k, v, tables[1], None, 0.125),
                                   fa.flash_attention(q, k, v, tables[1].clone(), None, 0.125))
    finally:
        fa.FlashAttentionFunction.apply = real
    assert len(handed) == 10 and all(t.data_ptr() % 16 == 0 for t in handed)

