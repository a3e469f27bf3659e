"""What each rank runs in the tests of model parallelism
(``tests/test_torch_port_{tensor_parallel,ring_attention,pipeline}.py``),
through ``torch_ranks.run_ranks``.  Nothing here imports JAX: the JAX
oracles run in the parent."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from one_peace_tpu_torch.core.config import FrameworkConfig
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.parallel.data import slice_rows
from one_peace_tpu_torch.parallel.mesh import data_rank_world
from one_peace_tpu_torch.trainer import Trainer

def model_cfg(head_type="vl", layers=2, heads=4, **enc_kw):
    """The tiny model of ``tests/helpers.tiny_model_config`` on the port's
    config, ``layers`` deep with ``heads`` heads."""
    from one_peace_tpu_torch.core.config import (AudioAdapterConfig, EncoderConfig,
                                                 ImageAdapterConfig, ModelConfig,
                                                 TextAdapterConfig)
    enc = EncoderConfig(
        embed_dim=32, ffn_embed_dim=64, layers=layers, attention_heads=heads,
        text_adapter=TextAdapterConfig(vocab_size=100, bucket_size=8),
        image_adapter=ImageAdapterConfig(bucket_size=2, rel_bucket_size=2),
        audio_adapter=AudioAdapterConfig(
            feature_encoder_spec=((16, 4, 2), (16, 2, 2)), feature_embed_dim=16,
            bucket_size=8, conv_pos_depth=2, conv_pos_width=6, conv_pos_groups=4))
    for k, v in enc_kw.items():
        setattr(enc, k, v)
    return ModelConfig(encoder=enc, head_type=head_type)


def pretrain_model_cfg():
    """``tests/test_torch_port_pretrain_model.pretrain_config()`` (vl) on the
    port's config: the tiny encoder and a 2-layer decoder 16 wide, 2 heads."""
    from one_peace_tpu_torch.core.config import decoder_default_config

    cfg = model_cfg()
    cfg._name = "one_peace_pretrain"
    enc = cfg.encoder
    enc.use_audio_moe, enc.use_image_moe = False, True
    enc.audio_adapter.feature_encoder_spec = ((16, 4, 2), (16, 2, 2))
    dec = decoder_default_config()
    dec.embed_dim, dec.ffn_embed_dim, dec.layers, dec.attention_heads = 16, 32, 2, 2
    dec.use_audio_moe, dec.use_image_moe = False, True
    dec.text_adapter.vocab_size = enc.text_adapter.vocab_size
    cfg.decoder = dec
    return cfg


def framework_cfg(mcfg, criterion: str, layout: dict):
    """fp32, the retrieval trainer test's optimizer settings, and ``layout``'s
    entries (``dp``, ``fsdp``, ``tp``, ``pp``, ``sp``, ``pp_micro_batches``)
    in the ``distributed`` section."""
    cfg = FrameworkConfig()
    cfg.model = mcfg
    cfg.criterion._name = criterion
    cfg.common.bf16 = False
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 2
    for k, v in layout.items():
        setattr(cfg.distributed, k, v)
    return cfg


def build_trainer(case):
    """A fresh ``Trainer`` for ``case`` (a dict: ``model`` the port's
    ``ModelConfig``, ``kind`` retrieval, classify or pretrain, ``criterion``,
    ``state``, ``impl``, ``layout``, optional ``checkpoint``)."""
    from one_peace_tpu_torch.models.classify import OnePeaceClassifyModel
    from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
    from one_peace_tpu_torch.models.pretrain import OnePeacePretrainModel

    mcfg = case["model"]
    mcfg.encoder.checkpoint_activations = case.get("checkpoint", False)
    kind = case.get("kind", "retrieval")
    if kind == "classify":
        model = OnePeaceClassifyModel(mcfg, num_classes=case["num_classes"], device="cpu",
                                      **case.get("head", {}))
    elif kind == "pretrain":
        model = OnePeacePretrainModel(mcfg, device="cpu")
    else:
        model = OnePeaceRetrievalModel(mcfg, device="cpu")
    wanted = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in case["state"].items() if k in wanted}, strict=True)
    model.cfg.encoder.attn_impl = case.get("impl", "xla")
    if kind == "pretrain":
        model.cfg.decoder.attn_impl = case.get("impl", "xla")
    cfg = framework_cfg(mcfg, case["criterion"], case["layout"])
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def run_jobs(rank, world, jobs):
    """Each (function name, args) of ``jobs`` in turn: one spawn of ranks
    for every case of a layout."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


class RingCount:
    """Counts the calls of ``ring_attention`` by the sequence length they
    cover (their chunk's times ``sp``)."""

    def __enter__(self):
        from one_peace_tpu_torch.ops import ring_attention as ra

        self.module, self.inner, self.lengths = ra, ra.ring_attention, {}

        def counted(q, *args, **kw):
            length = q.shape[1] * args[5].size
            self.lengths[length] = self.lengths.get(length, 0) + 1
            return self.inner(q, *args, **kw)

        ra.ring_attention = counted
        return self

    def __exit__(self, *exc):
        self.module.ring_attention = self.inner


def full_gradients(rank, world, cases):
    """For each case: this data rank's slice of the global batch through
    ``Trainer.gradients``; the loss and every gradient gathered to full
    (rank 0), and each rank's loss."""
    out = []
    for case in cases:
        trainer = build_trainer(case)
        drank, dranks = data_rank_world()
        gen = torch.Generator().manual_seed(case["seed"]) if "seed" in case else None
        with RingCount() as ring:
            metrics, grads = trainer.gradients(slice_rows(case["batch"], drank, dranks), gen)
        full = trainer._gathered(zip(trainer._names, grads))
        out.append({"loss": float(metrics["loss"]),
                    "grads": {k: v.numpy() for k, v in full.items()} if rank == 0 else None,
                    "local_names": sorted(n for n, _ in trainer.model.named_parameters()),
                    "ring_lengths": ring.lengths})
    return out


def train_steps(rank, world, case, batches, valid=None):
    """``len(batches)`` train steps on this data rank's slices: every step's
    metrics, then ``valid_step``'s on ``valid`` (if given), then the bundle
    (rank 0)."""
    trainer = build_trainer(case)
    drank, dranks = data_rank_world()
    metrics = [trainer.train_step(slice_rows(b, drank, dranks)) for b in batches]
    scores = (None if valid is None
              else trainer.valid_step(slice_rows(valid, drank, dranks), fetch=True))
    bundle = trainer.state_dict()
    return {"metrics": metrics, "valid": scores, "bundle": bundle if rank == 0 else None}


def merge_eval(rank, world, case, feeds):
    """The recall and accuracy reducers fed this data rank's slice of each
    batch (``num_shards`` the data ranks), merged: a ``tp`` replica of a
    data rank is not counted twice."""
    from one_peace_tpu_torch.metrics.metrics import Accuracy, Recall

    build_trainer(case)  # opens the layout
    drank, dranks = data_rank_world()
    recall, acc = Recall(), Accuracy()
    recall.num_shards = acc.num_shards = dranks
    recall.initialize(feeds["text_ids"], [torch.tensor(feeds["text_logits"])])
    acc.initialize()
    for batch in feeds["batches"]:
        local = slice_rows(batch, drank, dranks)
        recall.compute(local["id"], torch.tensor(local["image_logits"]))
        acc.compute(torch.tensor(local["logits"]), local["target"])
    return {"recall": recall.merge_results(), "accuracy": acc.merge_results()}


# ---------------------------------------------------------------------------
# ring attention and the pipeline alone
# ---------------------------------------------------------------------------


def _groups(world, size):
    """Every rank opens the groups of ``size`` consecutive ranks; returns
    (this rank's group, its ranks, this rank's index in it)."""
    mine = None
    for start in range(0, world, size):
        ranks = list(range(start, start + size))
        group = dist.new_group(ranks) if size < world else dist.group.WORLD
        if dist.get_rank() in ranks:
            mine = (group, ranks, ranks.index(dist.get_rank()))
    return mine


def ring_cases(rank, world, cases):
    """``ring_attention`` on this rank's chunk of each case (sp = the
    case's size, over consecutive ranks): the output chunk and the
    gradients of q/k/v (chunks) and of the bias (whole), with a seeded
    output gradient."""
    from one_peace_tpu_torch.ops.ring_attention import ring_attention
    from one_peace_tpu_torch.parallel.tensor_parallel import Shard, chunk_of

    out = []
    groups = {}
    for case in cases:
        sp = case["sp"]
        if sp not in groups:
            groups[sp] = _groups(world, sp)
        group, ranks, me = groups[sp]
        q, k, v = (torch.tensor(case[n]) for n in ("q", "k", "v"))
        chunks = [chunk_of(t, 1, me, sp).requires_grad_() for t in (q, k, v)]
        bias = None if case["bias"] is None else torch.tensor(case["bias"], requires_grad=True)
        pad = None if case["pad"] is None else torch.tensor(case["pad"])
        o = ring_attention(*chunks, bias, pad, case["scaling"], Shard(group, me, sp), ranks)
        do = chunk_of(torch.tensor(case["do"]), 1, me, sp)
        wrt = chunks + ([bias] if bias is not None else [])
        grads = torch.autograd.grad(o, wrt, do)
        out.append({"out": o.detach().numpy(), "dq": grads[0].numpy(), "dk": grads[1].numpy(),
                    "dv": grads[2].numpy(),
                    "dbias": grads[3].numpy() if bias is not None else None})
    return out


def pipeline_cases(rank, world, cases):
    """``pipeline_forward`` of a tanh layer stack (the JAX pipeline test's
    body) over the world as the ``pp`` group: the output and the gradients
    of x and of every layer's (w, b) under sum(out ** 2), gathered (rank
    0)."""
    from one_peace_tpu_torch.parallel.pipeline import pipeline_forward
    from one_peace_tpu_torch.parallel.tensor_parallel import Shard

    out = []
    shard = Shard(dist.group.WORLD, rank, world)
    for case in cases:
        w, b = torch.tensor(case["w"]), torch.tensor(case["b"])
        per = len(w) // world
        mine = range(rank * per, (rank + 1) * per)
        params = [t.clone().requires_grad_() for i in mine for t in (w[i], b[i])]
        x = torch.tensor(case["x"], requires_grad=True)
        aux = None if case["aux"] is None else torch.tensor(case["aux"])

        def stage(m, h, batch_aux, bcast, flat):
            for j in range(per):
                h = torch.tanh(h @ flat[2 * j] + flat[2 * j + 1])
                if batch_aux[0] is not None:
                    h = h * batch_aux[0]
            return h

        y = pipeline_forward(stage, params, x, shard, list(range(world)), case["micro"],
                             batch_aux=(aux,), checkpoint_stages=case["checkpoint"])
        gx, *gp = torch.autograd.grad((y ** 2).sum(), [x] + params)
        dx = gx.clone()
        dist.all_reduce(dx)  # stage 0 holds the input's gradient
        parts = [None] * world
        dist.all_gather_object(parts, [g.numpy() for g in gp])
        flat = [g for part in parts for g in part]
        out.append({"out": y.detach().numpy(), "dx": dx.numpy(),
                    "dw": np.stack(flat[0::2]), "db": np.stack(flat[1::2])})
    return out
