"""What each rank runs in the tests of data parallelism and FSDP
(``tests/test_torch_port_parallel*.py``), through ``torch_ranks.run_ranks``.
Nothing here imports JAX: the JAX oracles run in the parent."""

from __future__ import annotations

import numpy as np
import torch

from one_peace_tpu_torch.core.config import FrameworkConfig
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.parallel.data import slice_rows
from one_peace_tpu_torch.trainer import Trainer


def retrieval_cfg(update_freq=1, fp16=False, dp=-1, fsdp=1, **model_kw) -> FrameworkConfig:
    """The trainer test's settings (``test_torch_port_train._framework_cfg``)
    on the port's config: cosine warmup, weight decay 0.05, clip 1.0, layer
    decay 0.9, the tiny vl model."""
    from one_peace_tpu_torch.core.config import (AudioAdapterConfig, EncoderConfig,
                                                 ImageAdapterConfig, ModelConfig,
                                                 TextAdapterConfig)
    enc = EncoderConfig(
        embed_dim=32, ffn_embed_dim=64, layers=2, attention_heads=4,
        text_adapter=TextAdapterConfig(vocab_size=100, bucket_size=8),
        image_adapter=ImageAdapterConfig(bucket_size=2, rel_bucket_size=2),
        audio_adapter=AudioAdapterConfig(
            feature_encoder_spec=((16, 4, 2), (16, 2, 2)), feature_embed_dim=16,
            bucket_size=8, conv_pos_depth=2, conv_pos_width=6, conv_pos_groups=4))
    cfg = FrameworkConfig()
    cfg.model = ModelConfig(encoder=enc, head_type="vl")
    for k, v in model_kw.items():
        setattr(cfg.model.encoder, k, v)
    cfg.criterion._name = "image_text_retrieval_criterion"
    cfg.common.bf16 = False
    cfg.common.fp16 = fp16
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 2e-3
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.update_freq = update_freq
    cfg.optimization.max_update = 10
    cfg.lr_scheduler.warmup_updates = 2
    cfg.distributed.dp, cfg.distributed.fsdp = dp, fsdp
    return cfg


def retrieval_trainer(cfg, state, impl="xla"):
    from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel

    model = OnePeaceRetrievalModel(cfg.model, device="cpu")
    model.load_state_dict(state, strict=True)
    model.cfg.encoder.attn_impl = impl
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def _params(trainer):
    return trainer.state_dict()["params"]  # gathered: every rank takes part


def train_scenarios(rank, world, state, scenarios, dp, fsdp):
    """Each scenario (name, config overrides, global batches, poison, bundle
    to resume from) on a fresh trainer over the (dp, fsdp) mesh: the metrics
    of every step, the gathered parameters (rank 0), and for "plain" the
    bundle after 3 steps, the parameters then, and the loss of the fourth
    batch's step from the resumed bundle."""
    out = {}
    for name, kw, batches, poison, resume in scenarios:
        cfg = retrieval_cfg(dp=dp, fsdp=fsdp, **kw)
        trainer = retrieval_trainer(cfg, state)
        run = {"metrics": []}
        for i, batch in enumerate(batches):
            if name == "plain" and i == 3:
                bundle = trainer.state_dict()
                run["params_after"] = bundle["params"] if rank == 0 else None
                run["bundle"] = bundle if rank == 0 else None
            local = slice_rows(batch, rank, world)
            if poison == (i, rank):
                local = dict(local, src_images=np.full_like(local["src_images"], np.inf))
            m = trainer.train_step(local)
            if trainer.scaler is not None:
                m["scale_after"] = float(trainer.scaler.scale)
            run["metrics"].append(m)
        params = _params(trainer)
        run["params"] = params if rank == 0 else None
        if name == "plain":
            run["sharded"] = None
            if resume is not None:
                again = retrieval_trainer(cfg, state)
                again.load_state_dict(resume)
                run["resumed_loss"] = again.train_step(slice_rows(batches[3], rank, world))["loss"]
        out[name] = run
    out["sharded"] = sorted(n for n, p in trainer.model.named_parameters()
                            if hasattr(p, "to_local"))
    return out


def device_mesh_layout(rank, world):
    """The mesh of (dp 2, fsdp 2) over 4 ranks, the sub-groups of a (dp 2,
    tp 2) layout, and the refusal of a mismatch."""
    import torch.distributed as dist

    from one_peace_tpu_torch.core.config import DistributedConfig
    from one_peace_tpu_torch.parallel.mesh import make_layout, make_mesh

    mesh = make_mesh(2, 2, device_type="cpu")
    out = {"names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
           "fsdp_group": dist.get_process_group_ranks(mesh["fsdp"].get_group())}
    layout = make_layout(DistributedConfig(dp=2, tp=2), torch.device("cpu"))
    out["tp_layout"] = {axis: (layout.ranks[axis], layout.rank(axis))
                        for axis in ("data", "tp", "sp", "pp")}
    try:
        make_mesh(1, 2, device_type="cpu")
        out["mismatch_refused"] = False
    except ValueError:
        out["mismatch_refused"] = True
    return out


# ---------------------------------------------------------------------------
# the losses, the detection step, the reducers and the CLI
# ---------------------------------------------------------------------------


def losses_at_ranks(rank, world, arrays, label_smoothing, gallery_chunks):
    """ITC and DCL on this rank's rows inside ``batch_rows``: each loss
    weighted by the rank's share, and its gradients."""
    from one_peace_tpu_torch.criterions.losses import dcl_loss, itc_loss
    from one_peace_tpu_torch.parallel.data import Rows, batch_rows, split_sizes

    total = len(arrays["a"])
    rows = Rows(split_sizes(total, world), rank)
    cut = slice(rows.offset, rows.offset + rows.local)
    a, b, student, teacher = (torch.tensor(arrays[k][cut], requires_grad=True)
                              for k in ("a", "b", "student", "teacher"))
    scale = torch.tensor(arrays["scale"], requires_grad=True)
    with batch_rows(rows):
        itc, m = itc_loss(a, b, scale, label_smoothing)
        dcl = dcl_loss(student, teacher, torch.tensor(arrays["mask"][cut]),
                       torch.tensor(arrays["pad"][cut]), logit_scale=2.5,
                       label_smoothing=label_smoothing, gallery_chunks=gallery_chunks)
    itc_share, dcl_share = itc * rows.share, dcl * rows.share
    ga, gb, gs = torch.autograd.grad(itc_share, (a, b, scale))
    (gst,) = torch.autograd.grad(dcl_share, (student,))
    return {"itc": float(itc_share), "dcl": float(dcl_share), "a": ga.numpy(), "b": gb.numpy(),
            "scale": float(gs), "student": gst.numpy(),
            "ncorrect": int(m["a2b_ncorrect"])}


def detection_cfg():
    cfg = FrameworkConfig()
    cfg.model.encoder.layers = 2
    cfg.criterion._name = "detection_criterion"
    cfg.optimization.lr, cfg.optimization.clip_norm = 1e-3, 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.lr_scheduler.warmup_updates = 0
    cfg.common.bf16 = False
    return cfg


def detector(seed=0, **kw):
    from one_peace_tpu_torch.utils.random_weights import fill_random_
    from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

    geometry = dict(num_classes=4, image_size=64, fpn_channels=16, embed_dim=32,
                    ffn_embed_dim=64, heads=4, layers=2, pretrain_bucket_size=4, window_size=2,
                    global_period=2)
    det = OnePeaceDetector(proposer="rpn", device="cpu", **{**geometry, **kw})
    return fill_random_(det, torch.Generator().manual_seed(seed))


def detection_steps(rank, world, batches, fsdp, det_kw):
    """The detection step (rpn, the subsample sampler, proposal jitter and
    drop path on) over this rank's slice of each global batch."""
    cfg = detection_cfg()
    cfg.distributed.fsdp = fsdp
    trainer = Trainer(cfg, detector(**det_kw), build_criterion(cfg.criterion), total_updates=10)
    metrics = [trainer.train_step(slice_rows(b, rank, world)) for b in batches]
    params = trainer.state_dict()["params"]
    return {"metrics": metrics, "params": params if rank == 0 else None}


def merge_reducers(rank, world, feeds, num_shards):
    """Every reducer fed this rank's slice of each batch (``num_shards``
    ranks), or every batch whole (``num_shards`` 1, replicas); merged."""
    from one_peace_tpu_torch.metrics.metrics import (MAP, Accuracy, DetectionAP, IouAcc, MIoU,
                                                     Recall)

    def mine(batch):
        if num_shards == 1:
            return batch
        return slice_rows(batch, rank, world)

    out = {}
    recall = Recall()
    recall.num_shards = num_shards
    recall.initialize(feeds["text_ids"], [torch.tensor(feeds["text_logits"])])
    acc, k400, iou, mean_ap = Accuracy(), Accuracy(), IouAcc(), MAP()
    miou = MIoU(num_classes=5, ignore_index=255)
    det = DetectionAP(num_classes=3)
    for r in (acc, k400, iou, mean_ap, miou, det):
        r.num_shards = num_shards
    for r in (acc, k400, iou, mean_ap, miou, det):
        r.initialize()
    for batch in feeds["batches"]:
        local = mine(batch)
        n = len(local["id"])
        if not n:  # a ragged last batch leaves this rank no rows
            continue
        recall.compute(local["id"], torch.tensor(local["image_logits"]))
        acc.compute(torch.tensor(local["logits"]), local["target"])
        hits = (torch.tensor(local["probs"]).mean(1).argmax(-1) == torch.tensor(local["target"]))
        k400.compute(ncorrect=hits.sum(), count=n)  # K400's multi-view counts
        iou.compute(local["pred_boxes"], local["target_boxes"])
        mean_ap.compute(local["id"], torch.tensor(local["logits"]), local["multi_hot"])
        miou.compute(local["pred_map"], local["target_map"])
        for i in range(n):
            nd, ng = int(local["n_det"][i]), int(local["n_gt"][i])
            det.compute(local["det_boxes"][i][:nd], local["det_scores"][i][:nd],
                        local["det_labels"][i][:nd], local["gt_boxes"][i][:ng],
                        local["gt_labels"][i][:ng], det_masks=local["det_masks"][i][:nd],
                        gt_masks=local["gt_masks"][i][:ng])
    out["recall"] = recall.merge_results()
    out["accuracy"] = acc.merge_results()
    out["k400"] = k400.merge_results()
    out["iou_acc"] = iou.merge_results()
    out["map"] = mean_ap.merge_results()
    out["miou"] = miou.merge_results()
    out["detection_ap"] = det.merge_results()
    return out


def train_cli(rank, world, argv):
    """``cli.train.main`` in this rank (the group is open already)."""
    from one_peace_tpu_torch.cli import train

    return train.main(argv)
