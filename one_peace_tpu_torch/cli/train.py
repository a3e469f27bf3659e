"""Training entry point (counterpart of ``one_peace_tpu/cli/train.py``).

Config layering (defaults <- YAML <- CLI dot-overrides), task, model and
criterion construction, the epoch loop with validation and saves, the
best export, and preemption-safe resume, on one card.

  python -m one_peace_tpu_torch.cli.train --config recipes/image_text_retrieval/base.yaml \\
      task.data=train.tsv task.valid_data=valid.tsv task.valid_file=valid.json \\
      task.bpe_dir=bpe [checkpoint.restore_file=one-peace.pt] [--device cuda]

  python -m one_peace_tpu_torch.cli.train \\
      --config recipes/detection/cascade_mask_rcnn_1024.yaml \\
      task.data=instances_train2017.json task.image_dir=train2017 \\
      task.valid_data=instances_val2017.json task.valid_image_dir=val2017 \\
      [checkpoint.restore_file=one-peace.pt] [--device cuda]

  python -m one_peace_tpu_torch.cli.train \
      --config recipes/segmentation/mask2former_896.yaml \
      task.data=ade/images/training:ade/annotations/training \
      task.valid_data=ade/images/validation:ade/annotations/validation \
      [checkpoint.restore_file=one-peace.pt] [--device cuda]

  python -m one_peace_tpu_torch.cli.train --config recipes/video/k400_32frames.yaml \
      task.data=train_list_rawframes.txt task.image_dir=rawframes_train \
      task.valid_data=val_list_rawframes.txt task.valid_image_dir=rawframes_val \
      [checkpoint.restore_file=one-peace.pt] [--device cuda]

  python -m one_peace_tpu_torch.cli.train --config recipes/vqa/base.yaml \
      task.data=train.tsv task.valid_data=valid.tsv task.bpe_dir=bpe \
      task.num_classes=3129 [checkpoint.restore_file=one-peace.pt] [--device cuda]

  python -m one_peace_tpu_torch.cli.train --config recipes/fsd50k/base.yaml \
      task.data=train.tsv task.valid_data=valid.tsv task.bpe_dir=bpe \
      task.num_classes=200 [checkpoint.restore_file=one-peace.pt] [--device cuda]

  (``recipes/nlvr2/base.yaml``, ``recipes/visual_grounding/base.yaml`` and
  ``recipes/aqa/base.yaml`` take the data overrides alone.)

  python -m one_peace_tpu_torch.cli.train --config recipes/pretrain/pretrain_al_4b.yaml \
      task.data=train.tsv task.valid_data=valid.tsv task.valid_file=valid.json \
      task.bpe_dir=bpe checkpoint.restore_file=stage1/checkpoint_best.npz [--device cuda]

  torchrun --nproc_per_node 8 -m one_peace_tpu_torch.cli.train \
      --config recipes/detection/cascade_mask_rcnn_1024.yaml task.data=... [--device cuda]

- **Weights.** For the retrieval and classify models,
  ``checkpoint.restore_file`` is a fairseq ``.pt`` (converted by
  ``utils/checkpoint_convert``: ``convert_retrieval_model`` or
  ``convert_classify_model``) or a flat ``.npz`` (``load_params`` ->
  ``params_from_jax``); without one, ``init_weights_`` draws them from
  ``common.seed``.  The classify model is built with the task's head
  (``task.head_kwargs()``: ``task.num_classes`` outputs, NLVR2's
  two-image head with 2 classes, RefCOCO's 4 box coordinates, AQA's one
  score per choice) and otherwise the head's defaults (CLS pooling, no
  pooler), as the JAX CLI builds it from ``task.num_classes``; a
  checkpoint whose ``classify_head`` differs from that head raises,
  naming the entry (``models.classify.check_head``); a ``.pt`` without one
  (a pretrained checkpoint) gives the encoder over a fresh head.  The
  pretrain model (``one_peace_pretrain``) restores a ``.npz`` export only;
  with ``model.stage2_pretrain`` or ``model.reset_logit_scale`` it is
  overlaid onto the config's init by
  ``upgrade_stage1_params`` (stage 2 from a stage-1 export: the audio
  branch fresh, ``logit_scale`` reset), as the JAX CLI does.  For a vision
  task's model (the detector of ``coco_detection``, the segmenter of
  ``ade20k_seg``, the video classifier of ``k400_video``), a ``.pt`` gives
  the trunk (``load_pretrained``) and ``init_detector_`` /
  ``init_segmenter_`` / ``init_video_classifier_`` the rest from
  ``common.seed``; a ``.npz`` gives every weight (``params_from_jax``,
  strict); without one, the init gives them all.  The video classifier
  trains only what its ``trainable_mask`` marks (the adapters, the temporal
  embedding, the rel-pos table, the norm and the head): the trunk is frozen.  Every model of
  the JAX package is ported (``one_peace_retrieval``,
  ``one_peace_classify``, ``one_peace_pretrain`` and the tasks' own), and
  models a ``--user-dir`` plugin registers.
- **Processes.** Under ``torchrun`` (``--nproc_per_node N``) each process
  drives one card (``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``)
  and the recipe's ``distributed`` section is the mesh: ``dp`` x ``fsdp``
  must be the number of processes (``dp: -1`` takes what ``fsdp`` leaves),
  and the trainer shards the parameters over ``fsdp`` with FSDP2
  (``parallel/``).  ``tp``, ``pp`` and ``sp`` above 1 are refused.  Without
  ``torchrun`` one process runs, and a recipe that sets ``fsdp: 8`` (the
  detection, segmentation, pretraining, K400 and 4B fine-tuning recipes)
  raises unless it is given ``distributed.fsdp=1``.  Rank 0 alone logs,
  saves bundles and exports; every rank takes part in the gathers that a
  save and an export need.
- **Batches.** ``dataset.batch_size`` samples are the global batch of a
  micro-step, as in the JAX package: every rank builds it and keeps its
  contiguous slice (``data.iterators.RankSliceIterator``), so that the
  augmentation draws are those of one process.  The batch keys that are evaluation bookkeeping
  (``HOST_KEYS``: ids, counts, the detection GT's crowd flags, areas and
  resize factors) stay on the host; the criterion does not read them.
- **Saves.** ``step_<n>/`` train-state bundles every
  ``checkpoint.save_interval_updates`` updates and every
  ``checkpoint.save_interval`` epochs, the newest ``keep_last_epochs``
  kept; ``checkpoint_best.npz`` (the JAX package's ``.npz`` layout) when
  ``best_checkpoint_metric`` improves, and the k best exports.
- **Resume.** Unless ``checkpoint.reset_optimizer``, the newest bundle in
  ``save_dir`` restores the trainer (masters, optimizer state, an
  accumulation in progress, counters, generator, the fp16 loss scale and
  the EMA shadow), the iterator's epoch and offset, the best
  metric and the update's logging window.  A dataset that draws its
  augmentation from one generator in fetch order (COCO's LSJ) is not
  rewound: a resumed run draws other crops than the straight run did, as in
  the JAX CLI.
- **Validation** runs on the trainer's compute-dtype copies of the masters
  (``Trainer.eval_params``) through ``functional_call``: no second model;
  under FSDP each rank gathers the parameters for the pass and scores its
  slice of each batch, and the task's reducer merges the ranks' parts;
  with ``ema.store_ema``, on copies of the EMA shadow instead, unless the
  task's ``uses_ema`` (default ``ema.ema_eval``) says otherwise.  The best
  export is the tree that validation scored, in the JAX package's layout
  (``utils.checkpoint.model_to_jax``), so the JAX CLIs read it.
- **Logging** follows the JAX CLI's tags: ``train_inner`` per update,
  ``train`` per epoch, ``valid`` per validation.  Under ``update_freq > 1``
  ``train_inner`` logs the mean of the update's micro-batch metrics weighted
  by their sample counts; the JAX CLI logs the last micro-batch's only.
- **Profiling**: updates ``[common.profile_start, common.profile_stop)``
  under ``torch.profiler``, written as a Chrome trace to
  ``common.profile_dir``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

logger = logging.getLogger("one_peace_tpu_torch.train")

# batch bookkeeping the model does not read
HOST_KEYS = ("id", "nsentences", "ntokens", "gt_crowd", "gt_areas", "im_scale")


def build_model_for_task(cfg, task, device="cuda"):
    """The task's model on ``device``, fp32 masters, weights not set."""
    from ..core.registry import MODELS
    from ..models.classify import OnePeaceClassifyModel
    from ..models.one_peace import OnePeaceRetrievalModel
    from ..models.pretrain import OnePeacePretrainModel

    if hasattr(task, "build_model"):
        return task.build_model(cfg, device=device)
    name = cfg.model._name
    cfg.model.encoder.image_adapter.rel_bucket_size = cfg.task.patch_image_size // 16
    cfg.model.encoder.text_adapter.vocab_size = len(task.dictionary)
    cfg.model.head_type = cfg.task.head_type
    if name == "one_peace_classify":
        return OnePeaceClassifyModel(cfg.model, **task.head_kwargs(), device=device,
                                     dtype=torch.float32)
    if name == "one_peace_pretrain":
        # the decoder's text embedding keeps the config's vocabulary, as in
        # the JAX CLI, so that the two packages' trees exchange weights
        return OnePeacePretrainModel(cfg.model, device=device, dtype=torch.float32)
    if name in MODELS:  # a --user-dir plugin's
        return MODELS.get(name)(cfg.model, device=device)
    if name != "one_peace_retrieval":
        raise NotImplementedError(f"model {name!r}: no such model in the JAX package either")
    return OnePeaceRetrievalModel(cfg.model, device=device, dtype=torch.float32)


def load_weights(cfg, model, device, path: Optional[str] = None) -> None:
    """``path`` (by default ``checkpoint.restore_file``) into ``model`` (the
    branches its head uses), or the config's init from ``common.seed`` when
    there is none.  A vision task's model (one with ``load_pretrained``)
    takes a ``.pt`` as its trunk over the rest of its init
    (``init_detector_``'s pyramid and heads, ``init_segmenter_``'s priors,
    interactions and head, ``init_video_classifier_``'s adapters, norm and
    head); the classify model takes a pretrained ``.pt``
    (one without a ``classify_head``) as its encoder over the config's init
    of the head."""
    from ..models.classify import OnePeaceClassifyModel, check_head
    from ..utils.checkpoint import params_from_jax
    from ..utils.checkpoint_convert import (convert_classify_model, convert_retrieval_model,
                                            load_torch_state_dict)
    from ..utils.native_checkpoint import load_params
    from ..utils.random_weights import (init_detector_, init_segmenter_,
                                        init_video_classifier_, init_weights_)
    from ..vision.zoo import OnePeaceSegmenter, OnePeaceVideoClassifier

    path = path or cfg.checkpoint.restore_file
    vision = hasattr(model, "load_pretrained")
    init_vision_ = (init_segmenter_ if isinstance(model, OnePeaceSegmenter)
                    else init_video_classifier_ if isinstance(model, OnePeaceVideoClassifier)
                    else init_detector_)
    generator = torch.Generator(device=device).manual_seed(cfg.common.seed)
    if not (path and os.path.exists(path)):
        if vision:
            init_vision_(model, generator)
        else:
            init_weights_(model, generator, cfg.model.encoder.layer_scale_init_value)
        return
    if path.endswith(".pt") and vision:
        init_vision_(model, generator)
        model.load_pretrained(path)
        return
    if hasattr(model, "upgrade_stage1_params"):  # the pretrain model
        if path.endswith(".pt"):
            raise NotImplementedError("the pretrain model restores from a .npz export; the "
                                      "JAX package has no .pt conversion for it either")
        tree = load_params(path)
        if cfg.model.stage2_pretrain or cfg.model.reset_logit_scale:
            init_weights_(model, generator, cfg.model.encoder.layer_scale_init_value)
            state = model.upgrade_stage1_params(tree)
        else:
            state = params_from_jax(tree)
        model.load_state_dict(state, strict=True)
        return
    if path.endswith(".pt"):
        convert = (convert_classify_model if cfg.model._name == "one_peace_classify"
                   else convert_retrieval_model)
        state = convert(load_torch_state_dict(path), cfg.model)
    else:
        state = params_from_jax(load_params(path))
    if isinstance(model, OnePeaceClassifyModel):
        check_head(state, model)
    if not vision:
        wanted = model.state_dict().keys()
        state = {k: v for k, v in state.items() if k in wanted}
        head = {k for k in wanted if k.startswith("classify_head.")}
        if head and not head & state.keys():  # a pretrained encoder: a fresh head
            init_weights_(model, generator, cfg.model.encoder.layer_scale_init_value)
            state = {**{k: v for k, v in model.state_dict().items() if k in head}, **state}
    model.load_state_dict(state, strict=True)


class UpdateWindow:
    """The micro-batch metrics of the update in progress, for its
    ``train_inner`` line: their mean weighted by each micro-batch's sample
    count.  Saved in the train-state bundle, so an update that straddles a
    resume logs what the uninterrupted run logs."""

    def __init__(self):
        self.items: List[Tuple[float, Dict[str, float]]] = []

    def add(self, metrics: Dict[str, float], weight: float) -> None:
        self.items.append((float(weight), dict(metrics)))

    def clear(self) -> None:
        self.items = []

    def mean(self) -> Dict[str, float]:
        if len(self.items) == 1:
            return dict(self.items[0][1])
        total = sum(w for w, _ in self.items)
        return {k: sum(w * m[k] for w, m in self.items) / total for k in self.items[0][1]}

    def state_dict(self) -> list:
        return [[w, dict(m)] for w, m in self.items]

    def load_state_dict(self, state: list) -> None:
        self.items = [(float(w), dict(m)) for w, m in state]


class Profiler:
    """``torch.profiler`` over the updates in ``[start, stop)``."""

    def __init__(self, common):
        self.dir, self.start, self.stop = (common.profile_dir, common.profile_start,
                                           common.profile_stop)
        self.prof = None
        self.first = None

    def step(self, step: int) -> None:
        if not self.dir:
            return
        # window membership, not equality: a resume can land inside it
        in_window = self.start <= step < self.stop
        if in_window and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof, self.first = profile(activities=acts), step
            self.prof.start()
        elif self.prof is not None and not in_window:
            self.close(step)

    def close(self, step: int) -> None:
        if self.prof is None:
            return
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(
            os.path.join(self.dir, f"trace_updates_{self.first}-{step}.json"))
        self.prof = None


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--user-dir", default=None,
                        help="plugin module dir with extra @register'd tasks/models")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    parser.add_argument("--dist-timeout", type=float, default=1800.0,
                        help="seconds a collective may wait before it raises")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.user_dir:
        from ..core.registry import load_user_module

        load_user_module(args.user_dir)

    from ..core.config import load_config
    from ..core.metrics import ProgressLogger, aggregate, build_sinks, log_scalar
    from ..criterions import build_criterion
    from ..parallel.mesh import (close_distributed, init_distributed, local_device,
                                 mesh_shape)
    from ..tasks import build_task
    from ..trainer import Trainer
    from ..utils import native_checkpoint as ckpt

    cfg = load_config(args.config, args.overrides)
    rank, world = init_distributed(args.device, args.dist_timeout)
    d = cfg.distributed
    mesh_shape(d.dp, d.fsdp, d.tp, d.pp, d.sp, world)  # a layout that does not fit raises
    main_rank = rank == 0
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING)
    device = local_device(args.device)

    task = build_task(cfg.task, cfg)
    if not cfg.criterion._name:
        cfg.criterion._name = type(task).criterion_name
    criterion = build_criterion(cfg.criterion)  # before any data: an unported one raises
    task.load_dataset("train")
    if cfg.task.valid_data:
        task.load_dataset("valid")
    model = build_model_for_task(cfg, task, device)
    load_weights(cfg, model, device)
    trainer = Trainer(cfg, model, criterion)

    if main_rank:
        progress = ProgressLogger(cfg.common.log_format, cfg.common.log_interval,
                                  cfg.common.tensorboard_logdir, sinks=build_sinks(cfg.common))
        inner_progress = ProgressLogger(cfg.common.log_format, cfg.common.log_interval,
                                        tag="train_inner", sinks=progress.sinks)
        valid_progress = ProgressLogger(cfg.common.log_format, cfg.common.log_interval,
                                        tag="valid", sinks=progress.sinks)
    else:
        progress = inner_progress = valid_progress = _Silent()
    itr = task.get_batch_iterator(
        "train", cfg.dataset.batch_size, seed=cfg.common.seed,
        shard_id=rank, num_shards=world,
        ensure_equal_batch=cfg.dataset.ensure_equal_batch,
        skip_remainder_batch=cfg.optimization.skip_remainder_batch)
    best = {"value": None}
    window = UpdateWindow()

    def full_state():
        """Everything an exact resume needs: the trainer's host copy, the
        iterator's position, the best metric and the logging window."""
        return {
            "trainer": trainer.state_dict(),
            "iterator": itr.state_dict(),
            "best_metric": float("nan") if best["value"] is None else float(best["value"]),
            "window": window.state_dict(),
        }

    latest = ckpt.latest_checkpoint(cfg.checkpoint.save_dir)
    if latest and not cfg.checkpoint.reset_optimizer:
        logger.info("resuming from %s", latest)
        state = ckpt.restore_train_state(latest)
        trainer.load_state_dict(state["trainer"])
        itr.load_state_dict(state["iterator"])
        value = float(state["best_metric"])
        best["value"] = None if value != value else value
        window.load_state_dict(state["window"])
        del state

    def save(step):
        with record_function("checkpoint_save"):
            state = full_state()  # every rank gathers
            if main_rank:
                ckpt.save_train_state(cfg.checkpoint.save_dir, step, state,
                                      keep=cfg.checkpoint.keep_last_epochs)

    max_update = cfg.optimization.max_update or int(1e9)
    max_epoch = cfg.optimization.max_epoch or int(1e9)
    profiler = Profiler(cfg.common) if main_rank else _Silent()
    last_val_step = -1
    last_save_step = -1

    def run_validation():
        nonlocal last_val_step
        with record_function("validate"):
            stats = validate(cfg, task, model, trainer, valid_progress)
        _maybe_save_best(cfg, task, trainer, stats, best, main_rank)
        last_val_step = trainer.step

    while trainer.step < max_update and itr.epoch <= max_epoch:
        epoch = itr.epoch
        with aggregate(new_root=True) as agg:
            for batch in itr.next_epoch_itr():
                profiler.step(trainer.step)
                prev_step = trainer.step
                metrics = trainer.train_step({k: v for k, v in batch.items()
                                              if k not in HOST_KEYS})
                for k, v in metrics.items():
                    log_scalar(k, v)
                window.add(metrics, batch["nsentences"])
                # one train_inner line per optimizer update
                if trainer.step != prev_step:
                    inner_progress.log(window.mean(), trainer.step)
                    window.clear()
                # interval actions fire once per optimizer update
                if (trainer.step > 0 and trainer.step != last_val_step
                        and _should_validate(cfg, task, trainer.step, epoch,
                                             end_of_epoch=False)):
                    # before the interval save, so the bundle holds the new best
                    run_validation()
                if (cfg.checkpoint.save_interval_updates
                        and trainer.step > 0
                        and trainer.step != last_save_step
                        and trainer.step % cfg.checkpoint.save_interval_updates == 0):
                    save(trainer.step)
                    last_save_step = trainer.step
                if trainer.step >= max_update:
                    break
            progress.print(agg.as_dict(), trainer.step)

        if (_should_validate(cfg, task, trainer.step, epoch, end_of_epoch=True)
                and trainer.step != last_val_step):
            run_validation()
        if epoch % cfg.checkpoint.save_interval == 0:
            save(trainer.step)
    profiler.close(trainer.step)
    ckpt.wait_for_saves()
    progress.close()
    close_distributed()
    return 0


class _Silent:
    """The loggers and profiler of a rank other than 0: they do nothing."""

    sinks = ()

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _should_validate(cfg, task, step: int, epoch: int, end_of_epoch: bool) -> bool:
    """ref train.py:345-358 do_validate: epoch-interval at epoch ends,
    every ``validate_interval_updates`` updates mid-epoch, and alongside
    mid-epoch interval saves; all gated on validate_after_updates."""
    ds = cfg.dataset
    if not cfg.task.valid_data or ds.disable_validation:
        return False
    if step < ds.validate_after_updates:
        return False
    if end_of_epoch:
        return epoch % ds.validate_interval == 0
    if (cfg.checkpoint.save_interval_updates
            and step % cfg.checkpoint.save_interval_updates == 0):
        return True
    return bool(ds.validate_interval_updates
                and step % ds.validate_interval_updates == 0)


def _eval_params_source(cfg, task, trainer):
    """What validation scores and the best export writes: the EMA shadow
    when one is kept and the task consumes it (the JAX CLI's rule: the
    task's ``uses_ema``, by default ``ema.ema_eval``), else None for the
    masters."""
    if trainer.ema is not None and getattr(task, "uses_ema", cfg.ema.ema_eval):
        return trainer.ema.shadow
    return None


def _maybe_save_best(cfg, task, trainer, stats, best, main_rank: bool = True) -> None:
    """Track ``best_checkpoint_metric``; export the tree that validation
    scored (the masters or the EMA shadow) as ``checkpoint_best.npz`` when
    it improves, and keep the k best exports (ref checkpoint_utils.py save
    policy).  Every rank gathers the tree; rank 0 writes it."""
    from ..utils import native_checkpoint as ckpt
    from ..utils.checkpoint import model_to_jax

    key = cfg.checkpoint.best_checkpoint_metric
    if not key or not stats or key not in stats:
        return
    value = stats[key]
    better = (best["value"] is None or
              (value > best["value"] if cfg.checkpoint.maximize_best_checkpoint_metric
               else value < best["value"]))
    keep_k = cfg.checkpoint.keep_best_checkpoints > 0
    if not (better or keep_k):
        return
    export = model_to_jax(trainer.model,
                          trainer.full_params(_eval_params_source(cfg, task, trainer)))
    if better:
        best["value"] = value
        path = os.path.join(cfg.checkpoint.save_dir, "checkpoint_best.npz")
        if main_rank:
            ckpt.save_params(path, export, metadata={key: float(value), "step": trainer.step})
            logger.info("new best %s=%.4f -> %s", key, value, path)
    if keep_k and main_rank:
        kpath = ckpt.save_best_k(
            cfg.checkpoint.save_dir, key, float(value),
            cfg.checkpoint.maximize_best_checkpoint_metric,
            cfg.checkpoint.keep_best_checkpoints, export, trainer.step)
        if kpath:
            logger.info("k-best export %s=%.4f -> %s", key, value, kpath)


def validate(cfg, task, model, trainer, progress) -> Dict[str, float]:
    """One pass over the valid split on the trainer's compute-dtype copies
    of the masters, or of the EMA shadow (``_eval_params_source``); prints
    and returns the task's numeric stats.  Across data ranks each scores
    its slice of every batch (none of a ragged last batch, maybe) and the
    reducer merges the parts."""
    from ..data.iterators import batch_rows_of
    from ..metrics.metrics import fetch_once
    from ..parallel.mesh import data_rank_world

    rank, world = data_rank_world()

    fetches_before = fetch_once.calls
    with trainer.eval_params(_eval_params_source(cfg, task, trainer)) as params:
        task.begin_valid_epoch(model, params)
        itr = task.get_batch_iterator("valid", cfg.dataset.batch_size_valid,
                                      shard_id=rank, num_shards=world,
                                      ensure_equal_batch=False)
        for batch in itr.next_epoch_itr():
            if batch_rows_of(batch):
                task.valid_step(model, params, batch)
        stats = task.merge_results()
        del params
    stats = {k: v for k, v in stats.items() if isinstance(v, (int, float))}
    # the whole pass fetches to the host once (Recall.merge_results)
    stats["eval_batched_fetches"] = fetch_once.calls - fetches_before
    progress.print(stats, trainer.step)
    return stats


if __name__ == "__main__":
    sys.exit(main())
