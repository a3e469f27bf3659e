"""Evaluation entry point (counterpart of ``one_peace_tpu/cli/evaluate.py``).

Loads a checkpoint (a fairseq ``.pt`` or a flat ``.npz``, such as the
training CLI's ``checkpoint_best.npz``), runs the task's evaluation loop on
``--device`` and prints its metrics as JSON.

  python -m one_peace_tpu_torch.cli.evaluate --config eval.yaml \\
      --path /path/to/ckpt.(pt|npz) [--output metrics.json] [--device cuda] \\
      [task.<k>=v ...]

- The retrieval and classification tasks load through
  ``hub.from_pretrained``; a classify model gets the task's head
  (``task.head_kwargs()``, as ``cli/train.py`` builds it).
  ``image_classify``, ``vggsound``, ``nlvr2`` and ``aqa`` print top-1
  accuracy, ``vqa`` the soft score of the argmax answer
  (``metrics.Accuracy``), ``refcoco`` ``acc@0.5`` (``metrics.IouAcc``) and
  ``fsd50k`` ``map`` (``metrics.MAP``), each with ``count``.
- ``coco_detection`` builds the detector with ``task.build_model`` on
  ``--device``; a ``.npz`` gives every weight (``params_from_jax``), a
  ``.pt`` the trunk (``load_pretrained``) over the pyramid and heads of
  ``init_detector_`` from ``common.seed`` (``cli.train.load_weights``).
  Under ``common.bf16`` the weights are cast to bf16.  It prints box and
  mask AP (``metrics.DetectionAP``).
- ``ade20k_seg`` builds the segmenter of ``task.seg_head`` (``mask2former``
  or ``upernet``) the same way: a ``.npz`` gives every weight, a ``.pt`` the
  image adapter and encoder layers over ``init_segmenter_``'s priors,
  interactions and head.  It prints mIoU (``metrics.MIoU``) by
  ``task.seg_eval_protocol`` (``whole``, ``slide`` or ``ms_flip``).
- ``k400_video`` builds the video classifier the same way: a ``.npz`` gives
  every weight, a ``.pt`` the trunk over ``init_video_classifier_``'s
  adapters, norm and head.  It prints top-1 accuracy (``metrics.Accuracy``)
  over the test views of ``task.video_test_clips`` clips x ThreeCrop
  (``task.video_test_three_crop``), the views' softmax probabilities
  averaged per clip.
- Under ``torchrun`` every process loads the whole model on its card (no
  sharding: evaluation keeps no optimizer state), scores its contiguous
  slice of each batch of ``dataset.batch_size_valid``, and the task's
  reducer merges the ranks' parts; rank 0 prints and writes the metrics.

  torchrun --nproc_per_node 8 -m one_peace_tpu_torch.cli.evaluate \
      --config eval.yaml --path ckpt.npz [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

import torch

logger = logging.getLogger("one_peace_tpu_torch.evaluate")


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--path", required=True, help="checkpoint path (.pt/.npz)")
    parser.add_argument("--output", default=None, help="metrics JSON output path")
    parser.add_argument("--device", default="cuda", help="torch device of the model")
    parser.add_argument("--dist-timeout", type=float, default=1800.0,
                        help="seconds a collective may wait before it raises")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from ..core.config import load_config
    from ..data.iterators import batch_rows_of
    from ..hub import from_pretrained
    from ..metrics.metrics import fetch_once
    from ..parallel.mesh import close_distributed, init_distributed, local_device
    from ..tasks import build_task
    from .train import load_weights

    cfg = load_config(args.config, args.overrides)
    rank, world = init_distributed(args.device, args.dist_timeout)
    args.device = str(local_device(args.device))
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)

    task = build_task(cfg.task, cfg)
    if hasattr(task, "build_model"):
        if not os.path.exists(args.path):
            raise FileNotFoundError(args.path)
        model = task.build_model(cfg, device=args.device)
        load_weights(cfg, model, args.device, args.path)
        if cfg.common.bf16:
            model.to(torch.bfloat16)
    else:
        cfg.model.encoder.text_adapter.vocab_size = len(task.dictionary)
        cfg.model.head_type = cfg.task.head_type
        cfg.model.encoder.image_adapter.rel_bucket_size = cfg.task.patch_image_size // 16
        head = task.head_kwargs()
        model = from_pretrained(
            args.path, model_type=cfg.model._name,
            dtype="bf16" if cfg.common.bf16 else "float32",
            bpe_dir=cfg.task.bpe_dir or None, model_cfg=cfg.model, task_cfg=cfg.task,
            num_classes=head.pop("num_classes"), classify_kwargs=head,
            device=args.device).model

    task.load_dataset("valid")
    t0 = time.time()
    fetches_before = fetch_once.calls
    task.begin_valid_epoch(model, None)
    itr = task.get_batch_iterator("valid", cfg.dataset.batch_size_valid,
                                  shard_id=rank, num_shards=world, ensure_equal_batch=False)
    for batch in itr.next_epoch_itr():
        if batch_rows_of(batch):
            task.valid_step(model, None, batch)
    stats = task.merge_results()
    stats["eval_wall_s"] = round(time.time() - t0, 3)
    stats["eval_compiled_programs"] = task.eval_compiles
    # a Recall pass fetches to the host once (Recall.merge_results)
    stats["eval_batched_fetches"] = fetch_once.calls - fetches_before
    printable = {k: v for k, v in stats.items() if isinstance(v, (int, float))}
    if rank == 0:
        print(json.dumps(printable, indent=2))
        if args.output:
            with open(args.output, "w") as fh:
                json.dump(printable, fh)
    close_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
