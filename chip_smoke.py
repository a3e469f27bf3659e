#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card, its name and power limit (nvidia-smi);
2. build: every kernel source under ``one_peace_tpu_torch/csrc``, one nvcc
   each, started together (beside it and the phases after it, two spawned
   set-up processes write the seeded fairseq ``.pt`` files and the data
   trees that phases 9-20 read, ``Prep``; each phase logs its wait);
3. the attention kernel against its plain PyTorch version, bf16 and fp32,
   at the main path's shapes (L = 257 image at B=2 and 256, 500 audio, 71
   text with pads, 850 VL concat), with the rows' softmax statistics that a
   gradient needs, so that both branches of ``tile_plan`` run (one walk with
   the row block resident, and two walks; logged per case);
4. the 4B retrieval model at full width (d 1536, FFN 6144, 24 heads, 40
   layers) on random weights from a seeded generator: text, image and audio
   embeddings through the kernel path (``attn_impl="pallas"``) against the
   plain path (``"xla"``), fp32 then bf16, and the kernel's launch count;
5. times (info lines): embeddings per second, kernel path and plain path,
   at bench.py's batches in bf16; attention ms per layer at L=257 (B=256),
   500 (B=32) and 71 (B=32, text pads), kernel and SDPA in turns;
6. the backward kernel against its plain version on the card, bf16 and fp32,
   at the training path's shapes (B=32 L=257 image, B=32 L=70 and 71 text
   with pads; with the forward kernel's statistics passed, as training
   does, and without) and at L=37 (batched bias), 500 and 850, each call
   twice and bit-equal, both branches of ``bwd_plan``; its time at L=257
   and 71 in turns with SDPA's backward, and each of its kernels alone;
7. the image-text retrieval fine-tuning step at full width through
   ``Trainer``: (a) 4 layers, kernel path against plain path on the same
   weights and batch -- loss and per-parameter gradient cosines in fp32 and
   bf16 compute, then 3 optimizer steps on each; (b) the depth-40 vl model,
   bf16 compute, fp32 master AdamW, remat, B=32: steps on the kernel path
   and then the plain path, ms per step, pairs per second, MFU, peak memory,
   the kernels' launch counts per step and a falling loss; one step under
   ``torch.profiler`` (its top ops go to ``chiprun_out/train_profile.txt``).
8. the int8 kernels (row quantize and GEMM) against their plain versions on
   the card, bit for bit, at the serving path's shapes, ragged ones and the
   edges of the GEMM's plan (M below one tile, a partial last wave of
   tiles, the audio rows); then
   the quantize's times at both FFN inputs and the GEMM's at the three FFN
   shapes, each beside its bound and plain version, the GEMM in turns with
   bf16 ``torch.matmul`` and ``torch._int_mm`` (its TOPS and share of the
   bound logged);
9. int8 serving at full width through the hub: ``from_pretrained`` on a
   2-layer full-width fairseq ``.pt`` written under ``build/``, quantize
   "ffn" and "ffn_attn", fp32 and bf16, text / image / audio embeddings on
   the kernel path against the plain int8 path, the launch counts per
   forward, ``process_image(on_device=True)``; then at depth 4 (``CUT_DEPTH``) in bf16
   the GEMM and quantize launches of one "ffn" and one "ffn_attn" image
   forward (3 / 2 and 7 / 4 a layer), and images/s and clips/s for the bf16, "ffn"
   and "ffn_attn" paths;
10. the depth-40 golden (``tests/fixtures/full_geometry_golden.npz``): the
   seeded 4B fairseq state regenerated and converted by the port's ``.pt``
   route in a process of its own, started with the script so that its
   minutes on the host overlap phases 2-17 (it holds no card), written as
   raw files and read memory-mapped onto the card, and the fp32
   model on the kernel path held to the golden embeddings at cosine >=
   1-1e-3;
11. detection serving: (a) the det attention kernel against its plain
   version, bf16 and fp32, with and without the LSE, at the 1024 px global
   grid (B=2, 64 x 64), its windows (B=32, 16 x 16; with each bias alone and
   none), a ragged 50 x 50 grid, a 1 x 64, an 8 x 8 and an 80 x 80 grid, so
   that each branch of the forward's plan runs (logged per case); (b)
   ``OnePeaceDetector`` at full width and depth 4 (``CUT_DEPTH``; phase 22
   runs it at depth 40), 1024 px, 80 classes, RPN and masks, on seeded
   random weights: the kernel path against the plain path (the stride-16
   map, the pyramid, the cascade and mask heads on fixed proposals; cosine
   per image >= 1-1e-6 fp32, >= 0.999 bf16), a launch per trunk layer,
   then ``detect()``; (c) images/s of ``detect()`` at B=2 in bf16 on the
   kernel path,
   one profiled call (``detect_profile.txt`` beside phase 7's profile), and
   ms per global and windowed layer for the kernel, its plain version and
   SDPA with the bias materialised (kernel and SDPA in turns), the kernel's
   ratio to SDPA, and the kernel with no bias beside it;
12. detection fine-tuning: (a) the det attention backward kernels (pass 1
   with the dtoep pass, pass 2) against their plain version, bf16 and fp32,
   at the global grid (B=2, 64 x 64), its windows (B=32, 16 x 16) with each
   bias alone, both and none, and ragged, 32 x 32, 1 x 64 and 80 x 80 grids,
   each call twice and bit-equal, so that each branch of the backward's plan
   runs (logged per case); (b) the recipe's detector with 4 trunk
   layers at full width, 1024 px, B=2, drop path 0.6 and remat, RPN, cascade
   and masks: loss and per-parameter gradients, kernel path against plain
   path, fp32 and bf16 compute; (c) the recipe at depth 40 through
   ``load_config``, ``CocoDetectionTask.build_model``,
   ``DetectionCriterion`` and ``Trainer`` (bf16 over fp32 masters, AdamW
   with layer decay): ms per step, images/s, peak memory, launches per step
   (80 forward, 40 backward) and a falling loss, one profiled step
   (``det_train_profile.txt``), and the plain path at depth 4 (a falling
   loss, no launch); (d) ms per global and windowed layer of
   the backward by pass, each pass with no bias, toep only, bh + bw only and
   both, the plain backward and SDPA's backward with the materialised bias
   needing a gradient, and the backward's ratio to it;
13. retrieval fine-tuning from data through the CLIs: (a) 160 image-caption
   pairs as JPEG files under ``build/smoke_retrieval/``, TSVs, a valid JSON
   of 5 captions for each of 64 valid ids, and a byte-level BPE set; (b)
   ``cli.train`` at full width and depth 2 (bf16, remat, drop path 0.5,
   B=8, update_freq=2) straight to 4 updates, and again stopped at the end
   of epoch 1 (a save at update 2 with a micro-batch pending) and resumed
   to 4: the updates' losses within 1e-6 relative and the final masters'
   cosine >= 1-1e-6, then ``cli.evaluate`` on the run's
   ``checkpoint_best.npz`` (64 images, 320 texts); (c) the recipe at depth
   8 (``CUT_DEPTH``: 9's times, 11's detector, 12(c)'s plain step, 21(d),
   23(a) and the recipes' runs through ``cli.train`` in 13(c)-20(d) are cut
   from 40 to 4 layers to keep the script inside
   its time limit) through
   ``cli.train`` from the config's init, B=32, 6 updates and one
   validation, no saves: ms per update from data beside phase 7(b)'s, pairs
   per second, peak memory, the attention kernels' launches per update and
   in validation, and one profiled update (``train_cli_profile.txt``);
14. detection from data through the CLIs: (a) a synthetic COCO tree under
   ``build/smoke_coco/``: 16 train and 8 valid JPEGs at 640 x 480, 480 x
   640, 1024 x 768 and 333 x 500, COCO's 80 non-contiguous category ids,
   objects as polygons, compressed and uncompressed RLE, a crowd region and
   a sub-pixel box in each image; (b) ``cli.train`` on the detection recipe
   at full width and depth 2 (one windowed and one global layer; 1024 px,
   B=2, bf16 over fp32 masters, remat,
   drop path 0.6): 2 updates, one validation and ``checkpoint_best.npz``,
   whose ``params_from_jax`` read-back must equal the masters bit for bit;
   then ``cli.evaluate`` on it must detect what the validation detected and
   print its AP dict (to 1e-6); (c) the recipe at depth 4 through
   ``cli.train`` from the config's init, B=2, 4 updates and one validation
   over the 8 valid images, no saves: ms per update from data beside
   12(c)'s ms per step, images per second, peak memory, the det attention's
   launches per update (2 forward, 1 backward a layer) and in validation
   (1 a layer),
   validation's wall time split between ``detect()``, the host's mask paste
   and AP records and the AP sweep, the host's share at 100 detections per
   image, and one profiled update (``det_cli_profile.txt``);
15. classification: (e) first, #1 and #2 alone at the slice's shapes (L=577
   at B=32, the 384 px image; L=750 at B=8, 15 s clips with key pads;
   L=971 at B=4, VQA's 480 px image and text with pads) against their plain
   versions with phase 3's and 6's bounds, then in turns with SDPA and its
   backward, beside their bounds and plain versions, with the plans'
   branches; then, the launches counted from 0: (a) ``from_pretrained(
   model_type="one_peace_classify")`` on 2-layer full-width fairseq ``.pt``
   files written under ``build/`` (16 x 16 pretrained image tables, a
   seeded head): an image head at 384 px with attention pooling, a vl head
   at 480 px and an audio head, fp32 and bf16, the kernel path against the
   plain path (cosine of the logits per sample >= 1-1e-6 / 0.999, 2 launches
   of #1 per forward), then the same model quantized as quantize="ffn"
   quantizes it (``quantize_ffn_`` after the cast) against the plain int8
   path;
   (b) each task's gradients at 2 layers (4 until PR 20), full width,
   through ``Trainer`` and the classify criterion (image_classify at 384 px, B=8, Mixup and
   CutMix soft targets; VQA at 480 px, B=4, BCE over 3129 answers;
   VGGSound B=8, clips of 5-15 s), kernel path against plain path with
   7(a)'s bounds, then 3 AdamW steps on each; (c) synthetic JPEGs, a VQA
   TSV, WAV clips and a BPE set under ``build/smoke_classify/``, and each
   recipe through ``cli.train`` at depth 2 (4 updates, one validation,
   ``checkpoint_best.npz`` read back bit-equal to the masters) and
   ``cli.evaluate`` on the export (the validation's accuracy to 1e-6);
   (d) the image_classify recipe at depth 4, 384 px, B=32 through
   ``cli.train`` from the config's init: 6 updates and one validation over
   64 images, no saves: ms per update, images/s, MFU, peak memory, the
   launches per update (2 / 1 a layer) and in validation (1 / 0 a layer), a falling loss
   and one profiled update (``classify_cli_profile.txt``).
16. pretraining: (a) first, #1 and #2 alone at the slice's new shapes (the
   students' per-sample (B, H, L, L) biases at L=65 and 124, B=32, and at
   L=338 and 456, B=16, the two-walk branch; the 768-d decoder's 12 heads
   without a bias at L=329, B=32 and L=822, B=16) against their plain
   versions with phase 3's and 6's bounds, then in turns with SDPA and its
   backward; then, the launches counted from 0: (b) both pretrain
   criterions at 4 layers, full width, with the decoder, B=8 from the
   corpus, kernel path against plain path with 7(a)'s bounds; (c)
   synthetic JPEGs, 14-15 s WAV clips and captions under
   ``build/smoke_pretrain/``, the VL recipe through ``cli.train`` at depth 2
   with its export read back bit-equal, then the AL stage-2 recipe
   restoring it: the shared leaves carried bit-equal, ``logit_scale``
   reset, the frozen parameters bit-unchanged after 3 updates; (d) both
   recipes at depth 4 (VL B=32, AL B=16), 5 updates each: the median ms
   per update, pairs or clips per second, MFU, peak memory, the launches
   per update, one profiled update each (``pretrain_{vl,al}_profile.txt``:
   the idle share and the per-sample bias gathers' index backward).
17. segmentation serving: (a) first, #1 alone at the 896 px trunk's shape
   (L = 3137, B=1 and 8, 24 heads, one shared fp32 (H, L, L) bias, no key
   bias; two walks, the last key tile holding one key) against its plain
   version with phase 3's bounds, bf16 and fp32, then in turns with SDPA;
   then, the launches counted from 0: (b) the UperNet and the recipe's
   Mask2Former segmenters at full width and depth 4, 896 px, B=2, kernel
   path against plain path in fp32 (cosine per image >= 1-1e-6) and bf16
   (>= 0.999) on the pyramid and the class scores, the share of flipped
   mask-attention keys, 4 launches per forward; (c) the Mask2Former recipe
   at depth 40 through ``load_config`` and ``Ade20kSegTask.build_model`` in
   bf16: kernel path against plain path, 40 launches per forward, images/s
   of ``logits`` at B = 1, 2 and 8, peak memory, one profiled forward
   (``seg_profile.txt``: the idle share); (d) a synthetic ADE20K tree and a
   depth-4 fairseq ``.pt`` under ``build/smoke_ade/``, ``cli.evaluate`` under
   the whole, slide and ms_flip protocols, the whole one's mIoU equal to a
   direct ``valid_step`` loop.
18. segmentation training: (a) first, #1 with the backward's statistics and
   #2 alone at the trunk's training shape (L = 3137, B=2, one shared fp32
   (H, L, L) bias, no key bias; #2's d(bias) in device memory) against their
   plain versions, fp32 (two backward calls bit-equal) and bf16, then in
   turns with SDPA and its backward; then, the launches counted from 0: (b)
   both segmenters' training objectives (UperNet's pixel CE, the recipe's
   Mask2Former set loss with its Hungarian matching) at full width and
   depth 4, 896 px, B=2, kernel path against plain path with phase 12(b)'s
   bounds, and the assignments that differ between the paths; (c) a
   synthetic ADE20K tree under ``build/smoke_ade_train/`` and the
   Mask2Former recipe through ``cli.train`` at depth 4 in fp32, straight to
   4 updates (one save, at 4) and stopped at 2 and resumed (losses to 1e-6,
   masters to
   cosine 1-1e-6), ``checkpoint_best.npz`` by mIoU and ``cli.evaluate`` on it
   equal to a direct ``valid_step`` loop; (d) the recipe at depth 4 through
   ``cli.train``, B=2, bf16: ms per update, images/s, MFU of the trunk's
   FLOPs, peak memory, launches per update (2 / 1 a layer) and one profiled update
   (``seg_train_profile.txt``: the idle share, the bias gathers' index
   backward, #1, #2 and the matching's host time).
19. video: (a) first, #1 with the backward's statistics and #2 alone at the
   video trunk's shapes at the recipe's B=8 (the temporal attention, L=32
   over 2056 sequences, no bias; the spatial one, L=257 over 256 frames,
   one shared fp32 (H, L, L) bias) against their plain versions, fp32 (two
   backward calls bit-equal) and bf16, then in turns with SDPA and its
   backward; then, the launches counted from 0: (b) the video classifier
   at full width and depth 4, 256 px, 32 frames, B=2, remat, on seeded
   random weights with non-zero adapters, temporal embedding and rel-pos
   table: the logits kernel path against plain path (cosine per clip >=
   1-1e-6 fp32, >= 0.999 bf16), the trainable gradients through ``Trainer``
   with 7(a)'s bounds, the launches per forward (8) and gradient (16 / 8);
   (c) a synthetic rawframes tree under ``build/smoke_k400/`` (24 train and
   8 valid clips of 40-150 frames, landscape and portrait) and the recipe
   through ``cli.train`` at depth 2, straight to 4 updates and stopped at 2
   and resumed (update losses to 1e-6), ``checkpoint_best.npz`` read back
   bit-equal to its step's masters, the trunk unchanged, and
   ``cli.evaluate`` under 3 clips x ThreeCrop equal to a direct
   ``valid_step`` loop; (d) the recipe at depth 4 through ``cli.train``,
   B=8, bf16: ms per update, clips/s, MFU, peak memory, launches per update
   (80 / 40), one validation over 8 clips (72 views) with its ms per clip
   and peak, and one profiled update (``video_train_profile.txt``: the idle
   share, #1 and #2).

20. the rest of classification: (a) first, #1 with the backward's
   statistics and #2 alone at the new shapes (NLVR2's vl sequences, L=647
   = 70 text + 577 image tokens at 384 px, B=32 with text pads; AQA's al
   sequences, L=820 = 70 text + 750 audio tokens at 15 s, B=32 = 8
   questions x 4 choices with text and audio pads; one shared fp32 (H, L,
   L) bias) against their plain versions, fp32 (two backward calls
   bit-equal) and bf16, then in turns with SDPA and its backward; then, the
   launches counted from 0: (b) the four criterions (NLVR2's two images
   through the classify criterion, RefCOCO's grounding loss, AQA's hinge
   over 4 choices, FSD50K's BCE over 200 classes) at full width and depth
   2 through ``Trainer`` on 8 batches of 8 examples each, each batch from
   its own seed, kernel path against plain path: fp32 with 7(a)'s bounds;
   bf16 no further from fp32 than the plain path, in the gradients and in
   the loss: the kernel path's mean excess over the 8 batches at most three
   standard errors of the paired differences; (c) synthetic JPEGs and WAV clips with the four TSVs under
   ``build/smoke_classify_rest/`` and each recipe through ``cli.train`` at
   depth 2 (2 updates, one validation, ``checkpoint_best.npz`` read back
   bit-equal to the masters) and ``cli.evaluate`` on the export (its
   accuracy, acc@0.5 or map to 1e-6); (d) the NLVR2 recipe at depth 4,
   384 px, B=16 pairs through ``cli.train``: ms per update (median of 3),
   pairs/s, MFU, peak memory, the launches per update (80 / 40) and one
   profiled update (``nlvr2_train_profile.txt``: the idle share, #1, #2).
21. fp16, the EMA, Adan and the remat policies: (a) first, the fp16 arms
   of #1/#2 (every branch of ``tile_plan`` and ``bwd_plan``, tails 16-64
   wide, text and key pads, shared and per-sample bias) and of #3/3b
   (bit-equal) alone against their plain versions, at a fifth of bf16's
   bounds, then in turns with SDPA / ``torch.matmul`` in fp16 and the bf16
   kernel; then each fp16 run with its launches set to 0 before it and
   held to its expected counts after it (the depth-40 golden in fp16
   runs inside phase 10, on its state: images and audio >= 0.999, each
   modality's kernel path no further from it than the plain path and
   above bf16's, beside fp32 compute on the weights rounded to fp16): (b)
   4B embeddings/s in fp16 and int8 "ffn" fp16 at depth 40; (c) 7(a)'s
   check in fp16, then the depth-40 vl step in fp16 with loss scaling and
   the EMA (ms, MFU, peak, the scale after each step, skips, 160 / 80
   launches a step; the EMA update and the unscale alone, one step
   profiled); (d)
   ``full`` / ``qkv`` / ``offload_qkv`` on a vl model at depth 4 (``CUT_DEPTH``):
   gradients bit-equal,
   GEMMs in the backward, the median ms of three in turns, peak, one
   call each profiled; (e) Adan card vs CPU on the
   same clipped gradients at depth 2, and its step at depth 40 against its
   bound; (f) ``cli.train`` at depth 2 with fp16, the EMA and Adan,
   stopped and resumed bit-equal, ``checkpoint_best.npz`` the shadow.
22. detection in fp16 and int8 serving of the vision trunks: (a) first,
   the fp16 arms of #4, #5 and #6 alone against their plain versions at
   every case and plan branch of 11(a) and 12(a) (two backward calls
   bit-equal), at a fifth of bf16's bounds, then per global and windowed
   layer in turns with the bf16 kernels and SDPA in fp16 on the
   materialised bias; then each run with the launches of #4, #5/#6, #3 and
   3b set to 0 before it and held to its expected counts after it: (b) the
   depth-40 detector in fp16, kernel path against plain path (11(b)'s
   outputs, cosine >= 0.999, 40 launches of #4 a trunk forward); (c) 12(b)
   in fp16 (the loss scaled as the ``Trainer`` scales it), then the
   depth-40 recipe through ``Trainer`` with ``common.fp16``: 3 steps, 80 /
   40 launches a step, the loss scale after each step, the skips and ms
   per step beside 12(c)'s; (d) ``vision.zoo.quantize_serving_params`` on
   the bf16 depth-40 detector: 120 / 80 launches of #3 / 3b a trunk
   forward, the int8 kernel path against the plain int8 path, #3 / 3b at
   M = 8192 and 25096 against their plain versions and in turns with bf16
   ``torch.matmul``, and the trunk forward and ``detect()``, int8 against
   bf16, medians of 3 in turns; (e) the Mask2Former recipe at depth 40 in
   int8: the kernel path against the plain int8 path at B=1, images/s at
   B=8 with and without int8; the video classifier at depth 4 in int8
   against the plain int8 path.
23. data parallelism and FSDP on the card, each run over a one-rank NCCL
   group opened in this process (a ``FileStore`` under ``build/``): (a) the
   retrieval step at full width, depth ``CUT_DEPTH``, bf16, B=32 (7(b)'s
   build): 3 updates through the ``Trainer`` FSDP-wrapped by the sharding
   rules, then, freed, through the unwrapped one on the same seeded weights
   and batches: per update the loss and gnorm, their largest relative
   difference against ``PARALLEL_BOUND``, ms, peak, #1 and #2's launches
   held to the unwrapped run's, and one profiled update of each (the card's
   busy time, the idle share, NCCL's share under FSDP); (b) the same for the
   detection step at 1024 px, B=2, depth 2 (one windowed, one global
   layer), #4-#6's launches; (c) ``python -m torch.distributed.run
   --standalone --nproc_per_node 1 -m one_peace_tpu_torch.cli.train`` on
   phase 13's corpus at depth 2 with ``distributed.fsdp=1``, started before
   17(d) so that its start-up overlaps 17(d) and phase 10: its
   ``train_inner`` losses and validation Recall held to the same arguments
   without torchrun, and its bundle resumed without torchrun (the next
   update's loss).
24. model parallelism on one card, full width, bf16: (a) #1/#2 on every
   ``tp`` rank's heads (tp 2, 4, 8) against the unsharded call and the
   plain version; (b) the ring's step functions for every (rank, step) at
   sp 2 and 4 against #1/#2 on the whole sequence; (c) the fusion encoder
   at depth ``CUT_DEPTH`` split into stages and micro-batches, and through
   its own pipeline route (``pipeline_forward`` over a one-rank NCCL group,
   without and with the stage remat), against the serial stack.

The CLI checks 13(b), 14(b), 15(c), 16(c) and 19(c) run at depth 2
(resume, export and ``cli.evaluate`` do not depend on depth); 17(d) and
18(c) run at depth 4, since the ViT-Adapter splits the trunk into four
interaction groups.  Phase 10 runs after phase 17, when
the process started with the script has written its state under
``build/golden_state/``.

Every timed kernel also prints its bound: the larger of its bytes over the
HBM rate and its operations over the peak rate (NVIDIA's data sheet).  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import json
import math
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.nn.utils import get_total_norm
from torch.utils._python_dispatch import TorchDispatchMode

from one_peace_tpu_torch import hub as port_hub
from one_peace_tpu_torch.core.config import FrameworkConfig, TaskConfig, load_config
from one_peace_tpu_torch.data.tokenizer import bytes_to_unicode
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.data.mixup import Mixup
from one_peace_tpu_torch.models.adapters.audio import conv_output_length
from one_peace_tpu_torch.models import components
from one_peace_tpu_torch.models.classify import OnePeaceClassifyModel
from one_peace_tpu_torch.models.one_peace import ModelConfig, OnePeaceRetrievalModel
from one_peace_tpu_torch.ops import build
from one_peace_tpu_torch.ops import det_attention as da
from one_peace_tpu_torch.ops import flash_attention as fa
from one_peace_tpu_torch.ops import int8_matmul as im
from one_peace_tpu_torch.ops import ring_attention as ra
from one_peace_tpu_torch.parallel import tensor_parallel as tpar
from one_peace_tpu_torch.ops.attention import attention_plain
from one_peace_tpu_torch.ops.preprocess import resize_normalize
from one_peace_tpu_torch.ops.quant import quantize_ffn_
from one_peace_tpu_torch.optim import build_optimizer
from one_peace_tpu_torch.tasks.vision_tasks import CocoDetectionTask
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint_convert import convert_retrieval_model
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision import zoo as tzoo
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "examples")]
import full_geometry_parity as golden  # noqa: E402  (its constants; it imports numpy only)
from torch_fixture import make_random_state_dict  # noqa: E402  (numpy)

H100_BF16_PEAK_TFLOPS = 989.0  # dense, NVIDIA data sheet (SXM, 700 W)
H100_INT8_PEAK_TOPS = 1979.0  # dense, the same sheet
H100_FP32_PEAK_TFLOPS = 67.0  # outside the tensor cores, the same sheet
H100_HBM_BYTES_PER_S = 3.35e12  # the same sheet
IMG_BATCH, AUD_BATCH, AUDIO_SECONDS = 256, 32, 10  # bench.py's workload
BF16_MAX_ERR, BF16_MEAN_ERR, FP32_MAX_ERR = 2e-2, 2e-3, 1e-4
# the depth of phase 9's times through the hub and of the recipes' runs
# through cli.train in 13(c)-20(d): the 4B model's 40 layers halved, so that
# the script stays inside its time limit
CUT_DEPTH = 4
# the recipes that set distributed.fsdp: 8 (detection, segmentation, K400,
# pretraining) run in this one process with the override that names it
ONE_PROCESS = "distributed.fsdp=1"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def analytic_flops(cfg, seq_len: int, batch: int, frontend: str, wav_samples: int = 0,
                   image_size: int = 256) -> float:
    """bench.py's closed form (2 FLOPs per MAC: trunk matmuls, attention,
    frontend convs), with the hMLP stem's real channels (d/4 -> d/4 -> d)
    at ``image_size`` px."""
    enc = cfg.encoder
    d, f, L = enc.embed_dim, enc.ffn_embed_dim, seq_len
    flops = enc.layers * (2 * (4 * L * d * d) + 2 * (2 * L * L * d) + 2 * (3 * L * d * f))
    if frontend == "text":
        pass
    elif frontend == "image":
        hw = image_size
        flops += 2 * ((hw // 4) ** 2 * (d // 4) * 3 * 16
                      + (hw // 8) ** 2 * (d // 4) * (d // 4) * 4
                      + (hw // 16) ** 2 * d * (d // 4) * 4)
    else:
        t, cin = wav_samples, 1
        for ch, k, s in enc.audio_adapter.feature_encoder_spec:
            t = (t - k) // s + 1
            flops += 2 * t * ch * cin * k
            cin = ch
        flops += 2 * t * d * cin
    return float(batch * flops)


def bound_ms(n_bytes: float, ops: float, peak_ops_per_s: float) -> tuple:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate; and which one it is."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Smallest cosine between matching rows, in fp64."""
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


FWD_BRANCHES = {True: "one walk, the row block's scores resident", False: "two walks"}


def check_kernel(gen) -> float:
    """Phase 3: kernel vs plain (fp32 on the same rounded inputs); returns
    the largest max |diff| seen.  Each case names the branch of
    ``tile_plan`` that the bf16 kernel took, and the phase fails unless both
    ran.  The rows' statistics (m, 1/l), written when a gradient will be
    taken, are held to the plain version's to 1e-4 relative, and the output
    written beside them must equal the one without."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, pad lengths per row, or "text", or None)
        (2, 257, "shared", None), (2, 257, "shared", [0, 0]),
        (2, 500, "shared", [0, 137]), (2, 37, "batched", [5, 0]),
        (1, 128, "shared", None), (1, 850, "shared", None),
        (32, 71, "shared", "text"), (256, 257, "shared", None)]
    # the last two cases draw from a generator of their own, so that `gen`
    # reaches the later phases (7(a)'s batch) in the state it always had
    extra = torch.Generator(device="cuda").manual_seed(1)
    branches = set()
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, l, form, pads) in enumerate(cases):
            rng = gen if i < 6 else extra
            q, k, v = (torch.randn(b, l, heads, 64, generator=rng, device="cuda").to(dtype)
                       for _ in range(3))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=rng, device="cuda")
            mask = None
            if pads == "text":
                mask = text_pad_mask(b, l)
            elif pads is not None:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads):
                    if n:
                        mask[row, l - n:] = True
            got = fa.flash_attention(q, k, v, bias, mask, 0.125).float()
            torch.cuda.synchronize()
            key_bias = None if mask is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            q3, k3, v3 = (x.reshape(b, l, heads * 64) for x in (q, k, v))
            want, want_stats = fa.flash_attention_plain(
                *(x.float() for x in (q3, k3, v3)), bias, key_bias, 0.125, heads,
                with_stats=True)
            want = want.reshape(b, l, heads, 64)
            out_s, stats = fa.flash_attention_cuda(q3, k3, v3, bias, key_bias, 0.125, heads,
                                                   with_stats=True)
            torch.cuda.synchronize()
            err = (got - want).abs()
            mx, mean = err.max().item(), err.mean().item()
            stats_err = max(((stats[0] - want_stats[0]).abs()
                             / want_stats[0].abs().clamp_min(1)).max().item(),
                            ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item())
            worst = max(worst, mx)
            plan = fa.tile_plan(l)
            if dtype == torch.bfloat16:
                branches.add(plan.resident)
            log(f"kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads="
                f"{'text' if pads == 'text' else pads}: max|d| {mx:.3e} mean|d| {mean:.3e}, "
                f"statistics {stats_err:.2e} relative; plan: {FWD_BRANCHES[plan.resident]}, "
                f"last tile {plan.tail} wide")
            if not torch.isfinite(got).all():
                raise RuntimeError("kernel output is not finite")
            if dtype == torch.bfloat16 and (mx > BF16_MAX_ERR or mean > BF16_MEAN_ERR):
                raise RuntimeError(f"bf16 kernel disagrees: max {mx} mean {mean}")
            if dtype == torch.float32 and mx > FP32_MAX_ERR:
                raise RuntimeError(f"fp32 kernel disagrees: max {mx}")
            if stats_err > 1e-4:
                raise RuntimeError(f"kernel statistics disagree: {stats_err}")
            if not torch.equal(out_s.reshape(b, l, heads, 64).float(), got):
                raise RuntimeError("the output written with the statistics differs")
            if pads == [0, 0]:  # an all-False mask must equal no mask
                same = fa.flash_attention(q, k, v, bias, None, 0.125).float()
                if not torch.equal(same, got):
                    raise RuntimeError("all-False mask and no mask disagree")
            del q, k, v, bias, got, want, want_stats, out_s, stats, q3, k3, v3, err
            torch.cuda.empty_cache()
    if branches != {True, False}:
        raise RuntimeError(f"phase 3 ran the forward plan's branches {branches}, not both")
    return worst


def text_pad_mask(b: int, l: int, device="cuda") -> torch.Tensor:
    """(b, l) True at pads: row i keeps CLS and 8 + 7i mod (l - 8) tokens."""
    mask = torch.zeros(b, l, dtype=torch.bool, device=device)
    for row in range(b):
        mask[row, 9 + (7 * row) % (l - 9):] = True
    return mask


DQ_BRANCHES = {True: "dq: p32 resident", False: "dq: two walks"}
DKV_BRANCHES = {True: "dk/dv: d(bias) slab", False: "dk/dv: d(bias) in device memory"}


def check_backward_kernel(gen) -> float:
    """Phase 6: the backward kernel against flash_attention_bwd_plain on the
    same inputs, bf16 and fp32; returns the largest max |diff| of dq, dk, dv
    and d(bias).  Each call runs twice and must be bit-equal.  The case
    marked "fwd" passes the forward kernel's statistics, as training does;
    the others let the wrapper launch the forward for them.  Each case names
    the branches of ``bwd_plan`` that the bf16 kernels took (the dq kernel's
    walks, and with a shared bias the dk/dv kernel's d(bias) sum), and the
    phase fails unless each branch ran.

    Bounds, relative to max |plain| (and mean |diff| to mean |plain|):
    fp32 1e-4 max -- both sides sum in fp32, in other orders, over at most
    850 terms (and 32 batch rows for d(bias)), and the kernel's exp is
    ex2.approx (2 ulp); bf16 2e-2 max, 5e-3 mean -- dq, dk, dv are rounded to
    bf16 (2^-8 relative), and where the kernel's fp32 p or ds*scaling lands
    on the other side of a bf16 rounding boundary than the plain version's,
    one product term moves by one bf16 ulp."""
    heads, worst = 24, 0.0
    cases = [  # (B, L, bias form, key mask, the forward's statistics passed)
        (32, 257, "shared", None, False), (32, 70, "shared", "text", False),
        (2, 37, "batched", [5, 0], False), (4, 500, "shared", [0, 137, 0, 60], False),
        (1, 850, "shared", None, False), (32, 257, "shared", None, True),
        (32, 71, "shared", "text", True)]
    # the last two cases draw from a generator of their own (see check_kernel)
    extra = torch.Generator(device="cuda").manual_seed(2)
    branches = set()
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, l, form, pads, fwd_stats) in enumerate(cases):
            rng = gen if i < 5 else extra
            q, k, v, g = (torch.randn(b, l, heads * 64, generator=rng, device="cuda").to(dtype)
                          for _ in range(4))
            shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
            bias = torch.randn(shape, generator=rng, device="cuda")
            if pads == "text":
                mask = text_pad_mask(b, l)
            else:
                mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
                for row, n in enumerate(pads or []):
                    if n:
                        mask[row, l - n:] = True
            key_bias = None if pads is None else torch.zeros(
                b, l, device="cuda").masked_fill(mask, fa.NEG_INF)
            stats = None
            if fwd_stats:
                _, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads,
                                                   with_stats=True)
            got = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads,
                                              stats=stats)
            again = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads,
                                                stats=stats)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
                raise RuntimeError(f"two backward calls differ: {str(dtype)[6:]} B={b} L={l}")
            want = fa.flash_attention_bwd_plain(q, k, v, g, bias, key_bias, 0.125, heads)
            parts = []
            for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"backward kernel {name} is not finite")
                err = (x.float() - y.float()).abs()
                rel_max = err.max().item() / y.float().abs().max().item()
                rel_mean = err.mean().item() / y.float().abs().mean().item()
                parts.append(f"{name} {rel_max:.2e}/{rel_mean:.2e}")
                worst = max(worst, err.max().item())
                bad = (rel_max > 1e-4 if dtype == torch.float32
                       else rel_max > 2e-2 or rel_mean > 5e-3)
                if bad:
                    raise RuntimeError(f"backward kernel {name} disagrees with the plain "
                                       f"version: {str(dtype)[6:]} B={b} L={l} {form} "
                                       f"{pads}: max {rel_max:.3e} mean {rel_mean:.3e}")
            plan = fa.bwd_plan(b, l, heads, form == "shared")
            branch = f"; plan: {DQ_BRANCHES[plan.tiles.resident]}"
            if dtype == torch.bfloat16:
                branches.add(("dq", plan.tiles.resident))
            if form == "shared":
                branch += (f", {DKV_BRANCHES[plan.dkv_slab]}, {plan.chunks} chunks of "
                           f"{plan.b_chunk}")
                if dtype == torch.bfloat16:
                    branches.add(("dkv", plan.dkv_slab))
            log(f"bwd kernel vs plain {str(dtype)[6:]} B={b} L={l} bias={form} pads="
                f"{'text' if pads == 'text' else pads}"
                f"{', statistics from the forward' if fwd_stats else ''}: max/mean |d| "
                f"relative {', '.join(parts)}; two calls bit-equal{branch}")
            del q, k, v, g, bias, got, again, want, stats
            torch.cuda.empty_cache()
    if branches != {(kernel, x) for kernel in ("dq", "dkv") for x in (True, False)}:
        raise RuntimeError(f"phase 6 ran the backward plan's branches {branches}, not all")
    return worst


def in_turns(fns: dict, iters: int) -> dict:
    """Mean ms per call of each function, timed in turns (a, b, ..., b, a)."""
    names = list(fns)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(cuda_time_ms(fns[name], iters))
    return {name: float(np.mean(turns[name])) for name in names}


def sdpa_mask(bias, key_bias, b, heads=None, l=None, dtype=torch.bfloat16):
    """The additive mask SDPA gets, in ``dtype`` (bf16 unless given): a
    shared (H, L, L) or per-sample (B, H, L, L) bias plus the key bias where
    there is one, expanded to (B, H, L, L); without a bias (give ``heads``
    and ``l``) the key bias alone; None without either."""
    if bias is None and key_bias is None:
        return None
    if bias is None:
        mask = key_bias[:, None, None, :].expand(b, heads, l, l)
    else:
        mask = bias if bias.ndim == 4 else bias[None]
        if key_bias is not None:
            mask = mask + key_bias[:, None, None, :]
    return mask.to(dtype).expand(b, -1, -1, -1)


def time_backward(gen, card: str) -> dict:
    """Phase 6 times: the backward kernel (given the forward's statistics,
    as in training) and SDPA's backward in turns, at the image training
    shape (B=32, L=257, shared bias) and the text one (B=32, L=71 with pads),
    bf16; each kernel alone (``passes``); the plain version; autograd
    through the plain attention as information at L=257.  Returns L=257's
    numbers with the text row under "shapes"."""
    heads, out = 24, {}
    extra = torch.Generator(device="cuda").manual_seed(3)  # the text row's (see check_kernel)
    for b, l, pads in ((32, 257, False), (32, 71, True)):
        rng = gen if l == 257 else extra
        q, k, v, g = (torch.randn(b, l, heads * 64, generator=rng, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        bias = torch.randn(heads, l, l, generator=rng, device="cuda")
        key_bias = (torch.zeros(b, l, device="cuda").masked_fill(text_pad_mask(b, l), fa.NEG_INF)
                    if pads else None)
        _, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads, with_stats=True)
        leaves = [x.reshape(b, l, heads, 64).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        mask = sdpa_mask(bias, key_bias, b).detach().requires_grad_()
        res = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                               scale=0.125)
        g4 = g.reshape(b, l, heads, 64).transpose(1, 2)
        args = (q, k, v, g, bias, key_bias, 0.125, heads)
        t = in_turns({
            "kernel": lambda: fa.flash_attention_bwd_cuda(*args, stats=stats),
            "sdpa": lambda: torch.autograd.grad(res, [*leaves, mask], g4, retain_graph=True)},
            iters=10)
        dq_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(*args, stats=stats, passes=1),
                             iters=10)
        dkv_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(*args, stats=stats, passes=2),
                              iters=10)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=5)
        # dq, dk, dv and d(bias) from q, k, v, g, the bias: S recomputed, dP, dV, dQ, dK
        flops = 10 * b * heads * l * l * 64
        bound = bound_ms(7 * q.numel() * 2 + 2 * bias.numel() * 4 + stats.numel() * 4, flops,
                         H100_BF16_PEAK_TFLOPS * 1e12)
        plan = fa.bwd_plan(b, l, heads, True)
        log(f"attention backward per layer B={b} L={l}{' text pads' if pads else ''} bf16: "
            f"kernel {t['kernel']:.4f} ms (dq kernel {dq_ms:.4f}, dk/dv kernel {dkv_ms:.4f}), "
            f"{t['kernel'] / t['sdpa']:.3f}x SDPA's backward {t['sdpa']:.4f} ms (in turns); "
            f"plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]}; plan "
            f"{DQ_BRANCHES[plan.tiles.resident]}, {DKV_BRANCHES[plan.dkv_slab]}, last tile "
            f"{plan.tiles.tail} wide, {plan.chunks} chunks of {plan.b_chunk} ({card})")
        row = {"ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
               "bound_ms": bound[0], "bound_by": bound[1], "dq_ms": dq_ms, "dkv_ms": dkv_ms}
        if l == 257:
            leaves32 = [x.detach().float().requires_grad_() for x in leaves]
            bias.requires_grad_()

            def autograd_plain():
                o = attention_plain(*(x.transpose(1, 2) for x in leaves32), bias, None, 0.125)
                torch.autograd.grad(o, [*leaves32, bias], g4.transpose(1, 2).float())

            log(f"attention backward B={b} L={l}: autograd through the plain attention "
                f"(forward included, fp32) {cuda_time_ms(autograd_plain, iters=3):.3f} ms")
            out.update(row)
        else:
            out.setdefault("shapes", {})[f"L={l} B={b} text pads"] = row
        del q, k, v, g, bias, key_bias, stats, leaves, mask, res, g4, args
        torch.cuda.empty_cache()
    return out


def train_config(layers: int, bf16: bool, remat: bool, drop_path: float) -> FrameworkConfig:
    """The image-text retrieval fine-tune (recipes/image_text_retrieval over
    recipes/finetune_4b_base): vl head at the 4B width, AdamW betas (0.9,
    0.999), weight decay 0.05, no clipping; constant lr 1e-5 for the few
    steps taken here (no warmup)."""
    cfg = FrameworkConfig()
    cfg.model = ModelConfig(head_type="vl")
    enc = cfg.model.encoder
    enc.layers, enc.checkpoint_activations, enc.drop_path_rate = layers, remat, drop_path
    cfg.criterion._name = "image_text_retrieval_criterion"
    cfg.common.bf16 = bf16
    cfg.optimizer.adam_betas = (0.9, 0.999)
    cfg.optimizer.weight_decay = 0.05
    cfg.optimization.lr = 1e-5
    cfg.optimization.clip_norm = 0.0
    cfg.lr_scheduler.min_lr = 1e-5
    return cfg


def train_batch(cfg, gen, b: int) -> dict:
    """b image-text pairs: 256 px images, 70-token texts with pads."""
    tokens = torch.randint(4, cfg.model.encoder.text_adapter.vocab_size, (b, 70),
                           generator=gen, device="cuda")
    tokens[text_pad_mask(b, 71)[:, 1:]] = cfg.model.encoder.text_adapter.padding_idx
    return {"src_tokens": tokens,
            "src_images": torch.randn(b, 3, 256, 256, generator=gen, device="cuda")}


def make_trainer(cfg, seed: int = 0) -> Trainer:
    model = OnePeaceRetrievalModel(cfg.model, device="cuda", dtype=torch.float32)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def grad_cosines(grads_a, grads_b) -> list:
    """Cosine between matching gradients (1 where both are zero), in fp64."""
    out = []
    for a, b in zip(grads_a, grads_b):
        a, b = a.double().flatten(), b.double().flatten()
        norm = a.norm() * b.norm()
        out.append(1.0 if norm == 0 else (a @ b / norm).item())
    return out


def check_train_paths(gen) -> None:
    """Phase 7(a): 4 layers at full width, kernel path against plain path on
    the same weights and batch.

    fp32: the losses within 1e-5 and every parameter's gradient cosine
    >= 1-1e-6 (the kernels agree with their plain versions to ~3e-7).
    bf16 compute: both paths round activations and the weights' copies to
    bf16, so each differs from the fp32 gradients by bf16 noise; small
    parameters fed by few positions (a last-layer LN bias) sit near cosine
    0.99 between any two bf16 runs.  The kernel path must be no further from
    the fp32 gradients than the plain path: per parameter, cosine to fp32 at
    least the plain path's minus 0.01, and over all parameters together
    kernel vs plain >= 0.999; losses within 2e-3.  Then 3 AdamW steps on
    each path: losses within 1e-4 (fp32) and 2e-2 (bf16) -- Adam's
    normalised update turns small gradient differences into parameter
    differences of order lr."""
    cfg = train_config(layers=4, bf16=False, remat=False, drop_path=0.0)
    batch = train_batch(cfg, gen, 8)
    runs, ref32 = {}, None
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        cfg = train_config(layers=4, bf16=bf16, remat=False, drop_path=0.0)
        trainer = make_trainer(cfg)
        enc = trainer.model.cfg.encoder
        for impl in ("pallas", "xla"):
            enc.attn_impl = impl
            fa.launches = fa.bwd_launches = 0
            metrics, grads = trainer.gradients(batch)
            torch.cuda.synchronize()
            launched = (fa.launches, fa.bwd_launches)
            want = (2 * 4, 2 * 4) if impl == "pallas" else (0, 0)
            if launched != want:
                raise RuntimeError(f"7(a) {name} {impl}: launches {launched}, expected {want}")
            if not all(torch.isfinite(g).all() for g in grads):
                raise RuntimeError(f"7(a) {name} {impl}: non-finite gradient")
            runs[name, impl] = (float(metrics["loss"]), grads)
        enc.attn_impl = "pallas"
        names = trainer._names
        del trainer
        (loss_k, grads_k), (loss_p, grads_p) = runs[name, "pallas"], runs[name, "xla"]
        cos = grad_cosines(grads_k, grads_p)
        worst = min(range(len(cos)), key=cos.__getitem__)
        log(f"7(a) {name} 4-layer vl B=8: loss kernel {loss_k:.7f} plain {loss_p:.7f}; "
            f"gradient cosine kernel vs plain per parameter min {cos[worst]:.9f} "
            f"({names[worst]}), median {sorted(cos)[len(cos) // 2]:.9f}, "
            f"{len(cos)} parameters")
        if not bf16:
            ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and cos[worst] >= 1 - 1e-6
            ref32 = grads_p
        else:
            cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
            gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
            total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                                 [torch.cat([g.flatten() for g in grads_p])])[0]
            log(f"7(a) bf16 vs the fp32 gradients: min cosine kernel path {min(cos_k):.6f}, "
                f"plain path {min(cos_p):.6f}; largest shortfall of the kernel path "
                f"{cos_p[gap] - cos_k[gap]:.2e} ({names[gap]}); all parameters together "
                f"kernel vs plain {total:.9f}")
            ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
                  and cos_p[gap] - cos_k[gap] <= 0.01)
        if not ok:
            raise RuntimeError(f"7(a) {name}: kernel and plain training paths disagree")
        runs.clear()
        del grads_k, grads_p
        losses = {}
        for impl in ("pallas", "xla"):
            trainer = make_trainer(cfg)
            trainer.model.cfg.encoder.attn_impl = impl
            losses[impl] = [trainer.train_step(batch)["loss"] for _ in range(3)]
            del trainer
        log(f"7(a) {name} 3 AdamW steps: losses kernel {losses['pallas']}, plain {losses['xla']}")
        tol = 2e-2 if bf16 else 1e-4
        for a, b in zip(losses["pallas"], losses["xla"]):
            if abs(a - b) > tol * abs(b):
                raise RuntimeError(f"7(a) {name}: step losses disagree")
        torch.cuda.empty_cache()


def train_full_depth(gen, card: str) -> dict:
    """Phase 7(b): the depth-40 vl model, bf16 compute, fp32 master AdamW,
    remat, drop path 0.5 (the recipe's); B=32, or 16 if 32 does not fit.
    Every step sees the same batch and the same drop-path masks (the
    trainer's generator is reset before each), so the loss must fall."""
    cfg = train_config(layers=40, bf16=True, remat=True, drop_path=0.5)
    trainer = make_trainer(cfg)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"7(b) 4B vl model: {n_params / 1e9:.3f}B parameters, fp32 master + AdamW state")
    enc = trainer.model.cfg.encoder
    rng_state = trainer.generator.get_state()
    for b in (32, 16):
        batch = train_batch(cfg, gen, b)
        try:
            torch.cuda.reset_peak_memory_stats()
            trainer.generator.set_state(rng_state)
            first = trainer.train_step(batch)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"7(b) B={b} does not fit on the card")
            if b == 16:
                raise
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"7(b) running B={b} (first step, warm-up: loss {first['loss']:.5f}, "
        f"{first['step_time'] * 1e3:.0f} ms)")
    flops = 4 * (analytic_flops(cfg.model, 257, b, "image")
                 + analytic_flops(cfg.model, 71, b, "text"))
    layers = cfg.model.encoder.layers
    result = {"batch": b}
    for impl, steps in (("pallas", 3), ("xla", 1)):
        enc.attn_impl = impl
        fa.launches = fa.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(metrics["loss"])
        launched = (fa.launches, fa.bwd_launches)
        want = (steps * 2 * layers * 2, steps * 2 * layers) if impl == "pallas" else (0, 0)
        ms = 1e3 * sum(times) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflops = flops / ms / 1e9
        log(f"7(b) {impl} B={b}: {ms:.1f} ms per step, {b / ms * 1e3:.1f} pairs/s, "
            f"{tflops:.1f} TFLOP/s = {100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU, peak "
            f"{peak:.1f} GiB, losses {[round(x, 5) for x in losses]}, launches fwd "
            f"{launched[0]} bwd {launched[1]} (expected {want[0]} and {want[1]}) ({card})")
        if launched != want:
            raise RuntimeError(f"7(b) {impl}: launches {launched}, expected {want}")
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"7(b) {impl}: non-finite loss")
        result[impl] = {"ms": ms, "peak_gib": peak, "losses": losses,
                        "launches": launched}
    losses = [first["loss"], *result["pallas"]["losses"], *result["xla"]["losses"]]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"7(b): the loss on a repeated batch did not fall: {losses}")
    enc.attn_impl = "pallas"
    trainer.generator.set_state(rng_state)
    profile_call(lambda: trainer.train_step(batch), result["pallas"]["ms"], "7(b)",
                 "train_profile.txt")
    return result


def profile_call(fn, wall_ms: float, label: str, file_name: str) -> tuple:
    """One kernel-path call under torch.profiler: device time by event name
    (``device_times``), and the device's busy time against the unprofiled
    call's ``wall_ms`` (one stream, so kernels do not overlap).  Returns
    ``device_times``' rows and busy ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, busy = device_times(prof)
    table = device_table(rows, busy, 25)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / file_name).write_text(table)
    log(f"{label} profiled kernel-path call, top event names by device time:")
    for line in table.splitlines()[:16]:
        log(f"  {line}")
    log(f"{label} device busy {busy:.1f} ms of the unprofiled {wall_ms:.1f} ms: "
        f"idle {100 * (1 - busy / wall_ms):.0f}%")
    return rows, busy


def make_inputs(cfg, gen, n_img, n_aud, n_txt):
    """Images at 256 px, 10 s clips (the second padded to 6 s), 32-token
    texts with pads."""
    spec = cfg.encoder.audio_adapter.feature_encoder_spec
    imgs = torch.randn(n_img, 3, 256, 256, generator=gen, device="cuda")
    samples = 16000 * AUDIO_SECONDS
    wav = torch.randn(n_aud, samples, generator=gen, device="cuda")
    frames = conv_output_length(samples, spec)
    pad = torch.zeros(n_aud, frames + 1, dtype=torch.bool, device="cuda")
    if n_aud > 1:
        wav[1, 16000 * 6:] = 0
        pad[1, 1 + conv_output_length(16000 * 6, spec):] = True
    vocab = cfg.encoder.text_adapter.vocab_size
    tokens = torch.randint(4, vocab, (n_txt, 32), generator=gen, device="cuda")
    for row in range(1, n_txt):
        tokens[row, 32 - 5 * row:] = cfg.encoder.text_adapter.padding_idx
    return {"image": {"src_images": imgs},
            "audio": {"src_audios": wav, "audio_padding_masks": pad},
            "text": {"src_tokens": tokens}}


def check_slice(cfg, inputs, dtype, min_cos: float, reference=None) -> dict:
    """Phase 4 for one dtype: kernel path vs plain path on the same weights.
    Returns the plain path's embeddings; ``reference`` (the fp32 plain
    path's) is compared with both paths as information."""
    t0 = time.time()
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=dtype)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"4B model {str(dtype)[6:]}: {n_params / 1e9:.3f}B params on the card "
        f"({time.time() - t0:.1f} s to build and fill)")
    plain = {}
    with torch.inference_mode():
        for encoder_type, kwargs in inputs.items():
            outs = {}
            for impl in ("pallas", "xla"):
                model.cfg.encoder.attn_impl = impl
                before = fa.launches
                out = model(encoder_type=encoder_type, **kwargs)
                torch.cuda.synchronize()
                launched = fa.launches - before
                want = model.cfg.encoder.layers if impl == "pallas" else 0
                if launched != want:
                    raise RuntimeError(f"{encoder_type} {impl}: {launched} kernel "
                                       f"launches, expected {want}")
                outs[impl] = out.float()
            got, ref = outs["pallas"], outs["xla"]
            b = next(iter(kwargs.values())).shape[0]
            if got.shape != (b, cfg.encoder.embed_dim) or not torch.isfinite(got).all():
                raise RuntimeError(f"{encoder_type}: bad embeddings {tuple(got.shape)}")
            norm_err = (got.norm(dim=-1) - 1).abs().max().item()
            cos = min_cosine(got, ref)
            log(f"slice {str(dtype)[6:]} {encoder_type} B={b}: min cosine kernel vs plain "
                f"{cos:.9f} (bound {min_cos}), max |norm-1| {norm_err:.2e}, "
                f"{cfg.encoder.layers} launches per kernel-path forward")
            if reference is not None:
                ref32 = reference[encoder_type]
                log(f"  vs the fp32 plain path: min cosine kernel "
                    f"{min_cosine(got, ref32):.6f}, plain {min_cosine(ref, ref32):.6f}")
            plain[encoder_type] = ref
            if norm_err > 1e-2:
                raise RuntimeError(f"{encoder_type}: embedding norms off by {norm_err}")
            if cos < min_cos:
                raise RuntimeError(f"{encoder_type}: kernel and plain paths disagree")
    model.cfg.encoder.attn_impl = "pallas"
    return plain


def time_paths(cfg, card: str):
    """Phase 5: e2e and attention-only times, kernel path and plain path.
    Returns ``time_attention``'s rows with the kernel path's images/s and
    clips/s under "bf16_rates"."""
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = make_inputs(cfg, gen, IMG_BATCH, AUD_BATCH, 1)
    inputs["audio"]["audio_padding_masks"].zero_()  # bench.py: unpadded clips
    inputs["image"]["src_images"] = inputs["image"]["src_images"].bfloat16()
    frames = inputs["audio"]["audio_padding_masks"].shape[1]
    work = {"image": (IMG_BATCH, 257, analytic_flops(cfg, 257, IMG_BATCH, "image")),
            "audio": (AUD_BATCH, frames, analytic_flops(
                cfg, frames, AUD_BATCH, "audio", 16000 * AUDIO_SECONDS))}
    rates = {}
    with torch.inference_mode():
        for encoder_type in ("image", "audio"):
            b, _, flops = work[encoder_type]
            for impl in ("pallas", "xla"):
                model.cfg.encoder.attn_impl = impl
                ms = cuda_time_ms(lambda: model(encoder_type=encoder_type,
                                                **inputs[encoder_type]), iters=3, warmup=1)
                if impl == "pallas":
                    rates[encoder_type] = b / ms * 1e3
                tflops = flops / ms / 1e9
                log(f"e2e {encoder_type} B={b} bf16 {impl}: {ms:.1f} ms per batch, "
                    f"{b / ms * 1e3:.1f} {encoder_type}s/s, {tflops:.1f} TFLOP/s = "
                    f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% of {H100_BF16_PEAK_TFLOPS:.0f} "
                    f"({card})")
    model.cfg.encoder.attn_impl = "pallas"
    del model, inputs
    torch.cuda.empty_cache()
    return {**time_attention(gen, cfg.encoder.attention_heads, frames, card),
            "bf16_rates": rates}


def time_attention(gen, heads: int, frames: int, card: str) -> dict:
    """Phase 5's attention times: ms per layer of the forward kernel and of
    SDPA with the additive mask, in turns, at the image (B=256, L=257),
    audio (B=32, L=frames) and text (B=32, L=71, pads) shapes; beside them
    the kernel writing the statistics a gradient needs, and the plain
    version.  Returns L=257's numbers with the others under "shapes"."""
    attn_ms = {}
    for b, l, pads in ((IMG_BATCH, 257, False), (AUD_BATCH, frames, False), (32, 71, True)):
        q, k, v = (torch.randn(b, l, heads * 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        bias = torch.randn(heads, l, l, generator=gen, device="cuda")
        key_bias = (torch.zeros(b, l, device="cuda").masked_fill(text_pad_mask(b, l), fa.NEG_INF)
                    if pads else None)
        q4, k4, v4 = (x.view(b, l, heads, 64).transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(bias, key_bias, b)
        t = in_turns({
            "kernel": lambda: fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=20)
        stats_ms = cuda_time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, bias, key_bias, 0.125, heads, with_stats=True), iters=20)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, bias, key_bias, 0.125, heads), iters=5)
        flops = 4 * b * heads * l * l * 64
        kb_bytes = 0 if key_bias is None else key_bias.numel() * 4
        bound = bound_ms(4 * q.numel() * 2 + bias.numel() * 4 + kb_bytes, flops,
                         H100_BF16_PEAK_TFLOPS * 1e12)
        plan = fa.tile_plan(l)
        log(f"attention per layer B={b} L={l}{' text pads' if pads else ''} bf16: kernel "
            f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} TFLOP/s; with the "
            f"statistics {stats_ms:.4f}), {t['kernel'] / t['sdpa']:.3f}x SDPA with the additive "
            f"mask {t['sdpa']:.4f} ms (in turns); plain {plain_ms:.3f} ms; bound "
            f"{bound[0]:.4f} ms by {bound[1]}; plan {FWD_BRANCHES[plan.resident]}, last tile "
            f"{plan.tail} wide ({card})")
        attn_ms[l] = {"ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
                      "bound_ms": bound[0], "bound_by": bound[1], "stats_ms": stats_ms,
                      "batch": b}
        del q, k, v, bias, key_bias, q4, k4, v4, mask
        torch.cuda.empty_cache()
    main = attn_ms.pop(257)
    main["shapes"] = {f"L={l} B={row.pop('batch')}" + (" text pads" if l == 71 else ""): row
                      for l, row in attn_ms.items()}
    return main


FFN_SHAPES = [(65792, 1536, 6144), (65792, 6144, 1536), (65792, 1536, 1536)]  # (M, K, N)
RAGGED_SHAPES = [(13, 100, 70), (260, 520, 515)]  # tests/test_quant.py:141's
# M below one tile; a tile count that leaves a partial last wave on 132 SMs;
# the audio rows (B=32 at L=501)
EDGE_SHAPES = [(64, 1536, 6144), (4100, 1536, 6144), (16032, 6144, 1536)]


def check_int8_kernels(gen) -> dict:
    """Phase 8 (a): the row quantize and the GEMM against their plain
    versions, bit for bit, at the serving path's shapes (M = 65,792 image
    rows at B=256, 16,032 audio rows at B=32), ragged ones and the GEMM
    plan's edges.  Returns the largest differences (0)."""
    worst = {"quantize": 0.0, "gemm": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for m, k in ((65792, 1536), (65792, 6144), (16032, 6144), (13, 100)):
            x = (torch.randn(m, k, generator=gen, device="cuda") * 2).to(dtype)
            got = im.int8_quantize_rows_cuda(x)
            torch.cuda.synchronize()
            want = im.int8_quantize_rows_plain(x)
            err = max((got[0].int() - want[0].int()).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            worst["quantize"] = max(worst["quantize"], float(err))
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            log(f"int8 quantize vs plain {str(dtype)[6:]} ({m} x {k}): "
                f"{'bit-equal' if same else f'DIFFERENT, max |d| {err}'}")
            if not same:
                raise RuntimeError(f"int8 quantize kernel disagrees at {dtype} ({m}, {k})")
            del x, got, want
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the plan's edges draw from a generator of their own, so that `gen`
    # reaches the later phases (11 and 12) in the state it always had
    extra = torch.Generator(device="cuda").manual_seed(4)
    for m, k, n in FFN_SHAPES + RAGGED_SHAPES + EDGE_SHAPES:
        rng = extra if (m, k, n) in EDGE_SHAPES else gen
        x_q = torch.randint(-127, 128, (m, k), generator=rng, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=rng, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=rng, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=rng, device="cuda") * 0.01 + 1e-4
        bias = torch.randn(n, generator=rng, device="cuda")
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                got = im.int8_matmul_cuda(x_q, w_q, sx, sw, b, out_dtype)
                torch.cuda.synchronize()
                want = im.int8_matmul_plain(x_q, w_q, sx, sw, b, out_dtype)
                err = (got.float() - want.float()).abs().max().item()
                worst["gemm"] = max(worst["gemm"], err)
                if not torch.equal(got, want):
                    raise RuntimeError(f"int8 GEMM disagrees at ({m}, {k}, {n}) "
                                       f"{out_dtype} bias={b is not None}: max {err}")
                del got, want
        plan = im.gemm_plan(m, n, k, sms)
        log(f"int8 GEMM vs plain ({m}, {k}, {n}): bit-equal in fp32 and bf16, with and "
            f"without bias ({plan.tiles_m * plan.tiles_n} tiles on a grid of {plan.grid})")
    torch.cuda.empty_cache()
    return worst


def gemm_bound(m: int, k: int, n: int) -> tuple:
    """x_q, w_q, the scales read once and y written once in bf16; 2MKN
    integer operations at the int8 peak."""
    return bound_ms(m * k + n * k + 4 * (m + n) + 2 * m * n, 2 * m * k * n,
                    H100_INT8_PEAK_TOPS * 1e12)


def time_int8_kernels(gen, card: str) -> dict:
    """Phase 8 (b): the row quantize at both FFN inputs and the GEMM at the
    three FFN shapes, each beside its plain version; the GEMM in turns with
    bf16 ``torch.matmul`` on the same product and ``torch._int_mm`` with the
    scales (information: neither is used by the port)."""
    times = {}
    extra = torch.Generator(device="cuda").manual_seed(5)  # the wo input's (see check_int8_kernels)
    for m, k in ((65792, 1536), (65792, 6144)):
        x = torch.randn(m, k, generator=gen if k == 1536 else extra, device="cuda",
                        dtype=torch.bfloat16)
        kernel_ms = cuda_time_ms(lambda: im.int8_quantize_rows_cuda(x), iters=20)
        plain_ms = cuda_time_ms(lambda: im.int8_quantize_rows_plain(x), iters=5)
        bound = bound_ms(x.numel() * 3 + m * 4, 3 * x.numel(), H100_FP32_PEAK_TFLOPS * 1e12)
        log(f"int8 quantize ({m} x {k}) bf16: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({100 * bound[0] / kernel_ms:.1f}% of it) ({card})")
        times[(m, k)] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "library_ms": None}
        del x
    for m, k, n in FFN_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(m, device="cuda"), torch.rand(n, device="cuda")
        xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        turns = in_turns({
            "kernel": lambda: im.int8_matmul_cuda(x_q, w_q, sx, sw, None, torch.bfloat16),
            "bf16": lambda: xb @ wb.T,
            "library": lambda: (torch._int_mm(x_q, w_q.t()) * sx[:, None]
                                * sw[None, :]).to(torch.bfloat16)}, iters=10)
        plain_ms = cuda_time_ms(lambda: im.int8_matmul_plain(x_q, w_q, sx, sw, None,
                                                             torch.bfloat16), iters=3, warmup=1)
        bound = gemm_bound(m, k, n)
        tops = 2 * m * k * n / turns["kernel"] / 1e9
        log(f"int8 GEMM ({m}, {k}, {n}) -> bf16: kernel {turns['kernel']:.4f} ms ({tops:.1f} "
            f"TOPS = {100 * tops / H100_INT8_PEAK_TOPS:.1f}% of {H100_INT8_PEAK_TOPS:.0f}; "
            f"{100 * bound[0] / turns['kernel']:.1f}% of its bound {bound[0]:.4f} ms by "
            f"{bound[1]}), plain {plain_ms:.3f} ms; bf16 torch.matmul {turns['bf16']:.4f} ms "
            f"({2 * m * k * n / turns['bf16'] / 1e9:.1f} TFLOP/s); torch._int_mm with the "
            f"scales {turns['library']:.4f} ms ({card})")
        times[(m, k, n)] = {"ms": turns["kernel"], "plain_ms": plain_ms,
                            "bf16_ms": turns["bf16"], "library_ms": turns["library"],
                            "bound_ms": bound[0], "bound_by": bound[1]}
        del x_q, w_q, xb, wb
    torch.cuda.empty_cache()
    return times


@contextlib.contextmanager
def plain_int8():
    """The int8 serving path on the plain versions (the comparison side of
    phase 9): ``ops.quant`` reaches the dispatchers through the module."""
    saved = im.int8_quantize_rows, im.int8_matmul
    im.int8_quantize_rows, im.int8_matmul = im.int8_quantize_rows_plain, im.int8_matmul_plain
    try:
        yield
    finally:
        im.int8_quantize_rows, im.int8_matmul = saved


def write_bpe_dir(path: Path) -> str:
    """A byte-level BPE set: encoder.json over the 256 byte symbols, no
    merges, a 256-row dict.txt (the GPT-2 assets are not in the repo)."""
    path.mkdir(parents=True, exist_ok=True)
    symbols = bytes_to_unicode()
    (path / "encoder.json").write_text(json.dumps({symbols[b]: b for b in range(256)}))
    (path / "vocab.bpe").write_text("#version: 0.2\n")
    (path / "dict.txt").write_text("".join(f"{i} 1\n" for i in range(256)))
    return str(path)


def smooth_images(n: int, rng) -> list:
    """n PIL RGB images of low-frequency patterns, sizes around 256 px."""
    from PIL import Image

    out = []
    for i in range(n):
        h, w = 300 + 37 * i, 260 + 53 * i
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (17 + 5 * c + rng.rand() * 9) + yy / (23 + 3 * c)) for c in range(3)]
        out.append(Image.fromarray(((np.stack(chans, -1) * 0.45 + 0.5) * 255).astype(np.uint8)))
    return out


def write_hub_pt(work: Path) -> tuple:
    """Phase 9's set-up: a BPE set and a 2-layer full-width fairseq ``.pt``
    from ``make_random_state_dict`` (seed 0) under ``work``."""
    work.mkdir(parents=True, exist_ok=True)
    bpe = write_bpe_dir(work / "bpe")
    cfg = ModelConfig(head_type="val")
    cfg.encoder.layers = 2
    sd = make_random_state_dict(cfg, seed=0)
    pt = work / "model.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    return bpe, pt


def serve_int8(card: str, prep: "Prep") -> dict:
    """Phase 9: int8 serving at full width through the hub: "none", "ffn"
    and "ffn_attn" in fp32 and bf16.  fp32 loads once through
    ``from_pretrained`` and is quantized in place ("ffn", then its attention
    for "ffn_attn", as ``quantize_ffn_`` skips what is already int8); bf16
    "none" is those fp32 weights cast before the quantize (the cast
    ``from_pretrained(dtype="bf16")`` makes), and bf16 "ffn" and "ffn_attn"
    load through ``from_pretrained(dtype="bf16", quantize=...)``.  Returns
    the int8 kernels' launch counts over the kernel-path forwards."""
    cfg = ModelConfig(head_type="val")
    cfg.encoder.layers = 2
    bpe, pt = prep.take("9", "a 2-layer full-width fairseq .pt")

    rng = np.random.RandomState(0)
    texts = ["a dog barking in the rain", "two cats", "an orchestra tuning up before the show",
             "waves"]
    images = smooth_images(4, rng)
    wavs = [rng.randn(16000 * AUDIO_SECONDS).astype(np.float32) * 0.1,
            rng.randn(16000 * 6).astype(np.float32) * 0.1]
    launched = {"gemm": 0, "quantize": 0}
    task = TaskConfig()
    bounds = {"float32": 1 - 1e-6, "bf16": 0.999}
    weights32 = None
    for dtype in ("float32", "bf16"):
        reference, inputs = None, None
        for quantize in ("none", "ffn", "ffn_attn"):
            t0 = time.time()
            if dtype == "float32" and quantize != "none":
                quantize_ffn_(hub.model, include_attn=quantize == "ffn_attn")
                how = "quantize_ffn_ in place on the loaded fp32 model"
            elif dtype == "bf16" and quantize == "none":
                hub = port_hub.OnePeaceHubInterface(cfg, task, weights32.to(torch.bfloat16),
                                                    dtype=torch.bfloat16, bpe_dir=bpe)
                weights32 = None
                how = "the loaded fp32 weights cast"
            else:
                hub = port_hub.from_pretrained(str(pt), dtype=dtype, bpe_dir=bpe, model_cfg=cfg,
                                               task_cfg=task, quantize=quantize, device="cuda")
                how = "from_pretrained"
                if dtype == "float32":
                    weights32 = copy.deepcopy(hub.model)
            log(f"9: {dtype} quantize={quantize} ({how}): {time.time() - t0:.1f} s")
            if inputs is None:
                inputs = {"text": {"src_tokens": hub.process_text(texts)},
                          "image": {"src_images": hub.process_image(images)},
                          "audio": dict(zip(("src_audios", "audio_padding_masks"),
                                            hub.process_audio(wavs)))}
                check_on_device_images(hub, images)
            extract = {"text": hub.extract_text_features, "image": hub.extract_image_features,
                       "audio": hub.extract_audio_features}
            if quantize == "none":
                reference = {m: extract[m](**kw).float() for m, kw in inputs.items()}
                if dtype == "bf16":
                    del hub
                continue
            want = (6, 4) if quantize == "ffn" else (14, 8)
            for modality, kwargs in inputs.items():
                im.launches = im.quantize_launches = 0
                got = extract[modality](**kwargs).float()
                torch.cuda.synchronize()
                counts = (im.launches, im.quantize_launches)
                launched["gemm"] += counts[0]
                launched["quantize"] += counts[1]
                with plain_int8():
                    im.launches = im.quantize_launches = 0
                    plain = extract[modality](**kwargs).float()
                    if (im.launches, im.quantize_launches) != (0, 0):
                        raise RuntimeError("9: the plain int8 path launched a kernel")
                b = next(iter(kwargs.values())).shape[0]
                if got.shape != (b, cfg.encoder.embed_dim) or not torch.isfinite(got).all():
                    raise RuntimeError(f"9: bad {modality} embeddings {tuple(got.shape)}")
                cos = min_cosine(got, plain)
                log(f"9: {dtype} {quantize} {modality} B={b}: min cosine kernel vs plain int8 "
                    f"{cos:.9f} (bound {bounds[dtype]}); vs unquantized {dtype} "
                    f"{min_cosine(got, reference[modality]):.6f}; launches per forward "
                    f"{counts[0]} GEMM, {counts[1]} quantize (expected {want[0]}, {want[1]})")
                if counts != want:
                    raise RuntimeError(f"9: {quantize} launched {counts}, expected {want}")
                if cos < bounds[dtype]:
                    raise RuntimeError(f"9: {dtype} {quantize} {modality}: kernel and plain "
                                       f"int8 paths disagree")
            if dtype == "bf16" or quantize == "ffn_attn":
                del hub
                torch.cuda.empty_cache()
    time_int8_paths(card, bpe)
    return launched


def check_on_device_images(hub, images) -> None:
    """process_image(on_device=True) against the host PIL path (the JAX
    package documents ~1e-2 in normalised units between the two), and the
    card's resize against the same function on the CPU."""
    host = hub.process_image(images).float()
    dev = hub.process_image(images, on_device=True).float()
    vs_cpu = 0.0
    for img in images:
        a, b = (resize_normalize(torch.from_numpy(np.array(img)).to(where), 256,
                                 port_hub.CLIP_MEAN,
                                 port_hub.CLIP_STD).cpu() for where in ("cuda", "cpu"))
        vs_cpu = max(vs_cpu, (a - b).abs().max().item())
    vs_host = (dev - host).abs()
    log(f"9: process_image(on_device=True) {hub.dtype}: vs the host PIL path max |d| "
        f"{vs_host.max().item():.3e} mean {vs_host.mean().item():.3e}; fp32 resize on the "
        f"card vs on the CPU max |d| {vs_cpu:.3e}")
    if vs_host.mean().item() > 2e-2 or vs_cpu > 1e-4:
        raise RuntimeError("9: the on-device image path disagrees")


def time_int8_paths(card: str, bpe: str) -> None:
    """Phase 9 times: the model at depth ``CUT_DEPTH`` in bf16 through the
    hub at bench.py's batches, bf16 / "ffn" / "ffn_attn" (the int8 models are
    quantized copies of the same bf16 weights)."""
    cfg = ModelConfig(head_type="val")
    cfg.encoder.layers = CUT_DEPTH
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    hubs = {"bf16": port_hub.OnePeaceHubInterface(cfg, TaskConfig(), model,
                                                  dtype=torch.bfloat16, bpe_dir=bpe)}
    for mode in ("ffn", "ffn_attn"):
        hubs[mode] = port_hub.OnePeaceHubInterface(
            cfg, TaskConfig(), quantize_ffn_(copy.deepcopy(model), include_attn=mode == "ffn_attn"),
            dtype=torch.bfloat16, bpe_dir=bpe)
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = make_inputs(cfg, gen, IMG_BATCH, AUD_BATCH, 1)
    inputs["audio"]["audio_padding_masks"].zero_()
    images = inputs["image"]["src_images"].bfloat16()
    audio = (inputs["audio"]["src_audios"].bfloat16(), inputs["audio"]["audio_padding_masks"])
    per_layer = {"ffn": (3, 2), "ffn_attn": (7, 4)}  # (GEMM, quantize) launches per layer
    for mode, (gemms, quantizes) in per_layer.items():
        im.launches = im.quantize_launches = 0
        hubs[mode].extract_image_features(images)
        counts = (im.launches, im.quantize_launches)
        want = (gemms * cfg.encoder.layers, quantizes * cfg.encoder.layers)
        log(f"9: depth {CUT_DEPTH} image B={IMG_BATCH} {mode}: {counts[0]} GEMM and {counts[1]} "
            f"quantize launches per forward (expected {want[0]} and {want[1]})")
        if counts != want:
            raise RuntimeError(f"9: depth-{CUT_DEPTH} {mode} launched {counts}, expected {want}")
    for modality, b in (("image", IMG_BATCH), ("audio", AUD_BATCH)):
        for mode in ("bf16", "ffn", "ffn_attn", "ffn_attn", "ffn", "bf16"):
            hub = hubs[mode]
            fn = ((lambda: hub.extract_image_features(images)) if modality == "image"
                  else (lambda: hub.extract_audio_features(*audio)))
            ms = cuda_time_ms(fn, iters=2, warmup=1)
            log(f"9: depth {CUT_DEPTH} {modality} B={b} {mode}: {ms:.1f} ms per batch, "
                f"{b / ms * 1e3:.1f} {modality}s/s ({card})")
    del hubs, model, inputs
    torch.cuda.empty_cache()


GOLDEN_STATE_DIR = ROOT / "build" / "golden_state"


def _golden_state_child(conn, out_dir: str) -> None:
    """Phase 10's host half, in a process of its own: the seeded 4B fairseq
    state regenerated (numpy's Gaussian draws hold the GIL, so a thread
    would slow the parent's host-bound phases) and converted by the port's
    ``.pt`` route, then written tensor by tensor as raw files under
    ``out_dir``; only their names, dtypes, shapes and paths go through
    ``conn``.  (Sent through the pipe, the 16 GB took 21-35 s to receive, and
    ~150 s in some runs.)"""
    try:
        torch.set_num_threads(1)
        cfg = ModelConfig(head_type="val")
        t0 = time.time()
        sd = make_random_state_dict(cfg, seed=golden.SD_SEED)
        t_gen = time.time() - t0
        t0 = time.time()
        state = convert_retrieval_model(sd, cfg)
        del sd
        t_conv = time.time() - t0
        t0 = time.time()
        out = Path(out_dir)
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        tensors = []
        for i, name in enumerate(list(state)):
            arr = state.pop(name).contiguous().numpy()
            path = out / f"{i}.bin"
            arr.tofile(path)
            tensors.append((name, arr.dtype.str, arr.shape, str(path)))
        conn.send({"tensors": tensors, "t_gen": t_gen, "t_conv": t_conv,
                   "t_write": time.time() - t0})
    except BaseException as e:
        conn.send({"error": repr(e)})
        raise
    finally:
        conn.close()


class GoldenState:
    """Starts ``_golden_state_child`` (spawned: it never touches the card)
    and reads its state, memory-mapped, into a model on the card."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_golden_state_child,
                                args=(child, str(GOLDEN_STATE_DIR)), daemon=True)
        self.proc.start()
        child.close()

    def load_into(self, model: torch.nn.Module) -> dict:
        """The child's state into ``model`` (strict: the same names and
        shapes); its files are removed after.  Returns its times, this
        call's wait for them and the read's time."""
        t0 = time.time()
        head = self.conn.recv()
        waited = time.time() - t0
        if "error" in head:
            raise RuntimeError(f"10: the golden state's process failed: {head['error']}")
        params = model.state_dict()
        if sorted(name for name, *_ in head["tensors"]) != sorted(params):
            raise RuntimeError("10: the converted state's names are not the model's")
        t0 = time.time()
        for name, dtype, shape, path in head["tensors"]:
            if tuple(params[name].shape) != tuple(shape):
                raise RuntimeError(f"10: {name} is {shape}, the model has "
                                   f"{tuple(params[name].shape)}")
            arr = (np.fromfile(path, dtype=np.dtype(dtype)).reshape(shape) if not shape
                   else np.memmap(path, dtype=np.dtype(dtype), mode="c", shape=tuple(shape)))
            params[name].copy_(torch.from_numpy(arr))
            del arr
        torch.cuda.synchronize()
        read = time.time() - t0
        self.stop(wait=60.0)
        shutil.rmtree(GOLDEN_STATE_DIR, ignore_errors=True)
        return {**head, "waited": waited, "read": read}

    def stop(self, wait: float = 0.0) -> None:
        """Close the pipe; end the child if it is not done within ``wait`` s."""
        self.conn.close()
        self.proc.join(wait)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()
        if wait == 0.0:
            shutil.rmtree(GOLDEN_STATE_DIR, ignore_errors=True)


def _timed(fn, *args):
    """``fn(*args)`` and its wall time, in a ``Prep`` worker."""
    t0 = time.time()
    return fn(*args), time.time() - t0


class Prep:
    """Host-only set-up -- the seeded fairseq ``.pt`` files and the data
    trees under ``build/`` -- written by two spawned processes (numpy holds
    the GIL while it draws, and none of this touches the card) while the
    card runs the phases before the one that reads each.  ``jobs`` maps a
    phase to ``(fn, *args)`` of a module-level function; the files are the
    same ones the phase would write itself."""

    def __init__(self, jobs: Optional[dict] = None):
        self.pool, self.futures = None, {}
        if jobs:
            self.start(jobs)

    def start(self, jobs: dict) -> None:
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {phase: self.pool.submit(_timed, *job) for phase, job in jobs.items()}

    def take(self, phase: str, what: str):
        """The job's result, once it is done; logs its time and this wait."""
        t0 = time.time()
        out, took = self.futures.pop(phase).result()
        log(f"{phase}: {what} written in {took:.1f} s in a set-up process; this phase waited "
            f"{time.time() - t0:.1f} s for it")
        return out

    def stop(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def prep_jobs() -> dict:
    """Every phase's host-only set-up, in the order the phases read it."""
    return {"9": (write_hub_pt, ROOT / "build" / "smoke_hub"),
            "13": (write_retrieval_corpus, RETRIEVAL_DIR),
            "14": (write_coco_corpus, COCO_DIR, 16, 8),
            "15(a)": (write_classify_hub_pts, ROOT / "build" / "smoke_classify_hub"),
            "15(c)": (write_classify_corpus, CLASSIFY_DIR, 96, 64),
            # 11 VL batches of 32: no epoch ends inside 16(d)'s window
            "16": (write_pretrain_corpus, PRETRAIN_DIR, 352, 32, (14.0, 15.0)),
            "17(d)": (write_seg_eval_setup, SEG_EVAL_LAYERS),
            "18(c)": (write_ade_corpus, SEG_TRAIN_DIR, 6, 2),
            "19": (write_k400_corpus, K400_DIR, 24, 8),
            "20": (write_classify_rest_corpus, CLASSIFY_REST_DIR, 96, 8)}


def check_golden(source: GoldenState, fp16_runs: dict) -> tuple:
    """Phase 10: the depth-40 golden through the port's .pt route, fp32,
    kernel path, the state from ``source``; then 21(b)'s fp16 run of the
    same inputs on the same state, cast (``check_golden_fp16``; its
    launches kept in ``fp16_runs``).  Returns the fp32 and the fp16
    cosines."""
    cfg = ModelConfig(head_type="val")  # the defaults are the golden's 4B geometry
    enc = cfg.encoder
    if (enc.embed_dim, enc.ffn_embed_dim, enc.layers, enc.attention_heads) != (1536, 6144, 40, 24):
        raise RuntimeError("10: the port's ModelConfig defaults are not the 4B geometry")
    t0 = time.time()
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.float32)
    got = source.load_into(model)
    log(f"10: 4B state from the seed in {got['t_gen']:.1f} s, converted by the port in "
        f"{got['t_conv']:.1f} s and written under build/ in {got['t_write']:.1f} s, in a "
        f"process started with the script; this phase waited {got['waited']:.1f} s for it, "
        f"read it memory-mapped onto the card in {got['read']:.1f} s and had it there after "
        f"{time.time() - t0:.1f} s")
    imgs = torch.from_numpy(np.random.RandomState(golden.IMAGE_SEED).randn(
        *golden.IMAGE_SHAPE).astype(np.float32)).cuda()
    wav = torch.from_numpy(np.random.RandomState(golden.AUDIO_SEED).randn(
        1, golden.AUDIO_LEN).astype(np.float32)).cuda()
    frames = conv_output_length(golden.AUDIO_LEN, cfg.encoder.audio_adapter.feature_encoder_spec)
    apad = torch.zeros(1, frames + 1, dtype=torch.bool, device="cuda")
    apad[0, -7:] = True
    tokens = torch.from_numpy(golden.TOKENS).cuda()
    fa.launches = 0
    with torch.inference_mode():
        out = {"text": model(src_tokens=tokens, encoder_type="text"),
               "image": model(src_images=imgs, encoder_type="image"),
               "audio": model(src_audios=wav, audio_padding_masks=apad, encoder_type="audio")}
        text_f, image_f, _ = model.encoder_wrapper(src_tokens=tokens[:1], src_images=imgs,
                                                   encoder_type="vl")
        out["vl"] = torch.cat([text_f, image_f], dim=1)
    torch.cuda.synchronize()
    if fa.launches != 4 * cfg.encoder.layers:
        raise RuntimeError(f"10: {fa.launches} attention launches, expected "
                           f"{4 * cfg.encoder.layers}")
    ref = np.load(golden.GOLDEN)
    report = {}
    for key, value in out.items():
        a = value.double().cpu().flatten()
        b = torch.from_numpy(ref[f"emb_{key}"]).double().flatten()
        report[key] = (a @ b / (a.norm() * b.norm())).item()
    log(f"10: depth-40 golden, fp32 kernel path, cosine: "
        + ", ".join(f"{k} {v:.9f}" for k, v in report.items()) + " (bound 1-1e-3)")
    if min(report.values()) < 1 - 1e-3:
        raise RuntimeError(f"10: the port misses the depth-40 golden: {report}")
    out.pop("vl")
    report16 = check_golden_fp16(model, {"text": {"src_tokens": tokens}, "image": imgs,
                                         "audio": (wav, apad)}, out, fp16_runs)
    del model, out
    torch.cuda.empty_cache()
    return report, report16


DET_HEADS = 24
DET_CASES = [  # (B, hg, wg, toep, decomp): the global grid at 1024 px, its 16 x 16
    # windows (16 per image, B=2), the windows with each bias alone and none,
    # the ragged 50 x 50 global grid of an 800 px image, a one-row grid, an
    # 8 x 8 grid (a 64-token tile holds 8 grid rows) and a wide 80 x 80 grid
    # (the forward's plan stages the bias where wg is even and divides 64, and
    # gathers it per score on the 50 x 50 and 80 x 80 grids)
    (2, 64, 64, True, True), (32, 16, 16, True, True), (32, 16, 16, True, False),
    (32, 16, 16, False, True), (32, 16, 16, False, False), (2, 50, 50, True, True),
    (2, 1, 64, True, True), (2, 8, 8, True, True), (1, 80, 80, True, True)]
DET_FWD_MODES = {da.FWD_GATHER: "gather", da.FWD_SLAB: "slab, bw in registers"}


def det_operands(gen, b, hg, wg, dtype, toep_on=True, decomp_on=True):
    """q/k/v (B, L, 24*64) and fp32 biases of the trunk's magnitudes."""
    l = hg * wg
    q, k, v = (torch.randn(b, l, DET_HEADS * 64, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    toep = (0.5 * torch.randn(DET_HEADS, 2 * hg - 1, wg, wg, generator=gen, device="cuda")
            if toep_on else None)
    bh = bw = None
    if decomp_on:
        bh = 0.5 * torch.randn(b, DET_HEADS, hg, l, generator=gen, device="cuda")
        bw = 0.5 * torch.randn(b, DET_HEADS, l, wg, generator=gen, device="cuda")
    return q, k, v, toep, bh, bw


# max and mean |diff| bounds of the det forward against its plain version, by
# dtype: phase 3's for bf16 and fp32, a fifth of bf16's for fp16 (as 21(a))
DET_FWD_BOUNDS = {torch.bfloat16: (BF16_MAX_ERR, BF16_MEAN_ERR),
                  torch.float16: (BF16_MAX_ERR / 5, BF16_MEAN_ERR / 5),
                  torch.float32: (FP32_MAX_ERR, math.inf)}


def check_det_kernel(gen, dtypes=(torch.bfloat16, torch.float32), tag: str = "11(a)") -> float:
    """Phase 11(a): the det attention kernel against det_attention_plain on
    the same inputs, in each of ``dtypes``, with and without the LSE, at the
    detection trunk's shapes; returns the largest max |diff| of the output.
    Bounds ``DET_FWD_BOUNDS``, LSE 1e-4.  Each 2-byte case logs the branch
    of ``det_attention.fwd_plan`` it took, and the check fails unless both
    ran.  22(a) runs it in fp16."""
    worst, modes = 0.0, set()
    for dtype in dtypes:
        for b, hg, wg, toep_on, decomp_on in DET_CASES:
            ops = det_operands(gen, b, hg, wg, dtype, toep_on, decomp_on)
            plan = da.fwd_plan(hg, wg, toep_on, decomp_on)
            if dtype != torch.float32:
                modes.add(plan.mode)
            for with_lse in (False, True):
                got = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=with_lse)
                torch.cuda.synchronize()
                want = da.det_attention_plain(*ops, (hg, wg), 0.125, DET_HEADS,
                                              with_lse=with_lse)
                lse_err = 0.0
                if with_lse:
                    (got, lse), (want, want_lse) = got, want
                    if not torch.isfinite(lse).all():
                        raise RuntimeError(f"{tag}: det kernel LSE is not finite")
                    lse_err = (lse - want_lse).abs().max().item()
                if not torch.isfinite(got).all():
                    raise RuntimeError(f"{tag}: det kernel output is not finite")
                err = (got.float() - want.float()).abs()
                mx, mean = err.max().item(), err.mean().item()
                worst = max(worst, mx)
                branch = (f"plan: {DET_FWD_MODES[plan.mode]}, {plan.smem_bytes} B shared"
                          if dtype != torch.float32 else "fp32 kernel: gather")
                log(f"{tag} det kernel vs plain {str(dtype)[6:]} B={b} grid {hg}x{wg} "
                    f"toep={toep_on} decomp={decomp_on} lse={with_lse} ({branch}): max|d| "
                    f"{mx:.3e} mean|d| {mean:.3e}"
                    + (f", LSE max|d| {lse_err:.3e}" if with_lse else ""))
                max_bound, mean_bound = DET_FWD_BOUNDS[dtype]
                if mx > max_bound or mean > mean_bound or lse_err > 1e-4:
                    raise RuntimeError(f"{tag}: the det kernel disagrees with its plain version "
                                       f"({dtype}, B={b}, {hg}x{wg}, lse={with_lse})")
                del got, want
            del ops
    if modes != set(DET_FWD_MODES):
        raise RuntimeError(f"{tag}: the cases took the plan's branches {modes} only")
    torch.cuda.empty_cache()
    return worst


def check_det_head_dim() -> None:
    """11(a): head dim 32 raises on the card (the kernel takes 64 only, and
    there is no plain fallback)."""
    q = torch.randn(2, 16, 4, 32, device="cuda")
    try:
        da.det_flash_attention(q, q, q, None, None, None, (4, 4), 32 ** -0.5)
    except ValueError as e:
        log(f"11(a) head dim 32 on the card raises, no plain fallback: {e}")
    else:
        raise RuntimeError("11(a): the det kernel path took head dim 32")


def det_window_grids(layers: int) -> list:
    """The grids of #4's launches in one trunk forward: three 16 x 16 window
    layers, then a global 64 x 64 one, ``layers // 4`` times."""
    return ([(16, 16)] * 3 + [(64, 64)]) * (layers // 4)


@contextlib.contextmanager
def recorded_det_grids():
    """Observe the grid of every call of the det forward wrapper (the wrapper
    itself counts the launch)."""
    grids, kernel = [], da.det_attention_cuda

    def recording(q, k, v, toep, bh, bw, hw, *args, **kwargs):
        grids.append(tuple(hw))
        return kernel(q, k, v, toep, bh, bw, hw, *args, **kwargs)

    da.det_attention_cuda = recording
    try:
        yield grids
    finally:
        da.det_attention_cuda = kernel


def build_detector(layers: int):
    """The 1024 px detector (RPN, masks, 80 classes) at full width and
    ``layers`` deep in fp32, on seeded random weights (non-zero rel-pos
    tables)."""
    t0 = time.time()
    det = OnePeaceDetector(proposer="rpn", device="cuda", dtype=torch.float32, layers=layers)
    fill_random_(det, torch.Generator(device="cuda").manual_seed(0))
    log(f"detector at depth {layers}: "
        f"{sum(p.numel() for p in det.backbone.parameters()) / 1e9:.3f}B trunk parameters, "
        f"{sum(p.numel() for p in det.parameters()) / 1e9:.3f}B in all "
        f"({time.time() - t0:.1f} s to build and fill)")
    return det.eval()


def detector_inputs(gen) -> dict:
    """Two 1024 px images, 512 boxes per image for the cascade and the first
    100 of them for the mask head, with their image indices."""
    n_img, n_box, n_mask = 2, 512, 100
    images = torch.randn(n_img, 3, 1024, 1024, generator=gen, device="cuda")
    rs = np.random.RandomState(0)
    corner = rs.uniform(0, 900, (n_img * n_box, 2))
    boxes = np.concatenate([corner, corner + rs.uniform(16, 400, (n_img * n_box, 2))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).cuda()
    return {"images": images, "boxes": boxes,
            "bidx": torch.arange(n_img, device="cuda").repeat_interleave(n_box),
            "mboxes": boxes.reshape(n_img, n_box, 4)[:, :n_mask].reshape(-1, 4),
            "mbidx": torch.arange(n_img, device="cuda").repeat_interleave(n_mask)}


def detector_outputs(det, inputs: dict) -> dict:
    """The stride-16 map, each pyramid level, the cascade's scores and boxes
    and the mask logits on the fixed boxes, without a gradient."""
    with torch.no_grad():
        f16 = det.backbone(inputs["images"])
        pyr = det.fpn(f16)
        feats = tuple(pyr[k] for k in det.PYRAMID_KEYS)
        scores, refined = det.box_head(feats, inputs["boxes"], inputs["bidx"])
        masks = det.mask_head(feats, inputs["mboxes"], inputs["mbidx"])
    torch.cuda.synchronize()
    return {"f16": f16, **pyr, "scores": scores, "boxes": refined, "masks": masks}


def compare_detector_paths(det, inputs: dict, bound: float, tag: str) -> dict:
    """The kernel path against the plain path on the same weights: every
    output of ``detector_outputs``, cosine per image >= ``bound``, and #4's
    launches over the kernel path's trunk forward (``det_window_grids``)."""
    layers, n_img = len(det.backbone.layers), inputs["images"].shape[0]
    outs = {}
    try:
        for impl in ("pallas", "xla"):
            det.backbone.attn_impl = impl
            with recorded_det_grids() as grids:
                out = detector_outputs(det, inputs)
            want = det_window_grids(layers) if impl == "pallas" else []
            if grids != want:
                raise RuntimeError(f"{tag} {impl}: kernel launches over grids {grids}")
            if not all(torch.isfinite(x).all() for x in out.values()):
                raise RuntimeError(f"{tag} {impl}: non-finite output")
            outs[impl] = out
    finally:
        det.backbone.attn_impl = "pallas"
    report = {key: min_cosine(outs["pallas"][key].reshape(n_img, -1),
                              outs["xla"][key].reshape(n_img, -1)) for key in outs["pallas"]}
    log(f"{tag} 1024 px B={n_img}, kernel vs plain path, min cosine per image: "
        + ", ".join(f"{k} {v:.9f}" for k, v in report.items())
        + f" (bound {bound}); {layers} launches of #4 per trunk forward: {3 * layers // 4} "
        f"windowed, {layers // 4} global")
    if min(report.values()) < bound:
        raise RuntimeError(f"{tag}: kernel and plain paths disagree")
    return report


DETECT_SETTINGS = {"recipe": {}, "masks": {"score_thresh": 0.0, "max_proposals": 64}}


def check_detect_results(results, tag: str) -> None:
    """Every image has detections with 28 x 28 masks, all finite."""
    for r in results:
        n = len(r["boxes"])
        if (n == 0 or r["masks"].shape != (n, 28, 28) or not np.isfinite(r["boxes"]).all()
                or not np.isfinite(r["masks"]).all()):
            raise RuntimeError(f"{tag} detect(): bad result {[(k, v.shape) for k, v in r.items()]}")


def check_detector(gen, card: str) -> int:
    """Phase 11(b): OnePeaceDetector at full width and depth ``CUT_DEPTH``
    (d 1536, 24 heads, window 16, a global layer every 4th), 1024 px, 80
    classes, the RPN proposer and the mask head, on random weights from a
    seeded generator.  The kernel path against the plain path on the same
    weights: the stride-16 map, each pyramid level, the cascade scores and
    boxes and the mask logits on fixed proposals, cosine per image >=
    1-1e-6 in fp32 and >= 0.999 in bf16, a launch per trunk layer (3 in 4
    over 16 x 16 windows, 1 in 4 over the 64 x 64 grid).  Then ``detect()``
    in bf16 and its images/s on the kernel path (11(c)).  Phase 22 runs the
    detector at depth 40 in fp16, bf16 and int8.  Returns the kernel's
    launches over this phase's runs (the counter is set to 0 here)."""
    det = build_detector(CUT_DEPTH)
    inputs = detector_inputs(gen)
    n_img = inputs["images"].shape[0]
    da.launches = 0
    for dtype, bound in ((torch.float32, 1 - 1e-6), (torch.bfloat16, 0.999)):
        det.to(dtype)
        compare_detector_paths(det, inputs, bound, f"11(b) {str(dtype)[6:]} depth {CUT_DEPTH}")
        torch.cuda.empty_cache()
    x = inputs["images"].bfloat16()
    with torch.no_grad():
        results = det.detect(x, **DETECT_SETTINGS["masks"])
    check_detect_results(results, "11(b)")
    log(f"11(b) detect() bf16 kernel path, score_thresh 0, 64 proposals: "
        f"{[len(r['boxes']) for r in results]} detections with 28x28 masks, all finite")

    # two settings: the recipe's (score_thresh 0.05, 512 proposals; on random
    # weights no class scores above 0.05, so the mask head does not run) and
    # 11(b)'s (score_thresh 0, 64 proposals: 100 detections with masks per
    # image, so every head runs); the median and spread of 3 calls each on the
    # kernel path (the median leaves out a first call's set-up)
    wall = {}
    for label, kwargs in DETECT_SETTINGS.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            results = det.detect(x, **kwargs)
            torch.cuda.synchronize()
            times.append(1e3 * (time.time() - t0))
        if label == "masks":
            check_detect_results(results, "11(c)")
        med = wall[label] = float(np.median(times))
        log(f"11(c) detect() 1024 px B={n_img} bf16 depth {CUT_DEPTH}, {label} setting {kwargs}: "
            f"{[len(r['boxes']) for r in results]} detections; median {med:.1f} ms per batch "
            f"over {len(times)} calls (min {min(times):.1f}, max {max(times):.1f}), "
            f"{n_img / med * 1e3:.2f} images/s ({card})")
    profile_call(lambda: det.detect(x, **DETECT_SETTINGS["masks"]), wall["masks"], "11(c)",
                 "detect_profile.txt")
    launched = da.launches
    del det
    torch.cuda.empty_cache()
    return launched


def time_det_attention(gen, card: str) -> dict:
    """Phase 11(c): ms per global and per windowed layer, bf16, for the
    kernel, its plain version, and SDPA with the bias materialised (as bf16)
    outside the timed region, kernel and SDPA in turns (kernel, SDPA, kernel,
    SDPA; the mean of the two); the kernel's ratio to SDPA; the bound from
    this run's operands.  Beside it the kernel on the same q/k/v with no bias,
    which shows what the bias costs."""
    times = {}
    for name, (b, hg, wg) in (("global", (2, 64, 64)), ("windowed", (32, 16, 16))):
        ops = det_operands(gen, b, hg, wg, torch.bfloat16)
        q, k, v, toep, bh, bw = ops
        l = hg * wg
        bias = (bh.transpose(2, 3)[..., None] + bw[..., None, :]).reshape(b, DET_HEADS, l, l)
        bias += da.bias_from_toeplitz(toep, hg, wg)[None]
        mask = bias.to(torch.bfloat16)
        del bias
        q4, k4, v4 = (x.view(b, l, DET_HEADS, 64).transpose(1, 2) for x in (q, k, v))
        turns = {"kernel": [], "sdpa": []}
        for _ in range(2):
            turns["kernel"].append(cuda_time_ms(
                lambda: da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS), iters=10))
            turns["sdpa"].append(cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=0.125), iters=10))
        kernel_ms, library_ms = (float(np.mean(turns[key])) for key in ("kernel", "sdpa"))
        no_bias_ms = cuda_time_ms(lambda: da.det_attention_cuda(
            q, k, v, None, None, None, (hg, wg), 0.125, DET_HEADS), iters=10)
        plain_ms = cuda_time_ms(lambda: da.det_attention_plain(*ops, (hg, wg), 0.125, DET_HEADS),
                                iters=3, warmup=1)
        flops = 4 * b * DET_HEADS * l * l * 64
        n_bytes = 4 * q.numel() * 2 + 4 * (toep.numel() + bh.numel() + bw.numel())
        bound = bound_ms(n_bytes, flops, H100_BF16_PEAK_TFLOPS * 1e12)
        plan = da.fwd_plan(hg, wg)
        log(f"11(c) det attention per {name} layer B={b} grid {hg}x{wg} bf16: kernel "
            f"{kernel_ms:.3f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s; turns "
            f"{turns['kernel'][0]:.3f}, {turns['kernel'][1]:.3f}), {kernel_ms / library_ms:.2f}x "
            f"SDPA with the materialised bias {library_ms:.3f} ms (turns {turns['sdpa'][0]:.3f}, "
            f"{turns['sdpa'][1]:.3f}); plain {plain_ms:.3f} ms; bound {bound[0]:.3f} ms by "
            f"{bound[1]}; plan: {DET_FWD_MODES[plan.mode]} ({card})")
        log(f"11(c) det attention per {name} layer, what the bias costs: the kernel with toep, "
            f"bh and bw {kernel_ms:.3f} ms, with no bias {no_bias_ms:.3f} ms: the bias takes "
            f"{kernel_ms - no_bias_ms:.3f} ms, {100 * (1 - no_bias_ms / kernel_ms):.0f}% ({card})")
        times[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound[0], "bound_by": bound[1], "no_bias_ms": no_bias_ms}
        del ops, q, k, v, toep, bh, bw, mask, q4, k4, v4
        torch.cuda.empty_cache()
    return times


DET_BWD_CASES = [  # (B, hg, wg, toep, decomp): the 1024 px global grid with each bias
    # alone, both and none; its 16 x 16 windows (16 per image, B=2) likewise; a
    # ragged 50 x 50 grid; a 32 x 32 grid (the dtoep pass's middle tile width); a
    # 1 x 64 grid (one displacement; toep only, since a one-row grid's dbh, the sum
    # of ds over all keys, is 0 up to rounding); an 80 x 80 grid (slab tiles of 64)
    (2, 64, 64, True, True), (2, 64, 64, True, False), (2, 64, 64, False, True),
    (2, 64, 64, False, False), (32, 16, 16, True, True), (32, 16, 16, True, False),
    (32, 16, 16, False, True), (32, 16, 16, False, False), (2, 50, 50, True, True),
    (2, 32, 32, True, True), (2, 1, 64, True, False), (1, 80, 80, True, True)]
DET_BWD_NAMES = ("dq", "dk", "dv", "dtoep", "dbh", "dbw")
DET_BWD_MODES = {da.BWD_GATHER: "gather", da.BWD_SLAB: "staged, bias sums in registers"}


# max and mean |diff| bounds of the det backward relative to max and mean
# |plain|, by dtype: phase 6's for bf16 and fp32, a fifth of bf16's for fp16
DET_BWD_BOUNDS = {torch.bfloat16: (2e-2, 5e-3), torch.float16: (2e-2 / 5, 5e-3 / 5),
                  torch.float32: (1e-4, math.inf)}


def check_det_bwd_kernel(gen, dtypes=(torch.bfloat16, torch.float32),
                         tag: str = "12(a)") -> dict:
    """Phase 12(a): the det attention backward kernels (pass 1 with the
    dtoep pass, #5; pass 2, #6) against det_attention_bwd_plain on the same
    inputs (the forward kernel's output and LSE), in each of ``dtypes``; the
    same call twice must be bit-equal.  Returns the largest max |diff| of
    #5's outputs (dq, dtoep, dbh, dbw) and of #6's (dk, dv).  Bounds
    ``DET_BWD_BOUNDS``, relative to max and mean |plain|.  Each 2-byte case
    logs the branch of ``det_attention.bwd_plan`` it took; the phase fails
    unless both ran.  22(a) runs it in fp16."""
    worst = {"dq": 0.0, "dkv": 0.0}
    modes = set()
    for dtype in dtypes:
        for b, hg, wg, toep_on, decomp_on in DET_BWD_CASES:
            plan = da.bwd_plan(hg, wg, toep_on, decomp_on)
            if dtype != torch.float32:
                modes.add(plan.mode)
            ops = det_operands(gen, b, hg, wg, dtype, toep_on, decomp_on)
            out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
            got = da.det_attention_bwd_cuda(*args)
            again = da.det_attention_bwd_cuda(*args)
            torch.cuda.synchronize()
            want = da.det_attention_bwd_plain(*args)
            parts = []
            for name, x, y, z in zip(DET_BWD_NAMES, got, want, again):
                if (x is None) != (y is None):
                    raise RuntimeError(f"12(a): {name} is None on one side only")
                if x is None:
                    continue
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"{tag}: det backward {name} is not finite")
                if not torch.equal(x, z):
                    raise RuntimeError(f"{tag}: det backward {name} differs between two calls")
                err = (x.float() - y.float()).abs()
                scale = y.float().abs()
                rel_max = err.max().item() / max(scale.max().item(), 1e-30)
                rel_mean = err.mean().item() / max(scale.mean().item(), 1e-30)
                group = "dkv" if name in ("dk", "dv") else "dq"
                worst[group] = max(worst[group], err.max().item())
                parts.append(f"{name} {rel_max:.2e}/{rel_mean:.2e}")
                max_bound, mean_bound = DET_BWD_BOUNDS[dtype]
                if rel_max > max_bound or rel_mean > mean_bound:
                    raise RuntimeError(f"{tag}: det backward {name} disagrees with the plain "
                                       f"version: {str(dtype)[6:]} B={b} {hg}x{wg} "
                                       f"toep={toep_on} decomp={decomp_on}: max {rel_max:.3e} "
                                       f"mean {rel_mean:.3e}")
            branch = (f"plan: {DET_BWD_MODES[plan.mode]}, shared {plan.dq_smem}/"
                      f"{plan.dkv_smem}/{plan.dtoep_smem} B" if dtype != torch.float32
                      else "fp32 kernels: gather")
            log(f"{tag} det bwd kernel vs plain {str(dtype)[6:]} B={b} grid {hg}x{wg} "
                f"toep={toep_on} decomp={decomp_on} ({branch}): max/mean |d| relative "
                f"{', '.join(parts)}; bit-equal over two calls")
            del ops, out, lse, dout, got, again, want
            torch.cuda.empty_cache()
    if modes != set(DET_BWD_MODES):
        raise RuntimeError(f"{tag}: the cases took the plan's branches {modes} only")
    return worst


DET_RECIPE = ROOT / "recipes" / "detection" / "cascade_mask_rcnn_1024.yaml"


def det_config(overrides=()):
    """The detection recipe through the port's load_config, with
    ``overrides``; the criterion is the task's."""
    cfg = load_config(str(DET_RECIPE), [ONE_PROCESS, *overrides])
    cfg.criterion._name = cfg.criterion._name or CocoDetectionTask.criterion_name
    return cfg


def det_trainer(cfg, seed: int = 0) -> Trainer:
    model = CocoDetectionTask.build_model(cfg, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def det_batch(cfg, gen, b: int) -> dict:
    """b synthetic 1024 px images with cfg.task.max_boxes GT slots (the last
    quarter padded), 80 classes, and box-shaped instance masks at the
    recipe's stride 4 (uint8), as vision_collate gives them."""
    t = cfg.task
    size, m, stride = t.image_size, t.max_boxes, t.mask_stride
    rs = np.random.RandomState(int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda")))
    x0 = rs.uniform(0, size * 0.75, (b, m))
    y0 = rs.uniform(0, size * 0.75, (b, m))
    w = np.exp(rs.uniform(np.log(16), np.log(size / 2), (b, m)))
    h = w * np.exp(rs.uniform(-0.7, 0.7, (b, m)))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, size - 1), np.minimum(y0 + h, size - 1)], -1)
    valid = np.ones((b, m), bool)
    valid[:, 3 * m // 4:] = False
    boxes[~valid] = 0.0
    masks = np.zeros((b, m, size // stride, size // stride), np.uint8)
    for i in range(b):
        for j in range(m):
            if valid[i, j]:
                c0, r0, c1, r1 = (boxes[i, j] / stride).astype(int)
                masks[i, j, r0:r1 + 1, c0:c1 + 1] = 1
    return {"src_images": torch.randn(b, 3, size, size, generator=gen, device="cuda"),
            "gt_boxes": torch.from_numpy(boxes.astype(np.float32)).cuda(),
            "gt_labels": torch.from_numpy(rs.randint(0, t.num_classes, (b, m))).cuda(),
            "gt_valid": torch.from_numpy(valid).cuda(), "gt_masks": torch.from_numpy(masks).cuda()}


def check_det_train_paths(gen, computes=("fp32", "bf16"), tag: str = "12(b)", batch=None,
                          ref32=None) -> tuple:
    """Phase 12(b): the detection fine-tuning objective at full width with 4
    trunk layers (3 windowed, 1 global), pyramid, RPN, cascade and masks, at
    1024 px and B=2, drop path 0.6 and remat as the recipe: the kernel path
    against the plain path on the same weights, batch and generator seed
    (the same drop-path masks, RPN sample and jitter), in each compute dtype
    of ``computes``.  fp32: losses within 1e-5, the gradient cosine over all
    parameters together >= 1-1e-6 and every parameter's >= 1-1e-4 (the
    heads' ReLU units whose input lies within the two paths' ~1e-7
    difference of 0 flip, and move an FC weight's gradient cosine to
    ~1-1e-5); bf16 (and fp16, 22(c)) compute: the kernel path no further
    from the fp32 gradients than the plain path, over all parameters
    together to 1e-3 and per parameter to 0.02, losses within 2e-3.
    (Phase 7(a)'s 0.999 between the two bf16 paths does not carry over:
    here the plain path itself sits at cosine ~0.9965 from fp32 over all
    parameters, and a parameter's distance to fp32 moves by up to ~0.01 from
    one batch to the next on either path.)  fp16 scales the loss as the
    ``Trainer`` does, from 2^15, halving while a gradient is not finite (a
    step the ``Trainer`` would skip); both paths take the same scale.
    Launches: 8 forward (4 layers and their recompute), 4 backward.
    Returns the batch and the fp32 gradients (the reference of 22(c))."""
    for compute in computes:
        cfg = det_config(["model.encoder.layers=4", f"common.bf16={str(compute == 'bf16').lower()}",
                          f"common.fp16={str(compute == 'fp16').lower()}"])
        trainer = det_trainer(cfg)
        batch = batch or det_batch(cfg, gen, 2)
        runs = {}
        for impl in ("pallas", "xla"):
            trainer.model.backbone.attn_impl = impl
            while True:
                da.launches = da.bwd_launches = 0
                metrics, grads = trainer.gradients(batch, torch.Generator().manual_seed(5))
                torch.cuda.synchronize()
                finite = all(torch.isfinite(g).all() for g in grads)
                if finite or trainer.scaler is None or impl == "xla":
                    break
                trainer.scaler.update(False)
                log(f"{tag} {compute} {impl}: a gradient is not finite at the loss scale; the "
                    f"scale halves to {trainer.scaler.scale:g}")
            launched = (da.launches, da.bwd_launches)
            want = (8, 4) if impl == "pallas" else (0, 0)
            if launched != want:
                raise RuntimeError(f"{tag} {compute} {impl}: launches {launched}, expected {want}")
            if not finite:
                raise RuntimeError(f"{tag} {compute} {impl}: non-finite gradient")
            runs[impl] = (float(metrics["loss"]), grads)
        names = trainer._names
        scale = "" if trainer.scaler is None else f", loss scale {trainer.scaler.scale:g}"
        del trainer
        reference = judge_train_paths(f"{tag} {compute} 4-layer detector 1024 px B=2{scale}",
                                      runs, names, None if compute == "fp32" else ref32,
                                      bf16_loss_tol=2e-3)
        ref32 = reference if compute == "fp32" else ref32
        del runs
        torch.cuda.empty_cache()
    return batch, ref32


def judge_train_paths(tag: str, runs: dict, names: list, ref32, bf16_loss_tol: float,
                      null=()):
    """Phase 12(b)'s bounds on one model's loss and gradients, kernel path
    (``runs["pallas"]``) against plain path (``runs["xla"]``), each a (loss,
    gradients) pair.  fp32 (``ref32`` None): losses within 1e-5, the cosine
    over all parameters together >= 1-1e-6 and each parameter's >= 1-1e-4;
    returns the plain path's gradients as the reference for bf16.  bf16
    (``ref32`` the fp32 gradients): losses within ``bf16_loss_tol``, the
    kernel path no further from the fp32 gradients than the plain path, over
    all parameters together to 1e-3 and per parameter to 0.02.  The
    parameters named in ``null`` have a gradient that is 0 in exact
    arithmetic (an attention's key bias: softmax does not see a constant
    added to a query's logits), whose rounding noise has no direction: each
    is held below 1e-5 (fp32) or 2e-2 (bf16) of the whole gradient's norm on
    both paths instead, and left out of the per-parameter cosines."""
    (loss_k, grads_k), (loss_p, grads_p) = runs["pallas"], runs["xla"]
    reference = grads_p if ref32 is None else ref32
    if null:
        whole = min(torch.cat([g.flatten() for g in grads]).norm().item()
                    for grads in (grads_k, grads_p))
        noise = max(g.norm().item() / whole for grads in (grads_k, grads_p)
                    for name, g in zip(names, grads) if name in null)
        log(f"{tag}: the {len(null)} gradients that are 0 in exact arithmetic are at most "
            f"{noise:.2e} of the whole's norm")
        if noise > (1e-5 if ref32 is None else 2e-2):
            raise RuntimeError(f"{tag}: a gradient that should be 0 is {noise:.2e} of the whole")
        keep = [i for i, name in enumerate(names) if name not in null]
        names = [names[i] for i in keep]
        grads_k, grads_p = [grads_k[i] for i in keep], [grads_p[i] for i in keep]
        ref32 = None if ref32 is None else [ref32[i] for i in keep]
    cos = grad_cosines(grads_k, grads_p)
    worst = min(range(len(cos)), key=cos.__getitem__)
    total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                         [torch.cat([g.flatten() for g in grads_p])])[0]
    log(f"{tag}: loss kernel {loss_k:.7f} plain {loss_p:.7f}; gradient cosine kernel vs plain "
        f"over all parameters {total:.9f}, per parameter min {cos[worst]:.9f} "
        f"({names[worst]}), median {sorted(cos)[len(cos) // 2]:.9f}, "
        f"{sum(c < 1 - 1e-6 for c in cos)} of {len(cos)} parameters below 1-1e-6")
    if ref32 is None:
        ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and total >= 1 - 1e-6
              and cos[worst] >= 1 - 1e-4)
    else:
        cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
        gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
        flat32 = [torch.cat([g.flatten() for g in ref32])]
        total_k = grad_cosines([torch.cat([g.flatten() for g in grads_k])], flat32)[0]
        total_p = grad_cosines([torch.cat([g.flatten() for g in grads_p])], flat32)[0]
        log(f"{tag}: vs the fp32 gradients, all parameters together: kernel path "
            f"{total_k:.6f}, plain path {total_p:.6f}; per parameter min kernel path "
            f"{min(cos_k):.6f}, plain path {min(cos_p):.6f}, largest shortfall of the kernel "
            f"path {cos_p[gap] - cos_k[gap]:.2e} ({names[gap]})")
        ok = (abs(loss_k - loss_p) <= bf16_loss_tol * abs(loss_p) and total_k >= total_p - 1e-3
              and cos_p[gap] - cos_k[gap] <= 0.02)
    if not ok:
        raise RuntimeError(f"{tag}: kernel and plain training paths disagree")
    return reference


def train_det_full_depth(gen, card: str) -> dict:
    """Phase 12(c): the recipe at depth 40 (load_config on the recipe,
    CocoDetectionTask.build_model, DetectionCriterion, Trainer): 1024 px,
    B=2, bf16 compute over fp32 masters, AdamW with layer decay, remat, drop
    path 0.6; the warm-up is cut to 0 so a few steps move the weights.  Each
    path gets a fresh trainer (the same seeded weights) and every step the
    same batch and generator state, so the loss must fall; the plain path
    runs at depth ``CUT_DEPTH``.  Returns the batch, the kernel path's
    launches per step and the times."""
    cfg = det_config(["lr_scheduler.warmup_updates=0"])
    batch = det_batch(cfg, gen, 2)
    result = {"batch": batch}
    for impl, steps, layers in (("pallas", 3, 40), ("xla", 1, CUT_DEPTH)):
        t0 = time.time()
        trainer = det_trainer(det_config(["lr_scheduler.warmup_updates=0",
                                          f"model.encoder.layers={layers}"]))
        torch.cuda.synchronize()
        trainer.model.backbone.attn_impl = impl
        if impl == "pallas":
            n = sum(p.numel() for p in trainer.model.parameters())
            n_trunk = sum(p.numel() for p in trainer.model.backbone.parameters())
            log(f"12(c) detector from the recipe: {n_trunk / 1e9:.3f}B trunk parameters, "
                f"{n / 1e9:.3f}B in all, fp32 masters + AdamW ({time.time() - t0:.1f} s to "
                f"build and fill)")
        rng_state = trainer.generator.get_state()
        first = trainer.train_step(batch)
        torch.cuda.synchronize()
        da.launches = da.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times = [first["loss"]], []
        for _ in range(steps):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(metrics["loss"])
        launched = (da.launches // steps, da.bwd_launches // steps)
        want = (80, 40) if impl == "pallas" else (0, 0)
        ms = 1e3 * sum(times) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"12(c) {impl} depth {layers} B=2 bf16: {ms:.1f} ms per step (steps "
            f"{[round(1e3 * x, 1) for x in times]}), {2 / ms * 1e3:.2f} images/s, peak "
            f"{peak:.1f} GiB, losses {[round(x, 5) for x in losses]} (the first a warm-up "
            f"step), launches per step: det attention forward {launched[0]}, backward "
            f"{launched[1]} (expected {want[0]} and {want[1]}) ({card})")
        if launched != want or da.launches != want[0] * steps:
            raise RuntimeError(f"12(c) {impl}: launches {launched} per step, expected {want}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"12(c) {impl}: the loss on a repeated batch did not fall: "
                               f"{losses}")
        result[impl] = {"ms": ms, "peak_gib": peak, "losses": losses, "launches": launched,
                        "total": (da.launches, da.bwd_launches)}
        if impl == "pallas":
            trainer.generator.set_state(rng_state)
            profile_call(lambda: trainer.train_step(batch), ms, "12(c)", "det_train_profile.txt")
        del trainer
        torch.cuda.empty_cache()
    return result


def time_det_backward(gen, card: str) -> dict:
    """Phase 12(d): ms per global and windowed layer of the backward, bf16:
    pass 1 with the dtoep pass (#5), pass 2 (#6) and the whole backward
    (with delta); the plain backward; SDPA with the materialised bf16 bias
    requiring a gradient (its backward alone, the library call set beside
    the kernels, and forward + backward), and the whole backward's ratio to
    it.  Bounds from this run's operands: #5 computes s, dp and dq (6 B H L^2
    64 operations), #6 s, dp, dv and dk (8), the whole backward at least 10.
    Beside them each kernel on the same q/k/v with no bias, toep only, bh +
    bw only and both: what each bias costs each kernel."""
    times = {}
    for name, (b, hg, wg) in (("global", (2, 64, 64)), ("windowed", (32, 16, 16))):
        by_bias = []
        for toep_on, decomp_on in ((False, False), (True, False), (False, True), (True, True)):
            ops = det_operands(gen, b, hg, wg, torch.bfloat16, toep_on, decomp_on)
            out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
            args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
            ms = [cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=p), iters=10)
                  if p != 2 or toep_on else None for p in (1, 2, 4)]
            by_bias.append(f"{'toep' if toep_on else 'no toep'}, "
                           f"{'bh + bw' if decomp_on else 'no bh/bw'}: pass 1 {ms[0]:.3f}, dtoep "
                           + ("-" if ms[1] is None else f"{ms[1]:.3f}") + f", pass 2 {ms[2]:.3f}")
            del ops, out, lse, dout, args
        log(f"12(d) det attention backward per {name} layer B={b} grid {hg}x{wg} bf16, what "
            f"each bias costs each kernel (ms): {'; '.join(by_bias)}; plan: "
            f"{DET_BWD_MODES[da.bwd_plan(hg, wg).mode]} ({card})")
        ops = det_operands(gen, b, hg, wg, torch.bfloat16)
        q, k, v, toep, bh, bw = ops
        l = hg * wg
        out, lse = da.det_attention_cuda(*ops, (hg, wg), 0.125, DET_HEADS, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        args = (*ops, out, dout, lse, (hg, wg), 0.125, DET_HEADS)
        dq_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=3), iters=10)
        pass1_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=1), iters=10)
        dkv_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args, passes=4), iters=10)
        total_ms = cuda_time_ms(lambda: da.det_attention_bwd_cuda(*args), iters=10)
        plain_ms = cuda_time_ms(lambda: da.det_attention_bwd_plain(*args), iters=3, warmup=1)
        bias = (bh.transpose(2, 3)[..., None] + bw[..., None, :]).reshape(b, DET_HEADS, l, l)
        bias += da.bias_from_toeplitz(toep, hg, wg)[None]
        mask = bias.to(torch.bfloat16).requires_grad_()
        del bias
        leaves = [x.view(b, l, DET_HEADS, 64).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        g4 = dout.view(b, l, DET_HEADS, 64).transpose(1, 2)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            *leaves, attn_mask=mask, scale=0.125)
        res = sdpa()
        library_ms = cuda_time_ms(lambda: torch.autograd.grad(res, [*leaves, mask], g4,
                                                              retain_graph=True), iters=5)
        fwd_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa(), [*leaves, mask], g4),
                                  iters=5)
        del res
        unit = b * DET_HEADS * l * l * 64
        qkv = q.numel() * 2
        biases = 4 * (toep.numel() + bh.numel() + bw.numel())
        stats = 2 * 4 * lse.numel()
        bound_dq = bound_ms(5 * qkv + stats + 2 * biases, 6 * unit, H100_BF16_PEAK_TFLOPS * 1e12)
        bound_dkv = bound_ms(6 * qkv + stats + biases, 8 * unit, H100_BF16_PEAK_TFLOPS * 1e12)
        bound_all = bound_ms(8 * qkv + stats + 2 * biases, 10 * unit,
                             H100_BF16_PEAK_TFLOPS * 1e12)
        log(f"12(d) det attention backward per {name} layer B={b} grid {hg}x{wg} bf16: pass 1 + "
            f"dtoep (#5) {dq_ms:.3f} ms (pass 1 alone {pass1_ms:.3f}; bound {bound_dq[0]:.3f} "
            f"by {bound_dq[1]}), pass 2 "
            f"(#6) {dkv_ms:.3f} ms (bound {bound_dkv[0]:.3f} by {bound_dkv[1]}), whole backward "
            f"{total_ms:.3f} ms (bound {bound_all[0]:.3f} by {bound_all[1]}; "
            f"{total_ms / library_ms:.2f}x SDPA's backward); plain "
            f"{plain_ms:.3f} ms; SDPA with the materialised bf16 bias: backward {library_ms:.3f}"
            f" ms, forward + backward {fwd_bwd_ms:.3f} ms ({card})")
        times[name] = {
            "dq": {"ms": dq_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_dq[0], "bound_by": bound_dq[1]},
            "dkv": {"ms": dkv_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_dkv[0], "bound_by": bound_dkv[1]}}
        del ops, q, k, v, toep, bh, bw, out, lse, dout, args, mask, leaves, g4
        torch.cuda.empty_cache()
    return times


RETRIEVAL_DIR = ROOT / "build" / "smoke_retrieval"
RETRIEVAL_RECIPE = ROOT / "recipes" / "image_text_retrieval" / "base.yaml"
WORDS = ("a the red green blue small large dog cat bird boat car tree house river field "
         "sky cloud two three old young running sitting near under over beside water "
         "grass road city beach snow mountain").split()


def retrieval_images(n: int, rng) -> list:
    """n PIL RGB images like ``smooth_images``, sizes kept within 256-399 px."""
    from PIL import Image

    out = []
    for i in range(n):
        h, w = 256 + (37 * i) % 144, 256 + (53 * i) % 144
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (17 + 5 * c + rng.rand() * 9) + yy / (23 + 3 * c)) for c in range(3)]
        out.append(Image.fromarray(((np.stack(chans, -1) * 0.45 + 0.5) * 255).astype(np.uint8)))
    return out


def write_retrieval_corpus(root: Path, pairs: int = 160, valid: int = 64) -> dict:
    """Phase 13(a): ``pairs`` image-caption pairs as JPEG files, a train
    TSV over all of them, a 40-row train TSV (5 micro-batches of 8 an
    epoch), a valid TSV of the first ``valid`` and ``valid.json`` with 5
    captions per valid id, and the byte-level BPE set."""
    rng = np.random.RandomState(13)
    root.mkdir(parents=True, exist_ok=True)
    rows, captions = ["id\timage\tcaption"], {}
    for i, img in enumerate(retrieval_images(pairs, rng)):
        img.save(root / f"img{i}.jpg", quality=92)
        captions[i] = [" ".join(WORDS[j] for j in row)
                       for row in rng.randint(0, len(WORDS), (5, 4 + i % 9))]
        rows.append(f"{i}\timg{i}.jpg\t{captions[i][0]}")
    (root / "train.tsv").write_text("\n".join(rows) + "\n")
    (root / "train40.tsv").write_text("\n".join(rows[:41]) + "\n")
    (root / "valid.tsv").write_text("\n".join(rows[:valid + 1]) + "\n")
    (root / "valid.json").write_text(json.dumps({str(i): captions[i] for i in range(valid)}))
    return {"root": root, "bpe": write_bpe_dir(root / "bpe")}


def retrieval_argv(data: dict, save_dir: Path, layers: int, batch: int, extra=()) -> list:
    """``cli.train`` arguments: the image-text retrieval recipe with the
    fine-tuning base's optimizer (recipes/finetune_4b_base.yaml) at the 4B
    width (d 1536, FFN 6144, 24 heads), ``layers`` deep, bf16 over fp32
    masters, remat, drop path 0.5; then ``extra``."""
    root = data["root"]
    return ["--config", str(RETRIEVAL_RECIPE), "--device", "cuda",
            f"task.data={root}/train.tsv", f"task.valid_data={root}/valid.tsv",
            f"task.valid_file={root}/valid.json", f"task.bpe_dir={data['bpe']}",
            "task.selected_cols=id,image,caption",
            f"model.encoder.layers={layers}", "model.encoder.drop_path_rate=0.5",
            "model.encoder.checkpoint_activations=true",
            "common.bf16=true", "common.log_interval=1", "common.seed=3407",
            "optimizer.adam_betas=(0.9,0.999)", "optimizer.weight_decay=0.05",
            "lr_scheduler.warmup_ratio=0.1", "lr_scheduler.min_lr=1e-6", "optimization.lr=1e-4",
            "optimization.clip_norm=0.0", f"dataset.batch_size={batch}",
            "dataset.batch_size_valid=32", f"checkpoint.save_dir={save_dir}",
            "checkpoint.reset_optimizer=false", "checkpoint.keep_last_epochs=1",
            *extra]


@contextlib.contextmanager
def recorded_steps(ops=fa):
    """Record every ``Trainer.train_step`` of the runs inside: its metrics,
    its start and end on the host clock (the card synchronised at the end),
    and the launches within it of the attention kernels of ``ops`` (the
    retrieval attention, or ``da``, the det attention)."""
    real = Trainer.train_step
    steps = []

    def step(self, batch):
        f0, b0 = ops.launches, ops.bwd_launches
        t0 = time.time()
        metrics = real(self, batch)
        torch.cuda.synchronize()
        steps.append({"metrics": metrics, "t0": t0, "t1": time.time(),
                      "fwd": ops.launches - f0, "bwd": ops.bwd_launches - b0})
        return metrics

    Trainer.train_step = step
    try:
        yield steps
    finally:
        Trainer.train_step = real


def run_train_cli(argv: list) -> None:
    from one_peace_tpu_torch.cli import train as train_cli

    if train_cli.main(argv) != 0:
        raise RuntimeError(f"cli.train exited non-zero: {argv}")
    gc.collect()
    torch.cuda.empty_cache()


def update_losses(log_file: Path) -> list:
    return [json.loads(line)["loss"] for line in log_file.read_text().splitlines()
            if json.loads(line)["tag"] == "train_inner"]


def check_cli_resume(data: dict, layers: int = 2) -> dict:
    """Phase 13(b): the recipe at full width, depth ``layers``, B=8,
    update_freq=2, LayerScale 0.1, on the 40-row TSV (5 micro-batches an
    epoch), three times:
    straight to 4 updates; to the end of epoch 1, whose save at update 2
    holds a pending micro-gradient; and resumed from that save to 4 updates.
    The updates' losses must agree to 1e-6 relative and the final masters to
    cosine 1-1e-6.  Then ``cli.evaluate`` reads the straight run's
    ``checkpoint_best.npz``: 64 images, 320 texts."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli

    root = data["root"]
    runs = {"straight": root / "straight", "resumed": root / "resumed"}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)
    # LayerScale at 0.1, not the recipe's 1e-6: at 1e-6 every embedding is
    # nearly the CLS token's own, each loss is ln(B) and a faulty resume would
    # agree with the straight run all the same
    common = [f"task.data={root}/train40.tsv", "optimization.update_freq=2",
              "optimization.max_update=4", "checkpoint.best_checkpoint_metric=txt_r1",
              "model.encoder.layer_scale_init_value=0.1"]

    def argv(name, log, *extra):
        return retrieval_argv(data, runs[name], layers, 8,
                              [*common, f"common.log_file={runs[name]}/{log}.jsonl", *extra])

    t0 = time.time()
    run_train_cli(argv("straight", "log"))
    quiet = ("dataset.disable_validation=true", "checkpoint.best_checkpoint_metric=")
    run_train_cli(argv("resumed", "part1", "optimization.max_epoch=1", *quiet))
    mid = train_state_lazily(runs["resumed"] / "step_2")["trainer"]
    if (mid["step"], mid["mini"]) != (2, 1):
        raise RuntimeError(f"13(b): the epoch-1 save is at step {mid['step']} with "
                           f"{mid['mini']} micro-gradients pending, not 2 and 1")
    del mid
    run_train_cli(argv("resumed", "part2", *quiet))
    straight = update_losses(runs["straight"] / "log.jsonl")
    resumed = (update_losses(runs["resumed"] / "part1.jsonl")
               + update_losses(runs["resumed"] / "part2.jsonl"))
    log(f"13(b) depth {layers}, B=8, update_freq=2: update losses straight {straight}, "
        f"stopped after update 2 (a micro-batch pending) and resumed {resumed} "
        f"({time.time() - t0:.1f} s for the three runs)")
    a = train_state_lazily(runs["straight"] / "step_4")["trainer"]["params"]
    b = train_state_lazily(runs["resumed"] / "step_4")["trainer"]["params"]
    dot = na = nb = 0.0
    diff, equal = 0.0, True
    for name in a:
        x, y = a[name].cuda().double(), b[name].cuda().double()
        dot, na, nb = dot + float(x.flatten() @ y.flatten()), na + float(x.norm() ** 2), \
            nb + float(y.norm() ** 2)
        diff = max(diff, float((x - y).abs().max()))
        equal = equal and torch.equal(a[name], b[name])
    cosine = dot / math.sqrt(na * nb)
    log(f"13(b) final masters, straight vs resumed: max |diff| {diff:.3e}, cosine "
        f"{cosine:.12f}, bit-equal {equal}")
    ok = (len(straight) == len(resumed) == 4 and all(map(math.isfinite, straight))
          and all(abs(x - y) <= 1e-6 * abs(x) for x, y in zip(straight, resumed))
          and cosine >= 1 - 1e-6)
    if not ok:
        raise RuntimeError("13(b): the resumed run does not end where the straight run does")
    del a, b
    out = runs["straight"] / "eval.json"
    evaluate_cli.main(["--config", str(RETRIEVAL_RECIPE), "--path",
                       str(runs["straight"] / "checkpoint_best.npz"), "--output", str(out),
                       *retrieval_argv(data, runs["straight"], layers, 8)[4:]])
    stats = json.loads(out.read_text())
    log(f"13(b) cli.evaluate on checkpoint_best.npz: {stats}")
    if (stats["img_count"], stats["txt_count"]) != (64, 320):
        raise RuntimeError(f"13(b): evaluation counted {stats['img_count']} images and "
                           f"{stats['txt_count']} texts, not 64 and 320")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": straight, "max_abs_diff": diff, "cosine": cosine, "bit_equal": equal}


@contextlib.contextmanager
def profiled_update(update: int):
    """Run update ``update`` of the runs inside under torch.profiler, from
    the end of the update before (so the batch's fetch and copy are inside).
    Yields a dict that gets the profiler ("p") and the update's wall ms
    ("wall")."""
    from torch.profiler import ProfilerActivity, profile

    prof = {}
    real_step = Trainer.train_step

    def profiled_step(self, batch):
        metrics = real_step(self, batch)
        if self.step == update - 1 and "p" not in prof:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.time()
        elif self.step == update and "t0" in prof and "wall" not in prof:
            torch.cuda.synchronize()
            prof["wall"] = 1e3 * (time.time() - prof["t0"])
            prof["p"].stop()
        return metrics

    Trainer.train_step = profiled_step
    try:
        yield prof
    finally:
        Trainer.train_step = real_step


class DeviceTimes(NamedTuple):
    """One event name's totals over a profiled window, in microseconds."""
    key: str
    self_device_time_total: float  # its events' spans on the card
    cpu_time_total: float  # its events' spans on the host
    count: int


def device_times(p) -> tuple:
    """(rows by name, most device time first; the card's busy ms) of a
    stopped ``torch.profiler.profile``, read from its raw trace events.
    The busy time is what the profiler's table calls "Self CUDA time
    total": the spans of the device events but the user ranges'; a user
    range's span on the card (a ``record_function``) stays in its row.
    The profiler's own per-op events (``events()``, ``key_averages()``)
    took 48 s to build for one depth-40 VL pretrain update's 387k events on
    the card's host; this reads the same trace in about 2 s."""
    from torch.autograd import DeviceType

    rows, busy = {}, 0.0
    for e in p.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)() or e.is_async():
            continue
        us = e.duration_ns() / 1e3
        row = rows.setdefault(e.name(), [0.0, 0.0, 0])
        if e.device_type() == DeviceType.CUDA:
            row[0] += us
            busy += 0.0 if e.is_user_annotation() else us
        else:
            row[1] += us
        row[2] += 1
    return (sorted((DeviceTimes(k, *v) for k, v in rows.items()),
                   key=lambda r: -r.self_device_time_total), busy / 1e3)


def device_table(rows, busy_ms: float, limit: int) -> str:
    """The first ``limit`` rows of ``device_times``: device ms, share of the
    busy time, host ms, events, name; then the busy total."""
    lines = [f"{'device ms':>11} {'% busy':>7} {'host ms':>10} {'events':>7}  name"]
    for r in rows[:limit]:
        lines.append(f"{r.self_device_time_total / 1e3:11.3f} "
                     f"{100 * r.self_device_time_total / 1e3 / busy_ms:7.2f} "
                     f"{r.cpu_time_total / 1e3:10.3f} {r.count:7d}  {r.key[:100]}")
    return "\n".join(lines + [f"Self CUDA time total: {busy_ms:.3f}ms"])


def update_averages(prof: dict):
    """The profiled update's ``device_times`` rows, computed once."""
    if "averages" not in prof:
        prof["averages"], prof["busy"] = device_times(prof["p"])
    return prof["averages"]


def profile_busy_ms(prof: dict) -> float:
    """The profiled update's device busy time ("Self CUDA time total")."""
    update_averages(prof)
    return prof["busy"]


def write_update_profile(prof: dict, ms: float, what: str, file_name: str, card: str) -> str:
    """The device's busy time and idle share of the profiled update, against
    the unprofiled steady ``ms`` and the profiled update's own wall time;
    the top event names by device time go to ``chiprun_out/<file_name>``.
    Returns the line."""
    table = device_table(update_averages(prof), profile_busy_ms(prof), 25)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    busy = profile_busy_ms(prof)
    line = (f"{what}: device busy {busy:.1f} ms; idle {100 * (1 - busy / ms):.1f}% of the "
            f"unprofiled steady {ms:.1f} ms, {100 * (1 - busy / prof['wall']):.1f}% of this "
            f"profiled update's {prof['wall']:.1f} ms")
    (out / file_name).write_text(f"{card}\n{line}\n\n{table}")
    return line


def train_cli_full_depth(data: dict, card: str, ms_7b: float) -> dict:
    """Phase 13(c): the recipe at the 4B width, depth ``CUT_DEPTH``, through
    ``cli.train`` from no checkpoint (the config's init), B=32, 6 updates
    and one validation over the 64 valid rows; no step saves, no best
    export.  Update 4 runs under torch.profiler, from the end of update 3
    (so the batch's fetch and copy are inside)."""
    import one_peace_tpu_torch.cli.train as train_cli

    layers = CUT_DEPTH
    save_dir = data["root"] / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = retrieval_argv(data, save_dir, layers, 32, [
        "optimization.max_update=6", "dataset.validate_interval=2",
        "checkpoint.save_interval=1000", "checkpoint.best_checkpoint_metric=",
        f"common.log_file={save_dir}/log.jsonl"])
    valid_launches = []
    real_validate = train_cli.validate

    def counted_validate(*args):
        f0, b0 = fa.launches, fa.bwd_launches
        stats = real_validate(*args)
        valid_launches.append((fa.launches - f0, fa.bwd_launches - b0, stats))
        return stats

    torch.cuda.reset_peak_memory_stats()
    train_cli.validate = counted_validate
    try:
        with profiled_update(4) as prof, recorded_steps() as steps:
            t0 = time.time()
            run_train_cli(argv)
            wall = time.time() - t0
    finally:
        train_cli.validate = real_validate
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    step_ms = [1e3 * (s["t1"] - s["t0"]) for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (4, 6)]  # not profiled or rolled over
    ms = sum(steady) / len(steady)
    log(f"13(c) cli.train at depth {layers}, B=32, 6 updates from the config's init in {wall:.1f} s "
        f"(model build, data and validation included) ({card})")
    log(f"13(c) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(x, 1) for x in step_ms]} (update 1 warms up)")
    log(f"13(c) updates 2-6 from data, each from the end of the last (the batch's fetch and "
        f"copy included; 4 profiled, 6 after the epoch's end): "
        f"{[round(x, 1) for x in update_ms]} ms, beside phase 7(b)'s {ms_7b:.1f} ms per step "
        f"at depth 40 on hand-built batches in this run; steady {ms:.1f} ms per update, "
        f"{32 / ms * 1e3:.1f} pairs/s, peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    log(f"13(c) launches per update (#1, #2): {per_update}; validation: "
        f"{[(f, b) for f, b, _ in valid_launches]} over 64 images and 320 texts; "
        f"its stats {[s for _, _, s in valid_launches]}")
    if "wall" in prof:
        line = write_update_profile(prof, ms, f"update 4 of cli.train at depth {layers}, B=32, "
                                    "from the end of update 3", "train_cli_profile.txt", card)
        log(f"13(c) {line} (chiprun_out/train_cli_profile.txt)")
    if not all(map(math.isfinite, losses)) or len(losses) != 6:
        raise RuntimeError(f"13(c): losses {losses}")
    if min(s["fwd"] for s in steps) == 0 or min(s["bwd"] for s in steps) == 0:
        raise RuntimeError("13(c): an update launched no attention kernel")
    if len(valid_launches) != 1 or valid_launches[0][0] == 0 or valid_launches[0][1] != 0:
        raise RuntimeError(f"13(c): validation launches {valid_launches}")
    return {"ms": ms, "peak_gib": peak, "launches": per_update,
            "valid_launches": valid_launches[0][:2], "losses": losses}


COCO_DIR = ROOT / "build" / "smoke_coco"
# COCO's 80 category ids: 1..90 with gaps (instances_*.json "categories")
COCO_CATEGORY_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28]
                     + list(range(31, 45)) + list(range(46, 66)) + [67, 70]
                     + list(range(72, 83)) + list(range(84, 91)))
COCO_SIZES = ((640, 480), (480, 640), (1024, 768), (333, 500))  # (width, height)


def rle_encode(mask: np.ndarray, compressed: bool) -> dict:
    """A (h, w) 0/1 mask as COCO RLE: column-major runs starting with 0s,
    as a list, or in pycocotools' compressed string (each run less the one
    two back from the third on, 5 bits a character, offset 48)."""
    flat = mask.T.ravel().astype(np.int8)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    counts = np.diff(np.concatenate([[0], change])).tolist()
    if not compressed:
        return {"counts": counts, "size": list(mask.shape)}
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"counts": "".join(out), "size": list(mask.shape)}


def write_coco_corpus(root: Path, n_train: int, n_valid: int, sizes=COCO_SIZES,
                      category_ids=COCO_CATEGORY_IDS, ext: str = "jpg", seed: int = 14) -> dict:
    """Phase 14(a): a synthetic COCO tree under ``root``: ``train/`` and
    ``valid/`` images at ``sizes`` in turn, and ``instances_{train,valid}.json``
    with ``category_ids`` (COCO's non-contiguous 80 by default).  Each image
    holds 2-5 objects painted in a colour of their class, whose masks are in
    turn a polygon, compressed RLE and uncompressed RLE; one crowd region
    (uncompressed RLE, as COCO stores crowds); and a box 0.2 px wide, which
    every resize up to 5x drops.  Returns the paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    palette = rng.randint(40, 255, (len(category_ids), 3))
    paths = {}
    for split, n in (("train", n_train), ("valid", n_valid)):
        (root / split).mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            w, h = sizes[i % len(sizes)]
            img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            objects = []
            for j in range(rng.randint(2, 6)):
                bw, bh = rng.uniform(0.15, 0.5) * w, rng.uniform(0.15, 0.5) * h
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                cat = int(rng.randint(len(category_ids)))
                inside = (((xx + 0.5 - x0 - bw / 2) / (bw / 2)) ** 2
                          + ((yy + 0.5 - y0 - bh / 2) / (bh / 2)) ** 2) <= 1
                img[inside] = palette[cat]
                kind = j % 3
                if kind == 0:  # a diamond polygon
                    cx, cy = x0 + bw / 2, y0 + bh / 2
                    seg = [[cx, y0, x0 + bw, cy, cx, y0 + bh, x0, cy]]
                    area = bw * bh / 2
                else:
                    seg = rle_encode(inside.astype(np.uint8), compressed=kind == 1)
                    area = float(inside.sum())
                objects.append((cat, [x0, y0, bw, bh], seg, area, 0))
            cw, ch = 0.3 * w, 0.3 * h  # a crowd region in a corner
            crowd = (xx < cw) & (yy >= h - ch)
            objects.append((int(rng.randint(len(category_ids))), [0.0, h - ch, cw, ch],
                            rle_encode(crowd.astype(np.uint8), compressed=False),
                            float(crowd.sum()), 1))
            objects.append((0, [w / 2, h / 2, 0.2, 0.3 * h],
                            [[w / 2, h / 2, w / 2 + 0.2, h / 2, w / 2 + 0.2, h * 0.8]], 0.1, 0))
            name = f"{split}{i}.{ext}"
            Image.fromarray(img).save(root / split / name)
            image_id = 1000 * (split == "valid") + 7 * i + 3
            images.append({"id": image_id, "file_name": name, "width": w, "height": h})
            for cat, bbox, seg, area, iscrowd in objects:
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": category_ids[cat], "bbox": [float(v) for v in bbox],
                             "area": float(area), "iscrowd": iscrowd, "segmentation": seg})
        ann = root / f"instances_{split}.json"
        ann.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"class{c}"} for c in category_ids]}))
        paths[split] = {"ann": str(ann), "images": str(root / split)}
    return paths


def det_cli_argv(paths: dict, save_dir: Path, layers: int, extra=()) -> list:
    """``cli.train`` / ``cli.evaluate`` arguments: the detection recipe (1024
    px, RPN, cascade and masks, 80 classes; d 1536, FFN 6144, 24 heads; bf16
    over fp32 masters, remat, drop path 0.6, AdamW with layer decay) on the
    synthetic COCO tree, ``layers`` deep, B=2, the recipe's valid batch of 8,
    the warm-up cut to 0 (as in 12(c)), no epoch saves; then ``extra``.
    Below 4 layers every ``layers``-th layer is global (at 2: one windowed,
    one global), so that both kinds run."""
    return ["--config", str(DET_RECIPE), "--device", "cuda",
            f"task.data={paths['train']['ann']}", f"task.image_dir={paths['train']['images']}",
            f"task.valid_data={paths['valid']['ann']}",
            f"task.valid_image_dir={paths['valid']['images']}",
            f"model.encoder.layers={layers}", f"task.global_period={min(layers, 4)}",
            "dataset.batch_size=2",
            "lr_scheduler.warmup_updates=0", "common.log_interval=1", "common.seed=3407",
            f"checkpoint.save_dir={save_dir}", "checkpoint.save_interval=1000",
            f"common.log_file={save_dir}/log.jsonl", ONE_PROCESS, *extra]


@contextlib.contextmanager
def recorded_validation(keep_masters: bool = False):
    """Record each validation of ``cli.train``: its stats, wall time and det
    attention launches, and inside it the time of ``detect()`` (the card
    synchronised), of the rest of ``valid_step`` (the host's mask paste and
    per-image AP records) and of ``merge_results`` (the AP sweep), and
    ``detect()``'s outputs; with ``keep_masters``, a host copy of the
    masters."""
    import one_peace_tpu_torch.cli.train as train_cli

    runs, cur = [], {}
    real = (train_cli.validate, CocoDetectionTask.detect, CocoDetectionTask.valid_step,
            CocoDetectionTask.merge_results)

    def timed(key, fn, sync=False):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            cur[key] = cur.get(key, 0.0) + 1e3 * (time.time() - t0)
            if key == "detect_ms":
                cur["dets"] = cur.get("dets", 0) + sum(len(r["boxes"]) for r in out)
                cur.setdefault("outputs", []).append(out)
            return out
        return run

    def validate(cfg, task, model, trainer, progress):
        cur.clear()
        if keep_masters:
            cur["masters"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        f0, b0 = da.launches, da.bwd_launches
        stats = timed("wall_ms", real[0], sync=True)(cfg, task, model, trainer, progress)
        runs.append({**cur, "stats": stats, "fwd": da.launches - f0, "bwd": da.bwd_launches - b0})
        return stats

    train_cli.validate = validate
    CocoDetectionTask.detect = timed("detect_ms", real[1], sync=True)
    CocoDetectionTask.valid_step = timed("valid_step_ms", real[2])
    CocoDetectionTask.merge_results = timed("merge_ms", real[3])
    try:
        yield runs
    finally:
        (train_cli.validate, CocoDetectionTask.detect, CocoDetectionTask.valid_step,
         CocoDetectionTask.merge_results) = real


def validation_line(run: dict) -> str:
    paste = run["valid_step_ms"] - run["detect_ms"]
    rest = run["wall_ms"] - run["valid_step_ms"] - run["merge_ms"]
    return (f"{run['wall_ms']:.1f} ms: detect() {run['detect_ms']:.1f} ms over "
            f"{len(run['outputs'])} calls, the host's mask paste and per-image records "
            f"{paste:.1f} ms, the AP sweep {run['merge_ms']:.1f} ms, data and the rest "
            f"{rest:.1f} ms; {run['dets']} detections")


def check_det_cli(paths: dict, card: str, layers: int = 2) -> dict:
    """Phase 14(b): the recipe at full width, depth ``layers``, through
    ``cli.train``: 2 updates at B=2 from the config's init, one validation
    over the 8 valid images and ``checkpoint_best.npz``.  The export, read
    back through ``params_from_jax``, must equal the masters at the
    validation bit for bit; ``cli.evaluate`` on the export (bf16, as the
    recipe) must detect what the validation detected, bit for bit, and print
    its AP dict to 1e-6."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils.checkpoint import params_from_jax
    from one_peace_tpu_torch.utils.native_checkpoint import load_params

    save_dir = COCO_DIR / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = det_cli_argv(paths, save_dir, layers, ["optimization.max_update=2",
                                                  "dataset.validate_interval_updates=2"])
    t0 = time.time()
    with recorded_validation(keep_masters=True) as runs, recorded_steps(da) as steps:
        run_train_cli(argv)
    losses = update_losses(save_dir / "log.jsonl")
    log(f"14(b) cli.train, depth {layers}, B=2: update losses {losses}, launches per update "
        f"(#4, #5/#6) {sorted({(s['fwd'], s['bwd']) for s in steps})} "
        f"({time.time() - t0:.1f} s with the model's build)")
    if len(runs) != 1 or len(losses) != 2 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"14(b): {len(runs)} validations, losses {losses}")
    run = runs[0]
    log(f"14(b) validation: {validation_line(run)}; stats {run['stats']}")
    best = save_dir / "checkpoint_best.npz"
    export = params_from_jax(load_params(str(best)))
    masters = run["masters"]
    equal = export.keys() == masters.keys() and all(
        export[k].dtype == masters[k].dtype and torch.equal(export[k], masters[k]) for k in masters)
    log(f"14(b) checkpoint_best.npz through params_from_jax: {len(export)} tensors, bit-equal "
        f"to the masters at the validation: {equal}")
    if not equal:
        raise RuntimeError("14(b): the best export does not read back as the run's masters")
    out, outputs = save_dir / "eval.json", []
    real_detect = CocoDetectionTask.detect
    CocoDetectionTask.detect = lambda self, *args: outputs.append(real_detect(self, *args)) \
        or outputs[-1]
    try:
        evaluate_cli.main(["--path", str(best), "--output", str(out), *argv])
    finally:
        CocoDetectionTask.detect = real_detect
    stats = json.loads(out.read_text())
    keys = [k for k in stats if not k.startswith("eval_")]
    worst = max(abs(stats[k] - run["stats"][k]) for k in keys)
    same = len(outputs) == len(run["outputs"]) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for x, y in zip(outputs, run["outputs"]) for a, b in zip(x, y))
    log(f"14(b) cli.evaluate on checkpoint_best.npz: {stats}; largest difference from the "
        f"validation's {worst:.3e} over {len(keys)} numbers; its {run['dets']} detections "
        f"(boxes, scores, labels, masks) bit-equal to the validation's: {same}")
    if set(keys) - set(run["stats"]) or worst > 1e-6 or not same:
        raise RuntimeError("14(b): cli.evaluate disagrees with the run's validation")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ap": run["stats"], "eval_diff": worst}


def time_host_eval(paths: dict, card: str) -> str:
    """The host's share of validation at the most detections the recipe keeps
    (100 per image): ``valid_step`` on one valid batch of 8 with ``detect``
    replaced by 100 synthetic detections per image (random boxes, labels,
    scores and 28 x 28 mask probabilities), then ``merge_results``."""
    cfg = det_config([f"task.valid_data={paths['valid']['ann']}",
                      f"task.image_dir={paths['valid']['images']}"])
    task = CocoDetectionTask(cfg.task, cfg)
    task.load_dataset("valid")
    batch = next(iter(task.get_batch_iterator("valid", 8, ensure_equal_batch=False)
                      .next_epoch_itr()))
    rs = np.random.RandomState(14)
    size, n = cfg.task.image_size, 100
    dets = []
    for _ in range(len(batch["id"])):
        xy = rs.uniform(0, size * 0.8, (n, 2))
        wh = rs.uniform(16, size * 0.4, (n, 2))
        dets.append({"boxes": np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(np.float32),
                     "scores": rs.uniform(0.05, 1, n).astype(np.float32),
                     "labels": rs.randint(0, cfg.task.num_classes, n),
                     "masks": rs.uniform(0, 1, (n, 28, 28)).astype(np.float32)})
    task.detect = lambda model, params, images: dets
    task.begin_valid_epoch(None, None)
    t0 = time.time()
    task.valid_step(None, None, batch)
    t1 = time.time()
    task.merge_results()
    t2 = time.time()
    return (f"{1e3 * (t1 - t0):.1f} ms for the mask paste and per-image records of "
            f"{len(dets)} images at {n} detections each ({1e3 * (t1 - t0) / len(dets):.1f} ms an "
            f"image), {1e3 * (t2 - t1):.1f} ms for the AP sweep (host, beside {card})")


def train_det_cli_full_depth(paths: dict, card: str, ms_12c: float) -> dict:
    """Phase 14(c): the recipe at depth ``CUT_DEPTH`` through ``cli.train`` from the
    config's init (``init_detector_``), B=2, 4 updates and one validation
    over the 8 valid images; no saves, no best export.  Update 4 runs under
    torch.profiler from the end of update 3.  The det attention must launch
    twice a layer forward (the layers and their recompute) and once backward
    per update, as in 12(c), and once a layer per ``detect()`` in validation
    (11(b)), no backward."""
    layers = CUT_DEPTH
    save_dir = COCO_DIR / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = det_cli_argv(paths, save_dir, layers, ["optimization.max_update=4",
                                              "dataset.validate_interval_updates=4",
                                              "checkpoint.best_checkpoint_metric="])
    torch.cuda.reset_peak_memory_stats()
    with profiled_update(4) as prof, recorded_validation() as runs, \
            recorded_steps(da) as steps:
        t0 = time.time()
        run_train_cli(argv)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = [ms for i, ms in enumerate(update_ms, 2) if i != 4]  # 4 is profiled
    ms = sum(steady) / len(steady)
    log(f"14(c) cli.train at depth {layers}, B=2, 4 updates from the config's init in {wall:.1f} s "
        f"(model build, data and validation included) ({card})")
    log(f"14(c) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"14(c) updates 2-4 from data, each from the end of the last (the batch's fetch and "
        f"copy included; 4 profiled): {[round(x, 1) for x in update_ms]} ms, beside phase "
        f"12(c)'s {ms_12c:.1f} ms per step at depth 40 on a hand-built batch in this run; steady "
        f"{ms:.1f} ms per update, {2 / ms * 1e3:.2f} images/s, peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 4 of cli.train, detection recipe at "
                                    f"depth {layers}, B=2, from the end of update 3",
                                    "det_cli_profile.txt", card)
        log(f"14(c) {line} (chiprun_out/det_cli_profile.txt)")
    calls = -(-8 // 8)  # detect() calls over 8 valid images at the recipe's valid batch
    want = (2 * layers, layers)
    log(f"14(c) launches per update (#4, #5/#6): {per_update} (expected [{want}]); "
        f"validation: {[(r['fwd'], r['bwd']) for r in runs]} (expected {[(layers * calls, 0)]})")
    for r in runs:
        log(f"14(c) validation over 8 images: {validation_line(r)} ({card})")
        log(f"14(c) validation stats {r['stats']}")
    log(f"14(c) host evaluation at 100 detections per image: {time_host_eval(paths, card)}")
    if not all(map(math.isfinite, losses)) or len(losses) != 4:
        raise RuntimeError(f"14(c): losses {losses}")
    if per_update != [want]:
        raise RuntimeError(f"14(c): det attention launches per update {per_update}, "
                           f"expected [{want}]")
    if [(r["fwd"], r["bwd"]) for r in runs] != [(layers * calls, 0)]:
        raise RuntimeError(f"14(c): validation launches differ from {layers} per detect() call")
    return {"ms": ms, "peak_gib": peak, "launches": per_update, "losses": losses,
            "valid": {k: v for k, v in runs[0].items() if k != "masters"}}


CLASSIFY_DIR = ROOT / "build" / "smoke_classify"
CLASSIFY_RECIPES = {task: ROOT / "recipes" / task / "base.yaml"
                    for task in ("image_classify", "vqa", "vggsound")}
VQA_ANSWERS = 3129  # VqaDataset's answer_cnt
VGGSOUND_CLASSES = 309


def write_wav(path: Path, samples: np.ndarray, rate: int = 16000) -> None:
    import wave

    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(np.asarray(samples, np.int16).tobytes())


def write_classify_corpus(root: Path, n_train: int = 48, n_valid: int = 16,
                          clip_seconds=(5.0, 15.0)) -> dict:
    """Phase 15(c): ``n_train + n_valid`` JPEGs (256-399 px) with an
    image_classify TSV of 10 classes and a VQA TSV (``id, image, question,
    refs``, each ref ``answer|!+label|!+confidence`` over the 3129 answers,
    joined by ``&&``), WAV clips of ``clip_seconds`` with a VGGSound TSV
    (``id, audio, label, duration``, 10 of its 309 classes), each split into
    train and valid, and the byte-level BPE set.  Returns the paths."""
    rng = np.random.RandomState(15)
    root.mkdir(parents=True, exist_ok=True)
    n = n_train + n_valid
    tables = {"image_classify": ["image\tlabel"], "vqa": ["id\timage\tquestion\trefs"],
              "vggsound": ["id\taudio\tlabel\tduration"]}
    for i, img in enumerate(retrieval_images(n, rng)):
        img.save(root / f"img{i}.jpg", quality=92)
        tables["image_classify"].append(f"img{i}.jpg\t{i % 10}")
        question = " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), 3 + i % 8))
        answers = rng.choice(VQA_ANSWERS, 1 + i % 3, replace=False)
        refs = "&&".join(f"{WORDS[a % len(WORDS)]}|!+{a}|!+{rng.choice([0.3, 0.6, 0.9, 1.0])}"
                         for a in answers)
        tables["vqa"].append(f"{i}\timg{i}.jpg\t{question}?\t{refs}")
        samples = int(16000 * rng.uniform(*clip_seconds))
        t = np.arange(samples)
        wav = np.sin(t * (0.01 + 0.002 * (i % 10))) * 6000 + rng.randn(samples) * 700
        write_wav(root / f"clip{i}.wav", wav)
        tables["vggsound"].append(f"{i}\tclip{i}.wav\t{i % 10}\t{samples / 16000:.3f}")
    out = {"root": root, "bpe": write_bpe_dir(root / "bpe")}
    for task, rows in tables.items():
        for split, part in (("train", rows[1:n_train + 1]), ("valid", rows[n_train + 1:])):
            (root / f"{task}_{split}.tsv").write_text("\n".join([rows[0], *part]) + "\n")
        out[task] = {split: str(root / f"{task}_{split}.tsv") for split in ("train", "valid")}
    return out


CLASSIFY_HEADS = {  # task: (head type, px, classes, the head's kwargs in 15(a) and 15(b))
    "image_classify": ("image", 384, 1000, {"attn_pooling": True}),
    "vqa": ("vl", 480, VQA_ANSWERS, {}),
    "vggsound": ("audio", 256, VGGSOUND_CLASSES, {}),
}
HEAD_MODALITIES = {"image": ("image",), "vl": ("text", "image"), "audio": ("audio",)}
VQA_QUESTIONS = ["what color is the dog on the left", "how many people are there",
                 "is it raining", "what is the man holding in his hand"]


def classify_head_state(d: int, heads: int, num_classes: int, attn_pooling: bool,
                        seed: int) -> dict:
    """A seeded fairseq ``classify_head`` (the names of
    ``tests/torch_fixture.add_classify_head_state``): norm, the attention
    pooling's k/v/out projections and query, and ``classifier.{0,1,3}``."""
    rng = np.random.RandomState(seed)

    def draw(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {"classify_head.norm.weight": 1 + draw(d, scale=0.1),
          "classify_head.norm.bias": draw(d, scale=0.02)}
    if attn_pooling:
        pre = "classify_head.attn_pooling_func"
        sd.update({f"{pre}.k_proj.weight": draw(d, d, scale=0.02),
                   f"{pre}.v_proj.weight": draw(d, d, scale=0.02),
                   f"{pre}.v_proj.bias": draw(d, scale=0.02),
                   f"{pre}.out_proj.weight": draw(d, d, scale=0.02),
                   f"{pre}.out_proj.bias": draw(d, scale=0.02),
                   f"{pre}.q": draw(1, 1, heads, d // heads, scale=0.1)})
    sd.update({"classify_head.classifier.0.weight": draw(d, d, scale=0.02),
               "classify_head.classifier.0.bias": draw(d, scale=0.02),
               "classify_head.classifier.1.weight": 1 + draw(d, scale=0.1),
               "classify_head.classifier.1.bias": draw(d, scale=0.02),
               "classify_head.classifier.3.weight": draw(num_classes, d, scale=0.02),
               "classify_head.classifier.3.bias": draw(num_classes, scale=0.02)})
    return sd


def audio_clips(lengths, rng) -> tuple:
    """Waveforms of ``lengths`` samples padded to the longest, on the card,
    and their frame padding masks (CLS kept)."""
    spec = ModelConfig().encoder.audio_adapter.feature_encoder_spec
    wav = np.zeros((len(lengths), max(lengths)), np.float32)
    pad = np.ones((len(lengths), conv_output_length(max(lengths), spec) + 1), bool)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.randn(n) * 0.5
        pad[i, :conv_output_length(n, spec) + 1] = False
    return torch.from_numpy(wav).cuda(), torch.from_numpy(pad).cuda()


def classify_logits(hub, head: str, inputs: dict) -> torch.Tensor:
    """The hub's classify forward: ``extract_image_features`` /
    ``extract_audio_features`` give the logits; a vl head takes text and
    image together, so it runs the model under inference mode."""
    if head == "image":
        return hub.extract_image_features(inputs["src_images"])
    if head == "audio":
        return hub.extract_audio_features(inputs["src_audios"], inputs["audio_padding_masks"])
    with torch.inference_mode():
        return hub.model(**inputs)


def write_classify_hub_pts(work: Path) -> tuple:
    """15(a)'s set-up: a BPE set and, per head, a 2-layer full-width fairseq
    ``.pt`` under ``work``: the trunk from ``make_random_state_dict`` (seed
    15) without the branches the head does not use, and a seeded head."""
    work.mkdir(parents=True, exist_ok=True)
    bpe = write_bpe_dir(work / "bpe")
    base = ModelConfig(head_type="val")
    base.encoder.layers = 2
    enc = base.encoder
    trunk = make_random_state_dict(base, seed=15)
    pts = {}
    for task, (head, px, classes, kw) in CLASSIFY_HEADS.items():
        drop = [m for m in ("text", "image", "audio") if m not in HEAD_MODALITIES[head]]
        sd = {k: v for k, v in trunk.items()
              if not any(f".{m}_{part}" in k for m in drop
                         for part in ("adapter.", "ffn.", "layer_norm."))}
        sd.update(classify_head_state(enc.embed_dim, enc.attention_heads, classes,
                                      kw.get("attn_pooling", False), seed=len(task)))
        pts[task] = work / f"{task}.pt"
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pts[task])
        del sd
    return bpe, pts


def serve_classify(card: str, prep: "Prep") -> dict:
    """Phase 15(a): classify serving at full width through the hub.  A
    2-layer full-width fairseq ``.pt`` per head (the trunk's branches the
    head uses, 16 x 16 pretrained image tables, a seeded head), loaded by
    ``from_pretrained(model_type="one_peace_classify")`` in fp32: an image
    head at 384 px with attention pooling, a vl head at 480 px, an audio
    head.  fp32, and bf16 (the loaded weights cast, as ``from_pretrained(
    dtype="bf16")`` casts them): the kernel path against the plain path
    (cosine per sample >= 1-1e-6 / 0.999), 2 launches of #1 per forward;
    then the same model quantized as ``from_pretrained(quantize="ffn")``
    quantizes it (``quantize_ffn_`` after the cast; phase 9 loads "ffn" and
    bf16 through ``from_pretrained`` itself), the int8 kernels against the
    plain int8 path, with their launches.  Returns the int8 kernels' launches over the
    kernel-path forwards."""
    base = ModelConfig(head_type="val")
    base.encoder.layers = 2
    enc = base.encoder
    bpe, pts = prep.take("15(a)", "the heads' 2-layer full-width fairseq .pt files")
    rng = np.random.RandomState(151)
    launched = {"gemm": 0, "quantize": 0}
    bounds = {"float32": 1 - 1e-6, "bf16": 0.999}
    for task, (head, px, classes, kw) in CLASSIFY_HEADS.items():
        pt = pts[task]
        cfg = copy.deepcopy(base)
        cfg._name, cfg.head_type = "one_peace_classify", head
        cfg.encoder.image_adapter.rel_bucket_size = px // 16
        task_cfg = TaskConfig(patch_image_size=px)
        inputs = None
        t0 = time.time()
        hub = port_hub.from_pretrained(
            str(pt), model_type="one_peace_classify", dtype="float32", bpe_dir=bpe,
            model_cfg=cfg, task_cfg=task_cfg, num_classes=classes, classify_kwargs=kw,
            device="cuda")
        weights32 = copy.deepcopy(hub.model)  # bf16 below: these weights cast, as the hub casts
        for dtype in ("float32", "bf16"):
            reference = None
            if dtype == "bf16":
                t0 = time.time()
                hub = port_hub.OnePeaceHubInterface(cfg, task_cfg, weights32.to(torch.bfloat16),
                                                    dtype=torch.bfloat16, bpe_dir=bpe)
            model = hub.model
            for quantize in ("none", "ffn"):
                if quantize == "ffn":
                    t0 = time.time()
                    quantize_ffn_(model)
                if inputs is None:
                    inputs = {}
                    if head in ("image", "vl"):
                        inputs["src_images"] = hub.process_image(smooth_images(4, rng))
                        table = model.encoder_wrapper.image_adapter.rel_pos_table
                        grid = 2 * (px // 16) - 1
                        log(f"15(a) {task}: the 16 x 16 pretrained rel-pos tables loaded as "
                            f"{tuple(table.shape)} ({grid} x {grid} + 3 rows at {px} px)")
                        if tuple(table.shape) != (2, grid * grid + 3, enc.attention_heads):
                            raise RuntimeError(f"15(a) {task}: rel-pos table {table.shape}")
                    if head == "vl":
                        inputs["src_tokens"] = hub.process_text(VQA_QUESTIONS)
                    if head == "audio":
                        inputs["src_audios"], inputs["audio_padding_masks"] = hub.process_audio(
                            [rng.randn(16000 * s).astype(np.float32) * 0.1 for s in (15, 5, 9, 12)])
                inputs = {k: v.to(hub.dtype) if v.is_floating_point() else v
                          for k, v in inputs.items()}
                if quantize == "none":
                    outs = {}
                    for impl in ("pallas", "xla"):
                        model.cfg.encoder.attn_impl = impl
                        before = fa.launches
                        outs[impl] = classify_logits(hub, head, inputs).float()
                        torch.cuda.synchronize()
                        want = 2 if impl == "pallas" else 0
                        if fa.launches - before != want:
                            raise RuntimeError(f"15(a) {task} {impl}: {fa.launches - before} "
                                               f"launches of #1 per forward, expected {want}")
                    model.cfg.encoder.attn_impl = "pallas"
                    got, plain = outs["pallas"], outs["xla"]
                    reference = plain
                    what, counts = "plain path", "2 launches of #1 per kernel-path forward"
                else:
                    before = (im.launches, im.quantize_launches)
                    got = classify_logits(hub, head, inputs).float()
                    torch.cuda.synchronize()
                    counts = (im.launches - before[0], im.quantize_launches - before[1])
                    per = len(HEAD_MODALITIES[head]) * enc.layers
                    if counts != (3 * per, 2 * per):
                        raise RuntimeError(f"15(a) {task} ffn: launches {counts}, expected "
                                           f"{(3 * per, 2 * per)}")
                    launched["gemm"] += counts[0]
                    launched["quantize"] += counts[1]
                    with plain_int8():
                        plain = classify_logits(hub, head, inputs).float()
                    what = "plain int8 path"
                    counts = (f"{counts[0]} GEMM and {counts[1]} quantize per forward; "
                              f"vs unquantized {dtype} {min_cosine(got, reference):.6f}")
                b = got.shape[0]
                if got.shape != (b, classes) or not torch.isfinite(got).all():
                    raise RuntimeError(f"15(a) {task}: bad logits {tuple(got.shape)}")
                cos = min_cosine(got, plain)
                log(f"15(a) {task} {head} head {px} px {dtype} quantize={quantize} B={b}: min "
                    f"cosine of the logits kernel vs {what} {cos:.9f} (bound {bounds[dtype]}); "
                    f"{counts}; " + ("the hub and the forwards" if quantize == "none"
                                     else "the quantize and the forwards")
                    + f" {time.time() - t0:.1f} s")
                if cos < bounds[dtype]:
                    raise RuntimeError(f"15(a) {task} {dtype} {quantize}: the kernel path "
                                       f"disagrees with the {what}")
            del hub, model
            torch.cuda.empty_cache()
        del weights32
        pt.unlink()
    return launched


def classify_train_config(task: str, layers: int, bf16: bool, remat: bool,
                          drop_path: float) -> FrameworkConfig:
    """The task's fine-tune at the 4B width, ``layers`` deep: the classify
    criterion (BCE over the answers for VQA, label smoothing 0.1 for
    VGGSound), AdamW as ``train_config``."""
    head, px, classes, _ = CLASSIFY_HEADS[task]
    cfg = train_config(layers, bf16, remat, drop_path)
    cfg.model = ModelConfig(_name="one_peace_classify", head_type=head)
    enc = cfg.model.encoder
    enc.layers, enc.checkpoint_activations, enc.drop_path_rate = layers, remat, drop_path
    enc.image_adapter.rel_bucket_size = px // 16
    cfg.task.patch_image_size, cfg.task.num_classes = px, classes
    cfg.criterion._name = "classify_criterion"
    cfg.criterion.use_multi_label = task == "vqa"
    cfg.criterion.label_smoothing = 0.1 if task == "vggsound" else 0.0
    return cfg


def classify_trainer(cfg, task: str, seed: int = 0) -> Trainer:
    model = OnePeaceClassifyModel(cfg.model, cfg.task.num_classes, device="cuda",
                                  **CLASSIFY_HEADS[task][3])
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def classify_batch(task: str, rng) -> dict:
    """15(b)'s batch: image_classify B=8 at 384 px through Mixup + CutMix
    (soft targets over 1000 classes); VQA B=4 at 480 px with 70-token
    questions with pads and 1-3 answer confidences of 3129; VGGSound B=8
    clips of 5-15 s (key pads)."""
    if task == "image_classify":
        images = rng.randn(8, 3, 384, 384).astype(np.float32)
        mixer = Mixup(0.8, 1.0, label_smoothing=0.1, num_classes=1000, seed=15)
        images, target = mixer(images, rng.randint(0, 1000, 8))
        return {"src_images": torch.from_numpy(images).cuda(),
                "target": torch.from_numpy(target).cuda()}
    if task == "vqa":
        tokens = torch.from_numpy(rng.randint(4, 260, (4, 70))).cuda()
        tokens[text_pad_mask(4, 71)[:, 1:]] = ModelConfig().encoder.text_adapter.padding_idx
        target = np.zeros((4, VQA_ANSWERS), np.float32)
        for row in target:
            row[rng.choice(VQA_ANSWERS, 3, replace=False)] = (0.3, 0.6, 1.0)
        return {"src_tokens": tokens,
                "src_images": torch.from_numpy(rng.randn(4, 3, 480, 480).astype(np.float32)).cuda(),
                "target": torch.from_numpy(target).cuda()}
    wav, pad = audio_clips([int(16000 * s) for s in rng.uniform(5, 15, 8)], rng)
    return {"src_audios": wav, "audio_padding_masks": pad,
            "target": torch.from_numpy(rng.randint(0, VGGSOUND_CLASSES, 8)).cuda()}


CLASSIFY_CHECK_LAYERS = 2  # 15(b)'s depth (4 until PR 20): the bounds do not depend on it


def check_classify_train_paths() -> None:
    """Phase 15(b): each task's fine-tuning gradients at
    ``CLASSIFY_CHECK_LAYERS`` layers, full width, through ``Trainer`` with
    the classify criterion, kernel path
    against plain path on the same weights and batch, with phase 7(a)'s
    bounds: fp32 losses within 1e-5 and every gradient's cosine >= 1-1e-6;
    bf16 the kernel path no further from the fp32 gradients than the plain
    path (per parameter within 0.01, all together >= 0.999), losses within
    2e-3.  Then 3 AdamW steps on each path (losses within 1e-4 / 2e-2)."""
    rng = np.random.RandomState(152)
    for task in CLASSIFY_HEADS:
        batch = classify_batch(task, rng)
        lengths = {k: tuple(v.shape) for k, v in batch.items()}
        ref32 = None
        for bf16 in (False, True):
            name = "bf16" if bf16 else "fp32"
            cfg = classify_train_config(task, CLASSIFY_CHECK_LAYERS, bf16, False, 0.0)
            trainer = classify_trainer(cfg, task)
            runs = {}
            for impl in ("pallas", "xla"):
                trainer.model.cfg.encoder.attn_impl = impl
                before = (fa.launches, fa.bwd_launches)
                metrics, grads = trainer.gradients(batch)
                torch.cuda.synchronize()
                launched = (fa.launches - before[0], fa.bwd_launches - before[1])
                per_layer = CLASSIFY_CHECK_LAYERS if impl == "pallas" else 0
                want = (per_layer, per_layer)
                if launched != want:
                    raise RuntimeError(f"15(b) {task} {name} {impl}: launches {launched}, "
                                       f"expected {want}")
                if not all(torch.isfinite(g).all() for g in grads):
                    raise RuntimeError(f"15(b) {task} {name} {impl}: non-finite gradient")
                runs[impl] = (float(metrics["loss"]), float(metrics["accuracy"]), grads)
            names = trainer._names
            del trainer
            (loss_k, acc_k, grads_k), (loss_p, acc_p, grads_p) = runs["pallas"], runs["xla"]
            cos = grad_cosines(grads_k, grads_p)
            worst = min(range(len(cos)), key=cos.__getitem__)
            log(f"15(b) {task} {name} {CLASSIFY_CHECK_LAYERS} layers {lengths}: loss kernel "
                f"{loss_k:.7f} plain "
                f"{loss_p:.7f} (accuracy {acc_k:.3f} / {acc_p:.3f}); gradient cosine kernel vs "
                f"plain per parameter min {cos[worst]:.9f} ({names[worst]}), {len(cos)} "
                f"parameters")
            if not bf16:
                ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and cos[worst] >= 1 - 1e-6
                ref32 = grads_p
            else:
                cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
                gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
                total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                                     [torch.cat([g.flatten() for g in grads_p])])[0]
                log(f"15(b) {task} bf16 vs the fp32 gradients: min cosine kernel path "
                    f"{min(cos_k):.6f}, plain path {min(cos_p):.6f}; largest shortfall of the "
                    f"kernel path {cos_p[gap] - cos_k[gap]:.2e} ({names[gap]}); all parameters "
                    f"together kernel vs plain {total:.9f}")
                ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
                      and cos_p[gap] - cos_k[gap] <= 0.01)
            if not ok:
                raise RuntimeError(f"15(b) {task} {name}: kernel and plain paths disagree")
            del runs, grads_k, grads_p
            losses = {}
            for impl in ("pallas", "xla"):
                trainer = classify_trainer(cfg, task)
                trainer.model.cfg.encoder.attn_impl = impl
                losses[impl] = [trainer.train_step(batch)["loss"] for _ in range(3)]
                del trainer
            log(f"15(b) {task} {name} 3 AdamW steps: losses kernel {losses['pallas']}, "
                f"plain {losses['xla']}")
            tol = 2e-2 if bf16 else 1e-4
            if any(abs(a - b) > tol * abs(b) for a, b in zip(losses["pallas"], losses["xla"])):
                raise RuntimeError(f"15(b) {task} {name}: step losses disagree")
            torch.cuda.empty_cache()
        del ref32


CLASSIFY_TASK_ARGS = {  # each recipe's task settings as its users run it
    "image_classify": ["task.mixup=0.8", "task.cutmix=1.0", "task.label_smoothing=0.1"],
    "vqa": [f"task.num_classes={VQA_ANSWERS}"],
    "vggsound": [f"task.num_classes={VGGSOUND_CLASSES}"],
}
CLASSIFY_BATCH = {"image_classify": 8, "vqa": 4, "vggsound": 8}


def classify_argv(data: dict, task: str, save_dir: Path, layers: int, batch: int,
                  extra=()) -> list:
    """``cli.train`` / ``cli.evaluate`` arguments: the task's recipe at the 4B
    width, ``layers`` deep, bf16 over fp32 masters, remat, drop path 0.5,
    the fine-tuning base's AdamW (recipes/finetune_4b_base.yaml), no epoch
    saves; then ``extra``."""
    return ["--config", str(CLASSIFY_RECIPES[task]), "--device", "cuda",
            f"task.data={data[task]['train']}", f"task.valid_data={data[task]['valid']}",
            f"task.bpe_dir={data['bpe']}", *CLASSIFY_TASK_ARGS[task],
            f"model.encoder.layers={layers}", "model.encoder.drop_path_rate=0.5",
            "model.encoder.checkpoint_activations=true", "common.bf16=true",
            "common.log_interval=1", "common.seed=3407", "optimizer.adam_betas=(0.9,0.999)",
            "optimizer.weight_decay=0.05", "lr_scheduler.warmup_ratio=0.1",
            "lr_scheduler.min_lr=1e-6", "optimization.lr=1e-4", "optimization.clip_norm=0.0",
            f"dataset.batch_size={batch}", f"checkpoint.save_dir={save_dir}",
            "checkpoint.save_interval=1000", f"common.log_file={save_dir}/log.jsonl", *extra]


def check_classify_cli(data: dict, card: str, layers: int = 2) -> dict:
    """Phase 15(c): each task's recipe at full width, depth ``layers``,
    through ``cli.train`` from the config's init: 4 updates, one validation
    over the 64 valid rows and ``checkpoint_best.npz``, whose
    ``params_from_jax`` read-back must equal the masters at the validation
    bit for bit; then ``cli.evaluate`` on the export must print the
    validation's accuracy within 1e-6."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils.checkpoint import params_from_jax
    from one_peace_tpu_torch.utils.native_checkpoint import load_params

    out = {}
    for task in CLASSIFY_HEADS:
        save_dir = CLASSIFY_DIR / f"{task}_depth{layers}"
        shutil.rmtree(save_dir, ignore_errors=True)
        argv = classify_argv(data, task, save_dir, layers, CLASSIFY_BATCH[task],
                             ["optimization.max_update=4", "dataset.validate_interval_updates=4"])
        t0 = time.time()
        with recorded_validation(keep_masters=True) as runs, recorded_steps() as steps:
            run_train_cli(argv)
        losses = update_losses(save_dir / "log.jsonl")
        log(f"15(c) {task} cli.train, depth {layers}, B={CLASSIFY_BATCH[task]}: update losses "
            f"{losses}, launches per update (#1, #2) {sorted({(s['fwd'], s['bwd']) for s in steps})}"
            f" ({time.time() - t0:.1f} s with the model's build)")
        if len(runs) != 1 or len(losses) != 4 or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"15(c) {task}: {len(runs)} validations, losses {losses}")
        stats = runs[0]["stats"]
        best = save_dir / "checkpoint_best.npz"
        export = params_from_jax(load_params(str(best)))
        masters = runs[0]["masters"]
        equal = export.keys() == masters.keys() and all(
            export[k].dtype == masters[k].dtype and torch.equal(export[k], masters[k])
            for k in masters)
        log(f"15(c) {task} validation {stats}; checkpoint_best.npz through params_from_jax: "
            f"{len(export)} tensors, bit-equal to the masters at the validation: {equal}")
        if not equal:
            raise RuntimeError(f"15(c) {task}: the best export does not read back as the masters")
        result = save_dir / "eval.json"
        evaluate_cli.main(["--path", str(best), "--output", str(result), *argv])
        evaluated = json.loads(result.read_text())
        diff = abs(evaluated["accuracy"] - stats["accuracy"])
        log(f"15(c) {task} cli.evaluate on checkpoint_best.npz: {evaluated}; accuracy differs "
            f"from the validation's by {diff:.3e}")
        if diff > 1e-6 or evaluated["count"] != stats["count"]:
            raise RuntimeError(f"15(c) {task}: cli.evaluate disagrees with the validation")
        out[task] = {"losses": losses, "accuracy": stats["accuracy"]}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_classify_full_depth(data: dict, card: str) -> dict:
    """Phase 15(d): the image_classify recipe at depth ``CUT_DEPTH``, 384 px, through
    ``cli.train`` from the config's init: B=32 (Mixup + CutMix, label
    smoothing 0.1), 6 updates over 96 train images (3 an epoch) and one
    validation over the 64 valid images at the end of epoch 2, no saves.
    Update 5 runs under torch.profiler from the end of update 4.  #1 must
    launch twice a layer and #2 once a layer per update (remat), #1 once a
    layer per valid forward and #2 never in validation; the loss must fall."""
    import one_peace_tpu_torch.cli.train as train_cli

    layers = CUT_DEPTH
    save_dir = CLASSIFY_DIR / f"image_classify_depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = classify_argv(data, "image_classify", save_dir, layers, 32, [
        "optimization.max_update=6", "dataset.validate_interval=2",
        "checkpoint.best_checkpoint_metric="])
    valid = []
    real_validate = train_cli.validate

    def counted_validate(*args):
        torch.cuda.synchronize()
        f0, b0, t0 = fa.launches, fa.bwd_launches, time.time()
        stats = real_validate(*args)
        torch.cuda.synchronize()
        valid.append((fa.launches - f0, fa.bwd_launches - b0, 1e3 * (time.time() - t0), stats))
        return stats

    torch.cuda.reset_peak_memory_stats()
    train_cli.validate = counted_validate
    try:
        with profiled_update(5) as prof, recorded_steps() as steps:
            t0 = time.time()
            run_train_cli(argv)
            wall = time.time() - t0
    finally:
        train_cli.validate = real_validate
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (4, 5)]  # rolled over, profiled
    ms = sum(steady) / len(steady)
    cfg = load_config(str(CLASSIFY_RECIPES["image_classify"]), argv[4:])
    flops = 4 * analytic_flops(cfg.model, 577, 32, "image", image_size=384)
    tflops = flops / ms / 1e9
    log(f"15(d) cli.train, image_classify at depth {layers}, 384 px, B=32, 6 updates from the "
        f"config's init in {wall:.1f} s (model build, data and validation included) ({card})")
    log(f"15(d) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"15(d) updates 2-6 from data, each from the end of the last (4 after the epoch's end, "
        f"5 profiled): {[round(x, 1) for x in update_ms]} ms; steady {ms:.1f} ms per update, "
        f"{32 / ms * 1e3:.1f} images/s, {tflops:.1f} TFLOP/s = "
        f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU of {H100_BF16_PEAK_TFLOPS:.0f}, peak "
        f"{peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    want = (2 * layers, layers)
    log(f"15(d) launches per update (#1, #2): {per_update} (expected [{want}]); validation: "
        f"{[(f, b) for f, b, _, _ in valid]} over 64 images (expected [({layers}, 0)]) in "
        f"{[round(w, 1) for _, _, w, _ in valid]} ms; its stats {[v[3] for v in valid]}")
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 5 of cli.train, image_classify at depth "
                                    f"{layers}, 384 px, B=32, from the end of update 4",
                                    "classify_cli_profile.txt", card)
        log(f"15(d) {line} (chiprun_out/classify_cli_profile.txt)")
    if not all(map(math.isfinite, losses)) or len(losses) != 6:
        raise RuntimeError(f"15(d): losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"15(d): the loss did not fall: {losses}")
    if per_update != [want]:
        raise RuntimeError(f"15(d): launches per update {per_update}, expected [{want}]")
    if [(f, b) for f, b, _, _ in valid] != [(layers, 0)]:
        raise RuntimeError(f"15(d): validation launches {[(f, b) for f, b, _, _ in valid]}")
    return {"ms": ms, "peak_gib": peak, "losses": losses, "mfu": tflops / H100_BF16_PEAK_TFLOPS}


CLASSIFY_ATTENTION = [  # (B, L, what): the slice's shapes
    (32, 577, "image_classify 384 px, no pads"),
    (8, 750, "VGGSound clips of 5-15 s, key pads"),
    (4, 971, "VQA 480 px + 70 text tokens, text pads"),
]


def classify_key_bias(b: int, l: int, what: str, rng):
    """None for the image rows; the audio rows keep CLS and the frames of
    clips of 5-15 s; the VQA rows pad the text (its first 70 positions)
    after 9 + 7i tokens."""
    if what.startswith("image"):
        return None
    mask = torch.zeros(b, l, dtype=torch.bool)
    if what.startswith("VGGSound"):
        spec = ModelConfig().encoder.audio_adapter.feature_encoder_spec
        for row, seconds in enumerate(rng.uniform(5, 15, b)):
            mask[row, 1 + conv_output_length(int(16000 * seconds), spec):] = True
    else:
        for row in range(b):
            mask[row, 9 + 7 * row:70] = True
    return torch.zeros(b, l).masked_fill(mask, fa.NEG_INF).cuda()


def time_classify_attention(card: str) -> tuple:
    """Phase 15(e): #1 and #2 at the classification shapes
    (CLASSIFY_ATTENTION, 24 heads, a shared bias) through
    ``time_attention_cases``."""
    cases = [(b, l, 24, "shared", what) for b, l, what in CLASSIFY_ATTENTION]
    return time_attention_cases("15(e)", cases, card, 155, classify_key_bias)


def time_attention_cases(tag: str, cases, card: str, seed: int, key_bias_fn) -> tuple:
    """#1 and #2 alone, bf16, at ``cases`` of (B, L, heads, bias, what): the
    bias "shared" (H, L, L), "per-sample" (B, H, L, L) or None, the key bias
    from ``key_bias_fn(b, l, what, rng)``.  Each against its plain version
    with phase 3's and phase 6's bounds, then timed in turns with SDPA
    (forward: the additive mask; backward: SDPA's backward, the mask taking
    a gradient where there is a bias), beside its bound and plain version,
    with the plan's branch.  Returns the forward's and the backward's rows
    by shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    fwd_rows, bwd_rows = {}, {}
    for b, l, heads, bias_kind, what in cases:
        q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        bias_shape = {"shared": (heads, l, l), "per-sample": (b, heads, l, l)}.get(bias_kind)
        bias = (None if bias_shape is None else
                torch.randn(*bias_shape, generator=gen, device="cuda"))
        key_bias = key_bias_fn(b, l, what, rng)
        args = (q, k, v, bias, key_bias, 0.125, heads)
        out, stats = fa.flash_attention_cuda(*args, with_stats=True)
        want = fa.flash_attention_plain(*(x.float() for x in (q, k, v)), bias, key_bias,
                                        0.125, heads)
        err = (out.float() - want).abs()
        fwd_err = err.max().item()
        grads = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads, stats=stats)
        plain_grads = fa.flash_attention_bwd_plain(q, k, v, g, bias, key_bias, 0.125, heads)
        rel = []
        for x, y in zip(grads, plain_grads):
            if y is None:
                continue
            d = (x.float() - y.float()).abs()
            rel.append((d.max().item() / y.float().abs().max().item(),
                        d.mean().item() / y.float().abs().mean().item()))
        plan, bplan = fa.tile_plan(l), fa.bwd_plan(b, l, heads, bias_kind == "shared")
        name = f"B={b} L={l} H={heads}, {bias_kind or 'no'} bias ({what})"
        log(f"{tag} {name} bf16: forward vs plain max |d| {fwd_err:.3e} mean "
            f"{err.mean().item():.3e}; backward dq/dk/dv{'/d(bias)' if bias is not None else ''} "
            f"max/mean relative {', '.join(f'{a:.2e}/{m:.2e}' for a, m in rel)}; plan "
            f"{FWD_BRANCHES[plan.resident]}, last tile {plan.tail} wide; "
            f"{DQ_BRANCHES[bplan.tiles.resident]}, {DKV_BRANCHES[bplan.dkv_slab]}, "
            f"{bplan.chunks} chunks of {bplan.b_chunk}")
        if fwd_err > BF16_MAX_ERR or err.mean().item() > BF16_MEAN_ERR:
            raise RuntimeError(f"{tag} {name}: the forward kernel disagrees")
        if any(a > 2e-2 or m > 5e-3 for a, m in rel):
            raise RuntimeError(f"{tag} {name}: the backward kernel disagrees")
        del out, want, err, grads, plain_grads
        q4, k4, v4 = (x.view(b, l, heads, 64).transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(bias, key_bias, b, heads, l)
        t = in_turns({"kernel": lambda: fa.flash_attention_cuda(*args),
                      "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                          q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=10)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(*args), iters=3)
        flops = 4 * b * heads * l * l * 64
        kb_bytes = 0 if key_bias is None else key_bias.numel() * 4
        bias_bytes = 0 if bias is None else bias.numel() * 4
        bound = bound_ms(4 * q.numel() * 2 + bias_bytes + kb_bytes, flops,
                         H100_BF16_PEAK_TFLOPS * 1e12)
        log(f"{tag} attention forward per layer {name} bf16: kernel {t['kernel']:.4f} ms, "
            f"{t['kernel'] / t['sdpa']:.3f}x SDPA with the additive mask {t['sdpa']:.4f} ms (in "
            f"turns); plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({card})")
        fwd_rows[f"L={l} B={b} {what}"] = {
            "ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
            "bound_ms": bound[0], "bound_by": bound[1]}
        del mask
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        mask = sdpa_mask(bias, key_bias, b, heads, l)
        if mask is not None:
            mask = mask.detach().requires_grad_(bias is not None)
        res = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                               scale=0.125)
        g4 = g.view(b, l, heads, 64).transpose(1, 2)
        bargs = (q, k, v, g, bias, key_bias, 0.125, heads)
        wrt = [*leaves, mask] if bias is not None else leaves
        t = in_turns({
            "kernel": lambda: fa.flash_attention_bwd_cuda(*bargs, stats=stats),
            "sdpa": lambda: torch.autograd.grad(res, wrt, g4, retain_graph=True)},
            iters=5)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(*bargs), iters=2)
        bound = bound_ms(7 * q.numel() * 2 + 2 * bias_bytes + kb_bytes + stats.numel() * 4,
                         10 * b * heads * l * l * 64, H100_BF16_PEAK_TFLOPS * 1e12)
        log(f"{tag} attention backward per layer {name} bf16: kernel {t['kernel']:.4f} ms, "
            f"{t['kernel'] / t['sdpa']:.3f}x SDPA's backward {t['sdpa']:.4f} ms (in turns); "
            f"plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({card})")
        bwd_rows[f"L={l} B={b} {what}"] = {
            "ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
            "bound_ms": bound[0], "bound_by": bound[1]}
        del q, k, v, g, bias, key_bias, stats, q4, k4, v4, leaves, mask, res, g4, args, bargs
        del wrt
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


PRETRAIN_DIR = ROOT / "build" / "smoke_pretrain"
PRETRAIN_RECIPES = {stage: ROOT / "recipes" / "pretrain" / f"pretrain_{stage}_4b.yaml"
                    for stage in ("vl", "al")}


def write_pretrain_corpus(root: Path, n_train: int = 64, n_valid: int = 32,
                          clip_seconds=(5.0, 15.0)) -> dict:
    """Phase 16(c): ``n_train + n_valid`` JPEGs (256-399 px) with captions,
    as the VL recipe's TSV (``image_id, image, caption``), and as many WAV
    clips of ``clip_seconds`` with the same captions, as the AL recipe's
    (``uniq_id, audio, text, duration``), each split into train and valid;
    ``valid.json`` with 5 captions for each valid id, and the byte-level BPE
    set.  Returns the paths."""
    rng = np.random.RandomState(16)
    root.mkdir(parents=True, exist_ok=True)
    n = n_train + n_valid
    tables = {"vl": ["image_id\timage\tcaption"], "al": ["uniq_id\taudio\ttext\tduration"]}
    captions = {}
    for i, img in enumerate(retrieval_images(n, rng)):
        img.save(root / f"img{i}.jpg", quality=92)
        captions[i] = [" ".join(WORDS[j] for j in row)
                       for row in rng.randint(0, len(WORDS), (5, 4 + i % 9))]
        tables["vl"].append(f"{i}\timg{i}.jpg\t{captions[i][0]}")
        samples = int(16000 * rng.uniform(*clip_seconds))
        wav = (np.sin(np.arange(samples) * (0.01 + 0.002 * (i % 10))) * 6000
               + rng.randn(samples) * 700)
        write_wav(root / f"clip{i}.wav", wav)
        tables["al"].append(f"{i}\tclip{i}.wav\t{captions[i][0]}\t{samples / 16000:.3f}")
    out = {"root": root, "bpe": write_bpe_dir(root / "bpe"), "valid_json": str(root / "valid.json")}
    (root / "valid.json").write_text(json.dumps({str(i): captions[i] for i in range(n_train, n)}))
    for stage, rows in tables.items():
        for split, part in (("train", rows[1:n_train + 1]), ("valid", rows[n_train + 1:])):
            (root / f"{stage}_{split}.tsv").write_text("\n".join([rows[0], *part]) + "\n")
        out[stage] = {split: str(root / f"{stage}_{split}.tsv") for split in ("train", "valid")}
    return out


def pretrain_argv(data: dict, stage: str, save_dir: Path, layers: int, batch: int,
                  extra=()) -> list:
    """``cli.train`` arguments: the stage's pretrain recipe as it stands (4B
    width, the 768-d decoder, bf16 over fp32 masters, remat, drop path 0.4,
    AdamW, clip 3.0, stage 2's freezing and logit-scale reset), ``layers``
    deep, on the corpus of ``write_pretrain_corpus``, no epoch saves; then
    ``extra``."""
    return ["--config", str(PRETRAIN_RECIPES[stage]), "--device", "cuda",
            f"task.data={data[stage]['train']}", f"task.valid_data={data[stage]['valid']}",
            f"task.valid_file={data['valid_json']}", f"task.bpe_dir={data['bpe']}",
            f"model.encoder.layers={layers}", "common.log_interval=1",
            f"dataset.batch_size={batch}", "dataset.batch_size_valid=32",
            f"checkpoint.save_dir={save_dir}", "checkpoint.save_interval=1000",
            f"common.log_file={save_dir}/log.jsonl", ONE_PROCESS, *extra]


def pretrain_launches(stage: str, enc_layers: int, dec_layers: int, remat: bool) -> tuple:
    """(#1, #2) launches of one pretrain update: the criterion's encoder
    passes with a gradient (VL: both teachers and three students; AL: the
    audio teacher and two students) launch #1 once a layer (twice under
    remat) and #2 once; its no-gradient passes (VL: the VL teacher; AL: the
    text and AL teachers) #1 once; each student's decoder pass #1 and #2
    once a decoder layer."""
    grad, nograd, students = (5, 1, 3) if stage == "vl" else (3, 2, 2)
    fwd = grad * enc_layers * (2 if remat else 1) + nograd * enc_layers + students * dec_layers
    return fwd, grad * enc_layers + students * dec_layers


def pretrain_trainer(data: dict, stage: str, overrides=()) -> tuple:
    """(trainer, first training batch) of the stage's recipe with
    ``overrides``, the model built as ``cli.train`` builds it and filled by
    ``fill_random_`` from seed 0; the batch from the task's own iterator
    (masks and preserve ids as the dataset draws them), bookkeeping keys
    dropped."""
    from one_peace_tpu_torch.cli import train as train_cli
    from one_peace_tpu_torch.tasks import build_task

    argv = pretrain_argv(data, stage, PRETRAIN_DIR / "unused", 4, 8, overrides)
    cfg = load_config(argv[1], argv[4:])
    task = build_task(cfg.task, cfg)
    task.load_dataset("train")
    model = train_cli.build_model_for_task(cfg, task, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))
    batch = next(iter(task.get_batch_iterator("train", 8, seed=3407).next_epoch_itr()))
    batch = {k: v for k, v in batch.items() if k not in train_cli.HOST_KEYS}
    return Trainer(cfg, model, build_criterion(cfg.criterion)), batch


def check_pretrain_train_paths(data: dict) -> None:
    """Phase 16(b): both pretrain criterions at 4 layers, full width, with
    the 768-d decoder, B=8 from the corpus, kernel path against plain path
    on the same weights and batch, with phase 7(a)'s bounds: fp32 losses
    within 1e-5 and every trainable gradient's cosine >= 1-1e-6; bf16 the
    kernel path no further from the fp32 gradients than the plain path (per
    parameter within 0.01, all together >= 0.999), losses within 2e-3.  The
    AL recipe freezes its trunk (stage 2): only the trainable parameters
    have gradients.  #1 and #2 launch as ``pretrain_launches`` says
    (no remat here)."""
    for stage in ("vl", "al"):
        ref32 = None
        for bf16 in (False, True):
            name = "bf16" if bf16 else "fp32"
            trainer, batch = pretrain_trainer(data, stage, [
                "model.encoder.drop_path_rate=0.0", "model.encoder.checkpoint_activations=false",
                f"common.bf16={str(bf16).lower()}"])
            lengths = {k: tuple(v.shape) for k, v in batch.items() if "preserve" in k}
            runs = {}
            for impl in ("pallas", "xla"):
                trainer.model.cfg.encoder.attn_impl = trainer.model.cfg.decoder.attn_impl = impl
                before = (fa.launches, fa.bwd_launches)
                metrics, grads = trainer.gradients(batch)
                torch.cuda.synchronize()
                launched = (fa.launches - before[0], fa.bwd_launches - before[1])
                want = pretrain_launches(stage, 4, 2, False) if impl == "pallas" else (0, 0)
                if launched != want:
                    raise RuntimeError(f"16(b) {stage} {name} {impl}: launches {launched}, "
                                       f"expected {want}")
                if not all(torch.isfinite(g).all() for g in grads):
                    raise RuntimeError(f"16(b) {stage} {name} {impl}: non-finite gradient")
                runs[impl] = ({k: float(v) for k, v in metrics.items()}, grads)
            names, total_params = trainer._names, len(list(trainer.model.parameters()))
            del trainer
            (m_k, grads_k), (m_p, grads_p) = runs["pallas"], runs["xla"]
            loss_k, loss_p = m_k["loss"], m_p["loss"]
            cos = grad_cosines(grads_k, grads_p)
            worst = min(range(len(cos)), key=cos.__getitem__)
            log(f"16(b) {stage} {name} 4 layers, B=8, preserve ids {lengths}: loss kernel "
                f"{loss_k:.7f} plain {loss_p:.7f} ({', '.join(f'{k} {v:.5f}' for k, v in m_k.items() if k.endswith('_loss') and k != 'loss')}); "
                f"gradient cosine kernel vs plain per parameter min {cos[worst]:.9f} "
                f"({names[worst]}), {len(cos)} trainable of {total_params} parameters")
            if not bf16:
                ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and cos[worst] >= 1 - 1e-6
                ref32 = grads_p
            else:
                cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
                gap = max(range(len(cos)), key=lambda i: cos_p[i] - cos_k[i])
                total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                                     [torch.cat([g.flatten() for g in grads_p])])[0]
                log(f"16(b) {stage} bf16 vs the fp32 gradients: min cosine kernel path "
                    f"{min(cos_k):.6f}, plain path {min(cos_p):.6f}; largest shortfall of the "
                    f"kernel path {cos_p[gap] - cos_k[gap]:.2e} ({names[gap]}); all parameters "
                    f"together kernel vs plain {total:.9f}")
                ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
                      and cos_p[gap] - cos_k[gap] <= 0.01)
            if not ok:
                raise RuntimeError(f"16(b) {stage} {name}: kernel and plain paths disagree")
            del runs, grads_k, grads_p
            gc.collect()
            torch.cuda.empty_cache()
        del ref32


def check_pretrain_cli(data: dict, card: str, layers: int = 2) -> dict:
    """Phase 16(c): at full width, depth ``layers``, through ``cli.train``:
    the VL recipe from the config's init, B=8, 4 updates, one validation and
    ``checkpoint_best.npz`` (read back bit-equal to the masters at the
    validation); then the AL stage-2 recipe restoring that export, B=8, 3
    updates and one validation.  ``load_weights`` must carry every leaf the
    two trees share bit for bit and reset ``logit_scale``; the AL run's
    export must hold every frozen parameter bit-unchanged and the trainable
    ones moved."""
    from one_peace_tpu_torch.cli import train as train_cli
    from one_peace_tpu_torch.tasks import build_task
    from one_peace_tpu_torch.utils.checkpoint import params_from_jax
    from one_peace_tpu_torch.utils.native_checkpoint import load_params

    vl_dir, al_dir = PRETRAIN_DIR / f"vl_depth{layers}", PRETRAIN_DIR / f"al_depth{layers}"
    for d in (vl_dir, al_dir):
        shutil.rmtree(d, ignore_errors=True)
    argv = pretrain_argv(data, "vl", vl_dir, layers, 8, [
        "optimization.max_update=4", "dataset.validate_interval_updates=4"])
    t0 = time.time()
    with recorded_validation(keep_masters=True) as runs, recorded_steps() as steps:
        run_train_cli(argv)
    losses = update_losses(vl_dir / "log.jsonl")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    log(f"16(c) VL cli.train, depth {layers}, B=8: update losses {losses}, launches per update "
        f"(#1, #2) {per_update} ({time.time() - t0:.1f} s with the model's build)")
    if len(runs) != 1 or len(losses) != 4 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"16(c) VL: {len(runs)} validations, losses {losses}")
    if per_update != [pretrain_launches("vl", layers, 2, True)]:
        raise RuntimeError(f"16(c) VL: launches per update {per_update}")
    best = vl_dir / "checkpoint_best.npz"
    stage1 = params_from_jax(load_params(str(best)))
    masters = runs[0]["masters"]
    equal = stage1.keys() == masters.keys() and all(torch.equal(stage1[k], masters[k])
                                                     for k in masters)
    log(f"16(c) VL validation {runs[0]['stats']}; checkpoint_best.npz: {len(stage1)} tensors, "
        f"bit-equal to the masters at the validation: {equal}")
    if not equal:
        raise RuntimeError("16(c): the VL export does not read back as the masters")
    del runs, masters

    argv = pretrain_argv(data, "al", al_dir, layers, 8, [
        f"checkpoint.restore_file={best}", "optimization.max_update=3",
        "dataset.validate_interval_updates=3"])
    cfg = load_config(argv[1], argv[4:])
    model = train_cli.build_model_for_task(cfg, build_task(cfg.task, cfg), device="cuda")
    train_cli.load_weights(cfg, model, "cuda")
    loaded = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    mask = model.trainable_mask()
    del model
    shared = [k for k in loaded if k in stage1 and stage1[k].shape == loaded[k].shape
              and k != "logit_scale"]
    carried = all(torch.equal(loaded[k], stage1[k]) for k in shared)
    reset = (loaded["logit_scale"].item() == np.float32(math.log(1 / 0.07))
             and loaded["logit_scale"].item() != stage1["logit_scale"].item())
    t0 = time.time()
    with recorded_steps() as steps:
        run_train_cli(argv)
    losses = update_losses(al_dir / "log.jsonl")
    after = params_from_jax(load_params(str(al_dir / "checkpoint_best.npz")))
    frozen = [k for k, train in mask.items() if not train]
    unchanged = all(torch.equal(after[k], loaded[k]) for k in frozen)
    trainable = [k for k, train in mask.items() if train]
    moved = sum(not torch.equal(after[k], loaded[k]) for k in trainable)
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    log(f"16(c) AL stage 2 from the VL export, depth {layers}, B=8: {len(shared)} shared leaves "
        f"carried bit-equal: {carried}; logit_scale reset to ln(1/0.07) "
        f"({loaded['logit_scale'].item():.6f}, the export's {stage1['logit_scale'].item():.6f}): "
        f"{reset}; update losses {losses}, launches per update {per_update}; after the updates "
        f"{len(frozen)} frozen parameters bit-unchanged: {unchanged}, {moved} of {len(trainable)} "
        f"trainable moved ({time.time() - t0:.1f} s)")
    if not (carried and reset and unchanged and moved > 0.9 * len(trainable)
            and len(shared) > len(loaded) / 2 and len(losses) == 3
            and all(map(math.isfinite, losses))):
        raise RuntimeError("16(c): the stage-2 restore, reset or freeze does not hold")
    if per_update != [pretrain_launches("al", layers, 2, True)]:
        raise RuntimeError(f"16(c) AL: launches per update {per_update}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"vl_losses": update_losses(vl_dir / "log.jsonl"), "al_losses": losses}


def pretrain_update_flops(cfg, batch: dict, stage: str) -> float:
    """Closed-form FLOPs of one pretrain update (``analytic_flops``'s terms,
    2 per MAC) on ``batch``'s shapes: each encoder pass's trunk at its
    length and its frontend (the hMLP stem or the audio convs, which run on
    the whole input also in a student pass), each student's decoder pass at
    the whole sequence's length and its two projections.  A pass with a
    gradient counts three times its forward (forward, and a backward of
    twice it), except that a stage-2 pass through the frozen trunk counts
    its trunk's backward once (input gradients only) plus the weight
    gradients of the audio FFNs on the audio tokens; a pass without a
    gradient counts its forward.  Remat's recompute is not counted."""
    from types import SimpleNamespace

    enc, dec = cfg.model.encoder, cfg.model.decoder
    b = batch["src_tokens"].shape[0]
    lt = batch["src_tokens"].shape[1] + 1

    def trunk(layers_cfg, l):
        return analytic_flops(SimpleNamespace(encoder=layers_cfg), l, b, "text")

    def heads(l):  # decoder_{mod}_embed and {mod}_mask_head
        return 2 * 2 * b * l * enc.embed_dim * dec.embed_dim

    if stage == "vl":
        img = analytic_flops(cfg.model, 0, b, "image")
        li = 257
        pt, pi = (batch[k].shape[1] for k in ("text_preserve_ids", "image_preserve_ids"))
        pvl = sum(batch[k].shape[1] for k in ("vl_text_preserve_ids", "vl_image_preserve_ids"))
        grad = [trunk(enc, lt), trunk(enc, li) + img,
                trunk(enc, pt) + trunk(dec, lt) + heads(lt),
                trunk(enc, pi) + img + trunk(dec, li) + heads(li),
                trunk(enc, pvl) + img + trunk(dec, lt + li) + heads(lt + li)]
        return 3 * sum(grad) + trunk(enc, lt + li) + img
    wav = batch["src_audios"].shape[1]
    audio = analytic_flops(cfg.model, 0, b, "audio", wav_samples=wav)
    la = batch["audio_padding_masks"].shape[1]
    pa = batch["audio_preserve_ids"].shape[1]
    pal = sum(batch[k].shape[1] for k in ("al_text_preserve_ids", "al_audio_preserve_ids"))
    ffn_wgrad = lambda l: enc.layers * 2 * (3 * b * l * enc.embed_dim * enc.ffn_embed_dim)
    passes = [(trunk(enc, la), audio, 0, la - 1),
              (trunk(enc, pa), audio, trunk(dec, la) + heads(la), pa - 1),
              (trunk(enc, pal), audio, trunk(dec, lt + la) + heads(lt + la),
               batch["al_audio_preserve_ids"].shape[1] - 1)]
    total = sum(2 * t + 3 * f + 3 * d + ffn_wgrad(n) for t, f, d, n in passes)
    return total + trunk(enc, lt) + trunk(enc, lt + la) + audio


def index_backward_share(prof: dict) -> str:
    """The profiled update's device time in PyTorch's sort-based index
    backward (``indexing_backward_kernel``: the per-sample rel-pos bias
    gathers' backward), and its share of the device's busy time."""
    events = update_averages(prof)
    index = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                for e in events if "indexing_backward" in e.key) / 1e3
    busy = profile_busy_ms(prof)
    return f"indexing_backward_kernel {index:.1f} ms, {100 * index / busy:.1f}% of the busy {busy:.1f} ms"


def train_pretrain_full_depth(data: dict, stage: str, card: str) -> dict:
    """Phase 16(d): the stage's recipe at depth ``CUT_DEPTH`` through ``cli.train``
    from the config's init (AL with its stage-2 freezing), ``PRETRAIN_UPDATES``
    updates (VL at B=32, AL at B=16 on 14-15 s clips), no validation, no
    saves.  Update 5 runs under torch.profiler from the end of update 4
    (the device's idle share, the index backward's share); ``ms`` is the
    median of the other updates after the first that do not open an epoch.  #1 and #2 launch
    per update as ``pretrain_launches`` says (remat); the losses must be
    finite."""
    batch = 32 if stage == "vl" else 16
    layers = CUT_DEPTH
    save_dir = PRETRAIN_DIR / f"{stage}_depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = pretrain_argv(data, stage, save_dir, layers, batch, [
        f"optimization.max_update={PRETRAIN_UPDATES}", "dataset.disable_validation=true",
        "checkpoint.best_checkpoint_metric="])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with profiled_update(5) as prof, recorded_steps() as steps:
        t0 = time.time()
        run_train_cli(argv)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    cfg = load_config(argv[1], argv[4:])
    from one_peace_tpu_torch.tasks import build_task

    task = build_task(cfg.task, cfg)
    task.load_dataset("train")
    rolled = len(task.datasets["train"]) // batch + 1  # the first update of epoch 2
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (5, rolled)]  # 5: profiled
    ms = statistics.median(steady)
    shapes = next(iter(task.get_batch_iterator("train", batch, seed=3407).next_epoch_itr()))
    flops = pretrain_update_flops(cfg, shapes, stage)
    tflops = flops / ms / 1e9
    what = "pairs" if stage == "vl" else "clips"
    log(f"16(d) cli.train, {stage.upper()} pretrain at depth {layers}, B={batch}, {PRETRAIN_UPDATES} "
        f"updates from the "
        f"config's init in {wall:.1f} s (model build and data included) ({card})")
    log(f"16(d) {stage} losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"16(d) {stage} updates 2-{PRETRAIN_UPDATES} from data, each from the end of the last "
        f"(5 profiled, {rolled} after the epoch's end where it is <= {PRETRAIN_UPDATES}): "
        f"{[round(x, 1) for x in update_ms]} ms; steady: median {ms:.1f} ms per update of "
        f"{len(steady)} (mean {statistics.fmean(steady):.1f}, min {min(steady):.1f}, "
        f"max {max(steady):.1f}), "
        f"{batch / ms * 1e3:.2f} {what}/s, {flops / 1e12:.1f} TFLOP an update, "
        f"{tflops:.1f} TFLOP/s = {100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU of "
        f"{H100_BF16_PEAK_TFLOPS:.0f}, peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    want = pretrain_launches(stage, layers, 2, True)
    log(f"16(d) {stage} launches per update (#1, #2): {per_update} (expected [{want}])")
    if "wall" in prof:
        line = write_update_profile(prof, ms, f"update 5 of cli.train, {stage.upper()} pretrain "
                                    f"at depth {layers}, B={batch}, from the end of update 4",
                                    f"pretrain_{stage}_profile.txt", card)
        log(f"16(d) {stage} {line} (pretrain_{stage}_profile.txt); "
            f"{index_backward_share(prof)}")
    if not all(map(math.isfinite, losses)) or len(losses) != PRETRAIN_UPDATES:
        raise RuntimeError(f"16(d) {stage}: losses {losses}")
    if per_update != [want]:
        raise RuntimeError(f"16(d) {stage}: launches per update {per_update}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak, "losses": losses, "mfu": tflops / H100_BF16_PEAK_TFLOPS}


PRETRAIN_UPDATES = 5  # 16(d)'s window


PRETRAIN_ATTENTION = [  # (B, L, heads, bias, what): the pretrain slice's new shapes
    (32, 65, 24, "per-sample", "image student: CLS + 64 of 256 patches"),
    (32, 124, 24, "per-sample", "VL student: text and CLS + 80 patches, text pads"),
    (16, 338, 24, "per-sample", "audio student: 15 s clips, pads"),
    (16, 456, 24, "per-sample", "AL student: text and frames of 15 s clips, pads"),
    (32, 329, 12, None, "VL decoder: 72 text + 257 image, text pads"),
    (16, 822, 12, None, "AL decoder: 72 text + 750 frames, pads"),
]


def pretrain_key_bias(b: int, l: int, what: str, rng):
    """None where a case has no pads; else row r > 0 pads its last 0 to
    l / 8 keys (the -1s of ragged preserve ids, short clips, short text)."""
    if "pads" not in what:
        return None
    mask = torch.zeros(b, l, dtype=torch.bool)
    for row in range(1, b):
        n = int(rng.randint(0, l // 8 + 1))
        if n:
            mask[row, l - n:] = True
    return torch.zeros(b, l).masked_fill(mask, fa.NEG_INF).cuda()


def time_pretrain_attention(card: str) -> tuple:
    """Phase 16(a): #1 and #2 at the pretrain slice's shapes (per-sample
    rel-pos biases of the student passes, the decoder's 12 heads without a
    bias) through ``time_attention_cases``."""
    return time_attention_cases("16(a)", PRETRAIN_ATTENTION, card, 166, pretrain_key_bias)


ADE_DIR = ROOT / "build" / "smoke_ade"
ADE_SIZES = ((683, 512), (512, 683), (1024, 436), (371, 500))  # (width, height)


def write_ade_corpus(root: Path, n_train: int, n_valid: int, sizes=ADE_SIZES,
                     num_classes: int = 150, seed: int = 17) -> dict:
    """Phase 17(d): a synthetic ADE20K tree under ``root`` in mmseg's layout
    (``images/{training,validation}/*.jpg``, ``annotations/.../*.png``),
    images at ``sizes`` in turn, the valid split going on where the train
    split stopped.  Each label map holds regions of raw ADE
    classes 1..``num_classes`` (a coarse random grid, nearest-upsampled, with
    each region's colour in the image), a band of label 0 (ignored after
    ``reduce_zero_label``) and a patch of 255 (ignored as it is).  Returns
    the ``task.data`` / ``task.valid_data`` specs ("images:annotations")."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 255, (256, 3))  # a colour for every raw label
    specs, count = {}, 0
    for split, folder, n in (("train", "training", n_train), ("valid", "validation", n_valid)):
        img_dir, ann_dir = root / "images" / folder, root / "annotations" / folder
        img_dir.mkdir(parents=True, exist_ok=True)
        ann_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            w, h = sizes[count % len(sizes)]
            count += 1
            grid = rng.randint(1, num_classes + 1, (rng.randint(2, 6), rng.randint(2, 6)))
            ys = np.arange(h) * grid.shape[0] // h
            xs = np.arange(w) * grid.shape[1] // w
            label = grid[ys[:, None], xs[None, :]].astype(np.uint8)
            label[: max(1, h // 10)] = 0
            label[h // 2:h // 2 + max(1, h // 8), w // 3:w // 3 + max(1, w // 8)] = 255
            img = palette[label].astype(np.int64) + rng.randint(-20, 21, (h, w, 3))
            name = f"ADE_{split}_{i:08d}"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(img_dir / f"{name}.jpg")
            Image.fromarray(label).save(ann_dir / f"{name}.png")
        specs[split] = f"{img_dir}:{ann_dir}"
    return specs


SEG_RECIPE = ROOT / "recipes" / "segmentation" / "mask2former_896.yaml"
SEG_PX, SEG_HEADS = 896, 24
SEG_L = (SEG_PX // 16) ** 2 + 1  # 3137 trunk tokens at 896 px


def seg_encoder(layers: int):
    """The 4B encoder (d 1536, FFN 6144, 24 heads) at ``layers``, its image
    grids at 896 px (56 x 56)."""
    enc = ModelConfig().encoder
    enc.layers = layers
    enc.image_adapter.bucket_size = enc.image_adapter.rel_bucket_size = SEG_PX // 16
    return enc


def time_seg_attention(card: str) -> tuple:
    """Phase 17(a): #1 alone at the segmentation trunk's shape (L = 3137,
    24 heads of 64, one shared fp32 (H, L, L) bias, no key bias) at B=1 and
    8: bf16 and fp32 against the plain version with phase 3's bounds
    (forward only), the plan's branch, then bf16 times in turns with SDPA on
    the additive mask, beside the bound and the plain version.  Returns the
    largest max |diff| and the timed rows by shape."""
    gen = torch.Generator(device="cuda").manual_seed(177)
    heads, l = SEG_HEADS, SEG_L
    plan = fa.tile_plan(l)
    bias = torch.randn(heads, l, l, generator=gen, device="cuda")
    worst, rows = 0.0, {}
    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(b, l, heads * 64, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            got = fa.flash_attention_cuda(q, k, v, bias, None, 0.125, heads).float()
            want = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, None, 0.125,
                                            heads)
            err = (got - want).abs()
            mx, mean = err.max().item(), err.mean().item()
            worst = max(worst, mx)
            log(f"17(a) kernel vs plain {str(dtype)[6:]} B={b} L={l} H={heads} shared bias, no "
                f"key bias: max|d| {mx:.3e} mean|d| {mean:.3e}; plan "
                f"{FWD_BRANCHES[plan.resident]}, {plan.n_tiles} key tiles, the last "
                f"{plan.tail} wide holding {l - fa.TILE * (plan.n_tiles - 1)} key(s)")
            if not torch.isfinite(got).all():
                raise RuntimeError("17(a): kernel output is not finite")
            if dtype == torch.bfloat16 and (mx > BF16_MAX_ERR or mean > BF16_MEAN_ERR):
                raise RuntimeError(f"17(a) bf16 B={b}: the kernel disagrees: max {mx} mean {mean}")
            if dtype == torch.float32 and mx > FP32_MAX_ERR:
                raise RuntimeError(f"17(a) fp32 B={b}: the kernel disagrees: max {mx}")
            del got, want, err
            if dtype == torch.bfloat16:
                args = (q, k, v, bias, None, 0.125, heads)
                q4, k4, v4 = (x.view(b, l, heads, 64).transpose(1, 2) for x in (q, k, v))
                mask = sdpa_mask(bias, None, b)
                t = in_turns({"kernel": lambda: fa.flash_attention_cuda(*args),
                              "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                                  q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=5)
                plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(*args), iters=2,
                                        warmup=1)
                bound = bound_ms(4 * q.numel() * 2 + bias.numel() * 4, 4 * b * heads * l * l * 64,
                                 H100_BF16_PEAK_TFLOPS * 1e12)
                log(f"17(a) attention forward per layer B={b} L={l} H={heads} shared bias bf16: "
                    f"kernel {t['kernel']:.4f} ms, {t['kernel'] / t['sdpa']:.3f}x SDPA with the "
                    f"additive mask {t['sdpa']:.4f} ms (in turns); plain {plain_ms:.3f} ms; bound "
                    f"{bound[0]:.4f} ms by {bound[1]} ({card})")
                rows[f"L={l} B={b} segmentation trunk, 896 px"] = {
                    "ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
                    "bound_ms": bound[0], "bound_by": bound[1]}
                del q4, k4, v4, mask
            del q, k, v
            torch.cuda.empty_cache()
    del bias
    torch.cuda.empty_cache()
    return worst, rows


@contextlib.contextmanager
def recorded_seg_launches():
    """Observe #1's launches (the wrapper itself counts them): each one's
    length, whether it had a key bias and its bias's shape."""
    seen, kernel = [], fa.flash_attention_cuda

    def recording(q, k, v, rel_bias, key_bias, *args, **kwargs):
        seen.append((q.shape[1], key_bias is None,
                     None if rel_bias is None else tuple(rel_bias.shape)))
        return kernel(q, k, v, rel_bias, key_bias, *args, **kwargs)

    fa.flash_attention_cuda = recording
    try:
        yield seen
    finally:
        fa.flash_attention_cuda = kernel


def seg_outputs(model, images) -> tuple:
    """The pyramid and the class scores of ``model.logits`` (fp32), and for
    Mask2Former each round's blocked keys (``blocked_keys`` of its masks at
    the level the next round attends)."""
    from one_peace_tpu_torch.vision.mask2former import blocked_keys, semantic_inference

    with torch.no_grad():
        feats = model.backbone(images)
        blocked = []
        if model.is_mask2former:
            all_cls, all_masks = model.head(feats)
            scores = semantic_inference(all_cls[-1], all_masks[-1])
            shapes = [tuple(f.shape[1:3]) for f in (feats[3], feats[2], feats[1])]
            blocked = [blocked_keys(all_masks[j], shapes[j % 3])
                       for j in range(all_masks.shape[0] - 1)]
            del all_cls, all_masks
        else:
            scores = model.head(feats)
    outs = {f"f{4 << i}": f.float() for i, f in enumerate(feats)}
    outs["scores"] = scores.float()
    return outs, blocked


def compare_seg_paths(model, images, tag: str, min_cos: float) -> dict:
    """The kernel path against the plain path on the same weights and
    images: each output's cosine per image, the share of mask-attention keys
    whose blocked state flips, and #1's launches per kernel-path forward (one
    per trunk layer, L = 3137, no key bias, the layer's (H, L, L) table)."""
    b, layers = images.shape[0], model.backbone.cfg.layers
    outs, blocked = {}, {}
    for impl in ("pallas", "xla"):
        model.backbone.cfg.attn_impl = impl
        with recorded_seg_launches() as seen:
            outs[impl], blocked[impl] = seg_outputs(model, images)
            torch.cuda.synchronize()
        want = [(SEG_L, True, (SEG_HEADS, SEG_L, SEG_L))] * layers if impl == "pallas" else []
        if seen != want:
            raise RuntimeError(f"{tag} {impl}: #1 launches {seen[:3]}... ({len(seen)}), "
                               f"not {layers} at L={SEG_L} without a key bias")
        if not all(torch.isfinite(x).all() for x in outs[impl].values()):
            raise RuntimeError(f"{tag} {impl}: non-finite output")
    model.backbone.cfg.attn_impl = "pallas"
    cos = {key: min_cosine(outs["pallas"][key].reshape(b, -1), outs["xla"][key].reshape(b, -1))
           for key in outs["pallas"]}
    flipped = total = 0
    for x, y in zip(blocked["pallas"], blocked["xla"]):
        flipped += int((x != y).sum())
        total += x.numel()
    share = flipped / total if total else float("nan")
    log(f"{tag}: kernel vs plain path, cosine per image (min over {b}): "
        + ", ".join(f"{k} {v:.7f}" for k, v in cos.items())
        + (f"; mask-attention keys flipped {flipped} of {total} ({100 * share:.4f}%)"
           if total else "") + f"; {layers} launches of #1 per forward")
    if min(cos.values()) < min_cos:
        raise RuntimeError(f"{tag}: the kernel path disagrees with the plain path: {cos}")
    return {"cos": cos, "flipped": share}


def check_segmenters(card: str) -> None:
    """Phase 17(b): both segmenters at full width (d 1536, 24 heads) and
    depth 4, 896 px, 150 classes, on seeded random weights: UperNet and the
    recipe's Mask2Former (feat 1024, 200 queries, 9 decoder and 6 pixel
    layers), the kernel path against the plain path in fp32 (cosine per image
    >= 1-1e-6) and bf16 (>= 0.999) on the pyramid and the class scores, with
    the share of flipped mask-attention keys."""
    from one_peace_tpu_torch.vision.zoo import (OnePeaceMask2FormerSegmenter,
                                                 OnePeaceSegmenter)

    gen = torch.Generator(device="cuda").manual_seed(171)
    images = torch.randn(2, 3, SEG_PX, SEG_PX, generator=gen, device="cuda")
    builds = {"UperNet": lambda: OnePeaceSegmenter(seg_encoder(4), device="cuda"),
              "Mask2Former": lambda: OnePeaceMask2FormerSegmenter(
                  seg_encoder(4), feat_channels=1024, num_queries=200, dec_layers=9,
                  pixel_layers=6, device="cuda")}
    for name, build_model in builds.items():
        t0 = time.time()
        model = fill_random_(build_model(), torch.Generator(device="cuda").manual_seed(172)).eval()
        log(f"17(b) {name} segmenter, depth 4: "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B parameters "
            f"({time.time() - t0:.1f} s to build and fill)")
        for dtype, bound in ((torch.float32, 1 - 1e-6), (torch.bfloat16, 0.999)):
            model.to(dtype)
            compare_seg_paths(model, images, f"17(b) {name} {str(dtype)[6:]} B=2", bound)
        del model
        torch.cuda.empty_cache()


def seg_images_per_second(model, b: int, gen, card: str):
    """``model.logits`` at batch ``b`` in bf16: the median ms of 3 calls
    after one warm-up (host clock, synchronised), images per second and the
    peak memory; None if the batch does not fit."""
    try:
        images = torch.randn(b, 3, SEG_PX, SEG_PX, generator=gen, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.no_grad():
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.time()
                model.logits(images)
                torch.cuda.synchronize()
                if i:
                    times.append(1e3 * (time.time() - t0))
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        log(f"17(c) B={b} does not fit in the card's memory")
        return None
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"17(c) Mask2Former depth 40 bf16 logits B={b}: {ms:.1f} ms per call "
        f"({min(times):.1f}-{max(times):.1f}), {1e3 * b / ms:.2f} images/s, peak "
        f"{peak:.1f} GiB ({card})")
    return {"b": b, "ms": ms, "images": images, "peak": peak}


def serve_seg_full_depth(card: str) -> None:
    """Phase 17(c): the Mask2Former recipe at depth 40 through
    ``load_config`` and ``Ade20kSegTask.build_model`` in bf16 on seeded
    random weights: the kernel path against the plain path (as 17(b)), 40
    launches of #1 per forward, images per second of ``logits`` at B = 1, 2
    and 8 (each that fits), its peak memory, and one profiled forward at the
    largest (``chiprun_out/seg_profile.txt``: the device's idle share)."""
    from one_peace_tpu_torch.tasks.vision_tasks import Ade20kSegTask

    cfg = load_config(str(SEG_RECIPE), [])
    t0 = time.time()
    model = Ade20kSegTask.build_model(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(173)).eval()
    log(f"17(c) the recipe's Mask2Former segmenter, depth {cfg.model.encoder.layers}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B parameters "
        f"({time.time() - t0:.1f} s to build and fill)")
    gen = torch.Generator(device="cuda").manual_seed(174)
    images = torch.randn(1, 3, SEG_PX, SEG_PX, generator=gen, device="cuda")
    compare_seg_paths(model, images, "17(c) Mask2Former depth 40 bf16 B=1", 0.999)
    del images
    torch.cuda.empty_cache()
    best = None
    for b in (1, 2, 8):
        run = seg_images_per_second(model, b, gen, card)
        if run is not None:
            if best is not None:
                del best["images"]
            best = run
        torch.cuda.empty_cache()
    if best is None:
        raise RuntimeError("17(c): no batch fits")
    profile_call(lambda: model.logits(best["images"]), best["ms"], f"17(c) B={best['b']}",
                 "seg_profile.txt")
    del model, best
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_miou():
    """Observe each ``MIoU.merge_results``: its per-class intersection and
    union counts at the call."""
    from one_peace_tpu_torch.metrics.metrics import MIoU

    seen, merge = [], MIoU.merge_results

    def recording(self):
        seen.append((self.intersection.copy(), self.union.copy()))
        return merge(self)

    MIoU.merge_results = recording
    try:
        yield seen
    finally:
        MIoU.merge_results = merge


SEG_EVAL_LAYERS = 4  # 17(d)'s depth: the adapter's four interactions


def write_seg_eval_setup(layers: int) -> tuple:
    """17(d)'s set-up: a synthetic ADE20K tree under ``build/smoke_ade/`` and
    a fairseq ``.pt`` of the 4B encoder at ``layers`` from
    ``make_random_state_dict`` (seed 17, 16 x 16 pretrain tables)."""
    specs = write_ade_corpus(ADE_DIR, 2, 2)
    mcfg = ModelConfig(head_type="val")
    mcfg.encoder.layers = layers
    # the segmenter reads the image adapter and the layers' attention and
    # image FFNs only: the text and audio adapters are drawn small, and they
    # and the text and audio FFNs are left out of the file
    mcfg.encoder.text_adapter.vocab_size = 8
    mcfg.encoder.audio_adapter.feature_encoder_spec = ((16, 4, 2),)
    mcfg.encoder.audio_adapter.feature_embed_dim = 16
    pt = ADE_DIR / "one-peace.pt"
    sd = make_random_state_dict(mcfg, seed=17)
    unread = ("encoder_wrapper.text_adapter.", "encoder_wrapper.audio_adapter.")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()
                          if not k.startswith(unread)
                          and ".text_ffn." not in k and ".audio_ffn." not in k}}, pt)
    return specs, pt


def check_seg_cli(card: str, prep: "Prep", layers: int = SEG_EVAL_LAYERS) -> None:
    """Phase 17(d): a synthetic ADE20K tree under ``build/smoke_ade/``, a
    fairseq ``.pt`` of the 4B encoder at ``layers`` from
    ``make_random_state_dict`` (16 x 16 pretrain tables), and ``cli.evaluate``
    on the Mask2Former recipe at ``layers`` from it under the whole, slide and
    ms_flip protocols; the whole protocol's mIoU must equal a direct
    ``valid_step`` loop on the same weights to 1e-6, and its per-class
    intersection and union counts must be the same (random weights may give
    an mIoU of 0)."""
    from one_peace_tpu_torch.cli import evaluate as port_evaluate

    specs, pt = prep.take("17(d)", f"the corpus and a {layers}-layer fairseq .pt")
    overrides = [f"task.data={specs['train']}", f"task.valid_data={specs['valid']}",
                 f"model.encoder.layers={layers}", "dataset.batch_size_valid=2"]
    results, counts = {}, {}
    for protocol in ("whole", "slide", "ms_flip"):
        out = ADE_DIR / f"metrics_{protocol}.json"
        t0 = time.time()
        argv = ["--config", str(SEG_RECIPE), "--path", str(pt), "--output", str(out),
                "--device", "cuda", *overrides, f"task.seg_eval_protocol={protocol}"]
        with contextlib.redirect_stdout(sys.stderr), recorded_miou() as seen:
            if port_evaluate.main(argv) != 0:
                raise RuntimeError(f"17(d) cli.evaluate {protocol} failed")
        results[protocol], counts[protocol] = json.loads(out.read_text()), seen[-1]
        log(f"17(d) cli.evaluate {protocol} ({time.time() - t0:.1f} s): {results[protocol]}; "
            f"pixels counted {int(seen[-1][1].sum())}")
    direct, direct_counts = direct_miou(overrides, pt, torch.bfloat16)
    log(f"17(d) direct valid_step loop: {direct}")
    # with random weights the mIoU may well be 0: the per-class intersection
    # and union counts are compared too
    same = all(np.array_equal(a, b) for a, b in zip(direct_counts, counts["whole"]))
    if abs(direct["miou"] - results["whole"]["miou"]) > 1e-6 or not same:
        raise RuntimeError(f"17(d): cli.evaluate's mIoU {results['whole']['miou']} or its "
                           f"per-class counts differ from the direct loop's {direct['miou']}")


SEG_TRAIN_DIR = ROOT / "build" / "smoke_ade_train"
SEG_TRAIN_UPDATES = 6  # 18(d)'s window


def check_seg_train_attention(card: str) -> tuple:
    """Phase 18(a): #1 with the backward's statistics and #2 alone at the
    segmentation trunk's training shape (L = 3137, B=2, 24 heads, one shared
    fp32 (H, L, L) bias, no key bias; two walks, 50 key tiles, the last with
    one key; #2's d(bias) summed over the batch in device memory).  fp32
    first: the forward and its statistics within phase 3's bounds, the
    backward twice bit-equal and within phase 6's; then bf16 against the
    plain versions and timed in turns with SDPA and its backward through
    ``time_attention_cases``.  Returns the fp32 forward's max |diff|, the
    backward's, and the timed rows."""
    gen = torch.Generator(device="cuda").manual_seed(181)
    b, l, heads = 2, SEG_L, SEG_HEADS
    q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda") for _ in range(4))
    bias = torch.randn(heads, l, l, generator=gen, device="cuda")
    out, stats = fa.flash_attention_cuda(q, k, v, bias, None, 0.125, heads, with_stats=True)
    want, want_stats = fa.flash_attention_plain(q, k, v, bias, None, 0.125, heads,
                                                with_stats=True)
    fwd_err = (out - want).abs().max().item()
    stats_err = max(((stats[0] - want_stats[0]).abs() / want_stats[0].abs().clamp_min(1))
                    .max().item(), ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item())
    del out, want, want_stats
    got = fa.flash_attention_bwd_cuda(q, k, v, g, bias, None, 0.125, heads, stats=stats)
    again = fa.flash_attention_bwd_cuda(q, k, v, g, bias, None, 0.125, heads, stats=stats)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    plain = fa.flash_attention_bwd_plain(q, k, v, g, bias, None, 0.125, heads)
    parts, bwd_err, bad = [], 0.0, not same
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, plain):
        err = (x - y).abs()
        rel = err.max().item() / y.abs().max().item()
        bwd_err = max(bwd_err, err.max().item())
        parts.append(f"{name} {rel:.2e}/{err.mean().item() / y.abs().mean().item():.2e}")
        bad = bad or rel > 1e-4 or not torch.isfinite(x).all()
    plan = fa.bwd_plan(b, l, heads, True)
    log(f"18(a) fp32 B={b} L={l} H={heads} shared bias, no key bias: forward max|d| "
        f"{fwd_err:.3e}, statistics {stats_err:.2e} relative; backward from the forward's "
        f"statistics max/mean |d| relative {', '.join(parts)}; two calls bit-equal {same}; "
        f"{DQ_BRANCHES[plan.tiles.resident]}, {DKV_BRANCHES[plan.dkv_slab]}, {plan.chunks} "
        f"chunks of {plan.b_chunk}")
    if fwd_err > FP32_MAX_ERR or stats_err > 1e-4 or bad:
        raise RuntimeError("18(a): #1 or #2 disagrees with its plain version in fp32 at L=3137")
    del q, k, v, g, bias, stats, got, plain
    torch.cuda.empty_cache()
    fwd_rows, bwd_rows = time_attention_cases(
        "18(a)", [(b, l, heads, "shared", "segmentation training trunk, 896 px")], card, 182,
        lambda *args: None)
    return fwd_err, bwd_err, fwd_rows, bwd_rows


def seg_trainer(overrides: list, seed: int = 183) -> Trainer:
    """The recipe's segmenter (``Ade20kSegTask.build_model``: Mask2Former's
    ``max_instances`` and ``num_points`` from the task) on seeded random
    weights, its criterion and ``Trainer``."""
    from one_peace_tpu_torch.tasks.vision_tasks import Ade20kSegTask

    cfg = load_config(str(SEG_RECIPE), [ONE_PROCESS, *overrides])
    cfg.criterion._name = cfg.criterion._name or Ade20kSegTask.criterion_name
    model = Ade20kSegTask.build_model(cfg, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def seg_label_maps(b: int, rng, classes: int = 150) -> np.ndarray:
    """(b, 896, 896) int32 label maps: a random 7 x 7 grid of classes per
    image (up to 49 classes, more than the 32 instances kept), nearest
    upsampled, and a band of ignored pixels (255)."""
    grid = rng.randint(0, classes, (b, 7, 7))
    idx = np.arange(SEG_PX) * 7 // SEG_PX
    maps = grid[:, idx[:, None], idx[None, :]].astype(np.int32)
    maps[:, : SEG_PX // 10] = 255
    return maps


@contextlib.contextmanager
def recorded_assignments(fixed=None):
    """Observe the Mask2Former loss's Hungarian assignments: each call's
    (levels, B, K) columns, as the matching chose them.  With ``fixed``, the
    loss gets those columns instead."""
    from one_peace_tpu_torch.vision import mask2former_loss as mfl

    seen, assign = [], mfl.hungarian_assign

    def recording(cost, valid):
        cols = assign(cost, valid)
        seen.append(cols.cpu())
        return cols if fixed is None else fixed.to(cols.device)

    mfl.hungarian_assign = recording
    try:
        yield seen
    finally:
        mfl.hungarian_assign = assign


def check_seg_train_paths() -> None:
    """Phase 18(b): both segmenters' training objective at full width and
    depth 4 (remat), 896 px, B=2, from ``Ade20kSegTask.build_model`` on
    seeded random weights: UperNet's pixel CE at the labels' resolution and
    the recipe's Mask2Former set loss (200 queries, 10 prediction levels,
    12544 points, up to 32 GT masks), the kernel path against the plain path
    on the same weights, batch and generator seed, with phase 12(b)'s bounds
    (``judge_train_paths``; bf16 losses within 1e-3; the head's attention key
    biases and level embedding, whose gradient is 0 but for rounding, held
    near 0 instead of by cosine), and the number of Hungarian assignments
    that differ between the two paths.  bf16 rounding moves many costs
    across their near-ties, and a changed assignment changes a query's
    targets outright, so both bf16 paths take the fp32 plain path's
    assignment (the differences they would have chosen are logged): the
    bf16 bounds then measure the kernels' rounding, not a discrete choice.  Launches: 8 forward (4 layers and their recompute), 4
    backward."""
    rng = np.random.RandomState(184)
    gen = torch.Generator(device="cuda").manual_seed(184)
    batch = {"src_images": torch.randn(2, 3, SEG_PX, SEG_PX, generator=gen, device="cuda"),
             "target": torch.from_numpy(seg_label_maps(2, rng)).cuda()}
    for head in ("upernet", "mask2former"):
        ref32 = fixed = None
        for bf16 in (False, True):
            name = f"{head} {'bf16' if bf16 else 'fp32'}"
            t0 = time.time()
            trainer = seg_trainer(["model.encoder.layers=4", f"common.bf16={str(bf16).lower()}",
                                   f"task.seg_head={head}"])
            runs, cols = {}, {}
            for impl in ("pallas", "xla"):
                trainer.model.backbone.cfg.attn_impl = impl
                fa.launches = fa.bwd_launches = 0
                with recorded_assignments(fixed) as seen:
                    metrics, grads = trainer.gradients(batch, torch.Generator().manual_seed(5))
                torch.cuda.synchronize()
                launched = (fa.launches, fa.bwd_launches)
                want = (8, 4) if impl == "pallas" else (0, 0)
                if launched != want:
                    raise RuntimeError(f"18(b) {name} {impl}: launches {launched}, expected "
                                       f"{want}")
                if not all(torch.isfinite(g).all() for g in grads):
                    raise RuntimeError(f"18(b) {name} {impl}: non-finite gradient")
                runs[impl] = (float(metrics["loss"]), grads)
                cols[impl] = seen
            names = trainer._names
            del trainer
            differ = ""
            if head == "mask2former":
                (a,), (b,) = cols["pallas"], cols["xla"]
                differ = (f"; Hungarian assignments differing between the paths: "
                          f"{int((a != b).sum())} of {a.numel()} (levels x images x GT slots "
                          f"{tuple(a.shape)})")
                if fixed is None:
                    fixed = b
                else:
                    differ += (f", from the fp32 plain path's {int((a != fixed).sum())} (kernel "
                               f"path) and {int((b != fixed).sum())} (plain path), which both "
                               f"bf16 paths took")
            log(f"18(b) {name}: depth 4, 896 px, B=2 ({time.time() - t0:.1f} s){differ}")
            # the Mask2Former head's attention key biases, and its level
            # embedding, which enters only the keys of one level's
            # cross-attention: a constant over a softmax's keys, gradient 0
            null = {n for n in names if n.startswith("head.") and n.endswith(".k.bias")
                    or n == "head.level_embed"}
            ref32 = judge_train_paths(f"18(b) {name} 4-layer segmenter 896 px B=2", runs, names,
                                      ref32 if bf16 else None, bf16_loss_tol=1e-3, null=null)
            del runs, grads
            torch.cuda.empty_cache()
        del ref32
        torch.cuda.empty_cache()


def seg_train_argv(specs: dict, save_dir: Path, layers: int, extra=()) -> list:
    return ["--config", str(SEG_RECIPE), "--device", "cuda", f"task.data={specs['train']}",
            f"task.valid_data={specs['valid']}", f"model.encoder.layers={layers}",
            "dataset.batch_size=2", "dataset.batch_size_valid=2",
            f"checkpoint.save_dir={save_dir}", "checkpoint.keep_last_epochs=1", ONE_PROCESS,
            *extra]


def direct_miou(overrides: list, path: Path, dtype=None) -> tuple:
    """The recipe's segmenter at ``overrides`` with the weights of ``path``
    (``load_weights``), in ``dtype``, through a direct ``valid_step`` loop:
    the stats and the per-class (intersection, union) counts."""
    from one_peace_tpu_torch.cli.train import load_weights
    from one_peace_tpu_torch.tasks import build_task

    cfg = load_config(str(SEG_RECIPE), overrides)
    task = build_task(cfg.task, cfg)
    model = task.build_model(cfg, device="cuda")
    load_weights(cfg, model, "cuda", str(path))
    if dtype is not None:
        model.to(dtype)
    task.load_dataset("valid")
    task.begin_valid_epoch(model, None)
    for batch in task.get_batch_iterator("valid", 2, ensure_equal_batch=False).next_epoch_itr():
        task.valid_step(model, None, batch)
    with recorded_miou() as seen:
        stats = task.merge_results()
    del model
    torch.cuda.empty_cache()
    return stats, seen[-1]


def train_state_lazily(step_dir: Path) -> dict:
    """A ``step_<n>`` train-state bundle memory-mapped: only the tensors read
    are read from the file (a depth-4 seg bundle is 7 GB, its masters a
    third of it)."""
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt

    return torch.load(step_dir / ckpt.STATE_FILE, map_location="cpu", weights_only=True,
                      mmap=True)


def check_seg_train_cli(card: str, prep: "Prep", layers: int = 4) -> dict:
    """Phase 18(c): a synthetic ADE20K tree under ``build/smoke_ade_train/``
    (6 train images, 3 batches of 2 an epoch; 2 valid), and the Mask2Former
    recipe through ``cli.train`` at full width and depth ``layers`` in fp32,
    4 updates at lr 1e-5 from update 0: once straight, with a validation at
    update 4 (``checkpoint_best.npz`` by mIoU: the masters there) and no
    train-state save; once to the
    end of epoch 1 (3 updates: the repeat, with a save every 2 updates, the
    last at update 2, mid-epoch), and resumed from that save to 4 (the
    iterator restores the dataset's crop generator mid-epoch), with a
    validation at update 4 as the straight run's and no export.  Each
    run's masters are kept on the card at its validation.  The backward's atomics (the
    deformable sampling's and the point sampling's) make two runs of the
    same updates differ: by up to 6e-6 relative in the update losses by
    update 4 on an H100, the seeded random weights' gradients being large.
    So the repeat's and the resumed run's update losses must agree with the
    straight run's to 1e-4 relative (a resume with the wrong lr schedule
    moved update 3's by 43%), and the final masters to cosine 1-1e-6; then
    ``cli.evaluate`` on the straight run's export must equal a direct
    ``valid_step`` loop on it (mIoU to 1e-6 and the per-class counts)."""
    import one_peace_tpu_torch.cli.train as train_cli
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt

    specs = prep.take("18(c)", "the corpus")
    t0 = time.time()
    runs = {"straight": SEG_TRAIN_DIR / "straight", "resumed": SEG_TRAIN_DIR / "resumed"}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)
    common = ["common.bf16=false", "common.log_interval=1", "optimization.lr=1e-5",
              "lr_scheduler.warmup_updates=0", "optimization.max_update=4",
              "checkpoint.best_checkpoint_metric=miou", "checkpoint.save_interval=1000",
              "dataset.validate_interval=1000"]

    def argv(name, log_name, *extra):
        return seg_train_argv(specs, runs[name], layers, [
            *common, f"common.log_file={runs[name]}/{log_name}.jsonl", *extra])

    kept, real_validate = [], train_cli.validate  # (step, masters) at each validation

    def keeping_validate(cfg_, task_, model_, trainer_, progress_):
        kept.append((trainer_.step, {n: p.detach().clone()
                                     for n, p in trainer_.model.named_parameters()}))
        return real_validate(cfg_, task_, model_, trainer_, progress_)

    train_cli.validate = keeping_validate
    try:
        run_train_cli(argv("straight", "log", "dataset.validate_interval_updates=4"))
        quiet = ("dataset.disable_validation=true", "checkpoint.best_checkpoint_metric=",
                 "checkpoint.save_interval_updates=2")
        run_train_cli(argv("resumed", "part1", "optimization.max_epoch=1", *quiet))
        mid = train_state_lazily(runs["resumed"] / "step_2")
        if (mid["trainer"]["step"], mid["iterator"]["consumed"]) != (2, 2):
            raise RuntimeError(f"18(c): the save is at step {mid['trainer']['step']}, batch "
                               f"{mid['iterator']['consumed']} of its epoch, not 2 and 2")
        del mid
        run_train_cli(argv("resumed", "part2", "checkpoint.best_checkpoint_metric=",
                           "dataset.validate_interval_updates=4"))
    finally:
        train_cli.validate = real_validate
    straight = update_losses(runs["straight"] / "log.jsonl")
    repeat = update_losses(runs["resumed"] / "part1.jsonl")
    resumed = update_losses(runs["resumed"] / "part2.jsonl")
    spread = max(abs(x - y) / abs(y) for x, y in zip(repeat, straight))
    off = max(abs(x - y) / abs(y) for x, y in zip(resumed, straight[2:]))
    log(f"18(c) Mask2Former depth {layers} fp32, B=2: update losses straight {straight}, "
        f"repeated to the end of epoch 1 {repeat} (largest relative difference {spread:.2e}), "
        f"updates 3-4 resumed from the save at update 2 (mid-epoch) {resumed} (largest "
        f"relative difference {off:.2e}) ({time.time() - t0:.1f} s for the three runs)")
    # the straight run validates once, part 1 never, part 2 once
    if [step for step, _ in kept] != [4, 4]:
        raise RuntimeError(f"18(c): validations at updates {[step for step, _ in kept]}, not "
                           f"one at update 4 in the straight run and one in the resumed run")
    (_, a), (_, b) = kept
    dot = na = nb = diff = 0.0
    for name in a:
        x, y = a[name].double(), b[name].double()
        dot, na, nb = (dot + float(x.flatten() @ y.flatten()), na + float(x.norm() ** 2),
                       nb + float(y.norm() ** 2))
        diff = max(diff, float((x - y).abs().max()))
    cosine = dot / math.sqrt(na * nb)
    log(f"18(c) final masters, straight vs resumed: max |diff| {diff:.3e}, cosine "
        f"{cosine:.12f}")
    ok = (len(straight) == 4 and len(repeat) == 3 and len(resumed) == 2
          and all(map(math.isfinite, straight)) and max(spread, off) <= 1e-4
          and cosine >= 1 - 1e-6)
    if not ok:
        raise RuntimeError("18(c): the resumed run does not end where the straight run does")
    del a, b, kept
    best = runs["straight"] / "checkpoint_best.npz"
    meta = ckpt.load_metadata(str(best))
    overrides = seg_train_argv(specs, runs["straight"], layers, ["common.bf16=false"])[4:]
    out = runs["straight"] / "eval.json"
    with contextlib.redirect_stdout(sys.stderr), recorded_miou() as seen:
        if evaluate_cli.main(["--config", str(SEG_RECIPE), "--path", str(best), "--output",
                              str(out), "--device", "cuda", *overrides]) != 0:
            raise RuntimeError("18(c): cli.evaluate failed")
    stats = json.loads(out.read_text())
    direct, counts = direct_miou(overrides, best)
    same = all(np.array_equal(x, y) for x, y in zip(seen[-1], counts))
    log(f"18(c) checkpoint_best.npz ({meta}): cli.evaluate {stats}; direct valid_step loop "
        f"{direct}; per-class counts equal {same}")
    if abs(direct["miou"] - stats["miou"]) > 1e-6 or not same:
        raise RuntimeError("18(c): cli.evaluate on the export differs from the direct loop")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": straight, "cosine": cosine}


def seg_update_flops(cfg, b: int) -> float:
    """Closed-form FLOPs of one segmentation update's trunk (``analytic_flops``
    at L = 3137 with the hMLP stem at 896 px): forward, remat's recompute and
    a backward of twice the forward, 4x the forward.  The adapter's spatial
    priors and interactions and the Mask2Former head are not counted, so the
    MFU is a lower bound."""
    return 4 * analytic_flops(cfg.model, SEG_L, b, "image", image_size=SEG_PX)


def gather_backward_share(prof: dict) -> str:
    """The profiled update's device time by named part: the rel-pos bias
    gathers' backward (the per-bucket sums under ``rel_bias_bucket_sum``, and
    any index backward left, ``indexing_backward``), #1 and #2, and the
    host's time in the Hungarian matching (``hungarian_assign``), each beside
    the device's busy time."""
    events = update_averages(prof)

    def device_ms(match):  # a profiler range's self time is its span on the device
        return sum(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0)
                   for e in events if match(e.key)) / 1e3

    busy = profile_busy_ms(prof)
    parts = {"the bias gathers' per-bucket backward": device_ms(
                 lambda k: k == "rel_bias_bucket_sum"),
             "index backward": device_ms(lambda k: "indexing_backward" in k),
             "#1": device_ms(lambda k: "attn_fwd" in k),
             "#2": device_ms(lambda k: "attn_bwd" in k)}
    host = sum(e.cpu_time_total for e in events if e.key == "hungarian_assign") / 1e3
    return (", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)" for k, v in parts.items())
            + f" of the busy {busy:.1f} ms; the matching on the host {host:.1f} ms")


def train_seg_full_depth(card: str) -> dict:
    """Phase 18(d): the Mask2Former recipe at depth ``CUT_DEPTH`` through
    ``load_config`` and ``cli.train`` from the config's init (fp32 masters,
    AdamW, layer decay 0.95 with one lr per rel-pos table), bf16, remat, B=2,
    ``SEG_TRAIN_UPDATES`` updates from 18(c)'s files, no validation, no saves.
    Update 3 runs under torch.profiler from the end of update 2 (the idle
    share, the top device ops, the bias gathers' backward, #1, #2 and the
    matching's host time); ``ms`` is the median of the other updates after
    the first that do not open an epoch.  #1 launches twice a layer an
    update (forward and recompute) and #2 once; the losses must be finite."""
    specs = {"train": f"{SEG_TRAIN_DIR}/images/training:{SEG_TRAIN_DIR}/annotations/training",
             "valid": ""}
    layers = CUT_DEPTH
    save_dir = SEG_TRAIN_DIR / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = seg_train_argv(specs, save_dir, layers, [
        f"optimization.max_update={SEG_TRAIN_UPDATES}", "checkpoint.best_checkpoint_metric=",
        "checkpoint.save_interval=1000", "checkpoint.save_interval_updates=0"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with profiled_update(3) as prof, recorded_steps() as steps:
        t0 = time.time()
        run_train_cli(argv)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    rolled = 4  # 3 batches an epoch: update 4 opens epoch 2
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (3, rolled)]
    ms = statistics.median(steady)
    cfg = load_config(argv[1], argv[4:])
    flops = seg_update_flops(cfg, 2)
    tflops = flops / ms / 1e9
    log(f"18(d) cli.train, the Mask2Former recipe at depth {layers}, B=2, bf16, {SEG_TRAIN_UPDATES} "
        f"updates from the config's init in {wall:.1f} s (model build and data included) "
        f"({card})")
    log(f"18(d) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"18(d) updates 2-{SEG_TRAIN_UPDATES} from data, each from the end of the last (3 "
        f"profiled, {rolled} opens epoch 2): {[round(x, 1) for x in update_ms]} ms; steady: "
        f"median {ms:.1f} ms per update of {len(steady)}, {2 / ms * 1e3:.3f} images/s, "
        f"{flops / 1e12:.1f} TFLOP an update (the trunk's), {tflops:.1f} TFLOP/s = "
        f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU of {H100_BF16_PEAK_TFLOPS:.0f}, peak "
        f"{peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    want = (2 * layers, layers)
    log(f"18(d) launches per update (#1, #2): {per_update} (expected [{want}])")
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 3 of cli.train, the Mask2Former recipe "
                                    f"at depth {layers}, B=2, from the end of update 2",
                                    "seg_train_profile.txt", card)
        log(f"18(d) {line} (seg_train_profile.txt); {gather_backward_share(prof)}")
        table = device_table(update_averages(prof), profile_busy_ms(prof), 12)
        for row in table.splitlines()[:16]:
            log(f"  {row}")
    if not all(map(math.isfinite, losses)) or len(losses) != SEG_TRAIN_UPDATES:
        raise RuntimeError(f"18(d): losses {losses}")
    if per_update != [want]:
        raise RuntimeError(f"18(d): launches per update {per_update}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak, "losses": losses, "mfu": tflops / H100_BF16_PEAK_TFLOPS}


K400_DIR = ROOT / "build" / "smoke_k400"
K400_RECIPE = ROOT / "recipes" / "video" / "k400_32frames.yaml"
K400_SIZES = ((340, 256), (256, 340), (320, 240), (171, 128))  # (width, height)


def write_k400_corpus(root: Path, n_train: int, n_valid: int, lengths=(150, 40, 97, 64),
                      sizes=K400_SIZES, num_classes: int = 400, seed: int = 19,
                      distinct: int = 16) -> dict:
    """Phase 19(c): a synthetic Kinetics tree under ``root`` in mmaction2's
    rawframes layout (``rawframes/<clip>/img_00001.jpg``...,
    ``{train,valid}_list_rawframes.txt`` lines ``clip frames label``), the
    clips' lengths and frame sizes from ``lengths`` and ``sizes`` in turn
    (landscape and portrait; clips shorter than the recipe's 32 x 4 = 128
    frames are loop-padded), each clip a pattern drifting over its frames in
    a label-dependent colour.  A clip's first ``distinct`` frames are
    encoded and its later ones are hard links to them in turn (encoding
    every frame took 29.5 s for 32 clips).  Returns the annotation files and
    the frames' root."""
    import os

    from PIL import Image

    rng = np.random.RandomState(seed)
    palette = rng.randint(30, 225, (num_classes, 3))
    frames_root = root / "rawframes"
    out, count = {"root": str(frames_root)}, 0
    for split, n in (("train", n_train), ("valid", n_valid)):
        lines = []
        for _ in range(n):
            w, h = sizes[count % len(sizes)]
            total = lengths[count % len(lengths)]
            label = int(rng.randint(num_classes))
            clip = frames_root / f"clip{count:04d}"
            clip.mkdir(parents=True, exist_ok=True)
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            for fi in range(total):
                path = clip / f"img_{fi + 1:05d}.jpg"
                if fi >= distinct:
                    if path.exists():
                        path.unlink()
                    os.link(clip / f"img_{fi % distinct + 1:05d}.jpg", path)
                    continue
                wave = np.sin((xx + 3.0 * fi) / (11.0 + label % 7) + yy / 19.0)
                img = palette[label] * (0.75 + 0.25 * wave[..., None])
                img = img + rng.randint(-12, 13, (h, w, 3))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=90)
            lines.append(f"{clip.name} {total} {label}")
            count += 1
        ann = root / f"{split}_list_rawframes.txt"
        ann.write_text("\n".join(lines) + "\n")
        out[split] = str(ann)
    return out


K400_PX, K400_FRAMES, K400_HEADS = 256, 32, 24
K400_N = (K400_PX // 16) ** 2 + 1  # 257 tokens a frame
K400_UPDATES = 6  # 19(d)'s window
VIDEO_ATTENTION = [  # (B, L, heads, bias, what): the video trunk's two shapes at the recipe's B=8
    (8 * K400_N, K400_FRAMES, K400_HEADS, None, "temporal, 32 frames"),
    (8 * K400_FRAMES, K400_N, K400_HEADS, "shared", "spatial, 256 px")]


def check_attention_fp32(tag: str, cases, seed: int, key_bias_fn) -> tuple:
    """#1 with the backward's statistics and #2 alone in fp32 at ``cases``
    of (B, L, heads, bias, what) (the bias "shared" (H, L, L) or None, the
    key bias from ``key_bias_fn(b, l, what, rng)``): the forward and its
    statistics within phase 3's bounds, the backward from the forward's
    statistics twice bit-equal and within phase 6's.  Returns the forward's
    and the backward's largest max |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    fwd_worst = bwd_worst = 0.0
    for b, l, heads, bias_kind, what in cases:
        q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda")
                      for _ in range(4))
        bias = (torch.randn(heads, l, l, generator=gen, device="cuda")
                if bias_kind == "shared" else None)
        key_bias = key_bias_fn(b, l, what, rng)
        args = (bias, key_bias, 0.125, heads)
        out, stats = fa.flash_attention_cuda(q, k, v, *args, with_stats=True)
        want, want_stats = fa.flash_attention_plain(q, k, v, *args, with_stats=True)
        fwd_err = (out - want).abs().max().item()
        stats_err = max(((stats[0] - want_stats[0]).abs() / want_stats[0].abs().clamp_min(1))
                        .max().item(),
                        ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item())
        del out, want, want_stats
        got = fa.flash_attention_bwd_cuda(q, k, v, g, *args, stats=stats)
        again = fa.flash_attention_bwd_cuda(q, k, v, g, *args, stats=stats)
        torch.cuda.synchronize()
        same = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
        del again
        plain = fa.flash_attention_bwd_plain(q, k, v, g, *args)
        parts, bad = [], not same
        for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, plain):
            if y is None:
                continue
            err = (x - y).abs()
            rel = err.max().item() / y.abs().max().item()
            bwd_worst = max(bwd_worst, err.max().item())
            parts.append(f"{name} {rel:.2e}/{err.mean().item() / y.abs().mean().item():.2e}")
            bad = bad or rel > 1e-4 or not torch.isfinite(x).all()
        fwd_worst = max(fwd_worst, fwd_err)
        plan, bplan = fa.tile_plan(l), fa.bwd_plan(b, l, heads, bias is not None)
        log(f"{tag} fp32 B={b} L={l} H={heads} {bias_kind or 'no'} bias ({what}): forward max|d| "
            f"{fwd_err:.3e}, statistics {stats_err:.2e} relative; backward from the forward's "
            f"statistics max/mean |d| relative {', '.join(parts)}; two calls bit-equal {same}; "
            f"{FWD_BRANCHES[plan.resident]}, last tile {plan.tail} wide; "
            f"{DQ_BRANCHES[bplan.tiles.resident]}, {DKV_BRANCHES[bplan.dkv_slab]}, "
            f"{bplan.chunks} chunks of {bplan.b_chunk}")
        if fwd_err > FP32_MAX_ERR or stats_err > 1e-4 or bad:
            raise RuntimeError(f"{tag}: #1 or #2 disagrees with its plain version in fp32 at "
                               f"L={l}, B={b}")
        del q, k, v, g, bias, key_bias, stats, got, plain
        torch.cuda.empty_cache()
    return fwd_worst, bwd_worst


def check_video_attention(card: str) -> tuple:
    """Phase 19(a): #1 with the backward's statistics and #2 alone at the
    video trunk's shapes at the recipe's B=8: the temporal attention (L=32
    over B = 8 x 257 = 2056 sequences, no bias: one key tile whose tail is
    L, a 64-row q tile half empty, 2056 dk/dv blocks on grid z) and the
    spatial one (L=257 over B = 8 x 32 = 256 frames, one shared fp32
    (H, L, L) bias whose d(bias) #2 sums over the 256 rows in chunks).  fp32
    first through ``check_attention_fp32``; then bf16 against the plain
    versions and timed in turns with SDPA and its backward through
    ``time_attention_cases``.  Returns the fp32 forward's max |diff|, the
    backward's, and the timed rows."""
    fwd_worst, bwd_worst = check_attention_fp32("19(a)", VIDEO_ATTENTION, 191,
                                                lambda *args: None)
    fwd_rows, bwd_rows = time_attention_cases("19(a)", VIDEO_ATTENTION, card, 192,
                                              lambda *args: None)
    return fwd_worst, bwd_worst, fwd_rows, bwd_rows


def video_trainer(overrides: list, seed: int = 193) -> Trainer:
    """The recipe's video classifier (``K400VideoTask.build_model``: full
    width, 256 px, 32 frames, remat) on ``fill_random_``'s seeded weights
    (the adapters' ``fc2``, the temporal embedding and the rel-pos table
    non-zero), its criterion and ``Trainer``: the trunk frozen."""
    from one_peace_tpu_torch.tasks.vision_tasks import K400VideoTask

    cfg = load_config(str(K400_RECIPE), [ONE_PROCESS, *overrides])
    cfg.criterion._name = cfg.criterion._name or K400VideoTask.criterion_name
    model = K400VideoTask.build_model(cfg, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def check_video_train_paths() -> None:
    """Phase 19(b): the video classifier at full width and depth 4, 256 px,
    32 frames, B=2, remat, on seeded random weights, kernel path against
    plain path on the same weights and clips: the logits of a forward in
    fp32 (cosine per clip >= 1-1e-6) and bf16 (>= 0.999), 8 launches of #1
    per forward (4 layers x the temporal and the spatial attention); then the
    trainable parameters' gradients through ``Trainer`` and the criterion
    with 7(a)'s bounds (fp32: losses within 1e-5, every gradient's cosine
    >= 1-1e-6; bf16: losses within 2e-3, all gradients together >= 0.999
    kernel vs plain, and per parameter the kernel path no further from the
    fp32 gradients than the plain path but 0.01), 16 launches of #1 (the
    forward and remat's recompute) and 8 of #2 per gradient.  The trunk is
    frozen: its weights take no gradient, yet every layer's attention runs
    its backward."""
    from one_peace_tpu_torch.tasks.vision_tasks import call_on

    gen = torch.Generator(device="cuda").manual_seed(194)
    clips = torch.randn(2, K400_FRAMES, 3, K400_PX, K400_PX, generator=gen, device="cuda")
    batch = {"src_videos": clips, "target": torch.tensor([7, 311], device="cuda")}
    ref32 = logits32 = None
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        t0 = time.time()
        trainer = video_trainer(["model.encoder.layers=4", f"common.bf16={str(bf16).lower()}"])
        backbone = trainer.model.backbone
        runs, logits = {}, {}
        for impl in ("pallas", "xla"):
            backbone.attn_impl = impl
            fa.launches = fa.bwd_launches = 0
            with torch.no_grad():
                logits[impl] = call_on(trainer.model, trainer._compute_params(prefix=""),
                                       "forward", clips).float()
            torch.cuda.synchronize()
            fwd = fa.launches
            metrics, grads = trainer.gradients(batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            launched = (fwd, fa.launches - fwd, fa.bwd_launches)
            want = (8, 16, 8) if impl == "pallas" else (0, 0, 0)
            if launched != want:
                raise RuntimeError(f"19(b) {name} {impl}: launches (forward; gradient's #1, "
                                   f"#2) {launched}, expected {want}")
            if not all(torch.isfinite(g).all() for g in grads):
                raise RuntimeError(f"19(b) {name} {impl}: non-finite gradient")
            runs[impl] = (float(metrics["loss"]), grads)
        backbone.attn_impl = "pallas"
        names = trainer._names
        frozen = sum(not p.requires_grad for p in trainer.model.parameters())
        del trainer
        cos = min_cosine(logits["pallas"], logits["xla"])
        cos32 = (float("nan") if logits32 is None
                 else min_cosine(logits["pallas"], logits32))
        log(f"19(b) {name} depth 4, 256 px, 32 frames, B=2 ({time.time() - t0:.1f} s): logits "
            f"cosine per clip kernel vs plain min {cos:.9f}"
            + ("" if logits32 is None else f", kernel path vs the fp32 plain path {cos32:.6f}")
            + f"; launches per forward: #1 8; per gradient: #1 16, #2 8; {len(names)} "
            f"trainable parameters, {frozen} frozen")
        if cos < (0.999 if bf16 else 1 - 1e-6):
            raise RuntimeError(f"19(b) {name}: the kernel path's logits disagree")
        if logits32 is None:
            logits32 = logits["xla"]
        (loss_k, grads_k), (loss_p, grads_p) = runs["pallas"], runs["xla"]
        gcos = grad_cosines(grads_k, grads_p)
        worst = min(range(len(gcos)), key=gcos.__getitem__)
        total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                             [torch.cat([g.flatten() for g in grads_p])])[0]
        log(f"19(b) {name}: loss kernel {loss_k:.7f} plain {loss_p:.7f}; gradient cosine kernel "
            f"vs plain over all trainable parameters {total:.9f}, per parameter min "
            f"{gcos[worst]:.9f} ({names[worst]}), median {sorted(gcos)[len(gcos) // 2]:.9f}")
        if not bf16:
            ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and gcos[worst] >= 1 - 1e-6
            ref32 = grads_p
        else:
            cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
            gap = max(range(len(gcos)), key=lambda i: cos_p[i] - cos_k[i])
            log(f"19(b) bf16 vs the fp32 gradients: min cosine kernel path {min(cos_k):.6f}, "
                f"plain path {min(cos_p):.6f}; largest shortfall of the kernel path "
                f"{cos_p[gap] - cos_k[gap]:.2e} ({names[gap]})")
            ok = (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
                  and cos_p[gap] - cos_k[gap] <= 0.01)
        if not ok:
            raise RuntimeError(f"19(b) {name}: kernel and plain training paths disagree")
        del runs, grads, grads_k, grads_p
        torch.cuda.empty_cache()


def k400_argv(corpus: dict, train: str, save_dir: Path, layers: int, extra=()) -> list:
    return ["--config", str(K400_RECIPE), "--device", "cuda", f"task.data={train}",
            f"task.image_dir={corpus['root']}", f"task.valid_data={corpus['valid']}",
            "task.num_classes=400", f"model.encoder.layers={layers}",
            f"checkpoint.save_dir={save_dir}", ONE_PROCESS, *extra]


@contextlib.contextmanager
def recorded_hits():
    """Observe each ``Accuracy.merge_results``: the batches' top-1 hits and
    the stats."""
    from one_peace_tpu_torch.metrics.metrics import Accuracy

    seen, real = [], Accuracy.merge_results

    def merge(self):
        hits = [int(x) for x in self.ncorrect_list]
        stats = real(self)
        seen.append((hits, stats))
        return stats

    Accuracy.merge_results = merge
    try:
        yield seen
    finally:
        Accuracy.merge_results = real


def check_video_cli(corpus: dict, card: str, layers: int = 2) -> dict:
    """Phase 19(c): the recipe through ``cli.train`` at full width and depth
    ``layers`` (bf16 over fp32 masters, remat, B=2) on 6 of the synthetic
    clips (3 batches an epoch), 4 updates at lr 1e-4 from update 0, a save
    and a validation (4 clips x 3 clips x ThreeCrop = 36 views) every 2
    updates, ``checkpoint_best.npz`` by accuracy: once straight; once, with
    no validation, to the end of epoch 1 (3 updates, the last save at update
    2, mid-epoch) and resumed from that save to 4.  Nothing on the path sums by atomics, so
    the resumed run's update losses must equal the straight run's to 1e-6
    relative; the export must read back (``params_from_jax``) bit-equal to
    the masters of the bundle of its step, and ``cli.evaluate`` on it must
    equal a direct ``valid_step`` loop on the same weights (the accuracy and
    every batch's hits)."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.cli.train import load_weights
    from one_peace_tpu_torch.tasks import build_task
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt
    from one_peace_tpu_torch.utils.checkpoint import load_npz

    t0 = time.time()
    train6 = K400_DIR / "train6_list_rawframes.txt"
    train6.write_text("".join(Path(corpus["train"]).read_text().splitlines(True)[:6]))
    valid4 = K400_DIR / "valid4_list_rawframes.txt"
    valid4.write_text("".join(Path(corpus["valid"]).read_text().splitlines(True)[:4]))
    corpus = {**corpus, "valid": str(valid4)}
    runs = {"straight": K400_DIR / "straight", "resumed": K400_DIR / "resumed"}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)
    common = ["common.log_interval=1", "optimization.lr=1e-4", "lr_scheduler.warmup_updates=0",
              "lr_scheduler.warmup_ratio=0", "optimization.max_update=4",
              "checkpoint.save_interval_updates=2", "checkpoint.keep_last_epochs=2",
              "checkpoint.best_checkpoint_metric=accuracy", "checkpoint.save_interval=1000",
              "dataset.validate_interval=1000", "dataset.batch_size=2",
              "dataset.batch_size_valid=2"]

    def argv(name, log_name, *extra):
        return k400_argv(corpus, str(train6), runs[name], layers, [
            *common, f"common.log_file={runs[name]}/{log_name}.jsonl", *extra])

    with recorded_hits() as valid_hits:
        run_train_cli(argv("straight", "log"))
    quiet = ("dataset.disable_validation=true", "checkpoint.best_checkpoint_metric=")
    run_train_cli(argv("resumed", "part1", "optimization.max_epoch=1", *quiet))
    mid = train_state_lazily(runs["resumed"] / "step_2")
    if (mid["trainer"]["step"], mid["iterator"]["consumed"]) != (2, 2):
        raise RuntimeError(f"19(c): the save is at step {mid['trainer']['step']}, batch "
                           f"{mid['iterator']['consumed']} of its epoch, not 2 and 2")
    trunk_at_2 = {k: v for k, v in mid["trainer"]["params"].items()
                  if ".self_attn." in k or ".image_ffn." in k}
    del mid
    run_train_cli(argv("resumed", "part2", *quiet))
    straight = update_losses(runs["straight"] / "log.jsonl")
    repeat = update_losses(runs["resumed"] / "part1.jsonl")
    resumed = update_losses(runs["resumed"] / "part2.jsonl")
    spread = max(abs(x - y) / abs(y) for x, y in zip(repeat, straight))
    off = max(abs(x - y) / abs(y) for x, y in zip(resumed, straight[2:]))
    log(f"19(c) the recipe at depth {layers}, bf16, B=2: update losses straight {straight}, "
        f"repeated to the end of epoch 1 {repeat} (largest relative difference {spread:.2e}), "
        f"updates 3-4 resumed from the save at update 2 (mid-epoch) {resumed} (largest "
        f"relative difference {off:.2e}) ({time.time() - t0:.1f} s)")
    if not (len(straight) == 4 and len(repeat) == 3 and len(resumed) == 2
            and all(map(math.isfinite, straight)) and max(spread, off) <= 1e-6):
        raise RuntimeError("19(c): the resumed run does not repeat the straight run")
    best = runs["straight"] / "checkpoint_best.npz"
    meta = ckpt.load_metadata(str(best))
    masters = train_state_lazily(runs["straight"] / f"step_{meta['step']}")["trainer"]["params"]
    exported = load_npz(str(best))
    same = sorted(exported) == sorted(masters) and all(
        torch.equal(exported[k], masters[k]) for k in masters)
    frozen = all(torch.equal(masters[k], v) for k, v in trunk_at_2.items())
    log(f"19(c) checkpoint_best.npz ({meta}): read back bit-equal to the masters of step "
        f"{meta['step']}: {same}; the trunk's weights unchanged from update 2: {frozen}; the "
        f"validations' hits {[h for h, _ in valid_hits]}")
    if not same or not frozen:
        raise RuntimeError("19(c): the export or the frozen trunk is not what training left")
    del masters, exported
    overrides = k400_argv(corpus, str(train6), runs["straight"], layers)[4:]
    out = runs["straight"] / "eval.json"
    with contextlib.redirect_stdout(sys.stderr), recorded_hits() as seen:
        if evaluate_cli.main(["--config", str(K400_RECIPE), "--path", str(best), "--output",
                              str(out), "--device", "cuda", *overrides,
                              "dataset.batch_size_valid=2"]) != 0:
            raise RuntimeError("19(c): cli.evaluate failed")
    stats = json.loads(out.read_text())
    cfg = load_config(str(K400_RECIPE), overrides + ["dataset.batch_size_valid=2"])
    task = build_task(cfg.task, cfg)
    model = task.build_model(cfg, device="cuda")
    load_weights(cfg, model, "cuda", str(best))
    model.to(torch.bfloat16)
    task.load_dataset("valid")
    task.begin_valid_epoch(model, None)
    for batch in task.get_batch_iterator("valid", 2, ensure_equal_batch=False).next_epoch_itr():
        task.valid_step(model, None, batch)
    with recorded_hits() as direct:
        direct_stats = task.merge_results()
    del model
    log(f"19(c) cli.evaluate (3 clips x ThreeCrop, bf16) {stats}; direct valid_step loop "
        f"{direct_stats}; hits {seen[-1][0]} and {direct[-1][0]}")
    if (seen[-1][0] != direct[-1][0] or abs(stats["accuracy"] - direct_stats["accuracy"]) > 1e-6
            or stats["count"] != len(Path(corpus["valid"]).read_text().splitlines())):
        raise RuntimeError("19(c): cli.evaluate on the export differs from the direct loop")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": straight, "accuracy": stats["accuracy"]}


def video_update_flops(b: int, layers: int = 40, d: int = 1536, f: int = 6144) -> float:
    """Closed-form FLOPs of one frozen-trunk video update at B clips: per
    token and layer 19 d^2 (the two attention passes' projections and the
    three adapters) + 6 d f (the GeGLU FFN) + 4 (N + T) d (both attentions)
    in the forward, as much again for the input gradients, and the
    adapters' weight gradients (3 d^2); remat's recompute and the stem are
    not counted."""
    n, t = K400_N, K400_FRAMES
    fwd = 19 * d * d + 6 * d * f + 4 * (n + t) * d
    return float(b * t * n * layers * (2 * fwd + 3 * d * d))


def train_video_full_depth(corpus: dict, card: str) -> dict:
    """Phase 19(d): the recipe at depth ``CUT_DEPTH`` through ``cli.train``
    from the config's init (the trunk frozen, AdamW over the
    adapters, the temporal embedding, the rel-pos table, the norm and the
    head), bf16, remat, B=8 clips of 32 frames at 256 px (RandomResizedCrop
    and colour jitter on the host), ``K400_UPDATES`` updates from 19(c)'s
    files, one validation after the last (the 8 valid clips x 3 clips x
    ThreeCrop = 72 views in two batches of 4 clips, so that the second
    batch's decoding overlaps the first's forwards;
    ``K400VideoTask.VIEWS_PER_FORWARD`` views a forward), no saves.  Update 3 runs under torch.profiler from the end of update 2;
    ``ms`` is the median of the other updates after the first that do not
    open an epoch (3 batches an epoch).  #1 launches 4 times a layer an
    update (temporal and spatial, forward and recompute) and #2 twice; the
    losses must be finite."""
    import one_peace_tpu_torch.cli.train as train_cli

    layers = CUT_DEPTH
    save_dir = K400_DIR / f"depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = k400_argv(corpus, corpus["train"], save_dir, layers, [
        f"optimization.max_update={K400_UPDATES}", "checkpoint.best_checkpoint_metric=",
        "checkpoint.save_interval=1000", "checkpoint.save_interval_updates=0",
        "dataset.validate_interval=1000", f"dataset.validate_interval_updates={K400_UPDATES}",
        "dataset.batch_size_valid=4"])
    valid, real_validate = [], train_cli.validate

    def measured_validate(*args):
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        f0, b0, t0 = fa.launches, fa.bwd_launches, time.time()
        stats = real_validate(*args)
        torch.cuda.synchronize()
        valid.append({"ms": 1e3 * (time.time() - t0), "stats": stats, "train_peak": train_peak,
                      "peak": torch.cuda.max_memory_allocated() / 2**30,
                      "fwd": fa.launches - f0, "bwd": fa.bwd_launches - b0})
        return stats

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_cli.validate = measured_validate
    try:
        with profiled_update(3) as prof, recorded_steps() as steps:
            t0 = time.time()
            run_train_cli(argv)
            wall = time.time() - t0
    finally:
        train_cli.validate = real_validate
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    rolled = 4  # 3 batches an epoch: update 4 opens epoch 2
    steady = [ms for i, ms in enumerate(update_ms, 2) if i not in (3, rolled)]
    ms = statistics.median(steady)
    flops = video_update_flops(8, layers)
    tflops = flops / ms / 1e9
    v = valid[0] if valid else {}
    log(f"19(d) cli.train, the K400 recipe at depth {layers}, B=8 clips of 32 frames, bf16, "
        f"{K400_UPDATES} updates from the config's init and one validation in {wall:.1f} s "
        f"(model build and data included) ({card})")
    log(f"19(d) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"19(d) updates 2-{K400_UPDATES} from data, each from the end of the last (3 "
        f"profiled, {rolled} opens epoch 2): {[round(x, 1) for x in update_ms]} ms; steady: "
        f"median {ms:.1f} ms per update of {len(steady)}, {8 / ms * 1e3:.3f} clips/s, "
        f"{flops / 1e12:.1f} TFLOP an update, {tflops:.1f} TFLOP/s = "
        f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU of {H100_BF16_PEAK_TFLOPS:.0f}, peak "
        f"{v.get('train_peak', float('nan')):.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    want = (4 * layers, 2 * layers)
    log(f"19(d) launches per update (#1, #2): {per_update} (expected [{want}])")
    if v:
        log(f"19(d) validation over 8 clips (72 views, {K400_FRAMES} frames each, 2 batches): "
            f"{v['ms']:.1f} ms, {v['ms'] / 8:.1f} ms per clip (decoding included), peak "
            f"{v['peak']:.1f} GiB (the train state included), launches #1 {v['fwd']}, #2 "
            f"{v['bwd']}; {v['stats']} ({card})")
    if "wall" in prof:
        line = write_update_profile(prof, ms, "update 3 of cli.train, the K400 recipe at depth "
                                    f"{layers}, B=8, from the end of update 2",
                                    "video_train_profile.txt", card)
        events = update_averages(prof)
        busy = profile_busy_ms(prof)
        parts = {name: sum(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0)
                           for e in events if key in e.key) / 1e3
                 for name, key in (("#1", "attn_fwd"), ("#2", "attn_bwd"))}
        log(f"19(d) {line} (video_train_profile.txt); "
            + ", ".join(f"{k} {x:.1f} ms ({100 * x / busy:.1f}%)" for k, x in parts.items()))
        table = device_table(events, busy, 12)
        for row in table.splitlines()[:16]:
            log(f"  {row}")
    if not all(map(math.isfinite, losses)) or len(losses) != K400_UPDATES:
        raise RuntimeError(f"19(d): losses {losses}")
    if per_update != [want]:
        raise RuntimeError(f"19(d): launches per update {per_update}, expected {want}")
    from one_peace_tpu_torch.tasks.vision_tasks import K400VideoTask

    want = 2 * math.ceil(4 * 9 / K400VideoTask.VIEWS_PER_FORWARD) * 2 * layers
    if len(valid) != 1 or valid[0]["fwd"] != want or valid[0]["bwd"] != 0:
        raise RuntimeError(f"19(d): validations {[(x['fwd'], x['bwd']) for x in valid]}, "
                           f"expected one of {want} / 0 launches")
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": v["train_peak"], "losses": losses,
            "mfu": tflops / H100_BF16_PEAK_TFLOPS}


CLASSIFY_REST_DIR = ROOT / "build" / "smoke_classify_rest"
CLASSIFY_REST_RECIPES = {"nlvr2": ROOT / "recipes" / "nlvr2" / "base.yaml",
                         "refcoco": ROOT / "recipes" / "visual_grounding" / "base.yaml",
                         "aqa": ROOT / "recipes" / "aqa" / "base.yaml",
                         "fsd50k": ROOT / "recipes" / "fsd50k" / "base.yaml"}
FSD50K_CLASSES = 200  # Fsd50kDataset's num_classes
AQA_ANSWERS = ("a dog barking", "a car passing", "rain on a roof", "a man speaking",
               "birds singing", "a door closing", "music playing", "water running")


def write_classify_rest_corpus(root: Path, n_train: int = 48, n_valid: int = 16,
                               clip_seconds=(5.0, 15.0), image_px=(256, 399)) -> dict:
    """Phase 20(c): ``n_train + n_valid`` JPEGs of ``image_px`` with an NLVR2
    TSV (``id, text, image1, image2, label``, the label "True" or "False")
    and a RefCOCO TSV (``image, text, region_coord``, a box inside the image
    as ``x0,y0,x1,y1``); WAV clips of ``clip_seconds`` with an FSD50K TSV
    (``id, audio, labels, duration``: 1-3 of its 200 classes joined by
    commas) and an AQA TSV (``id, audio, text, duration``, the text
    ``question&&&a1&&&a2&&&a3&&&a4&&&choice``); each split into train and
    valid, and the byte-level BPE set.  Returns the paths."""
    from PIL import Image

    rng = np.random.RandomState(20)
    root.mkdir(parents=True, exist_ok=True)
    n = n_train + n_valid
    tables = {"nlvr2": ["id\ttext\timage1\timage2\tlabel"],
              "refcoco": ["image\ttext\tregion_coord"],
              "fsd50k": ["id\taudio\tlabels\tduration"],
              "aqa": ["id\taudio\ttext\tduration"]}
    lo, hi = image_px
    for i in range(n):
        h, w = lo + (37 * i) % (hi - lo + 1), lo + (53 * i) % (hi - lo + 1)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (0.07 * w + 5 * c + rng.rand() * 9) + yy / (0.09 * h + 3 * c))
                 for c in range(3)]
        Image.fromarray(((np.stack(chans, -1) * 0.45 + 0.5) * 255).astype(np.uint8)).save(
            root / f"img{i}.jpg", quality=92)
        words = " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), 4 + i % 9))
        tables["nlvr2"].append(f"{i}\tthe left image shows {words}\timg{i}.jpg\t"
                               f"img{(i + 1) % n}.jpg\t{('True', 'False')[rng.randint(2)]}")
        x0, y0 = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
        x1, y1 = rng.uniform(x0 + 8, w), rng.uniform(y0 + 8, h)
        tables["refcoco"].append(f"img{i}.jpg\tthe {words}\t{x0:.2f},{y0:.2f},{x1:.2f},{y1:.2f}")
        samples = int(16000 * rng.uniform(*clip_seconds))
        t = np.arange(samples)
        wav = np.sin(t * (0.008 + 0.003 * (i % 7))) * 5000 + rng.randn(samples) * 800
        write_wav(root / f"clip{i}.wav", wav)
        labels = ",".join(str(c) for c in sorted(rng.choice(FSD50K_CLASSES, 1 + i % 3,
                                                            replace=False)))
        tables["fsd50k"].append(f"{i}\tclip{i}.wav\t{labels}\t{samples / 16000:.3f}")
        answers = [AQA_ANSWERS[j] for j in rng.choice(len(AQA_ANSWERS), 4, replace=False)]
        question = f"what is heard {words}"
        tables["aqa"].append(f"{i}\tclip{i}.wav\t{'&&&'.join([question, *answers])}&&&"
                             f"{rng.randint(4)}\t{samples / 16000:.3f}")
    out = {"root": root, "bpe": write_bpe_dir(root / "bpe")}
    for task, rows in tables.items():
        for split, part in (("train", rows[1:n_train + 1]), ("valid", rows[n_train + 1:])):
            (root / f"{task}_{split}.tsv").write_text("\n".join([rows[0], *part]) + "\n")
        out[task] = {split: str(root / f"{task}_{split}.tsv") for split in ("train", "valid")}
    return out


CLASSIFY_REST_ATTENTION = [  # (B, L, heads, bias, what): the rest of classify's two new shapes
    (32, 647, 24, "shared", "NLVR2 16 pairs, 70 text + 577 image tokens at 384 px, text pads"),
    (32, 820, 24, "shared", "AQA 8 questions x 4 choices, 70 text + 750 audio tokens at 15 s, "
                            "text and audio pads"),
    (16, 760, 24, "shared", "AQA 4 questions x 4 choices, a ragged batch: L in 753-768, whose "
                            "padded width 768 leaves no room for the d(bias) slab")]


def classify_rest_key_bias(b: int, l: int, what: str, rng):
    """The text (its first 70 positions) padded after 12-61 tokens in each
    row; AQA's rows also pad the audio after clips of 5-15 s, the 4 choices
    of a question sharing one clip."""
    mask = torch.zeros(b, l, dtype=torch.bool)
    for row in range(b):
        mask[row, 12 + (7 * row) % 50:70] = True
    if what.startswith("AQA"):
        spec = ModelConfig().encoder.audio_adapter.feature_encoder_spec
        for question, seconds in enumerate(rng.uniform(5, 15, b // 4)):
            frames = conv_output_length(int(16000 * seconds), spec)
            mask[4 * question:4 * question + 4, 70 + 1 + frames:] = True
    return torch.zeros(b, l).masked_fill(mask, fa.NEG_INF).cuda()


def check_classify_rest_attention(card: str) -> tuple:
    """Phase 20(a): #1 and #2 alone at the rest of classify's shapes
    (``CLASSIFY_REST_ATTENTION``: NLVR2's vl sequences at L=647, B=32 with
    text pads; AQA's al sequences at L=820, B=32 with text and audio pads,
    and at L=760, B=16, where ``bwd_plan`` keeps d(bias) in device memory,
    the slab not fitting beside the kernel's static shared memory; 24
    heads, one shared fp32 (H, L, L) bias): fp32 through
    ``check_attention_fp32``, then bf16 against the plain versions and in
    turns with SDPA and its backward through ``time_attention_cases``.
    Returns the fp32 max |diff|s and the timed rows."""
    fwd_err, bwd_err = check_attention_fp32("20(a)", CLASSIFY_REST_ATTENTION, 201,
                                            classify_rest_key_bias)
    fwd_rows, bwd_rows = time_attention_cases("20(a)", CLASSIFY_REST_ATTENTION, card, 202,
                                              classify_rest_key_bias)
    return fwd_err, bwd_err, fwd_rows, bwd_rows


CLASSIFY_REST_HEADS = {  # task: (head type, px, criterion, the task's head)
    "nlvr2": ("vl", 384, "classify_criterion", {"num_classes": 2, "use_two_images": True}),
    "refcoco": ("vl", 384, "refcoco_criterion", {"num_classes": 4}),
    "aqa": ("al", 256, "hinge_criterion", {"num_classes": 1}),
    "fsd50k": ("audio", 256, "classify_criterion", {"num_classes": FSD50K_CLASSES}),
}


def classify_rest_trainer(task: str, layers: int, bf16: bool, seed: int = 0) -> Trainer:
    """The task's model at the 4B width, ``layers`` deep, with its head, on
    random weights drawn from ``seed``, and ``Trainer`` with the task's
    criterion (BCE for FSD50K, 4 choices for AQA)."""
    head, px, criterion, head_kw = CLASSIFY_REST_HEADS[task]
    cfg = train_config(layers, bf16, False, 0.0)
    cfg.model = ModelConfig(_name="one_peace_classify", head_type=head)
    cfg.model.encoder.layers = layers
    cfg.model.encoder.image_adapter.rel_bucket_size = px // 16
    cfg.criterion._name = criterion
    cfg.criterion.use_multi_label = task == "fsd50k"
    cfg.criterion.num_choices = 4
    model = OnePeaceClassifyModel(cfg.model, **head_kw, device="cuda")
    fill_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return Trainer(cfg, model, build_criterion(cfg.criterion))


def classify_rest_batch(task: str, rng, b: int = 8) -> dict:
    """20(b)'s batch of ``b`` examples: NLVR2 pairs at 384 px (two images
    each) and RefCOCO images at 384 px, each with a 70-token statement with
    pads; AQA questions x 4 choices of 70 tokens with pads over clips of
    5-15 s; FSD50K clips of 5-15 s with 1-3 of 200 classes each."""
    def tokens(n):
        out = torch.from_numpy(rng.randint(4, 260, (n, 70))).cuda()
        out[text_pad_mask(n, 71)[:, 1:]] = ModelConfig().encoder.text_adapter.padding_idx
        return out

    def images(n):
        return torch.from_numpy(rng.randn(n, 3, 384, 384).astype(np.float32)).cuda()

    if task == "nlvr2":
        return {"src_tokens": tokens(b), "src_images": images(b), "src_images_2": images(b),
                "target": torch.from_numpy(rng.randint(0, 2, b)).cuda()}
    if task == "refcoco":
        lo = rng.uniform(0, 0.5, (b, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (b, 2))], 1).astype(np.float32)
        return {"src_tokens": tokens(b), "src_images": images(b),
                "target": torch.from_numpy(boxes).cuda()}
    wav, pad = audio_clips([int(16000 * s) for s in rng.uniform(5, 15, b)], rng)
    if task == "aqa":
        return {"src_tokens": tokens(4 * b), "src_audios": wav, "audio_padding_masks": pad,
                "target": torch.from_numpy(rng.randint(0, 4, b)).cuda()}
    target = np.zeros((b, FSD50K_CLASSES), np.float32)
    for row in target:
        row[rng.choice(FSD50K_CLASSES, rng.randint(1, 4), replace=False)] = 1.0
    return {"src_audios": wav, "audio_padding_masks": pad,
            "target": torch.from_numpy(target).cuda()}


def no_further_than_plain(kernel: list, plain: list) -> tuple:
    """(the kernel path's mean excess over the plain path, three standard
    errors of that mean): the per-batch paired differences' sample standard
    deviation over sqrt(n), measured between the batches' seeds."""
    diff = [k - p for k, p in zip(kernel, plain)]
    return statistics.mean(diff), 3 * statistics.stdev(diff) / math.sqrt(len(diff))


def check_classify_rest_train_paths() -> None:
    """Phase 20(b): each task's criterion at 2 layers, full width, through
    ``Trainer``, kernel path against plain path on the same weights and
    batch, for 8 seeds: each draws the weights and a batch of 8 examples
    (NLVR2 pairs, RefCOCO images, AQA questions of 4 choices, FSD50K
    clips).  fp32, every seed: the losses within 1e-5 and every gradient's
    cosine >= 1-1e-6 (7(a)'s bounds).  bf16: the kernel path no further from
    fp32 than the plain path (7(a)), in the gradients (1 - cosine to the
    fp32 plain path's, all parameters together) and in the loss (relative
    error to the fp32 plain path's): over the 8 seeds, the kernel path's
    mean excess over the plain path at most three standard errors of that
    mean, the spread of the paired differences between the seeds.  One
    weight draw for all batches would not do: the paths' loss difference
    follows the weights' bf16 rounding as much as the batch, so batches on
    one draw are not independent samples (``PERF.md`` section 6).  Each
    seed's 7(a) per-batch bf16 rules are logged beside it: the hinge over
    bf16 scores (AQA) and cross entropy over a few samples move by bf16
    rounding alone, on either path, further than those rules allow
    (``PERF.md`` section 6).  #1 and #2 launch once per layer and image
    (NLVR2: twice) on the kernel path, never on the plain path."""
    seeds, layers = range(2030, 2038), 2
    for task in CLASSIFY_REST_HEADS:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        passes = 2 if task == "nlvr2" else 1
        dist, err = {"pallas": [], "xla": []}, {"pallas": [], "xla": []}
        for seed in seeds:
            batch = classify_rest_batch(task, np.random.RandomState(seed))
            runs = {}
            for bf16 in (False, True):  # one trainer at a time: AQA's fp32 path peaks near 70 GiB
                trainer = classify_rest_trainer(task, layers, bf16, seed)
                names = trainer._names
                for impl in ("pallas", "xla"):
                    trainer.model.cfg.encoder.attn_impl = impl
                    before = (fa.launches, fa.bwd_launches)
                    metrics, grads = trainer.gradients(batch)
                    torch.cuda.synchronize()
                    launched = (fa.launches - before[0], fa.bwd_launches - before[1])
                    want = (layers * passes,) * 2 if impl == "pallas" else (0, 0)
                    name = "bf16" if bf16 else "fp32"
                    if launched != want:
                        raise RuntimeError(f"20(b) {task} {name} {impl}: launches {launched}, "
                                           f"expected {want}")
                    if not all(torch.isfinite(g).all() for g in grads):
                        raise RuntimeError(f"20(b) {task} {name} {impl}: non-finite gradient")
                    runs[name, impl] = (float(metrics["loss"]), grads)
                    del metrics, grads
                del trainer
            (loss_k, grads_k), (loss_p, grads_p) = runs["fp32", "pallas"], runs["fp32", "xla"]
            cos = grad_cosines(grads_k, grads_p)
            worst = min(range(len(cos)), key=cos.__getitem__)
            log(f"20(b) {task} fp32 {layers} layers seed {seed} "
                f"{ {k: tuple(v.shape) for k, v in batch.items()} }: loss kernel "
                f"{loss_k:.7f} plain {loss_p:.7f}; gradient cosine kernel vs plain per "
                f"parameter min {cos[worst]:.9f} ({names[worst]}), {len(cos)} parameters")
            if not (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and cos[worst] >= 1 - 1e-6):
                raise RuntimeError(f"20(b) {task} fp32: kernel and plain paths disagree")
            loss32, ref = loss_p, grads_p
            del runs["fp32", "pallas"], grads_k
            (loss_k, grads_k), (loss_p, grads_p) = runs["bf16", "pallas"], runs["bf16", "xla"]
            flat_ref = torch.cat([g.flatten() for g in ref])
            for impl, (loss, grads) in (("pallas", (loss_k, grads_k)), ("xla", (loss_p, grads_p))):
                dist[impl].append(1 - grad_cosines([torch.cat([g.flatten() for g in grads])],
                                                   [flat_ref])[0])
                err[impl].append(abs(loss - loss32) / abs(loss32))
            cos_k, cos_p = grad_cosines(grads_k, ref), grad_cosines(grads_p, ref)
            gap = max(range(len(cos_k)), key=lambda j: cos_p[j] - cos_k[j])
            total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                                 [torch.cat([g.flatten() for g in grads_p])])[0]
            log(f"20(b) {task} bf16 seed {seed}: loss kernel {loss_k:.7f} plain {loss_p:.7f} fp32 "
                f"{loss32:.7f}; relative loss error to fp32 kernel {err['pallas'][-1]:.3e} plain "
                f"{err['xla'][-1]:.3e}; 1 - cosine to the fp32 gradients, all parameters "
                f"together: kernel {dist['pallas'][-1]:.3e}, plain {dist['xla'][-1]:.3e}; 7(a)'s "
                f"per-batch rules (logged): kernel vs plain {total:.6f} (>= 0.999), losses "
                f"{abs(loss_k - loss_p) / abs(loss_p):.2e} apart (<= 2e-3), largest "
                f"per-parameter shortfall {cos_p[gap] - cos_k[gap]:.2e} ({names[gap]}; <= 0.01)")
            del runs, ref, flat_ref, grads_k, grads_p, batch
            torch.cuda.empty_cache()
        failed = []
        for what, values in (("gradients' 1 - cosine", dist), ("loss's relative error", err)):
            excess, bound = no_further_than_plain(values["pallas"], values["xla"])
            mk, mp = statistics.mean(values["pallas"]), statistics.mean(values["xla"])
            log(f"20(b) {task} bf16 over {len(seeds)} seeds, the {what} to fp32: mean kernel "
                f"{mk:.3e} plain {mp:.3e} ({mk / mp:.3f}x); the kernel path's excess "
                f"{excess:.3e}, bound {bound:.3e} (three standard errors)")
            if excess > bound:
                failed.append(what)
        log(f"20(b) {task}: peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
            f"{time.time() - t0:.1f} s")
        if failed:
            raise RuntimeError(f"20(b) {task} bf16: the kernel path is further from fp32 than "
                               f"the plain path in the {' and the '.join(failed)}")


CLASSIFY_REST_METRIC = {"nlvr2": "accuracy", "refcoco": "acc@0.5", "aqa": "accuracy",
                        "fsd50k": "map"}
CLASSIFY_REST_TASK_ARGS = {"nlvr2": [], "refcoco": [], "aqa": [],  # the recipes as users run them
                           "fsd50k": [f"task.num_classes={FSD50K_CLASSES}"]}
CLASSIFY_REST_BATCH = {"nlvr2": 4, "refcoco": 4, "aqa": 4, "fsd50k": 8}


def classify_rest_argv(data: dict, task: str, save_dir: Path, layers: int, batch: int,
                       extra=()) -> list:
    """``cli.train`` / ``cli.evaluate`` arguments: the task's recipe with the
    data overrides (FSD50K's ``task.num_classes=200``) at the 4B width,
    ``layers`` deep, bf16 over fp32 masters, remat, drop path 0.5, the
    fine-tuning base's AdamW, no epoch saves; then ``extra``."""
    return ["--config", str(CLASSIFY_REST_RECIPES[task]), "--device", "cuda",
            f"task.data={data[task]['train']}", f"task.valid_data={data[task]['valid']}",
            f"task.bpe_dir={data['bpe']}", *CLASSIFY_REST_TASK_ARGS[task],
            f"model.encoder.layers={layers}", "model.encoder.drop_path_rate=0.5",
            "model.encoder.checkpoint_activations=true", "common.bf16=true",
            "common.log_interval=1", "common.seed=3407", "optimizer.adam_betas=(0.9,0.999)",
            "optimizer.weight_decay=0.05", "lr_scheduler.warmup_ratio=0.1",
            "lr_scheduler.min_lr=1e-6", "optimization.lr=1e-4", "optimization.clip_norm=0.0",
            f"dataset.batch_size={batch}", "dataset.batch_size_valid=8",
            f"checkpoint.save_dir={save_dir}", "checkpoint.save_interval=1000",
            f"common.log_file={save_dir}/log.jsonl", *extra]


def check_classify_rest_cli(data: dict, layers: int = 2) -> dict:
    """Phase 20(c): each of the four recipes at full width, depth
    ``layers``, from 20's synthetic files through ``cli.train`` from the
    config's init: 2 updates, one validation over the valid rows and
    ``checkpoint_best.npz`` by the recipe's metric (accuracy, acc@0.5 or
    map), whose ``params_from_jax`` read-back must equal the masters at the
    validation bit for bit; then ``cli.evaluate`` on the export must print
    the validation's metric within 1e-6 and its count."""
    from one_peace_tpu_torch.cli import evaluate as evaluate_cli
    from one_peace_tpu_torch.utils.checkpoint import params_from_jax
    from one_peace_tpu_torch.utils.native_checkpoint import load_params

    out = {}
    for task, metric in CLASSIFY_REST_METRIC.items():
        save_dir = CLASSIFY_REST_DIR / f"{task}_depth{layers}"
        shutil.rmtree(save_dir, ignore_errors=True)
        argv = classify_rest_argv(data, task, save_dir, layers, CLASSIFY_REST_BATCH[task],
                                  ["optimization.max_update=2",
                                   "dataset.validate_interval_updates=2"])
        t0 = time.time()
        with recorded_validation(keep_masters=True) as runs, recorded_steps() as steps:
            run_train_cli(argv)
        losses = update_losses(save_dir / "log.jsonl")
        log(f"20(c) {task} cli.train, depth {layers}, B={CLASSIFY_REST_BATCH[task]}: update "
            f"losses {losses}, launches per update (#1, #2) "
            f"{sorted({(s['fwd'], s['bwd']) for s in steps})} ({time.time() - t0:.1f} s with the "
            f"model's build)")
        if len(runs) != 1 or len(losses) != 2 or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"20(c) {task}: {len(runs)} validations, losses {losses}")
        stats = runs[0]["stats"]
        best = save_dir / "checkpoint_best.npz"
        export = params_from_jax(load_params(str(best)))
        masters = runs[0]["masters"]
        equal = export.keys() == masters.keys() and all(
            export[k].dtype == masters[k].dtype and torch.equal(export[k], masters[k])
            for k in masters)
        log(f"20(c) {task} validation {stats}; checkpoint_best.npz through params_from_jax: "
            f"{len(export)} tensors, bit-equal to the masters at the validation: {equal}")
        if not equal:
            raise RuntimeError(f"20(c) {task}: the best export does not read back as the masters")
        result = save_dir / "eval.json"
        evaluate_cli.main(["--path", str(best), "--output", str(result), *argv])
        evaluated = json.loads(result.read_text())
        diff = abs(evaluated[metric] - stats[metric])
        log(f"20(c) {task} cli.evaluate on checkpoint_best.npz: {evaluated}; {metric} differs "
            f"from the validation's by {diff:.3e}")
        if diff > 1e-6 or evaluated["count"] != stats["count"]:
            raise RuntimeError(f"20(c) {task}: cli.evaluate disagrees with the validation")
        out[task] = {"losses": losses, metric: stats[metric]}
        gc.collect()
        torch.cuda.empty_cache()
    return out


NLVR2_UPDATES = 5  # 20(d)'s window: update 1 warms up, 2-4 steady, 5 profiled


def train_nlvr2_full_depth(data: dict, card: str) -> dict:
    """Phase 20(d): the NLVR2 recipe at depth ``CUT_DEPTH``, 384 px, through
    ``cli.train`` from the config's init: B=16 pairs (32 sequences of
    L=647), bf16 over fp32 masters, remat, the train split's distortion,
    blur, flip and RandAugment on the host, ``NLVR2_UPDATES`` updates within
    one epoch, no validation, no saves.  Update 5 runs under torch.profiler
    from the end of update 4; ``ms`` is the median of updates 2-4.  #1 must
    launch 4 times a layer and #2 twice a layer an update (two images a pair,
    remat); the losses must be finite."""
    layers = CUT_DEPTH
    save_dir = CLASSIFY_REST_DIR / f"nlvr2_depth{layers}"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = classify_rest_argv(data, "nlvr2", save_dir, layers, 16, [
        f"optimization.max_update={NLVR2_UPDATES}", "dataset.disable_validation=true",
        "checkpoint.best_checkpoint_metric="])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with profiled_update(NLVR2_UPDATES) as prof, recorded_steps() as steps:
        t0 = time.time()
        run_train_cli(argv)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [s["metrics"]["loss"] for s in steps]
    update_ms = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(steps, steps[1:])]
    steady = update_ms[:NLVR2_UPDATES - 2]  # updates 2-4; 5 is profiled
    ms = statistics.median(steady)
    cfg = load_config(str(CLASSIFY_REST_RECIPES["nlvr2"]), argv[4:])
    forward = analytic_flops(cfg.model, 647, 32, "image", image_size=384)
    flops = 3 * forward  # forward and backward; remat's recompute not counted
    tflops = flops / ms / 1e9
    log(f"20(d) cli.train, the NLVR2 recipe at depth {layers}, 384 px, B=16 pairs (32 sequences of "
        f"L=647), bf16, remat, {NLVR2_UPDATES} updates from the config's init in {wall:.1f} s "
        f"(model build and data included) ({card})")
    log(f"20(d) losses {[round(x, 5) for x in losses]}; ms inside train_step "
        f"{[round(1e3 * (s['t1'] - s['t0']), 1) for s in steps]} (update 1 warms up)")
    log(f"20(d) updates 2-{NLVR2_UPDATES} from data, each from the end of the last "
        f"({NLVR2_UPDATES} profiled): {[round(x, 1) for x in update_ms]} ms; steady: median "
        f"{ms:.1f} ms per update of {len(steady)}, {16 / ms * 1e3:.3f} pairs/s, "
        f"{flops / 1e12:.1f} TFLOP an update (forward {forward / 1e12:.1f}), {tflops:.1f} "
        f"TFLOP/s = {100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU of "
        f"{H100_BF16_PEAK_TFLOPS:.0f} ({100 * 4 / 3 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% with "
        f"the recompute counted, as 15(d) counts it), peak {peak:.1f} GiB ({card})")
    per_update = sorted({(s["fwd"], s["bwd"]) for s in steps})
    want = (4 * layers, 2 * layers)
    log(f"20(d) launches per update (#1, #2): {per_update} (expected [{want}])")
    if "wall" in prof:
        line = write_update_profile(prof, ms, f"update {NLVR2_UPDATES} of cli.train, the NLVR2 "
                                    f"recipe at depth {layers}, 384 px, B=16 pairs, from the end of "
                                    f"update {NLVR2_UPDATES - 1}", "nlvr2_train_profile.txt", card)
        events = update_averages(prof)
        busy = profile_busy_ms(prof)
        parts = {name: sum(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0)
                           for e in events if key in e.key) / 1e3
                 for name, key in (("#1", "attn_fwd"), ("#2", "attn_bwd"))}
        log(f"20(d) {line} (nlvr2_train_profile.txt); "
            + ", ".join(f"{k} {x:.1f} ms ({100 * x / busy:.1f}%)" for k, x in parts.items()))
        table = device_table(events, busy, 12)
        for row in table.splitlines()[:16]:
            log(f"  {row}")
    if not all(map(math.isfinite, losses)) or len(losses) != NLVR2_UPDATES:
        raise RuntimeError(f"20(d): losses {losses}")
    if per_update != [want]:
        raise RuntimeError(f"20(d): launches per update {per_update}, expected [{want}]")
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak, "losses": losses, "mfu": tflops / H100_BF16_PEAK_TFLOPS}


# ---------------------------------------------------------------------------
# 21. fp16: the fp16 arms of #1/#2 and #3/3b, 4B embeddings, the retrieval
# step with loss scaling and the EMA, the remat policies, Adan, the CLI
# ---------------------------------------------------------------------------

# fp16 keeps 10 mantissa bits to bf16's 7: its bounds are bf16's over 5
FP16_MAX_ERR, FP16_MEAN_ERR = BF16_MAX_ERR / 5, BF16_MEAN_ERR / 5
FP16_BWD_MAX, FP16_BWD_MEAN = 2e-2 / 5, 5e-3 / 5  # phase 6's bf16 relative bounds over 5
FP16_ATTENTION = [  # (B, L, bias form, pads, what, backward too): every branch of both plans
    (256, 257, "shared", None, "image", False), (32, 500, "shared", None, "audio", False),
    (32, 257, "shared", None, "image training", True),
    (32, 71, "shared", "text", "text", True), (4, 971, "shared", None, "VQA's vl", True),
    (4, 500, "shared", [0, 137, 0, 60], "audio pads", True),
    (2, 90, "batched", [3, 0], "per-sample bias", True),
    (2, 100, "shared", [0, 9], "key pads", True)]


def fp16_operands(b: int, l: int, form: str, pads, gen, heads: int = 24) -> tuple:
    """fp32 q, k, v, g (B, L, H*64), the fp32 bias (shared or per-sample) and
    the key bias (text pads, the given pad counts per row, or None)."""
    q, k, v, g = (torch.randn(b, l, heads * 64, generator=gen, device="cuda")
                  for _ in range(4))
    shape = (heads, l, l) if form == "shared" else (b, heads, l, l)
    bias = torch.randn(shape, generator=gen, device="cuda")
    if pads is None:
        return q, k, v, g, bias, None
    if pads == "text":
        mask = text_pad_mask(b, l)
    else:
        mask = torch.zeros(b, l, dtype=torch.bool, device="cuda")
        for row, n in enumerate(pads):
            if n:
                mask[row, l - n:] = True
    return q, k, v, g, bias, torch.zeros(b, l, device="cuda").masked_fill(mask, fa.NEG_INF)


def attention_errors(q, k, v, g, bias, key_bias, dtype, heads: int = 24) -> tuple:
    """The kernels in ``dtype`` on the inputs rounded to it, against the
    plain versions in fp32 on the same rounded inputs: the forward's max and
    mean |diff|, and each gradient's max and mean |diff| relative to the
    plain one's and the max |diff| (None without g).  The backward runs twice from the
    forward's statistics and must be bit-equal; the output written with the
    statistics must equal the one without."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads,
                                         with_stats=True)
    alone = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads)
    want = fa.flash_attention_plain(*(x.float() for x in (q, k, v)), bias, key_bias, 0.125,
                                    heads)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.equal(out, alone):
        raise RuntimeError(f"{dtype} forward: not finite, or the output written with the "
                           f"statistics differs")
    err = (out.float() - want).abs()
    fwd = (err.max().item(), err.mean().item())
    if g is None:
        return fwd, None
    g = g.to(dtype)
    got = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads, stats=stats)
    again = fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, heads, stats=stats)
    plain = fa.flash_attention_bwd_plain(*(x.float() for x in (q, k, v, g)), bias, key_bias,
                                         0.125, heads)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
        raise RuntimeError(f"{dtype} backward: two calls differ")
    rel = []
    for x, y in zip(got, plain):
        if y is None:
            continue
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{dtype} backward: not finite")
        d = (x.float() - y).abs()
        rel.append((d.max().item() / y.abs().max().item(),
                    d.mean().item() / y.abs().mean().item(), d.max().item()))
    return fwd, rel


def check_fp16_attention() -> tuple:
    """21(a): #1 and #2 in fp16 against their plain versions at the main
    path's shapes (``FP16_ATTENTION``: every branch of ``tile_plan`` and
    ``bwd_plan``, last key tiles 16, 32, 48 and 64 wide, text and key pads,
    the shared and the per-sample bias, d(bias) in the slab and in device
    memory), with bounds a fifth of bf16's; beside each, the bf16 kernels'
    errors on the same fp32 inputs.  Returns the fp16 forward's and
    backward's largest max |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(211)
    branches, fwd_worst, bwd_worst = set(), 0.0, 0.0
    for b, l, form, pads, what, with_bwd in FP16_ATTENTION:
        q, k, v, g, bias, key_bias = fp16_operands(b, l, form, pads, gen)
        g = g if with_bwd else None
        f16, b16 = (attention_errors(q, k, v, g, bias, key_bias, dt)
                    for dt in (torch.float16, torch.bfloat16))
        plan, bplan = fa.tile_plan(l), fa.bwd_plan(b, l, 24, form == "shared")
        branches.add(("fwd", plan.resident))
        line = (f"21(a) fp16 B={b} L={l} {form} bias, pads "
                f"{'text' if pads == 'text' else pads} ({what}): forward max/mean |d| "
                f"{f16[0][0]:.3e}/{f16[0][1]:.3e} (bf16 {b16[0][0]:.3e}/{b16[0][1]:.3e}); "
                f"plan {FWD_BRANCHES[plan.resident]}, last tile {plan.tail} wide")
        fwd_worst = max(fwd_worst, f16[0][0])
        if f16[0][0] > FP16_MAX_ERR or f16[0][1] > FP16_MEAN_ERR:
            raise RuntimeError(f"21(a) the fp16 forward disagrees at B={b} L={l} {what}: "
                               f"{f16[0]}")
        if with_bwd:
            branches.add(("dq", bplan.tiles.resident))
            if form == "shared":
                branches.add(("dkv", bplan.dkv_slab))
            line += (f"; backward dq/dk/dv/d(bias) max/mean relative "
                     f"{', '.join(f'{a:.2e}/{m:.2e}' for a, m, _ in f16[1])} (bf16 "
                     f"{', '.join(f'{a:.2e}/{m:.2e}' for a, m, _ in b16[1])}), two calls "
                     f"bit-equal; plan {DQ_BRANCHES[bplan.tiles.resident]}"
                     + (f", {DKV_BRANCHES[bplan.dkv_slab]}" if form == "shared" else ""))
            bwd_worst = max(bwd_worst, *(x for _, _, x in f16[1]))
            if any(a > FP16_BWD_MAX or m > FP16_BWD_MEAN for a, m, _ in f16[1]):
                raise RuntimeError(f"21(a) the fp16 backward disagrees at B={b} L={l} "
                                   f"{what}: {f16[1]}")
        log(line)
        del q, k, v, g, bias, key_bias
        torch.cuda.empty_cache()
    want = {(kernel, x) for kernel in ("fwd", "dq", "dkv") for x in (True, False)}
    if branches != want:
        raise RuntimeError(f"21(a) ran the plans' branches {sorted(branches)}, not all")
    return fwd_worst, bwd_worst


FP16_TIMED = [  # (B, L, pads, what, forward or backward)
    (256, 257, None, "image", "fwd"), (32, 500, None, "audio", "fwd"),
    (32, 71, "text", "text", "fwd"), (32, 257, None, "image training", "bwd"),
    (32, 71, "text", "text", "bwd"), (4, 971, None, "VQA's vl, d(bias) in device memory", "bwd")]


def time_fp16_attention(card: str) -> tuple:
    """21(a) times: #1 and #2 in fp16 in turns with SDPA in fp16 (the
    additive mask in fp16; its backward with the mask taking a gradient) and
    with the bf16 kernel on the same inputs, beside the bound (the fp16 dense
    peak is bf16's, 989 TFLOP/s, and the bytes are the same) and the plain
    version.  Returns the forward's and the backward's rows by shape."""
    gen = torch.Generator(device="cuda").manual_seed(212)
    heads, fwd_rows, bwd_rows = 24, {}, {}
    for b, l, pads, what, kind in FP16_TIMED:
        q32, k32, v32, g32, bias, key_bias = fp16_operands(b, l, "shared", pads, gen)
        hb = [x.to(torch.bfloat16) for x in (q32, k32, v32, g32)]
        q, k, v, g = (x.to(torch.float16) for x in (q32, k32, v32, g32))
        del q32, k32, v32, g32
        q4, k4, v4 = (x.view(b, l, heads, 64).transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(bias, key_bias, b, dtype=torch.float16)
        kb_bytes = 0 if key_bias is None else key_bias.numel() * 4
        name = f"L={l} B={b} {what}"
        if kind == "fwd":
            t = in_turns({
                "kernel": lambda: fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads),
                "bf16": lambda: fa.flash_attention_cuda(*hb[:3], bias, key_bias, 0.125, heads),
                "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=10)
            plain_ms = cuda_time_ms(
                lambda: fa.flash_attention_plain(q, k, v, bias, key_bias, 0.125, heads), iters=3)
            bound = bound_ms(4 * q.numel() * 2 + bias.numel() * 4 + kb_bytes,
                             4 * b * heads * l * l * 64, H100_BF16_PEAK_TFLOPS * 1e12)
            rows = fwd_rows
        else:
            _, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, heads,
                                               with_stats=True)
            _, stats_b = fa.flash_attention_cuda(*hb[:3], bias, key_bias, 0.125, heads,
                                                 with_stats=True)
            leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            leaf_mask = mask.detach().requires_grad_()
            res = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=leaf_mask,
                                                                   scale=0.125)
            g4 = g.view(b, l, heads, 64).transpose(1, 2)
            t = in_turns({
                "kernel": lambda: fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125,
                                                              heads, stats=stats),
                "bf16": lambda: fa.flash_attention_bwd_cuda(*hb, bias, key_bias, 0.125, heads,
                                                            stats=stats_b),
                "sdpa": lambda: torch.autograd.grad(res, [*leaves, leaf_mask], g4,
                                                    retain_graph=True)}, iters=5)
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, g, bias, key_bias, 0.125, heads), iters=2)
            bound = bound_ms(7 * q.numel() * 2 + 2 * bias.numel() * 4 + kb_bytes
                             + stats.numel() * 4, 10 * b * heads * l * l * 64,
                             H100_BF16_PEAK_TFLOPS * 1e12)
            rows = bwd_rows
            del stats, stats_b, leaves, leaf_mask, res, g4
        log(f"21(a) attention {'forward' if kind == 'fwd' else 'backward'} per layer {name} "
            f"fp16: kernel {t['kernel']:.4f} ms, {t['kernel'] / t['sdpa']:.3f}x SDPA in fp16 "
            f"{t['sdpa']:.4f} ms, the bf16 kernel {t['bf16']:.4f} ms (in turns); plain "
            f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({card})")
        rows[name] = {"ms": t["kernel"], "plain_ms": plain_ms, "library_ms": t["sdpa"],
                      "bound_ms": bound[0], "bound_by": bound[1], "bf16_ms": t["bf16"]}
        del q, k, v, g, hb, q4, k4, v4, mask, bias, key_bias
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def check_int8_fp16() -> dict:
    """21(a): the row quantize on fp16 x and the GEMM writing fp16, bit-equal
    to their plain versions at the serving shapes, the ragged ones and the
    plan's edges (phase 8's), with and without the bias.  Returns the largest
    differences."""
    gen = torch.Generator(device="cuda").manual_seed(213)
    worst = {"quantize": 0.0, "gemm": 0.0}
    for m, k in ((65792, 1536), (65792, 6144), (16032, 6144), (13, 100)):
        x = (torch.randn(m, k, generator=gen, device="cuda") * 2).half()
        got, want = im.int8_quantize_rows_cuda(x), im.int8_quantize_rows_plain(x)
        torch.cuda.synchronize()
        err = max((got[0].int() - want[0].int()).abs().max().item(),
                  (got[1] - want[1]).abs().max().item())
        worst["quantize"] = max(worst["quantize"], float(err))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"21(a) the fp16 int8 quantize disagrees at ({m}, {k}): max {err}")
        log(f"21(a) int8 quantize vs plain fp16 ({m} x {k}): bit-equal")
        del x, got, want
    for m, k, n in FFN_SHAPES + RAGGED_SHAPES + EDGE_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.01 + 1e-4
        sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
        bias = torch.randn(n, generator=gen, device="cuda")
        for b in (None, bias):
            got = im.int8_matmul_cuda(x_q, w_q, sx, sw, b, torch.float16)
            torch.cuda.synchronize()
            want = im.int8_matmul_plain(x_q, w_q, sx, sw, b, torch.float16)
            err = (got.float() - want.float()).abs().max().item()
            worst["gemm"] = max(worst["gemm"], err)
            if not torch.equal(got, want):
                raise RuntimeError(f"21(a) the fp16 int8 GEMM disagrees at ({m}, {k}, {n}) "
                                   f"bias={b is not None}: max {err}")
            del got, want
        log(f"21(a) int8 GEMM vs plain ({m}, {k}, {n}) -> fp16: bit-equal, with and without "
            f"bias")
        del x_q, w_q, sx, sw, bias
    torch.cuda.empty_cache()
    return worst


def time_int8_fp16(card: str) -> dict:
    """21(a) times: the row quantize on fp16 x at both FFN inputs, and the
    GEMM writing fp16 at the three FFN shapes in turns with fp16
    ``torch.matmul`` on the same product, beside their bounds (y written in
    fp16, 2 bytes as bf16) and plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(214)
    times = {}
    for m, k in ((65792, 1536), (65792, 6144)):
        x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.float16)
        kernel_ms = cuda_time_ms(lambda: im.int8_quantize_rows_cuda(x), iters=20)
        plain_ms = cuda_time_ms(lambda: im.int8_quantize_rows_plain(x), iters=5)
        bound = bound_ms(x.numel() * 3 + m * 4, 3 * x.numel(), H100_FP32_PEAK_TFLOPS * 1e12)
        log(f"21(a) int8 quantize ({m} x {k}) fp16: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({card})")
        times[(m, k)] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "library_ms": None}
        del x
    for m, k, n in FFN_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(m, device="cuda") * 1e-3, torch.rand(n, device="cuda") * 1e-3
        xh = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.float16)
        wh = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.float16)
        turns = in_turns({
            "kernel": lambda: im.int8_matmul_cuda(x_q, w_q, sx, sw, None, torch.float16),
            "fp16": lambda: xh @ wh.T}, iters=10)
        plain_ms = cuda_time_ms(lambda: im.int8_matmul_plain(x_q, w_q, sx, sw, None,
                                                             torch.float16), iters=3, warmup=1)
        bound = gemm_bound(m, k, n)
        log(f"21(a) int8 GEMM ({m}, {k}, {n}) -> fp16: kernel {turns['kernel']:.4f} ms "
            f"({2 * m * k * n / turns['kernel'] / 1e9:.1f} TOPS), fp16 torch.matmul "
            f"{turns['fp16']:.4f} ms; plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by "
            f"{bound[1]} ({card})")
        times[(m, k, n)] = {"ms": turns["kernel"], "plain_ms": plain_ms,
                            "library_ms": turns["fp16"], "bound_ms": bound[0],
                            "bound_by": bound[1]}
        del x_q, w_q, xh, wh
    torch.cuda.empty_cache()
    return times


FP16_KERNELS = ("fwd", "bwd", "gemm", "quantize")  # #1, #2, #3, 3b


@contextlib.contextmanager
def fp16_run(runs: dict, name: str, want: tuple):
    """One fp16 run of phase 21: the launch counts of #1, #2, #3 and 3b set
    to 0 just before it and read just after, kept in ``runs[name]`` and held
    to ``want`` (a count per kernel; None: the count is not fixed, and the
    kernel must have launched)."""
    fa.launches = fa.bwd_launches = im.launches = im.quantize_launches = 0
    yield
    torch.cuda.synchronize()
    got = dict(zip(FP16_KERNELS, (fa.launches, fa.bwd_launches, im.launches,
                                  im.quantize_launches)))
    runs[name] = got
    log(f"21 {name}: launches #1 {got['fwd']}, #2 {got['bwd']}, int8 GEMM {got['gemm']}, "
        f"quantize {got['quantize']} (expected "
        + ", ".join("> 0" if w is None else str(w) for w in want) + ")")
    if any(got[k] != w if w is not None else got[k] == 0 for k, w in zip(FP16_KERNELS, want)):
        raise RuntimeError(f"21 {name}: launches {got}, expected {want}")


def check_golden_fp16(model, inputs: dict, fp32_out: dict, runs: dict) -> dict:
    """21(b), on phase 10's model: the depth-40 golden's inputs in fp16
    (the fp32 state cast, as ``from_pretrained(dtype="fp16")`` casts it),
    kernel path (its launches kept in ``runs``) and plain path, against the
    golden embeddings and the fp32 kernel path's.  Images and audio must
    reach cosine >= 0.999 against both; every modality's kernel path must
    be no further from the golden than the plain fp16 path (within 1e-3).
    Two witnesses on the same state: fp32 compute on the weights rounded
    to fp16 (what any fp16 model of this state holds, the JAX hub's
    ``dtype="fp16"`` included), which tells the rounding of the weights
    from that of the compute, and the kernel path in bf16, which the fp16
    kernel path must beat in every modality.  The texts' hidden states are
    compared layer by layer with fp32's.  (That the JAX package's fp16
    compute drifts as far over 40 layers: ``tests/test_torch_port_fp16_depth.py``.)
    Returns the kernel path's cosines against the golden."""
    ref = np.load(golden.GOLDEN)

    def cosine(a, b):
        a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    def to_golden(out: dict) -> dict:
        """Cosine to the golden per modality, and per text row."""
        got = {k: cosine(v, torch.from_numpy(ref[f"emb_{k}"])) for k, v in out.items()}
        for row in range(out["text"].shape[0]):
            got[f"text row {row}"] = cosine(out["text"][row], torch.from_numpy(
                ref["emb_text"][row]))
        return got

    hidden, record = {}, [None]

    def keep(i, out):
        if record[0] is not None:
            hidden.setdefault(record[0], {})[i] = out.detach().float()

    layers = model.encoder_wrapper.fusion.layers
    hooks = [layer.register_forward_hook(lambda mod, args, out, i=i: keep(i, out))
             for i, layer in enumerate(layers)]

    def forward(dtype) -> dict:
        record[0] = dtype
        out = {"text": model(**inputs["text"], encoder_type="text")}
        record[0] = None
        out["image"] = model(src_images=inputs["image"].to(dtype), encoder_type="image")
        out["audio"] = model(src_audios=inputs["audio"][0].to(dtype),
                             audio_padding_masks=inputs["audio"][1], encoder_type="audio")
        return {k: v.float() for k, v in out.items()}

    floats = lambda: [t for t in model.state_dict().values() if t.is_floating_point()]
    try:
        with torch.inference_mode():
            record[0] = "fp32"
            model(**inputs["text"], encoder_type="text")  # fp32, for the hidden states
            bf16_state = [t.to(torch.bfloat16) for t in floats()]
            for t in floats():
                t.copy_(t.half())  # exact in fp16 from here on
            weights16 = to_golden(forward(torch.float32))
            model.to(torch.float16)
            outs = {}
            for impl in ("pallas", "xla"):
                model.cfg.encoder.attn_impl = impl
                with (fp16_run(runs, "golden (phase 10's state)", (120, 0, 0, 0))
                      if impl == "pallas" else contextlib.nullcontext()):
                    outs[impl] = forward(torch.float16)
            model.cfg.encoder.attn_impl = "pallas"
            model.to(torch.bfloat16)
            for t, b in zip(floats(), bf16_state):
                t.copy_(b)
            del bf16_state
            bf16 = to_golden(forward(torch.bfloat16))
    finally:
        model.cfg.encoder.attn_impl = "pallas"
        for hook in hooks:
            hook.remove()
    report = {impl: to_golden(o) for impl, o in outs.items()}
    vs32 = {k: cosine(v, fp32_out[k]) for k, v in outs["pallas"].items()}

    def drift(dtype):
        rel = [((hidden[dtype][i] - h).norm() / h.norm()).item()
               for i, h in sorted(hidden["fp32"].items())]
        first = next((i for i, r in enumerate(rel) if r > 1e-2), None)
        mid = len(rel) // 2 - 1
        return (f"{str(dtype)[6:]} {rel[0]:.2e} after layer 0, {rel[mid]:.2e} after {mid}, "
                f"{rel[-1]:.2e} after {len(rel) - 1}, first above 1e-2 after layer {first}")

    fmt = lambda d: ", ".join(f"{k} {v:.6f}" for k, v in d.items())
    log(f"21(b) depth-40 golden in fp16: cosine to the golden, kernel path {fmt(report['pallas'])}"
        f"; plain path {fmt(report['xla'])}; kernel path to the fp32 kernel path {fmt(vs32)}, "
        f"to the plain fp16 path texts {cosine(outs['pallas']['text'], outs['xla']['text']):.6f} "
        f"(images and audio bound 0.999)")
    log(f"21(b) witnesses on the same state, cosine to the golden: fp32 compute on the weights "
        f"rounded to fp16 {fmt(weights16)}; the kernel path in bf16 {fmt(bf16)}; the texts' "
        f"hidden states against fp32, relative error: {drift(torch.float32)} (the rounded "
        f"weights), {drift(torch.float16)}, {drift(torch.bfloat16)}")
    if (min(report["pallas"]["image"], report["pallas"]["audio"], vs32["image"], vs32["audio"])
            < 0.999 or any(report["pallas"][k] < report["xla"][k] - 1e-3 for k in report["xla"])
            or any(report["pallas"][k] < bf16[k] for k in ("text", "image", "audio"))):
        raise RuntimeError(f"21(b): fp16 misses the depth-40 golden: {report}, {vs32}, "
                           f"{weights16}, {bf16}")
    return {k: report["pallas"][k] for k in ("text", "image", "audio")}


def serve_fp16(card: str, runs: dict, bf16_rates: dict) -> dict:
    """21(b): the 4B model at depth 40 in fp16 on seeded random weights:
    images/s at B=256 and clips/s at B=32 (10 s), beside phase 5's bf16
    ones (``bf16_rates``, this run's); then int8 "ffn" in fp16: its kernel
    path against the plain int8 path on 4 images, 2 clips and 4 texts
    (cosine >= 0.999) and its rates.  (fp16 against fp32 and the golden:
    ``check_golden_fp16``, on phase 10's state.)  The checked fp16 forwards
    keep their launches in ``runs``, 40 of #1 per modality, and 3 int8
    GEMMs and 2 quantizations per layer and modality under "ffn"."""
    cfg = ModelConfig(head_type="val")
    gen = torch.Generator(device="cuda").manual_seed(215)
    model = OnePeaceRetrievalModel(cfg, device="cuda", dtype=torch.float16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(0))

    def cast(inputs):
        return {k: v.half() if v.is_floating_point() else v for k, v in inputs.items()}

    small = {k: cast(v) for k, v in make_inputs(cfg, gen, 4, 2, 4).items()}
    big = {k: cast(v) for k, v in make_inputs(cfg, gen, IMG_BATCH, AUD_BATCH, 1).items()}
    big["audio"]["audio_padding_masks"].zero_()  # bench.py: unpadded clips
    rates = {kind: ({"bf16 (phase 5)": bf16_rates[kind]} if kind in bf16_rates else {})
             for kind in ("image", "audio")}
    with torch.inference_mode():
        with fp16_run(runs, "21(b) embeddings", (3 * 40, 0, 0, 0)):
            for k, v in small.items():
                out = model(encoder_type=k, **v)
                if not torch.isfinite(out).all():
                    raise RuntimeError(f"21(b): fp16 {k} embeddings are not finite")
        for quantized in (False, True):
            if quantized:
                quantize_ffn_(model)
                with fp16_run(runs, "21(b) int8 ffn embeddings",
                              (3 * 40, 0, 3 * 40 * 3, 3 * 40 * 2)):
                    kern = {k: model(encoder_type=k, **v).float() for k, v in small.items()}
                with plain_int8():
                    plain = {k: model(encoder_type=k, **v).float() for k, v in small.items()}
                int8_cos = {k: min_cosine(kern[k], plain[k]) for k in kern}
            for kind, b in (("image", IMG_BATCH), ("audio", AUD_BATCH)):
                ms = cuda_time_ms(lambda: model(encoder_type=kind, **big[kind]), iters=2,
                                  warmup=1)
                rates[kind]["int8 ffn fp16" if quantized else "fp16"] = b / ms * 1e3
    log("21(b) int8 ffn in fp16, kernel path vs plain int8 path, min cosine: "
        + ", ".join(f"{k} {v:.6f}" for k, v in int8_cos.items()) + " (bound 0.999)")
    for kind in rates:
        log(f"21(b) depth 40 {kind}s/s at B={IMG_BATCH if kind == 'image' else AUD_BATCH}: "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates[kind].items()) + f" ({card})")
    if min(int8_cos.values()) < 0.999:
        raise RuntimeError(f"21(b): the fp16 int8 kernel path disagrees: {int8_cos}")
    del model, big, small
    torch.cuda.empty_cache()
    return {"rates": rates, "int8_cosine": int8_cos}


def fp16_train_config(layers: int, remat: bool, drop_path: float, ema: bool) -> FrameworkConfig:
    """7(b)'s retrieval fine-tune in fp16 over the fp32 masters (the recipe
    keeps ``common.bf16``; ``common.fp16`` wins), with the EMA."""
    cfg = train_config(layers, True, remat, drop_path)
    cfg.common.fp16 = True
    cfg.ema.store_ema = ema
    cfg.ema.ema_decay = 0.999
    return cfg


def check_fp16_train_paths(gen) -> None:
    """21(c), 7(a)'s check in fp16: 4 layers at full width, B=8, kernel path
    against plain path on the same weights and batch, the loss scaled by
    2^10 (the first of the scaler's scales under which this loss stays
    finite in fp16) and the gradients unscaled: each no further from the
    fp32 plain path's gradients than the plain path is (per parameter, the
    cosine to fp32 at least the plain path's minus 0.01; over all
    parameters together, kernel vs plain >= 0.999), losses within 2e-3.
    The kernel path launches #1 and #2 twice per layer (7(a)'s counts), the
    plain path neither."""
    batch = train_batch(train_config(4, False, False, 0.0), gen, 8)
    trainer = make_trainer(train_config(4, False, False, 0.0))
    trainer.model.cfg.encoder.attn_impl = "xla"
    _, ref32 = trainer.gradients(batch)
    del trainer
    trainer = make_trainer(fp16_train_config(4, False, 0.0, ema=False))
    trainer.scaler.scale = np.float32(2.0**10)
    runs, launches = {}, {}
    for impl in ("pallas", "xla"):
        trainer.model.cfg.encoder.attn_impl = impl
        want = (2 * 4, 2 * 4, 0, 0) if impl == "pallas" else (0, 0, 0, 0)
        with fp16_run(launches, f"21(c) 4-layer {impl} gradients", want):
            metrics, grads = trainer.gradients(batch)
        if not all(torch.isfinite(g).all() for g in grads):
            raise RuntimeError(f"21(c) fp16 {impl}: non-finite gradient at scale 2^10")
        runs[impl] = (float(metrics["loss"]), grads)
    trainer.model.cfg.encoder.attn_impl = "pallas"
    (loss_k, grads_k), (loss_p, grads_p) = runs["pallas"], runs["xla"]
    cos_k, cos_p = grad_cosines(grads_k, ref32), grad_cosines(grads_p, ref32)
    gap = max(range(len(cos_k)), key=lambda i: cos_p[i] - cos_k[i])
    total = grad_cosines([torch.cat([g.flatten() for g in grads_k])],
                         [torch.cat([g.flatten() for g in grads_p])])[0]
    log(f"21(c) fp16 4-layer vl B=8: loss kernel {loss_k:.6f} plain {loss_p:.6f}; vs the fp32 "
        f"gradients min cosine kernel path {min(cos_k):.6f}, plain path {min(cos_p):.6f}; "
        f"largest shortfall of the kernel path {cos_p[gap] - cos_k[gap]:.2e} "
        f"({trainer._names[gap]}); all parameters together kernel vs plain {total:.9f}")
    if not (abs(loss_k - loss_p) <= 2e-3 * abs(loss_p) and total >= 0.999
            and cos_p[gap] - cos_k[gap] <= 0.01):
        raise RuntimeError("21(c) fp16: kernel and plain training paths disagree")
    del trainer, runs, grads_k, grads_p, ref32
    torch.cuda.empty_cache()


EMA_BYTES_PER_ELEMENT = 36  # utils/ema.py's update: s * decay (4 + 4), p in fp64
# (4 + 8), s + p * (1 - decay) stored into s (4 + 8 + 4)


def train_fp16_full_depth(gen, card: str, runs: dict) -> tuple:
    """21(c): 7(b)'s step in fp16 with dynamic loss scaling and the EMA
    (its fp32 shadow of every parameter on the card): the depth-40 vl model,
    remat, drop path 0.5, B=32, the same batch and masks every step.  ms per
    step, pairs/s, MFU, peak memory, the scale after each step and the
    skipped steps; the loss must fall over the finite steps, and each step
    launches #1 160 times and #2 80 times (7(b)'s counts; kept in ``runs``).
    Then what fp16 adds to bf16's step, each alone by CUDA events: the EMA
    update (beside its bytes' time) and the unscale of the gradients; and
    one step profiled (``fp16_train_profile.txt``, beside 7(b)'s
    ``train_profile.txt``).  Returns the row and the model (for 21(e))."""
    cfg = fp16_train_config(40, True, 0.5, ema=True)
    trainer = make_trainer(cfg)
    batch = train_batch(cfg, gen, 32)
    rng_state = trainer.generator.get_state()
    flops = 4 * (analytic_flops(cfg.model, 257, 32, "image")
                 + analytic_flops(cfg.model, 71, 32, "text"))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with fp16_run(runs, "21(c) depth-40 steps", (5 * 160, 5 * 80, 0, 0)):
        for _ in range(5):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            steps.append((time.time() - t0, metrics))
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = 1e3 * statistics.mean(t for t, _ in steps[1:])
    losses = [m["loss"] for _, m in steps]
    scales = [m["loss_scale"] for _, m in steps]
    skipped = int(sum(m["skipped"] for _, m in steps))
    tflops = flops / ms / 1e9
    shadow_gib = sum(s.numel() * s.element_size() for s in trainer.ema.shadow.values()) / 2**30
    log(f"21(c) fp16 depth 40 B=32 with loss scaling and the EMA: {ms:.1f} ms per step (steps "
        f"2-5), {32 / ms * 1e3:.1f} pairs/s, {tflops:.1f} TFLOP/s = "
        f"{100 * tflops / H100_BF16_PEAK_TFLOPS:.1f}% MFU, peak {peak:.1f} GiB (the shadow "
        f"{shadow_gib:.1f} GiB), losses {[round(x, 5) for x in losses]}, loss scale after each "
        f"step {scales}, {skipped} of 5 steps skipped ({card})")
    finite = [m["loss"] for _, m in steps if m["skipped"] == 0.0]
    if not all(map(math.isfinite, losses)) or len(finite) < 3 or not finite[-1] < finite[0]:
        raise RuntimeError(f"21(c): the fp16 loss did not fall over finite steps: {losses}")
    elements = sum(s.numel() for s in trainer.ema.shadow.values())
    ema_ms = cuda_time_ms(lambda: trainer.ema.step(trainer.model.named_parameters(),
                                                   trainer.step), iters=3, warmup=1)
    grads = [torch.ones_like(p) for p in trainer._params]
    unscale_ms = cuda_time_ms(lambda: trainer.scaler.unscale_(grads), iters=3, warmup=1)
    grad_elements = sum(g.numel() for g in grads)
    del grads
    log(f"21(c) alone: the EMA update {ema_ms:.1f} ms over {elements / 1e9:.3f}B elements, "
        f"bound {elements * EMA_BYTES_PER_ELEMENT / H100_HBM_BYTES_PER_S * 1e3:.1f} ms by bytes "
        f"({EMA_BYTES_PER_ELEMENT} B each); the unscale {unscale_ms:.1f} ms over "
        f"{grad_elements / 1e9:.3f}B gradients, bound "
        f"{grad_elements * 8 / H100_HBM_BYTES_PER_S * 1e3:.1f} ms by bytes ({card})")
    trainer.generator.set_state(rng_state)
    profile_call(lambda: trainer.train_step(batch), ms, "21(c)", "fp16_train_profile.txt")
    model = trainer.model
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak, "mfu": tflops / H100_BF16_PEAK_TFLOPS,
            "scales": scales, "skipped": skipped, "losses": losses, "ema_ms": ema_ms,
            "unscale_ms": unscale_ms}, model


class CountGemms(TorchDispatchMode):
    """Counts the aten GEMMs dispatched inside (each a cuBLAS launch)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in components._GEMM_OPS
        return func(*args, **(kwargs or {}))


def check_remat_policies(gen, card: str, layers: int = CUT_DEPTH) -> dict:
    """21(d): ``full``, ``qkv`` and ``offload_qkv`` on one vl model at full
    width and depth ``layers`` (seeded random weights, bf16 compute over
    fp32 masters, remat, drop path 0.5), B=32, ``remat_policy`` flipped
    between runs: the gradients of each policy bit-equal to ``full``'s under
    the same masks, the GEMMs the backward dispatches (3 x ``layers`` x 2
    fewer under the qkv policies: the text and the image pass of each
    layer) and the peak memory of that run, then
    ms per forward and backward (the median of 3, the policies timed in
    turns), and one call of each profiled: the card's busy time and its
    time in GEMM kernels (``remat_<policy>_profile.txt``)."""
    cfg = train_config(layers, True, True, 0.5)
    trainer = make_trainer(cfg, seed=214)
    enc = trainer.model.cfg.encoder
    batch = train_batch(cfg, gen, 32)
    batch_t = trainer._to_device(batch)

    def gradients(count: bool):
        loss, _ = torch.func.functional_call(
            trainer._call, trainer._compute_params(),
            (batch_t, torch.Generator().manual_seed(21), 0))
        with CountGemms() if count else contextlib.nullcontext() as counter:
            grads = torch.autograd.grad(loss, trainer._params, allow_unused=True)
        return grads, counter.count if count else None

    policies = ("full", "qkv", "offload_qkv")
    rows, full = {}, None
    for policy in policies:
        enc.remat_policy = policy
        torch.cuda.reset_peak_memory_stats()
        grads, gemms = gradients(count=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        equal = full is None or all(
            (a is None and b is None) or torch.equal(a, b) for a, b in zip(grads, full))
        if full is None:
            full = grads
        del grads
        torch.cuda.empty_cache()
        rows[policy] = {"peak_gib": peak, "backward_gemms": gemms, "equal_to_full": equal,
                        "times": []}
    for policy in policies + policies[::-1] + policies:  # in turns
        enc.remat_policy = policy
        torch.cuda.synchronize()
        t0 = time.time()
        gradients(count=False)
        torch.cuda.synchronize()
        rows[policy]["times"].append(1e3 * (time.time() - t0))
    for policy, row in rows.items():
        enc.remat_policy = policy
        row["ms"] = statistics.median(row["times"])
        times, busy = profile_call(lambda: gradients(count=False), row["ms"], f"21(d) {policy}",
                                   f"remat_{policy}_profile.txt")
        gemm_ms = sum(r.self_device_time_total for r in times
                      if any(k in r.key.lower() for k in ("gemm", "nvjet", "xmma"))) / 1e3
        row.update(busy_ms=busy, gemm_ms=gemm_ms)
        log(f"21(d) remat_policy={policy} depth {layers} B=32 bf16: forward + backward median "
            f"{row['ms']:.1f} ms of {len(row['times'])} in turns "
            f"({min(row['times']):.1f}-{max(row['times']):.1f}); profiled, the card busy "
            f"{busy:.1f} ms, {gemm_ms:.1f} ms of it in GEMM kernels; peak "
            f"{row['peak_gib']:.1f} GiB (with full's gradients kept), {row['backward_gemms']} "
            f"GEMMs in the backward, gradients bit-equal to full: {row['equal_to_full']} "
            f"({card})")
    enc.remat_policy = "full"
    # the step runs the encoder twice, on the texts and on the images: 3 GEMMs
    # fewer per layer and pass
    fewer = {p: rows["full"]["backward_gemms"] - rows[p]["backward_gemms"]
             for p in ("qkv", "offload_qkv")}
    if not all(r["equal_to_full"] for r in rows.values()) or set(fewer.values()) != {
            3 * layers * 2}:
        raise RuntimeError(f"21(d): the qkv policies' gradients or GEMM counts are off: "
                           f"{rows}")
    del trainer, full
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def adan_config(layers: int) -> FrameworkConfig:
    """Adan with clip 1.0, layer decay 0.9, weight decay 0.05, lr 1e-4 and
    no warm-up, fp32 compute (the card and the CPU compared)."""
    cfg = train_config(layers, False, False, 0.0)
    cfg.optimizer._name = "adan"
    cfg.optimization.clip_norm = 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.optimization.lr = 1e-4
    cfg.lr_scheduler.min_lr = 1e-4
    return cfg


def check_adan(model, card: str) -> dict:
    """21(e): Adan over 3 updates of the vl model at full width, depth 2,
    a text vocabulary of 1024 (Adan is elementwise; the CPU's share of the
    phase is its steps), fp32, on the card and on the CPU from the same
    weights: the card
    computes each update's gradients (B=2, a batch of its own each) and
    clips them, and both optimizers step on those same gradients.  Each
    parameter's update (its change over the 3 updates) must agree within
    1e-4 relative between the devices; a dropped proximal decay moves the
    updates by ~1e-3 of themselves, a wrong bias correction by their whole
    size.  Then one Adan step on ``model``, the depth-40 vl model that
    21(c) trained: it holds 6 fp32 copies of the 2.74B parameters (masters,
    gradients and Adan's 4 states), 61 GiB beside its chunk temporaries (the
    val model's 4B would need 96 GB, over the card's 80), against its bound
    (every read and write once)."""
    cfg = adan_config(2)
    cfg.model.encoder.text_adapter.vocab_size = 1024  # 77M embedding rows fewer for the CPU
    cpu = OnePeaceRetrievalModel(cfg.model, device="cpu", dtype=torch.float32)
    fill_random_(cpu, torch.Generator().manual_seed(5))
    card_model = OnePeaceRetrievalModel(cfg.model, device="cuda", dtype=torch.float32)
    card_model.load_state_dict(cpu.state_dict())
    start = {n: p.detach().double().clone() for n, p in cpu.named_parameters()}
    trainers = {where: Trainer(cfg, model, build_criterion(cfg.criterion))
                for where, model in (("card", card_model), ("cpu", cpu))}
    rs = np.random.RandomState(5)
    for update in range(3):
        batch = {"src_tokens": rs.randint(4, cfg.model.encoder.text_adapter.vocab_size, (2, 70)),
                 "src_images": rs.randn(2, 3, 256, 256).astype(np.float32)}
        _, grads = trainers["card"].gradients(batch)
        factor = (cfg.optimization.clip_norm / get_total_norm(grads)).clamp(max=1.0)
        lr = trainers["card"].lr_schedule(update)
        for where, t in trainers.items():
            for p, g in zip(t._params, grads):
                p.grad = (g * factor).to(p.device)
            for group in t.optimizer.param_groups:
                group["lr"], group["schedule_lr"] = lr * group["lr_scale"], lr
            t.optimizer.step()
            t.optimizer.zero_grad(set_to_none=True)
        del grads
    rows = []
    for (name, a), b in zip(card_model.named_parameters(), cpu.parameters()):
        ua, ub = a.detach().cpu().double() - start[name], b.detach().double() - start[name]
        rows.append(((ua - ub).norm().item() / max(ub.norm().item(), 1e-30), name,
                     (ua - ub).abs().max().item()))
    worst = max(rows)
    log(f"21(e) Adan depth 2 fp32, 3 updates on the same clipped gradients, card vs CPU: the "
        f"updates' largest relative difference {worst[0]:.3e} ({worst[1]}, max |diff| "
        f"{worst[2]:.3e}; bound 1e-4)")
    if worst[0] > 1e-4:
        raise RuntimeError("21(e): Adan on the card and on the CPU disagree")
    del trainers, cpu, card_model, start
    gc.collect()
    torch.cuda.empty_cache()

    named = list(model.named_parameters())
    n_params = sum(p.numel() for _, p in named)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for _, p in named:
        p.requires_grad_(True)
        p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
    ocfg = adan_config(40)
    opt = build_optimizer(ocfg.optimizer, ocfg.optimization, named, num_layers=40)
    for group in opt.param_groups:
        group["lr"], group["schedule_lr"] = 1e-4 * group["lr_scale"], 1e-4
    opt.step()  # the states are made here
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(opt.step, iters=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the masters and the 4 states read and written, the gradients read, and
    # the copy of them Adan keeps written
    bound = bound_ms(4 * n_params * (2 * 5 + 2), 0, 1.0)
    log(f"21(e) Adan step at depth 40, {n_params / 1e9:.2f}B fp32 parameters: {ms:.1f} ms, peak "
        f"{peak:.1f} GiB; bound {bound[0]:.1f} ms by bytes ({card})")
    del opt, named
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_rel_diff": worst[0], "ms": ms, "bound_ms": bound[0], "peak_gib": peak}


def check_fp16_cli(data: dict, layers: int = 2) -> dict:
    """21(f): the retrieval recipe from files through ``cli.train`` at full
    width, depth 2, B=8, update_freq=2, with ``common.fp16=true
    ema.store_ema=true optimizer._name=adan``: straight to 4 updates, and
    stopped at the end of epoch 1 (a micro-batch pending) and resumed to 4.
    The two step-4 bundles must be bit-equal (masters, Adan's state, the
    EMA shadow, the loss scale); validation runs at update 4 only, on the
    shadow, so ``checkpoint_best.npz`` must equal the bundle's shadow, and
    not its masters."""
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt
    from one_peace_tpu_torch.utils.checkpoint import load_npz

    root = data["root"]
    runs = {"straight": root / "fp16_straight", "resumed": root / "fp16_resumed"}
    for d in runs.values():
        shutil.rmtree(d, ignore_errors=True)
    common = [f"task.data={root}/train40.tsv", "optimization.update_freq=2",
              "optimization.max_update=4", "model.encoder.layer_scale_init_value=0.1",
              "common.fp16=true", "ema.store_ema=true", "ema.ema_decay=0.9",
              "optimizer._name=adan", "dataset.validate_interval=100",
              "dataset.validate_interval_updates=4", "checkpoint.best_checkpoint_metric=txt_r1"]

    def argv(name, *extra):
        return retrieval_argv(data, runs[name], layers, 8,
                              [*common, f"common.log_file={runs[name]}/log.jsonl", *extra])

    t0 = time.time()
    run_train_cli(argv("straight"))
    quiet = "dataset.disable_validation=true"  # the export is the straight run's
    run_train_cli(argv("resumed", "optimization.max_epoch=1", quiet))
    run_train_cli(argv("resumed", quiet))
    a = ckpt.restore_train_state(str(runs["straight"] / "step_4"))["trainer"]
    b = ckpt.restore_train_state(str(runs["resumed"] / "step_4"))["trainer"]
    same = {key: all(torch.equal(a[key][n], b[key][n]) for n in a[key])
            for key in ("params", "ema_shadow")}
    same["loss_scale"] = a["loss_scale"] == b["loss_scale"]
    same["adan"] = all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                       for i in a["opt_state"]["state"]
                       for x, y in zip(a["opt_state"]["state"][i].values(),
                                       b["opt_state"]["state"][i].values()))
    best = load_npz(str(runs["straight"] / "checkpoint_best.npz"))
    shadow_exported = all(torch.equal(best[n], s) for n, s in a["ema_shadow"].items())
    masters_differ = any(not torch.equal(a["params"][n], s) for n, s in a["ema_shadow"].items())
    skipped = [json.loads(line).get("skipped") for line in
               (runs["straight"] / "log.jsonl").read_text().splitlines()
               if json.loads(line)["tag"] == "train_inner"]
    log(f"21(f) cli.train depth {layers} fp16 + EMA + Adan: straight vs stopped at epoch 1 and "
        f"resumed, bit-equal at update 4: {same}; loss scale {a['loss_scale']}; skipped per "
        f"update {skipped}; checkpoint_best.npz is the EMA shadow: {shadow_exported} (the "
        f"masters differ from it: {masters_differ}); {time.time() - t0:.1f} s for the three runs")
    if not (all(same.values()) and shadow_exported and masters_differ):
        raise RuntimeError("21(f): the fp16 + EMA + Adan resume or the EMA export is off")
    del a, b, best
    gc.collect()
    torch.cuda.empty_cache()
    return {"bit_equal": same}


# ---------------------------------------------------------------------------
# Phase 22: detection in fp16, and int8 serving of the vision trunks
# ---------------------------------------------------------------------------

PHASE22_KERNELS = ("det_fwd", "det_bwd", "gemm", "quantize")  # #4, #5/#6, #3, 3b


@contextlib.contextmanager
def phase22_run(runs: dict, name: str, want: dict):
    """One run of phase 22 on the main path: the launch counts of #4, #5/#6
    (one backward call launches both), #3 and 3b set to 0 just before it
    and read just after, kept in ``runs[name]`` and held to ``want`` (a
    count per kernel; a kernel not named must not launch)."""
    da.launches = da.bwd_launches = im.launches = im.quantize_launches = 0
    yield
    torch.cuda.synchronize()
    got = dict(zip(PHASE22_KERNELS, (da.launches, da.bwd_launches, im.launches,
                                     im.quantize_launches)))
    runs[name] = got
    expected = {k: want.get(k, 0) for k in PHASE22_KERNELS}
    log(f"22 {name}: launches #4 {got['det_fwd']}, #5/#6 {got['det_bwd']}, int8 GEMM "
        f"{got['gemm']}, quantize {got['quantize']} (expected "
        + ", ".join(str(expected[k]) for k in PHASE22_KERNELS) + ")")
    if got != expected:
        raise RuntimeError(f"22 {name}: launches {got}, expected {expected}")


def det_fp16_train(cfg, batch: dict, card: str, bf16_ms: float, runs: dict) -> dict:
    """22(c): the recipe at depth 40 through ``Trainer`` with
    ``common.fp16``: a warm-up step, then 3 steps on 12(c)'s batch with the
    same generator state each, 80 launches of #4 and 40 of #5/#6 a step.
    Logs the loss scale after each step, the skipped steps and ms per step
    beside 12(c)'s bf16 step from this run.  Some step must be applied, and
    the loss after it must be below the first."""
    t0 = time.time()
    trainer = det_trainer(cfg)
    torch.cuda.synchronize()
    log(f"22(c) detector from the recipe with common.fp16 ({time.time() - t0:.1f} s to build "
        f"and fill)")
    rng_state = trainer.generator.get_state()
    first = trainer.train_step(batch)
    steps, losses, times, scales, skipped = 3, [first["loss"]], [], [first["loss_scale"]], [
        first["skipped"]]
    torch.cuda.reset_peak_memory_stats()
    with phase22_run(runs, "22(c) fp16 depth-40 steps", {"det_fwd": 80 * steps,
                                                        "det_bwd": 40 * steps}):
        for _ in range(steps):
            trainer.generator.set_state(rng_state)
            torch.cuda.synchronize()
            t1 = time.time()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.time() - t1))
            losses.append(metrics["loss"])
            scales.append(metrics["loss_scale"])
            skipped.append(metrics["skipped"])
    ms = float(np.mean(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"22(c) depth 40 B=2 fp16 with loss scaling: {ms:.1f} ms per step (steps "
        f"{[round(x, 1) for x in times]}; 12(c)'s bf16 step in this run {bf16_ms:.1f} ms), "
        f"{2 / ms * 1e3:.2f} images/s, peak {peak:.1f} GiB, losses "
        f"{[round(x, 5) for x in losses]} (the first a warm-up step), loss scale after each "
        f"step {[float(x) for x in scales]}, skipped {[int(x) for x in skipped]} "
        f"({int(sum(skipped))} of {steps + 1}) ({card})")
    applied = [i for i, x in enumerate(skipped[:-1]) if not x]
    if (not all(map(math.isfinite, losses)) or not applied
            or not min(losses[i + 1] for i in applied) < losses[0]):
        raise RuntimeError(f"22(c): the fp16 loss on a repeated batch did not fall: {losses}, "
                           f"skipped {skipped}")
    del trainer
    torch.cuda.empty_cache()
    return {"ms": ms, "losses": losses, "scales": scales, "skipped": skipped}


def in_turns_wall(fns: dict, rounds: int = 3) -> dict:
    """The median ms of ``rounds`` calls of each function (host clock,
    synchronised), taken in turns (a, b, b, a, ...); the median leaves out a
    first call's set-up."""
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.time()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.time() - t0))
    return {name: float(np.median(ms)) for name, ms in times.items()}


def serve_det_int8(det, inputs: dict, card: str, runs: dict) -> dict:
    """22(d): ``vision.zoo.quantize_serving_params`` on the bf16 depth-40
    detector (a copy): 120 launches of #3 and 80 of 3b per trunk forward at
    M = 2 x 64 x 64 = 8192 rows (40 of #4), the int8 kernel path against
    the plain int8 path (the same attention kernel, the int8 ops' plain
    versions) on the stride-16 map, cosine per image >= 0.999; the trunk
    forward in ms and ``detect()`` in images/s (every head running:
    score_thresh 0, 64 proposals), int8 against bf16, medians of 3 in
    turns."""
    x = inputs["images"].bfloat16()
    qdet = tzoo.quantize_serving_params(copy.deepcopy(det))
    with phase22_run(runs, "22(d) int8 trunk forward", {"det_fwd": 40, "gemm": 120,
                                                       "quantize": 80}):
        with torch.no_grad():
            got = qdet.backbone(x)
    with torch.no_grad(), plain_int8():
        plain = qdet.backbone(x)
        bf16 = det.backbone(x)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(plain).all()):
        raise RuntimeError("22(d): the int8 trunk's map is not finite")
    cos = min_cosine(got.reshape(2, -1), plain.reshape(2, -1))
    to_bf16 = min_cosine(got.reshape(2, -1), bf16.reshape(2, -1))
    log(f"22(d) int8 detector trunk depth 40, 1024 px B=2: stride-16 map kernel path vs plain "
        f"int8 path min cosine per image {cos:.9f} (bit-equal: {torch.equal(got, plain)}; "
        f"bound 0.999); vs the bf16 trunk {to_bf16:.6f}")
    if cos < 0.999:
        raise RuntimeError("22(d): the int8 kernel path disagrees with the plain int8 path")
    del got, plain, bf16

    def trunk(model):
        def run():
            with torch.no_grad():
                model.backbone(x)
        return run

    trunk_ms = in_turns_wall({"bf16": trunk(det), "int8": trunk(qdet)})
    kwargs = DETECT_SETTINGS["masks"]
    with torch.no_grad():
        results = qdet.detect(x, **kwargs)
    check_detect_results(results, "22(d) int8")
    detect_ms = in_turns_wall({"bf16": lambda: det.detect(x, **kwargs),
                               "int8": lambda: qdet.detect(x, **kwargs)})
    log(f"22(d) depth 40, 1024 px B=2, medians of 3 in turns: the trunk forward bf16 "
        f"{trunk_ms['bf16']:.1f} ms, int8 {trunk_ms['int8']:.1f} ms "
        f"({trunk_ms['bf16'] - trunk_ms['int8']:.1f} ms, "
        f"{100 * (1 - trunk_ms['int8'] / trunk_ms['bf16']):.1f}% less); detect() (score_thresh "
        f"0, 64 proposals, {[len(r['boxes']) for r in results]} detections) bf16 "
        f"{detect_ms['bf16']:.1f} ms = {2e3 / detect_ms['bf16']:.2f} images/s, int8 "
        f"{detect_ms['int8']:.1f} ms = {2e3 / detect_ms['int8']:.2f} images/s ({card})")
    del qdet
    torch.cuda.empty_cache()
    return {"trunk_ms": trunk_ms, "detect_ms": detect_ms}


VISION_INT8_ROWS = (8192, 25096)  # the det trunk at 1024 px, B=2; the seg trunk at 896 px, B=8


def time_vision_int8(card: str) -> dict:
    """22(d) kernels: the row quantize (3b) on bf16 x and the GEMM (#3)
    writing bf16 at the vision trunks' row counts (``VISION_INT8_ROWS``) and
    the FFN's two (K, N), bit-equal to their plain versions (``gemm_plan``
    at these M on the card), the GEMM in turns with bf16 ``torch.matmul``,
    each beside its bound and plain version.  Returns the rows by shape and
    the largest differences to the plain versions ("worst")."""
    gen = torch.Generator(device="cuda").manual_seed(224)
    rows = {"gemm": {}, "quantize": {}, "worst": {"gemm": 0.0, "quantize": 0.0}}
    for m in VISION_INT8_ROWS:
        for k in (1536, 6144):
            x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            got, want = im.int8_quantize_rows_cuda(x), im.int8_quantize_rows_plain(x)
            err = max((got[0].int() - want[0].int()).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            rows["worst"]["quantize"] = max(rows["worst"]["quantize"], float(err))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"22(d) the int8 quantize disagrees at ({m}, {k}): max {err}")
            kernel_ms = cuda_time_ms(lambda: im.int8_quantize_rows_cuda(x), iters=20)
            plain_ms = cuda_time_ms(lambda: im.int8_quantize_rows_plain(x), iters=5)
            bound = bound_ms(x.numel() * 3 + m * 4, 3 * x.numel(), H100_FP32_PEAK_TFLOPS * 1e12)
            log(f"22(d) int8 quantize ({m} x {k}) bf16: bit-equal to plain; kernel "
                f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms by "
                f"{bound[1]} ({card})")
            rows["quantize"][f"(M, K) = ({m}, {k})"] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}
            del x, got, want
        for k, n in ((1536, 6144), (6144, 1536)):
            x_q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
            sx = torch.rand(m, generator=gen, device="cuda") * 1e-3
            sw = torch.rand(n, generator=gen, device="cuda") * 1e-3
            got = im.int8_matmul_cuda(x_q, w_q, sx, sw, None, torch.bfloat16)
            want = im.int8_matmul_plain(x_q, w_q, sx, sw, None, torch.bfloat16)
            err = (got.float() - want.float()).abs().max().item()
            rows["worst"]["gemm"] = max(rows["worst"]["gemm"], err)
            if not torch.equal(got, want):
                raise RuntimeError(f"22(d) the int8 GEMM disagrees at ({m}, {k}, {n}): max {err}")
            del got, want
            xb = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            wb = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            turns = in_turns({
                "kernel": lambda: im.int8_matmul_cuda(x_q, w_q, sx, sw, None, torch.bfloat16),
                "bf16": lambda: xb @ wb.T}, iters=10)
            plain_ms = cuda_time_ms(lambda: im.int8_matmul_plain(x_q, w_q, sx, sw, None,
                                                                 torch.bfloat16), iters=3,
                                    warmup=1)
            bound = gemm_bound(m, k, n)
            plan = im.gemm_plan(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"22(d) int8 GEMM ({m}, {k}, {n}) -> bf16: bit-equal to plain ({plan.tiles_m} x "
                f"{-(-n // plan.tile_n)} tiles of {plan.tile_m} x {plan.tile_n}); kernel "
                f"{turns['kernel']:.4f} ms ({2 * m * k * n / turns['kernel'] / 1e9:.1f} TOPS), "
                f"bf16 torch.matmul {turns['bf16']:.4f} ms "
                f"({turns['kernel'] / turns['bf16']:.2f}x; in turns); plain {plain_ms:.3f} ms; "
                f"bound {bound[0]:.4f} ms by {bound[1]} ({card})")
            rows["gemm"][f"(M, K, N) = ({m}, {k}, {n})"] = {
                "ms": turns["kernel"], "plain_ms": plain_ms, "library_ms": turns["bf16"],
                "bound_ms": bound[0], "bound_by": bound[1]}
            del x_q, w_q, xb, wb
    torch.cuda.empty_cache()
    return rows


def serve_seg_video_int8(card: str, runs: dict) -> dict:
    """22(e): ``quantize_serving_params`` on the Mask2Former recipe at depth
    40 in bf16 (17(c)'s weights): at B=1 the int8 kernel path against the
    plain int8 path on the logits (cosine per image >= 0.999), 120 launches
    of #3 and 80 of 3b a forward (M = 3137 rows); at B=8 (M = 25096) images
    per second with and without int8, medians of 3 in turns, beside 17(c)'s
    bf16 rate.  Then the video classifier (the recipe at depth 4, 32 frames,
    256 px, B=2 clips: M = 2 x 32 x 257 rows) in bf16 with int8: the kernel
    path against the plain int8 path on the logits, 12 launches of #3 and 8
    of 3b a forward."""
    from one_peace_tpu_torch.tasks.vision_tasks import Ade20kSegTask, K400VideoTask

    cfg = load_config(str(SEG_RECIPE), [])
    layers = cfg.model.encoder.layers
    model = Ade20kSegTask.build_model(cfg, device="cuda", dtype=torch.bfloat16)
    fill_random_(model, torch.Generator(device="cuda").manual_seed(173)).eval()
    qmodel = tzoo.quantize_serving_params(copy.deepcopy(model))
    gen = torch.Generator(device="cuda").manual_seed(225)
    one = torch.randn(1, 3, SEG_PX, SEG_PX, generator=gen, device="cuda")
    with phase22_run(runs, "22(e) int8 Mask2Former B=1", {"gemm": 3 * layers,
                                                          "quantize": 2 * layers}):
        with torch.no_grad():
            got = qmodel.logits(one).float()
    with torch.no_grad(), plain_int8():
        plain = qmodel.logits(one).float()
    cos = min_cosine(got.reshape(1, -1), plain.reshape(1, -1))
    log(f"22(e) int8 Mask2Former depth {layers} 896 px B=1: logits kernel path vs plain int8 "
        f"path cosine {cos:.9f} (bit-equal: {torch.equal(got, plain)}; bound 0.999)")
    if not torch.isfinite(got).all() or cos < 0.999:
        raise RuntimeError("22(e): the int8 segmenter's kernel path disagrees")
    del one, got, plain
    eight = torch.randn(8, 3, SEG_PX, SEG_PX, generator=gen, device="cuda")

    def logits(m):
        def run():
            with torch.no_grad():
                m.logits(eight)
        return run

    torch.cuda.reset_peak_memory_stats()
    ms = in_turns_wall({"bf16": logits(model), "int8": logits(qmodel)})
    log(f"22(e) Mask2Former depth {layers} 896 px B=8 (M = {8 * SEG_L} rows), medians of 3 in "
        f"turns: bf16 {ms['bf16']:.1f} ms = {8e3 / ms['bf16']:.2f} images/s, int8 "
        f"{ms['int8']:.1f} ms = {8e3 / ms['int8']:.2f} images/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card})")
    del model, qmodel, eight
    torch.cuda.empty_cache()

    vcfg = load_config(str(K400_RECIPE), ["model.encoder.layers=4"])
    video = K400VideoTask.build_model(vcfg, device="cuda")
    fill_random_(video, torch.Generator(device="cuda").manual_seed(193))
    video = video.bfloat16().eval()
    qvideo = tzoo.quantize_serving_params(copy.deepcopy(video))
    clips = torch.randn(2, K400_FRAMES, 3, K400_PX, K400_PX, generator=gen, device="cuda")
    with phase22_run(runs, "22(e) int8 video depth 4", {"gemm": 12, "quantize": 8}):
        with torch.no_grad():
            got = qvideo(clips.bfloat16()).float()
    with torch.no_grad(), plain_int8():
        plain = qvideo(clips.bfloat16()).float()
    cos = min_cosine(got, plain)
    log(f"22(e) int8 video classifier depth 4, 32 frames, B=2 (M = {2 * K400_FRAMES * K400_N} "
        f"rows): logits kernel path vs plain int8 path min cosine per clip {cos:.9f} "
        f"(bit-equal: {torch.equal(got, plain)}; bound 0.999)")
    if not torch.isfinite(got).all() or cos < 0.999:
        raise RuntimeError("22(e): the int8 video classifier's kernel path disagrees")
    del video, qvideo, clips, got, plain
    torch.cuda.empty_cache()
    return {"seg_ms": ms}


DET_TIMED = (("global", (2, 64, 64)), ("windowed", (32, 16, 16)))  # (B, hg, wg), 11(c)'s


def time_det_fp16(card: str) -> dict:
    """22(a) times, per global and windowed layer: the fp16 forward (#4),
    pass 1 with the dtoep pass (#5) and pass 2 (#6), each in turns with the
    bf16 kernel on the same inputs rounded to bf16 and with SDPA in fp16 on
    the bias materialised in fp16 (its backward with the bias taking a
    gradient, as 12(d)'s); beside them the plain versions and the bounds
    (11(c)'s and 12(d)'s: the dense fp16 peak is bf16's, the bytes are the
    same).  Returns {"fwd" | "dq" | "dkv": {layer: row}}."""
    gen = torch.Generator(device="cuda").manual_seed(222)
    peak = H100_BF16_PEAK_TFLOPS * 1e12
    rows = {"fwd": {}, "dq": {}, "dkv": {}}
    for name, (b, hg, wg) in DET_TIMED:
        q32, k32, v32, toep, bh, bw = det_operands(gen, b, hg, wg, torch.float32)
        l, hw, biases = hg * wg, (hg, wg), (toep, bh, bw)
        half = [x.half() for x in (q32, k32, v32)]
        bf = [x.bfloat16() for x in (q32, k32, v32)]
        del q32, k32, v32
        bias = (bh.transpose(2, 3)[..., None] + bw[..., None, :]).reshape(b, DET_HEADS, l, l)
        bias += da.bias_from_toeplitz(toep, hg, wg)[None]
        mask = bias.half()
        del bias
        q4, k4, v4 = (x.view(b, l, DET_HEADS, 64).transpose(1, 2) for x in half)
        fwd = in_turns({
            "kernel": lambda: da.det_attention_cuda(*half, *biases, hw, 0.125, DET_HEADS),
            "bf16": lambda: da.det_attention_cuda(*bf, *biases, hw, 0.125, DET_HEADS),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=0.125)}, iters=10)
        plain_ms = cuda_time_ms(lambda: da.det_attention_plain(*half, *biases, hw, 0.125,
                                                               DET_HEADS), iters=3, warmup=1)
        unit = b * DET_HEADS * l * l * 64
        qkv, bias_bytes = half[0].numel() * 2, 4 * sum(x.numel() for x in biases)
        bound = bound_ms(4 * qkv + bias_bytes, 4 * unit, peak)
        log(f"22(a) det attention forward per {name} layer B={b} grid {hg}x{wg} fp16: kernel "
            f"{fwd['kernel']:.4f} ms, the bf16 kernel {fwd['bf16']:.4f} ms, SDPA in fp16 on "
            f"the materialised bias {fwd['sdpa']:.4f} ms ({fwd['kernel'] / fwd['sdpa']:.2f}x; "
            f"in turns); plain {plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({card})")
        rows["fwd"][name] = {"ms": fwd["kernel"], "plain_ms": plain_ms,
                             "library_ms": fwd["sdpa"], "bound_ms": bound[0],
                             "bound_by": bound[1], "bf16_ms": fwd["bf16"]}

        out, lse = da.det_attention_cuda(*half, *biases, hw, 0.125, DET_HEADS, with_lse=True)
        out_b, lse_b = da.det_attention_cuda(*bf, *biases, hw, 0.125, DET_HEADS, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda")
        args = (*half, *biases, out, dout.half(), lse, hw, 0.125, DET_HEADS)
        args_b = (*bf, *biases, out_b, dout.bfloat16(), lse_b, hw, 0.125, DET_HEADS)
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        leaf_mask = mask.detach().requires_grad_()
        res = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=leaf_mask,
                                                               scale=0.125)
        g4 = args[7].view(b, l, DET_HEADS, 64).transpose(1, 2)
        bwd = in_turns({
            "dq": lambda: da.det_attention_bwd_cuda(*args, passes=3),
            "dq_bf16": lambda: da.det_attention_bwd_cuda(*args_b, passes=3),
            "dkv": lambda: da.det_attention_bwd_cuda(*args, passes=4),
            "dkv_bf16": lambda: da.det_attention_bwd_cuda(*args_b, passes=4),
            "sdpa": lambda: torch.autograd.grad(res, [*leaves, leaf_mask], g4,
                                                retain_graph=True)}, iters=5)
        plain_ms = cuda_time_ms(lambda: da.det_attention_bwd_plain(*args), iters=2, warmup=1)
        stats = 2 * 4 * lse.numel()
        bounds = {"dq": bound_ms(5 * qkv + stats + 2 * bias_bytes, 6 * unit, peak),
                  "dkv": bound_ms(6 * qkv + stats + bias_bytes, 8 * unit, peak)}
        for kernel, what in (("dq", "pass 1 + dtoep (#5)"), ("dkv", "pass 2 (#6)")):
            log(f"22(a) det attention backward per {name} layer B={b} grid {hg}x{wg} fp16, "
                f"{what}: kernel {bwd[kernel]:.4f} ms, the bf16 kernel "
                f"{bwd[kernel + '_bf16']:.4f} ms (in turns); SDPA's backward in fp16 on the "
                f"materialised bias {bwd['sdpa']:.4f} ms; the whole plain backward "
                f"{plain_ms:.3f} ms; bound {bounds[kernel][0]:.4f} ms by {bounds[kernel][1]} "
                f"({card})")
            rows[kernel][name] = {"ms": bwd[kernel], "plain_ms": plain_ms,
                                  "library_ms": bwd["sdpa"], "bound_ms": bounds[kernel][0],
                                  "bound_by": bounds[kernel][1], "bf16_ms": bwd[kernel + "_bf16"]}
        del half, bf, biases, toep, bh, bw, mask, q4, k4, v4, out, lse, out_b, lse_b, dout
        del args, args_b, leaves, leaf_mask, res, g4
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# 23. data parallelism and FSDP on one card
# ---------------------------------------------------------------------------

# the largest relative difference of an update's loss or gnorm, the FSDP-
# wrapped trainer against the unwrapped one in bf16: FSDP gathers the same
# bf16 parameters, but sums a layer's gradient over its text and image
# passes in fp32, where the unwrapped copy sums it in bf16 (2^-8 relative
# per element)
PARALLEL_BOUND = 1e-2
PARALLEL_DIR = ROOT / "build" / "smoke_parallel"


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL group in this process over a ``FileStore`` under
    ``build/``, with a timeout; destroyed at the end of the block."""
    import datetime

    import torch.distributed as dist

    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    store = PARALLEL_DIR / f"store_{time.time_ns()}"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def nccl_share(rows, busy_ms: float) -> tuple:
    """(ms, share of the busy time) of the NCCL all-gather and reduce-scatter
    kernels in ``device_times`` rows."""
    ms = sum(r.self_device_time_total for r in rows if "nccl" in r.key.lower()
             and ("allgather" in r.key.lower() or "reducescatter" in r.key.lower())) / 1e3
    return ms, ms / busy_ms


def relative_gap(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b, strict=True))


def sharded_vs_plain(tag: str, make, batches: list, ops, card: str) -> dict:
    """The same updates, on the same seeded weights and batches, through the
    trainer FSDP-wrapped over a one-rank group and then, once it is freed,
    through the unwrapped one: per update the loss and gnorm, ms, the peak,
    the launches of ``ops``' kernels; then one more update of each profiled
    (the card's busy time, the idle share, the NCCL share under FSDP).  Raises if the losses or gnorms differ by more than
    ``PARALLEL_BOUND``, or the launches differ or are 0."""
    out = {}
    for name in ("fsdp", "plain"):
        with one_rank_group() if name == "fsdp" else contextlib.nullcontext():
            trainer = make()
            sharded = sum(hasattr(p, "device_mesh") for p in trainer.model.parameters())
            if (name == "fsdp") != (sharded > 0):
                raise RuntimeError(f"{tag} {name}: {sharded} FSDP-sharded parameters")
            rng_state = trainer.generator.get_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.launches = ops.bwd_launches = 0
            losses, gnorms, times = [], [], []
            for batch in batches:
                t0 = time.time()
                metrics = trainer.train_step(batch)
                torch.cuda.synchronize()
                times.append(1e3 * (time.time() - t0))
                losses.append(metrics["loss"])
                gnorms.append(metrics["gnorm"])
            run = {"losses": losses, "gnorms": gnorms, "ms": times, "sharded": sharded,
                   "launches": (ops.launches, ops.bwd_launches),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            from torch.profiler import ProfilerActivity, profile

            trainer.generator.set_state(rng_state)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                trainer.train_step(batches[0])
                torch.cuda.synchronize()
                wall = 1e3 * (time.time() - t0)
            rows, busy = device_times(prof)
            run["nccl_ms"], run["nccl_share"] = nccl_share(rows, busy)
            run["busy_ms"], run["idle"] = busy, 1 - busy / wall
            out[name] = run
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    fsdp, plain = out["fsdp"], out["plain"]
    gap = max(relative_gap(fsdp["losses"], plain["losses"]),
              relative_gap(fsdp["gnorms"], plain["gnorms"]))
    out["gap"] = gap
    for name, run in out.items():
        if name == "gap":
            continue
        log(f"{tag} {name}: losses {[round(x, 6) for x in run['losses']]}, gnorms "
            f"{[round(x, 5) for x in run['gnorms']]}, ms per update "
            f"{[round(x, 1) for x in run['ms']]} (the first warms up), peak "
            f"{run['peak_gib']:.1f} GiB, launches (fwd, bwd) {run['launches']}, "
            f"{run['sharded']} sharded parameters ({card})")
    log(f"{tag} one profiled update: card busy {fsdp['busy_ms']:.1f} ms under FSDP (idle "
        f"{100 * fsdp['idle']:.0f}%), {plain['busy_ms']:.1f} ms unwrapped (idle "
        f"{100 * plain['idle']:.0f}%); FSDP's NCCL all-gather and reduce-scatter "
        f"{fsdp['nccl_ms']:.2f} ms, {100 * fsdp['nccl_share']:.2f}% of its card time; largest "
        f"relative difference of loss or gnorm {gap:.3e} (bound {PARALLEL_BOUND:g}) ({card})")
    if not gap <= PARALLEL_BOUND:
        raise RuntimeError(f"{tag}: FSDP and the unwrapped trainer differ by {gap:.3e}")
    if fsdp["launches"] != plain["launches"] or min(fsdp["launches"]) == 0:
        raise RuntimeError(f"{tag}: launches {fsdp['launches']} under FSDP, "
                           f"{plain['launches']} unwrapped")
    return out


def train_sharded(gen, card: str) -> dict:
    """Phase 23(a): the retrieval step at full width, depth ``CUT_DEPTH``, bf16,
    remat, drop path 0.5, vl B=32 as 7(b) builds it: 3 updates FSDP-wrapped
    over a one-rank NCCL group, then unwrapped (``sharded_vs_plain``)."""
    cfg = train_config(layers=CUT_DEPTH, bf16=True, remat=True, drop_path=0.5)
    batches = [train_batch(cfg, gen, 32) for _ in range(3)]
    out = sharded_vs_plain("23(a) retrieval step", lambda: make_trainer(cfg), batches, fa, card)
    for name in ("fsdp", "plain"):
        steady = statistics.median(out[name]["ms"][1:])
        out[name]["steady_ms"] = steady
    log(f"23(a) ms per update (median of updates 2-3): FSDP {out['fsdp']['steady_ms']:.1f}, "
        f"unwrapped {out['plain']['steady_ms']:.1f} ({card})")
    return out


def train_det_sharded(gen, card: str) -> dict:
    """Phase 23(b): the detection step at full width, 1024 px, B=2, bf16,
    depth 2 with one windowed and one global layer (14(b)'s), so that #4-#6
    run: 3 updates FSDP-wrapped, then unwrapped (``sharded_vs_plain``)."""
    overrides = ["lr_scheduler.warmup_updates=0", "model.encoder.layers=2",
                 "task.global_period=2"]
    cfg = det_config(overrides)
    batches = [det_batch(cfg, gen, 2) for _ in range(3)]
    out = sharded_vs_plain("23(b) detection step", lambda: det_trainer(det_config(overrides)),
                           batches, da, card)
    for name in ("fsdp", "plain"):
        out[name]["steady_ms"] = statistics.median(out[name]["ms"][1:])
    log(f"23(b) ms per update (median of updates 2-3): FSDP {out['fsdp']['steady_ms']:.1f}, "
        f"unwrapped {out['plain']['steady_ms']:.1f} ({card})")
    return out


TORCHRUN_LAYERS = 2  # 23(c)'s depth


def torchrun_argv(data: dict, save_dir: Path) -> list:
    """23(c)'s ``cli.train`` arguments: phase 13's corpus at full width and
    depth ``TORCHRUN_LAYERS``, 5 updates, a validation and a bundle at update
    4, ``distributed.fsdp=1``."""
    return retrieval_argv(data, save_dir, TORCHRUN_LAYERS, 8, [
        "optimization.max_update=5", "dataset.validate_interval_updates=4",
        "checkpoint.save_interval_updates=4", "checkpoint.save_interval=1000",
        "checkpoint.best_checkpoint_metric=", f"common.log_file={save_dir}/log.jsonl",
        ONE_PROCESS])


class TorchrunCli:
    """23(c)'s launch users run, ``python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m one_peace_tpu_torch.cli.train``, as a
    subprocess started before 17(d) (whose checks and phase 10's take no
    times) so that its start-up on the host overlaps them; 23(c) waits for
    it.  Its output goes to ``LOG``, beside the profiles; ``stop`` kills it
    if it is still running."""

    LOG = Path("chiprun_out") / "torchrun_cli.log"

    def __init__(self):
        self.proc, self.log, self.t0, self.seconds = None, None, 0.0, None
        self.ended = None  # when the process ended, on the host clock
        self.save_dir = PARALLEL_DIR / "torchrun"

    def start(self, data: dict) -> None:
        import os

        shutil.rmtree(self.save_dir, ignore_errors=True)
        self.LOG.parent.mkdir(exist_ok=True)
        self.log = open(self.LOG, "w")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "one_peace_tpu_torch.cli.train",
               *torchrun_argv(data, self.save_dir)]
        self.t0 = time.time()
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT,
                                     env={**os.environ, "PYTHONPATH": str(ROOT)})

        def note_end(proc=self.proc):
            proc.wait()
            self.ended = time.time()

        threading.Thread(target=note_end, daemon=True).start()

    def wait(self, timeout: float = 600.0) -> int:
        t0 = time.time()
        rc = self.proc.wait(timeout=timeout)
        while self.ended is None:  # its watcher thread notes the end
            time.sleep(0.01)
        self.seconds = self.ended - self.t0
        self.log.close()
        log(f"23(c) the torchrun run took {self.seconds:.1f} s from its start, rc {rc}; this "
            f"phase waited {time.time() - t0:.1f} s for it")
        return rc

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.log is not None and not self.log.closed:
            self.log.close()


def check_torchrun_cli(data: dict, card: str, child: TorchrunCli) -> dict:
    """Phase 23(c): the torchrun launch of ``cli.train`` (``TorchrunCli``,
    started before 17(d)) on phase 13's corpus at full width, depth
    ``TORCHRUN_LAYERS``, ``distributed.fsdp=1``, 5 updates, one validation
    and a bundle at update 4: its ``train_inner`` losses and its validation
    Recall held to the same arguments run in this process without torchrun;
    then its bundle at update 4 resumed here without torchrun, whose fifth
    update's loss must be the straight run's."""
    RECALL = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10")

    def logged(save_dir, tag):
        lines = [json.loads(x) for x in (save_dir / "log.jsonl").read_text().splitlines()]
        return [x for x in lines if x["tag"] == tag]

    runs = {"torchrun": child.save_dir, "straight": PARALLEL_DIR / "straight"}
    shutil.rmtree(runs["straight"], ignore_errors=True)
    rc = child.wait()
    if rc != 0:
        tail = child.LOG.read_text()[-2000:]
        raise RuntimeError(f"23(c) torchrun exited {rc}: {tail}")
    gc.collect()
    torch.cuda.empty_cache()
    fa.launches = fa.bwd_launches = 0
    t0 = time.time()
    run_train_cli(torchrun_argv(data, runs["straight"]))
    straight_s = time.time() - t0
    inner = {name: logged(d, "train_inner") for name, d in runs.items()}
    valid = {name: logged(d, "valid") for name, d in runs.items()}
    losses = {name: [x["loss"] for x in lines] for name, lines in inner.items()}
    gap = relative_gap(losses["torchrun"], losses["straight"])
    recall = {name: {k: v[0][k] for k in RECALL} for name, v in valid.items()}
    n_images = valid["straight"][0]["img_count"]
    recall_gap = max(abs(recall["torchrun"][k] - recall["straight"][k]) for k in RECALL)
    log(f"23(c) torchrun --nproc_per_node 1 cli.train, depth {TORCHRUN_LAYERS}: "
        f"{child.seconds:.1f} s (start-up included), losses "
        f"{[round(x, 6) for x in losses['torchrun']]}, Recall {recall['torchrun']}; without "
        f"torchrun ({straight_s:.1f} s): losses {[round(x, 6) for x in losses['straight']]}, "
        f"Recall {recall['straight']}; largest relative loss difference over updates 1-5 "
        f"{gap:.3e} (bound {PARALLEL_BOUND:g}), largest Recall difference {recall_gap:.4f} "
        f"points (bound one of {n_images} images, {100 / n_images:.4f}) ({card})")
    if len(losses["torchrun"]) != 5 or not gap <= PARALLEL_BOUND:
        raise RuntimeError(f"23(c): the torchrun losses {losses['torchrun']} differ from "
                           f"{losses['straight']}")
    if not recall_gap <= 100 / n_images:
        raise RuntimeError(f"23(c): the torchrun Recall {recall['torchrun']} differs from "
                           f"{recall['straight']}")
    if not (runs["torchrun"] / "step_4").is_dir():
        raise RuntimeError("23(c): the torchrun run saved no bundle at update 4")
    run_train_cli(torchrun_argv(data, runs["torchrun"]))  # resumes its step_4, one process
    resumed = [x for x in logged(runs["torchrun"], "train_inner") if x["step"] == 5]
    fifth = losses["straight"][4]
    resume_gap = abs(resumed[-1]["loss"] - fifth) / abs(fifth) if resumed else math.inf
    log(f"23(c) the torchrun bundle resumed without torchrun: update 5 loss "
        f"{resumed[-1]['loss'] if resumed else None} against the straight run's {fifth:.6f}, "
        f"relative difference {resume_gap:.3e} (bound {PARALLEL_BOUND:g})")
    if not resume_gap <= PARALLEL_BOUND:
        raise RuntimeError("23(c): the resumed update's loss differs from the straight run's")
    return {"launches": (fa.launches, fa.bwd_launches), "gap": gap, "recall_gap": recall_gap,
            "resume_gap": resume_gap, "torchrun_s": child.seconds}


# ---------------------------------------------------------------------------
# 24. model parallelism: #1/#2 on a TP rank's heads, the ring's steps, the
# pipeline's stage split and route (one card: N > 1 runs on the CPU tests only)
# ---------------------------------------------------------------------------

TP_SHAPES = [  # (B, L, bias, what): the shared vl bias, pretraining's per-sample one
    (32, 257, "shared", "vl image tower"),
    (32, 124, "per-sample", "VL student, text pads"),
]
TP_SIZES = (2, 4, 8)
RING_B, RING_L, RING_SIZES = 32, 500, (2, 4)  # audio's L = 500
PIPE_B, PIPE_STAGES, PIPE_MICRO = 32, 2, 4


def tp_key_bias(b: int, l: int, what: str, rng):
    return pretrain_key_bias(b, l, what, rng) if "pads" in what else None


def heads_of(x: torch.Tensor, rank: int, tp: int, heads: int = 24) -> torch.Tensor:
    """Rank ``rank``'s heads of a (B, L, heads * 64) tensor, through the
    port's slicing code (``tensor_parallel.chunk_of``)."""
    b, l, _ = x.shape
    return tpar.chunk_of(x.view(b, l, heads, 64), 2, rank, tp).view(b, l, heads // tp * 64)


def check_tp_heads(card: str) -> tuple:
    """Phase 24(a): at each of ``TP_SHAPES``, #1 with statistics and #2 with
    d(bias) on every TP rank's heads for tp = 2, 4, 8 (12, 6, 3 heads), the
    q/k/v/g and bias slices cut by ``tensor_parallel.chunk_of`` (the
    per-sample bias's head slice is not contiguous in the whole; a shared
    bias's is a view, aligned by ``flash_attention.kernel_bias`` as
    ``flash_attention`` aligns it), the
    ranks' results concatenated over heads against the unsharded kernel call
    (whether bit-equal) and the plain version (phase 3's and 6's bounds);
    then all ranks' calls (on their slices, cut beforehand) timed in turns
    with the unsharded one, and each
    rank's shape through ``time_attention_cases`` for #1/#2's rows.
    Returns (forward rows, backward rows, launches)."""
    gen = torch.Generator(device="cuda").manual_seed(240)
    rng = np.random.RandomState(240)
    fa.launches = fa.bwd_launches = 0
    for b, l, kind, what in TP_SHAPES:
        q, k, v, g = (torch.randn(b, l, 24 * 64, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        bias = torch.randn(*((24, l, l) if kind == "shared" else (b, 24, l, l)),
                           generator=gen, device="cuda")
        key_bias = tp_key_bias(b, l, what, rng)
        head_dim = 0 if kind == "shared" else 1
        out, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, 24, with_stats=True)
        whole = (out,) + tuple(fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, 24,
                                                           stats=stats))
        plain = (fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, key_bias,
                                          0.125, 24),) + tuple(
            fa.flash_attention_bwd_plain(q, k, v, g, bias, key_bias, 0.125, 24))
        for tp in TP_SIZES:
            h = 24 // tp

            sliced = [[heads_of(x, r, tp) for x in (q, k, v, g)]
                      + [fa.kernel_bias(tpar.chunk_of(bias, head_dim, r, tp))]
                      for r in range(tp)]

            def ranks(keep=True):
                parts = []
                for qr, kr, vr, gr, br in sliced:
                    o, st = fa.flash_attention_cuda(qr, kr, vr, br, key_bias, 0.125, h,
                                                    with_stats=True)
                    grads = fa.flash_attention_bwd_cuda(qr, kr, vr, gr, br, key_bias, 0.125, h,
                                                        stats=st)
                    if keep:
                        parts.append((o,) + tuple(grads))
                return parts

            parts = ranks()
            got = [torch.cat([p[i].view(b, l, h, 64) for p in parts], 2).view(b, l, 24 * 64)
                   for i in range(4)] + [torch.cat([p[4] for p in parts], head_dim)]
            equal = [torch.equal(x, y) for x, y in zip(got, whole)]
            fwd_err = (got[0].float() - plain[0]).abs()
            rel = [((x.float() - y.float()).abs().max().item() / y.float().abs().max().item(),
                    (x.float() - y.float()).abs().mean().item() / y.float().abs().mean().item())
                   for x, y in zip(got[1:], plain[1:])]
            t = in_turns({"ranks": lambda: ranks(keep=False),
                          "whole": lambda: fa.flash_attention_bwd_cuda(
                              q, k, v, g, bias, key_bias, 0.125, 24, stats=fa.flash_attention_cuda(
                                  q, k, v, bias, key_bias, 0.125, 24, with_stats=True)[1])},
                         iters=3)
            log(f"24(a) B={b} L={l} {kind} bias, tp={tp} ({h} heads a rank) bf16: the ranks' "
                f"out/dq/dk/dv/d(bias) concatenated bit-equal to the unsharded call: "
                f"{equal}; forward vs plain max |d| {fwd_err.max().item():.3e} mean "
                f"{fwd_err.mean().item():.3e}; backward max/mean relative "
                f"{', '.join(f'{a:.2e}/{m:.2e}' for a, m in rel)}; forward + backward of all "
                f"{tp} ranks {t['ranks']:.4f} ms, unsharded {t['whole']:.4f} ms (in turns; "
                f"{card})")
            if fwd_err.max().item() > BF16_MAX_ERR or fwd_err.mean().item() > BF16_MEAN_ERR:
                raise RuntimeError(f"24(a) tp={tp} {what}: the forward on the ranks' heads "
                                   "disagrees with the plain version")
            if any(a > 2e-2 or m > 5e-3 for a, m in rel):
                raise RuntimeError(f"24(a) tp={tp} {what}: the backward on the ranks' heads "
                                   "disagrees with the plain version")
            del parts, got, sliced
        del q, k, v, g, bias, out, stats, whole, plain
        torch.cuda.empty_cache()
    launches = (fa.launches, fa.bwd_launches)
    cases = [(b, l, 24 // tp, kind, f"{what}, tp={tp} rank ({24 // tp} heads)")
             for b, l, kind, what in TP_SHAPES for tp in TP_SIZES]
    fwd_rows, bwd_rows = time_attention_cases("24(a)", cases, card, 241, tp_key_bias)
    return fwd_rows, bwd_rows, launches


def check_ring_steps(card: str) -> None:
    """Phase 24(b): ring attention's step functions
    (``ops.ring_attention.forward_block`` / ``backward_block``, the
    arithmetic each rank runs between two hops) for every (rank, step) in
    turn at sp = 2 and 4, at audio's L=500, B=32, 24 heads, bf16 q/k/v,
    the shared bias and key pads; the chunks assembled as the ring
    assembles them, against #1/#2 on the whole sequence.  Bounds: phase 3's
    bf16 ones on the output (max |d| 2e-2, mean 2e-3) and phase 6's
    relative ones on dq/dk/dv/d(bias) (max 2e-2, mean 5e-3): the ring
    computes in fp32 from the bf16 inputs, the kernels round their outputs
    to bf16."""
    gen = torch.Generator(device="cuda").manual_seed(242)
    b, l, h = RING_B, RING_L, 24
    q, k, v, g = (torch.randn(b, l, h * 64, generator=gen, device="cuda", dtype=torch.bfloat16)
                  for _ in range(4))
    bias = torch.randn(h, l, l, generator=gen, device="cuda")
    spec = ModelConfig().encoder.audio_adapter.feature_encoder_spec
    pad = torch.zeros(b, l, dtype=torch.bool, device="cuda")
    for row, seconds in enumerate(np.random.RandomState(242).uniform(5, 10, b)):
        pad[row, 1 + conv_output_length(int(16000 * seconds), spec):] = True
    key_bias = torch.zeros(b, l, device="cuda").masked_fill(pad, fa.NEG_INF)
    out, stats = fa.flash_attention_cuda(q, k, v, bias, key_bias, 0.125, h, with_stats=True)
    kernel = (out,) + tuple(fa.flash_attention_bwd_cuda(q, k, v, g, bias, key_bias, 0.125, h,
                                                        stats=stats))
    q4, k4, v4, g4 = (x.view(b, l, h, 64) for x in (q, k, v, g))
    for sp in RING_SIZES:
        lc = l // sp
        chunk = [[tpar.chunk_of(x, 1, r, sp) for r in range(sp)] for x in (q4, k4, v4, g4)]
        outs, lses, dq = [], [], []
        dk = [torch.zeros(b, lc, h, 64, device="cuda") for _ in range(sp)]
        dv = [torch.zeros(b, lc, h, 64, device="cuda") for _ in range(sp)]
        dbias = torch.zeros(h, l, l, device="cuda")
        for r in range(sp):
            qf = chunk[0][r].float() * 0.125
            state = ra.start_state(chunk[0][r])
            for step in range(sp):
                src = (r - step) % sp
                state = ra.forward_block(state, qf, chunk[1][src], chunk[2][src], bias, pad, r, src)
            o, lse = ra.finish_state(state)
            outs.append(o)
            do = chunk[3][r].float()
            delta = (do * o).sum(-1).transpose(1, 2)
            dq_r = torch.zeros_like(qf)
            for step in range(sp):
                src = (r - step) % sp
                dq_part, dk_part, dv_part, tile = ra.backward_block(
                    qf, do, delta, lse, chunk[1][src], chunk[2][src], bias, pad, r, src, 0.125)
                dq_r += dq_part
                dk[src] += dk_part
                dv[src] += dv_part
                dbias[:, r * lc:(r + 1) * lc, src * lc:(src + 1) * lc] = tile
            dq.append(dq_r)
        got = [torch.cat(x, 1).reshape(b, l, h * 64) for x in (outs, dq, dk, dv)] + [dbias]
        fwd_err = (got[0] - kernel[0].float()).abs()
        rel = [((x - y.float()).abs().max().item() / y.float().abs().max().item(),
                (x - y.float()).abs().mean().item() / y.float().abs().mean().item())
               for x, y in zip(got[1:], kernel[1:])]
        qf0 = chunk[0][0].float() * 0.125
        step_fwd = cuda_time_ms(lambda: ra.forward_block(ra.start_state(chunk[0][0]), qf0,
                                                         chunk[1][0], chunk[2][0], bias, pad, 0,
                                                         0), iters=3)
        log(f"24(b) ring sp={sp} (chunks of {lc}) B={b} L={l} H={h}, shared bias, key pads: "
            f"the {sp}x{sp} (rank, step) blocks vs #1 on the whole sequence max |d| "
            f"{fwd_err.max().item():.3e} mean {fwd_err.mean().item():.3e} (bound "
            f"{BF16_MAX_ERR:.0e} / {BF16_MEAN_ERR:.0e}); vs #2 dq/dk/dv/d(bias) max/mean "
            f"relative {', '.join(f'{a:.2e}/{m:.2e}' for a, m in rel)} (bound 2e-2 / 5e-3); "
            f"one forward step (plain torch, fp32) {step_fwd:.3f} ms ({card})")
        if fwd_err.max().item() > BF16_MAX_ERR or fwd_err.mean().item() > BF16_MEAN_ERR:
            raise RuntimeError(f"24(b) sp={sp}: the ring's forward steps disagree with #1")
        if any(a > 2e-2 or m > 5e-3 for a, m in rel):
            raise RuntimeError(f"24(b) sp={sp}: the ring's backward steps disagree with #2")
        del chunk, outs, dq, dk, dv, dbias, got, fwd_err
        torch.cuda.empty_cache()


def check_pipeline_split(gen, card: str) -> tuple:
    """Phase 24(c): the vl step's batch (B=32: 256 px images, L=257; 70-token
    texts with pads, L=71) through the fusion encoder at depth ``CUT_DEPTH``,
    bf16, against the serial stack (#1/#2 at B=32): each tower's output and
    every layer parameter's gradient under a seeded linear loss, for
    - "split": each of ``PIPE_STAGES`` stages' ``FusionEncoder.stage_fn`` on
      each of ``PIPE_MICRO`` micro-batches in turn (#1/#2 at B=8, the
      padding mask micro-sliced);
    - "pipeline" and "pipeline, remat": the encoder's own pipeline route
      (``FusionEncoder.enable_pipeline``, ``_pipelined``, ``pipeline_forward``)
      over a one-rank NCCL group: one stage of every layer, ``PIPE_MICRO``
      micro-batches, the output broadcast over the group, the backward
      through ``torch.autograd.grad`` of the stage's leaves, without and with
      ``checkpoint_stages``.
    Returns the launches (#1, #2) of the pipeline route's two runs, counted
    from 0 around them."""
    from one_peace_tpu_torch.parallel.pipeline import micro_batches

    cfg = train_config(layers=CUT_DEPTH, bf16=True, remat=False, drop_path=0.0)
    model = fill_random_(OnePeaceRetrievalModel(cfg.model, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(243)).to(torch.bfloat16)
    wrapper, fusion = model.encoder_wrapper, model.encoder_wrapper.fusion
    for p in fusion.layers.parameters():
        p.requires_grad_(True)
    batch = train_batch(cfg, gen, PIPE_B)
    n = CUT_DEPTH
    per = n // PIPE_STAGES
    stages = [list(range(s * per, (s + 1) * per)) for s in range(PIPE_STAGES)]
    params = list(fusion.layers.parameters())
    bounds = micro_batches(PIPE_B, PIPE_MICRO)
    rates, seeds, keep = np.zeros(n, np.float32), [None] * n, [True] * n
    towers = []
    with torch.no_grad():
        towers.append(("text", wrapper.text_adapter(batch["src_tokens"], None, None, None,
                                                    deterministic=True, generator=None)))
        towers.append(("image", wrapper.image_adapter(
            batch["src_images"].to(torch.bfloat16), None, None, None, False, deterministic=True,
            generator=None)))

    def run(path):
        outs = []
        for tower, (x, pad, bias) in towers:
            x = x * (1.0 - pad[..., None].to(x.dtype))
            key_mask = pad if bool(pad.any()) else None
            split_lens = (x.shape[1], 0, 0) if tower == "text" else (0, x.shape[1], 0)
            if path == "serial":
                outs.append(fusion._serial(x, key_mask, bias, False, tower, split_lens, rates,
                                           True, seeds, keep, None))
                continue
            if path != "split":
                outs.append(fusion._pipelined(x, key_mask, bias, False, tower, split_lens,
                                              rates, True, seeds, keep))
                continue
            fns = [fusion.stage_fn(owned, PIPE_MICRO, PIPE_B, False, False, tower, split_lens,
                                   rates, True, seeds, keep) for owned in stages]
            stage_params = [[p for i in owned for _, p in fusion.layers[i].named_parameters()]
                            for owned in stages]
            rows = []
            for m, (start, count) in enumerate(bounds):
                h = x[start:start + count]
                aux = (None if key_mask is None else key_mask[start:start + count], None)
                for fn, ps in zip(fns, stage_params):
                    h = fn(m, h, aux, (bias[0],), ps)
                rows.append(h)
            outs.append(torch.cat(rows))
        weights = [torch.randn(o.shape, generator=torch.Generator(device="cuda").manual_seed(
            244 + i), device="cuda") for i, o in enumerate(outs)]
        loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return [o.detach() for o in outs], grads

    import torch.distributed as dist

    results = {path: run(path) for path in ("serial", "split")}
    launches = {}
    with one_rank_group():
        fusion.enable_pipeline(tpar.Shard(dist.group.WORLD, 0, 1), [0], PIPE_MICRO)
        for path, remat in (("pipeline", False), ("pipeline, remat", True)):
            fusion.cfg.checkpoint_activations = remat
            fa.launches = fa.bwd_launches = 0
            results[path] = run(path)
            launches[path] = (fa.launches, fa.bwd_launches)
        fusion.cfg.checkpoint_activations = False
        fusion.pipeline = None
    out_s, grads_s = results["serial"]
    for path in ("split", "pipeline", "pipeline, remat"):
        out_p, grads_p = results[path]
        out_cos = min(min_cosine(a.flatten(1), b.flatten(1)) for a, b in zip(out_s, out_p))
        grad_cos = min(torch.nn.functional.cosine_similarity(
            a.double().flatten(), b.double().flatten(), dim=0).item()
            for a, b in zip(grads_s, grads_p))
        got = launches.get(path)
        # two towers, every layer, every micro-batch; the remat runs the
        # forward again in the backward
        want = None if got is None else (2 * n * PIPE_MICRO * (2 if "remat" in path else 1),
                                         2 * n * PIPE_MICRO)
        log(f"24(c) {path}: {PIPE_STAGES if path == 'split' else 1} stage(s) x {PIPE_MICRO} "
            f"micro-batches of {PIPE_B // PIPE_MICRO} at depth {n}, bf16, text L=71 with pads "
            f"and image L=257: outputs vs the serial stack min row cosine {out_cos:.6f}; layer "
            f"parameters' gradients min cosine {grad_cos:.6f} over {len(grads_p)}"
            + ("" if got is None else f"; launches #1 {got[0]}, #2 {got[1]} (expected {want})")
            + f" ({card})")
        if got is not None and got != want:
            raise RuntimeError(f"24(c) {path} ran #1/#2 {got} times, not {want}")
        if out_cos < 0.9999 or grad_cos < 0.999:
            raise RuntimeError(f"24(c) {path} disagrees with the serial stack")
    del model, results
    torch.cuda.empty_cache()
    return tuple(sum(c[i] for c in launches.values()) for i in range(2))


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: no card to run on")
    card = card_line()
    log(card)
    clock = [time.time(), time.time()]
    golden_state = GoldenState()  # phase 10's host work, beside phases 2-17
    prep = Prep()  # started after the build, which it would slow
    torchrun = TorchrunCli()  # 23(c)'s subprocess, started before phase 10
    try:
        run_phases(card, clock, golden_state, prep, torchrun)
    finally:
        torchrun.stop()
        prep.stop()
        golden_state.stop()


def run_phases(card: str, clock: list, golden_state: GoldenState, prep: Prep,
               torchrun: "TorchrunCli") -> None:
    """Phases 2-24 (10 after 17) and the two last lines."""

    def mark(phase: str) -> None:
        """Log the phase's wall time and the script's so far."""
        now = time.time()
        log(f"phase {phase} took {now - clock[1]:.1f} s ({now - clock[0]:.1f} s so far)")
        clock[1] = now

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build: one nvcc per kernel source, started together, each timed
    t0 = time.time()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))

    def timed_build(name):
        start = time.time()
        return build.build_library(name), time.time() - start

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(timed_build, names)))
    libs = {name: lib for name, (lib, _) in built.items()}
    log("built " + ", ".join(f"{lib.name} in {sec:.1f} s" for lib, sec in built.values())
        + f"; {time.time() - t0:.1f} s together")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "C75" in line:  # C7508, C7517
                log(f"  ptxas: {line.strip()}")
    prep.start(prep_jobs())

    mark("2")

    # 3. kernel vs plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernel(gen)

    mark("3")

    # 4. the embedding slice at full width: fp32, then bf16
    cfg = ModelConfig(head_type="val")
    inputs = make_inputs(cfg, gen, 4, 2, 4)
    fa.launches = 0
    reference = check_slice(cfg, inputs, torch.float32, 1 - 1e-6)
    torch.cuda.empty_cache()
    check_slice(cfg, inputs, torch.bfloat16, 0.999, reference)
    embed_launches = fa.launches
    if embed_launches == 0:
        raise RuntimeError("the embedding path never launched the attention kernel")
    torch.cuda.empty_cache()

    mark("4")

    # 5. times
    fwd_times = time_paths(cfg, card)

    mark("5")

    # 6. the backward kernel vs plain
    bwd_worst = check_backward_kernel(gen)
    bwd_times = time_backward(gen, card)
    torch.cuda.empty_cache()

    mark("6")

    # 7. the training slice
    check_train_paths(gen)
    train = train_full_depth(gen, card)
    fwd_train, bwd_train = train["pallas"]["launches"]
    if bwd_train == 0:
        raise RuntimeError("the training path never launched the backward kernel")
    torch.cuda.empty_cache()

    mark("7")

    # 8. the int8 kernels vs plain, and their times
    int8_worst = check_int8_kernels(gen)
    int8_times = time_int8_kernels(gen, card)
    mark("8")

    # 9. int8 serving through the hub (the counts are read over its kernel-path forwards)
    int8_launches = serve_int8(card, prep)
    if min(int8_launches.values()) == 0:
        raise RuntimeError(f"the int8 serving path never launched a kernel: {int8_launches}")
    mark("9")

    # 11. detection serving: the det attention kernel vs plain, the 1024 px
    # detector at depth 4 (CUT_DEPTH) through it (its launches counted from 0 here), and times
    det_worst = check_det_kernel(gen)
    check_det_head_dim()
    det_launches = check_detector(gen, card)
    if det_launches == 0:
        raise RuntimeError("the detection path never launched the det attention kernel")
    det_times = time_det_attention(gen, card)

    mark("11")

    # 12. detection fine-tuning: the backward kernels vs plain, the 4-layer
    # full-width objective on both paths, the depth-40 recipe through the
    # Trainer (its launches counted from 0 after a warm-up step), and times
    det_bwd_worst = check_det_bwd_kernel(gen)
    det_batch4, det_grads32 = check_det_train_paths(gen)  # 22(c) checks fp16 against these
    det_train = train_det_full_depth(gen, card)
    det_fwd_train, det_bwd_train = det_train["pallas"]["total"]
    det_bwd_times = time_det_backward(gen, card)

    mark("12")

    # 13. retrieval fine-tuning from data: cli.train's resume at depth 2 and
    # cli.evaluate on its export, then the depth-40 recipe through cli.train
    # (the attention kernels' launches counted from 0 here)
    fa.launches = fa.bwd_launches = 0
    data = prep.take("13", "the corpus")
    check_cli_resume(data)
    train_cli_full_depth(data, card, train["pallas"]["ms"])
    cli_fwd, cli_bwd = fa.launches, fa.bwd_launches
    log(f"13 launches over the phase: #1 {cli_fwd}, #2 {cli_bwd}")
    if cli_fwd == 0 or cli_bwd == 0:
        raise RuntimeError("the retrieval CLI path never launched an attention kernel")

    mark("13")

    # 14. detection from data: the synthetic COCO tree, cli.train at depth 2
    # with its export read back and cli.evaluate, then the depth-40 recipe
    # (the det attention kernels' launches counted from 0 here)
    da.launches = da.bwd_launches = 0
    coco = prep.take("14", "the corpus")
    check_det_cli(coco, card)
    train_det_cli_full_depth(coco, card, det_train["pallas"]["ms"])
    coco_fwd, coco_bwd = da.launches, da.bwd_launches
    log(f"14 launches over the phase: #4 {coco_fwd}, #5/#6 {coco_bwd}")
    if coco_fwd == 0 or coco_bwd == 0:
        raise RuntimeError("the detection CLI path never launched a det attention kernel")

    mark("14")

    # 15. classification: #1 and #2 alone at the slice's shapes against
    # their plain versions and SDPA (15(e)); then, the launches counted from
    # 0, classify serving through the hub (15(a)), the three tasks'
    # gradients at 4 layers (15(b)), their recipes from files through the
    # CLIs at depth 2 (15(c)) and image_classify at depth 40 (15(d))
    t15 = time.time()
    cls_fwd_rows, cls_bwd_rows = time_classify_attention(card)
    fa.launches = fa.bwd_launches = im.launches = im.quantize_launches = 0
    cls_int8 = serve_classify(card, prep)
    check_classify_train_paths()
    cls_data = prep.take("15(c)", "the corpus")
    check_classify_cli(cls_data, card)
    train_classify_full_depth(cls_data, card)
    cls_fwd, cls_bwd = fa.launches, fa.bwd_launches
    log(f"15 launches over the phase: #1 {cls_fwd}, #2 {cls_bwd}, int8 GEMM {im.launches}, "
        f"quantize {im.quantize_launches}; the phase took {time.time() - t15:.1f} s")
    if cls_fwd == 0 or cls_bwd == 0 or im.launches == 0 or im.quantize_launches == 0:
        raise RuntimeError("the classification path never launched one of its kernels")
    fwd_times.setdefault("shapes", {}).update(cls_fwd_rows)
    bwd_times.setdefault("shapes", {}).update(cls_bwd_rows)
    mark("15")

    # 16. pretraining: #1 and #2 alone at the slice's shapes against their
    # plain versions and SDPA (16(a)); then, the launches counted from 0,
    # both criterions' gradients at 4 layers (16(b)), the VL recipe and the
    # AL stage-2 recipe from its export through cli.train at depth 2 (16(c)),
    # and both recipes at depth 40 (16(d))
    t16 = time.time()
    pre_fwd_rows, pre_bwd_rows = time_pretrain_attention(card)
    mark("16(a)")
    fa.launches = fa.bwd_launches = 0
    pre_data = prep.take("16", "the corpus")
    check_pretrain_train_paths(pre_data)
    mark("16(b)")
    check_pretrain_cli(pre_data, card)
    mark("16(c)")
    for stage in ("vl", "al"):
        train_pretrain_full_depth(pre_data, stage, card)
    pre_fwd, pre_bwd = fa.launches, fa.bwd_launches
    log(f"16 launches over the phase: #1 {pre_fwd}, #2 {pre_bwd}; the phase took "
        f"{time.time() - t16:.1f} s")
    mark("16(d)")
    if pre_fwd == 0 or pre_bwd == 0:
        raise RuntimeError("the pretrain path never launched an attention kernel")
    fwd_times["shapes"].update(pre_fwd_rows)
    bwd_times["shapes"].update(pre_bwd_rows)

    # 17. segmentation serving: #1 alone at the trunk's L = 3137 against its
    # plain version and SDPA (17(a)); then, the launches counted from 0, both
    # segmenters at depth 4 on both paths (17(b)), the Mask2Former recipe at
    # depth 40 (17(c)) and cli.evaluate from files under three protocols (17(d))
    t17 = time.time()
    seg_worst, seg_rows = time_seg_attention(card)
    worst = max(worst, seg_worst)
    mark("17(a)")
    fa.launches = 0
    check_segmenters(card)
    mark("17(b)")
    serve_seg_full_depth(card)
    mark("17(c)")
    # 23(c)'s torchrun subprocess starts here: its start-up on the host
    # overlaps 17(d) and phase 10, which take no times
    torchrun.start(data)
    check_seg_cli(card, prep)
    seg_fwd = fa.launches
    log(f"17 launches over the phase: #1 {seg_fwd}; the phase took {time.time() - t17:.1f} s")
    mark("17(d)")
    if seg_fwd == 0:
        raise RuntimeError("the segmentation path never launched the attention kernel")
    fwd_times["shapes"].update(seg_rows)

    # 10. the depth-40 golden through the .pt route, run here, when the
    # process started with the script has its state written (~260 s of host
    # work): run after phase 12 it waited 42 s for it, after phase 14 13 s,
    # after 15 34 s (with the recipes at depth 8)
    fp16_runs = {}  # phase 21's fp16 launches by run (its golden check runs here, on this state)
    golden16 = check_golden(golden_state, fp16_runs)[1]

    mark("10")

    # 18. segmentation training: #1 with statistics and #2 alone at L = 3137,
    # B=2 (18(a)); then, the launches counted from 0, both segmenters'
    # objectives at depth 4 on both paths (18(b)), cli.train's resume and
    # export at depth 4 (18(c)) and the Mask2Former recipe at depth 40 (18(d))
    t18 = time.time()
    seg_fwd_err, seg_bwd_err, seg_fwd_rows, seg_bwd_rows = check_seg_train_attention(card)
    worst, bwd_worst = max(worst, seg_fwd_err), max(bwd_worst, seg_bwd_err)
    mark("18(a)")
    fa.launches = fa.bwd_launches = 0
    check_seg_train_paths()
    mark("18(b)")
    check_seg_train_cli(card, prep)
    mark("18(c)")
    train_seg_full_depth(card)
    seg_train_fwd, seg_train_bwd = fa.launches, fa.bwd_launches
    log(f"18 launches over the phase: #1 {seg_train_fwd}, #2 {seg_train_bwd}; the phase took "
        f"{time.time() - t18:.1f} s")
    mark("18(d)")
    if seg_train_fwd == 0 or seg_train_bwd == 0:
        raise RuntimeError("the segmentation training path never launched an attention kernel")
    fwd_times["shapes"].update(seg_fwd_rows)
    bwd_times["shapes"].update(seg_bwd_rows)

    # 19. video: #1 and #2 alone at the temporal (L=32) and spatial (L=257)
    # shapes against their plain versions and SDPA (19(a)); then, the
    # launches counted from 0, the classifier's logits and gradients at depth
    # 4 on both paths (19(b)), the recipe's resume, export and cli.evaluate
    # from files at depth 4 (19(c)) and the recipe at depth 40 (19(d))
    t19 = time.time()
    vid_fwd_err, vid_bwd_err, vid_fwd_rows, vid_bwd_rows = check_video_attention(card)
    worst, bwd_worst = max(worst, vid_fwd_err), max(bwd_worst, vid_bwd_err)
    mark("19(a)")
    fa.launches = fa.bwd_launches = 0
    check_video_train_paths()
    mark("19(b)")
    k400 = prep.take("19", "the corpus")
    check_video_cli(k400, card)
    mark("19(c)")
    train_video_full_depth(k400, card)
    vid_fwd, vid_bwd = fa.launches, fa.bwd_launches
    log(f"19 launches over the phase: #1 {vid_fwd}, #2 {vid_bwd}; the phase took "
        f"{time.time() - t19:.1f} s")
    mark("19(d)")
    if vid_fwd == 0 or vid_bwd == 0:
        raise RuntimeError("the video path never launched an attention kernel")
    fwd_times["shapes"].update(vid_fwd_rows)
    bwd_times["shapes"].update(vid_bwd_rows)

    # 20. the rest of classification: #1 and #2 alone at NLVR2's L=647 and
    # AQA's L=820 against their plain versions and SDPA (20(a)); then, the
    # launches counted from 0, the four criterions' gradients at depth 2
    # (20(b)), the four recipes from files through both CLIs at depth 2
    # (20(c)) and the NLVR2 recipe at depth 40 (20(d))
    t20 = time.time()
    rest_fwd_err, rest_bwd_err, rest_fwd_rows, rest_bwd_rows = check_classify_rest_attention(card)
    worst, bwd_worst = max(worst, rest_fwd_err), max(bwd_worst, rest_bwd_err)
    mark("20(a)")
    fa.launches = fa.bwd_launches = 0
    check_classify_rest_train_paths()
    mark("20(b)")
    rest_data = prep.take("20", "the corpus")
    check_classify_rest_cli(rest_data)
    mark("20(c)")
    train_nlvr2_full_depth(rest_data, card)
    rest_fwd, rest_bwd = fa.launches, fa.bwd_launches
    log(f"20 launches over the phase: #1 {rest_fwd}, #2 {rest_bwd}; the phase took "
        f"{time.time() - t20:.1f} s")
    mark("20(d)")
    if rest_fwd == 0 or rest_bwd == 0:
        raise RuntimeError("the rest of classification never launched an attention kernel")
    fwd_times["shapes"].update(rest_fwd_rows)
    bwd_times["shapes"].update(rest_bwd_rows)

    # 21. fp16: #1/#2 and #3/3b in fp16 alone against their plain versions
    # and in turns with SDPA / torch.matmul in fp16 and the bf16 kernels
    # (21(a)); then, the fp16 launches counted (21(b)'s golden ran in phase
    # 10, on its state): 4B embeddings in fp16 and int8 "ffn" in fp16
    # (21(b)), the retrieval step in fp16 with loss scaling and the EMA
    # (21(c)), the remat policies at CUT_DEPTH (21(d), bf16), Adan (21(e),
    # fp32) and the retrieval recipe through cli.train with fp16, the EMA and
    # Adan (21(f))
    t21 = time.time()
    fp16_fwd_err, fp16_bwd_err = check_fp16_attention()
    fp16_int8_worst = check_int8_fp16()
    fp16_fwd_rows, fp16_bwd_rows = time_fp16_attention(card)
    fp16_int8_times = time_int8_fp16(card)
    mark("21(a)")
    serve_fp16(card, fp16_runs, fwd_times["bf16_rates"])
    mark("21(b)")
    gen21 = torch.Generator(device="cuda").manual_seed(216)
    check_fp16_train_paths(gen21)
    _, model21 = train_fp16_full_depth(gen21, card, fp16_runs)
    mark("21(c)")
    check_remat_policies(gen21, card)
    mark("21(d)")
    check_adan(model21, card)
    del model21
    mark("21(e)")
    # 16 micro-steps of depth 2 over the three runs, #2 twice per layer in
    # each; validation's forwards are not counted in advance
    with fp16_run(fp16_runs, "21(f) cli.train", (None, 16 * 2 * 2, 0, 0)):
        check_fp16_cli(data)
    fp16_counts = {k: sum(run[k] for run in fp16_runs.values()) for k in FP16_KERNELS}
    log(f"21 fp16 launches over its main-path runs ({', '.join(fp16_runs)}): #1 "
        f"{fp16_counts['fwd']}, #2 {fp16_counts['bwd']}, int8 GEMM {fp16_counts['gemm']}, "
        f"quantize {fp16_counts['quantize']} (golden cosine "
        + ", ".join(f"{k} {v:.6f}" for k, v in golden16.items())
        + f"); the phase took {time.time() - t21:.1f} s")
    mark("21(f)")

    # 22. detection in fp16 and int8 serving of the vision trunks: the fp16
    # arms of #4-#6 alone against their plain versions and in turns with the
    # bf16 kernels and SDPA in fp16 (22(a)); then, each run's launches
    # counted from 0: the depth-40 detector in fp16 (22(b)), int8 detection
    # (22(d)), 12(b) in fp16 and the depth-40 recipe through Trainer with
    # common.fp16 (22(c)), int8 segmentation and video (22(e))
    t22 = time.time()
    gen22 = torch.Generator(device="cuda").manual_seed(221)
    det16_fwd_err = check_det_kernel(gen22, (torch.float16,), "22(a)")
    det16_bwd_err = check_det_bwd_kernel(gen22, (torch.float16,), "22(a)")
    det16_times = time_det_fp16(card)
    mark("22(a)")
    runs22 = {}
    det = build_detector(40)
    inputs = detector_inputs(gen22)
    det16 = copy.deepcopy(det).half()
    with phase22_run(runs22, "22(b) fp16 detector", {"det_fwd": 40}):
        compare_detector_paths(det16, inputs, 0.999, "22(b) fp16 depth 40")
    del det16
    mark("22(b)")
    serve_det_int8(det.bfloat16(), inputs, card, runs22)
    vision_int8 = time_vision_int8(card)
    del det, inputs
    torch.cuda.empty_cache()
    mark("22(d)")
    check_det_train_paths(None, ("fp16",), "22(c)", det_batch4, det_grads32)
    del det_batch4, det_grads32
    det_fp16_train(det_config(["lr_scheduler.warmup_updates=0", "common.fp16=true"]),
                   det_train["batch"], card, det_train["pallas"]["ms"], runs22)
    mark("22(c)")
    serve_seg_video_int8(card, runs22)
    counts22 = {k: sum(run[k] for run in runs22.values()) for k in PHASE22_KERNELS}
    # #4 and #5/#6 launch in fp16 in 22(b) and 22(c); 22(d)'s int8 trunk runs #4 in bf16
    det16_launches = {k: sum(run[k] for name, run in runs22.items() if name.startswith(
        ("22(b)", "22(c)"))) for k in ("det_fwd", "det_bwd")}
    det_bf16_22 = counts22["det_fwd"] - det16_launches["det_fwd"]
    log(f"22 launches over its main-path runs ({', '.join(runs22)}): #4 fp16 "
        f"{det16_launches['det_fwd']}, #4 bf16 {det_bf16_22}, #5/#6 fp16 "
        f"{det16_launches['det_bwd']}, int8 GEMM {counts22['gemm']}, quantize "
        f"{counts22['quantize']}; the phase took {time.time() - t22:.1f} s")
    mark("22(e)")

    # 23. data parallelism and FSDP: the retrieval and detection steps
    # FSDP-wrapped over a one-rank NCCL group against the unwrapped trainer,
    # each run's launches counted from 0 and held to the other's (23(a),
    # 23(b)); then the torchrun launch of cli.train against the same argv
    # without it, and its bundle resumed in one process (23(c))
    t23 = time.time()
    gen23 = torch.Generator(device="cuda").manual_seed(230)
    shard_a = train_sharded(gen23, card)
    mark("23(a)")
    shard_b = train_det_sharded(gen23, card)
    mark("23(b)")
    shard_c = check_torchrun_cli(data, card, torchrun)
    par_fwd = sum(shard_a[k]["launches"][0] for k in ("fsdp", "plain")) + shard_c["launches"][0]
    par_bwd = sum(shard_a[k]["launches"][1] for k in ("fsdp", "plain")) + shard_c["launches"][1]
    par_det_fwd = sum(shard_b[k]["launches"][0] for k in ("fsdp", "plain"))
    par_det_bwd = sum(shard_b[k]["launches"][1] for k in ("fsdp", "plain"))
    log(f"23 launches over its runs: #1 {par_fwd}, #2 {par_bwd}, #4 {par_det_fwd}, #5/#6 "
        f"{par_det_bwd}; the phase took {time.time() - t23:.1f} s")
    mark("23(c)")

    # 24. model parallelism on one card: #1/#2 on every TP rank's heads at
    # tp = 2, 4, 8 against the unsharded call and the plain version (24(a));
    # the ring's step functions for every (rank, step) at sp = 2, 4 against
    # #1/#2 on the whole sequence (24(b)); the pipeline's stage split and
    # its route over a one-rank NCCL group against the serial stack, the
    # route's launches counted from 0 (24(c))
    t24 = time.time()
    tp_fwd_rows, tp_bwd_rows, tp_launches = check_tp_heads(card)
    fwd_times["shapes"].update(tp_fwd_rows)
    bwd_times["shapes"].update(tp_bwd_rows)
    mark("24(a)")
    check_ring_steps(card)
    mark("24(b)")
    pipe_fwd, pipe_bwd = check_pipeline_split(gen, card)
    log(f"24 launches: #1 {tp_launches[0]}, #2 {tp_launches[1]} on the TP ranks' heads (checks); "
        f"#1 {pipe_fwd}, #2 {pipe_bwd} in the pipeline route's two runs; the phase took "
        f"{time.time() - t24:.1f} s")
    mark("24(c)")

    imported = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "one_peace_tpu" or m.startswith("one_peace_tpu."))
    if imported:
        raise RuntimeError(f"the port imported jax or the JAX package: {imported[:5]}")

    def entry(name, replaces, launches, max_abs_err, times, source=None):
        return {"name": name, "route": "cuda",
                "source": f"one_peace_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                **{key: times[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "shapes") if key in times}}

    def with_shapes(rows: dict) -> dict:
        """The first shape's numbers, and every shape's under "shapes"."""
        return {**next(iter(rows.values())), "shapes": rows}

    gemm = with_shapes({f"(M, K, N) = {shape}": int8_times[shape] for shape in FFN_SHAPES})
    quantize = entry("int8_quantize_rows", "one_peace_tpu/ops/quant.py:46",
                     int8_launches["quantize"] + cls_int8["quantize"], int8_worst["quantize"],
                     with_shapes({f"(M, K) = {shape}": int8_times[shape]
                                  for shape in ((65792, 1536), (65792, 6144))}),
                     source="int8_matmul")
    log(json.dumps({"kernels": [
        entry("flash_attention_fwd", "one_peace_tpu/ops/flash_attention.py:239",
              embed_launches + fwd_train + cli_fwd + cls_fwd + pre_fwd + seg_fwd + seg_train_fwd
              + vid_fwd + rest_fwd + par_fwd + pipe_fwd, worst, fwd_times),
        entry("flash_attention_bwd", "one_peace_tpu/ops/flash_attention.py:409",
              bwd_train + cli_bwd + cls_bwd + pre_bwd + seg_train_bwd + vid_bwd + rest_bwd
              + par_bwd + pipe_bwd, bwd_worst, bwd_times),
        entry("int8_matmul", "one_peace_tpu/ops/quant_pallas.py:75",
              int8_launches["gemm"] + cls_int8["gemm"], int8_worst["gemm"], gemm),
        quantize,
        entry("flash_attention_fwd (fp16)", "one_peace_tpu/ops/flash_attention.py:239",
              fp16_counts["fwd"], fp16_fwd_err, with_shapes(fp16_fwd_rows),
              source="flash_attention_fwd"),
        entry("flash_attention_bwd (fp16)", "one_peace_tpu/ops/flash_attention.py:409",
              fp16_counts["bwd"], fp16_bwd_err, with_shapes(fp16_bwd_rows),
              source="flash_attention_bwd"),
        entry("int8_matmul (fp16)", "one_peace_tpu/ops/quant_pallas.py:75", fp16_counts["gemm"],
              fp16_int8_worst["gemm"], with_shapes({f"(M, K, N) = {shape}": fp16_int8_times[shape]
                                                    for shape in FFN_SHAPES}),
              source="int8_matmul"),
        entry("int8_quantize_rows (fp16)", "one_peace_tpu/ops/quant.py:46",
              fp16_counts["quantize"], fp16_int8_worst["quantize"],
              with_shapes({f"(M, K) = {shape}": fp16_int8_times[shape]
                           for shape in ((65792, 1536), (65792, 6144))}),
              source="int8_matmul"),
        entry("det_attention_fwd", "one_peace_tpu/ops/det_attention.py:277",
              det_launches + det_fwd_train + coco_fwd + det_bf16_22 + par_det_fwd, det_worst,
              det_times["global"]),
        entry("det_attention_bwd_dq", "one_peace_tpu/ops/det_attention.py:618",
              det_bwd_train + coco_bwd + par_det_bwd, det_bwd_worst["dq"],
              det_bwd_times["global"]["dq"], source="det_attention_bwd"),
        entry("det_attention_bwd_dkv", "one_peace_tpu/ops/det_attention.py:642",
              det_bwd_train + coco_bwd + par_det_bwd, det_bwd_worst["dkv"],
              det_bwd_times["global"]["dkv"], source="det_attention_bwd"),
        entry("det_attention_fwd (fp16)", "one_peace_tpu/ops/det_attention.py:277",
              det16_launches["det_fwd"], det16_fwd_err, with_shapes(det16_times["fwd"]),
              source="det_attention_fwd"),
        entry("det_attention_bwd_dq (fp16)", "one_peace_tpu/ops/det_attention.py:618",
              det16_launches["det_bwd"], det16_bwd_err["dq"], with_shapes(det16_times["dq"]),
              source="det_attention_bwd"),
        entry("det_attention_bwd_dkv (fp16)", "one_peace_tpu/ops/det_attention.py:642",
              det16_launches["det_bwd"], det16_bwd_err["dkv"], with_shapes(det16_times["dkv"]),
              source="det_attention_bwd"),
        entry("int8_matmul (vision trunks)", "one_peace_tpu/ops/quant_pallas.py:75",
              counts22["gemm"], vision_int8["worst"]["gemm"], with_shapes(vision_int8["gemm"]),
              source="int8_matmul"),
        entry("int8_quantize_rows (vision trunks)", "one_peace_tpu/ops/quant.py:46",
              counts22["quantize"], vision_int8["worst"]["quantize"],
              with_shapes(vision_int8["quantize"]),
              source="int8_matmul")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
