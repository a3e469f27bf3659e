"""Batch embedding extraction (counterpart of ``one_peace_tpu/cli/embed.py``).

Reads inputs (texts file / image paths / audio paths), embeds them with a
checkpoint through the hub API in fixed-size batches on ``--device``, and
writes an ``.npz`` of L2-normalized fp32 embeddings.

  python -m one_peace_tpu_torch.cli.embed --path one-peace.pt \\
      --texts captions.txt --images imgs/*.JPEG --audios clips/*.flac \\
      --output embeddings.npz [--batch-size 128] [--dtype bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def _batched(items: List, n: int):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", required=True)
    parser.add_argument("--texts", default=None, help="file with one text per line")
    parser.add_argument("--images", nargs="*", default=[])
    parser.add_argument("--audios", nargs="*", default=[])
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--dtype", default="bf16", choices=["float32", "bf16"])
    parser.add_argument("--device", default="cuda", help="torch device of the model")
    parser.add_argument("--patch-image-size", type=int, default=None,
                        help="override the image resolution (default: the "
                             "YAML config's task.patch_image_size, else 256)")
    parser.add_argument("--config", default=None,
                        help="optional YAML with model/task overrides")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from one_peace_tpu.core.config import TaskConfig, load_config

    from ..hub import from_pretrained

    model_cfg = None
    task_cfg = TaskConfig(patch_image_size=args.patch_image_size or 256)
    if args.config or args.overrides:
        cfg = load_config(args.config, args.overrides)
        model_cfg = cfg.model
        # the flag only overrides when passed
        if args.patch_image_size is not None:
            cfg.task.patch_image_size = args.patch_image_size
        # the rel-pos grid must match the requested resolution
        cfg.model.encoder.image_adapter.rel_bucket_size = cfg.task.patch_image_size // 16
        task_cfg = cfg.task
    hub = from_pretrained(args.path, dtype=args.dtype, task_cfg=task_cfg,
                          model_cfg=model_cfg, device=args.device)
    out = {}
    bs = args.batch_size

    if args.texts:
        with open(args.texts) as fh:
            texts = [line.rstrip("\n") for line in fh if line.strip()]
        embs = []
        t0 = time.time()
        max_len = max(len(hub.tokenizer.encode(t)) for t in texts)
        for batch in _batched(texts, bs):
            embs.append(_host(hub.extract_text_features(hub.process_text(batch, pad_to=max_len))))
        out["text"] = np.concatenate(embs)[: len(texts)]
        print(f"texts: {len(texts)} in {time.time()-t0:.1f}s", file=sys.stderr)

    if args.images:
        embs = []
        t0 = time.time()
        for batch in _batched(args.images, bs):
            embs.append(_host(hub.extract_image_features(hub.process_image(batch))))
        out["image"] = np.concatenate(embs)[: len(args.images)]
        print(f"images: {len(args.images)} in {time.time()-t0:.1f}s", file=sys.stderr)

    if args.audios:
        embs = []
        t0 = time.time()
        pad_to = 16000 * task_cfg.max_duration
        for batch in _batched(args.audios, bs):
            wavs, masks = hub.process_audio(batch, pad_to=pad_to)
            embs.append(_host(hub.extract_audio_features(wavs, masks)))
        out["audio"] = np.concatenate(embs)[: len(args.audios)]
        print(f"audios: {len(args.audios)} in {time.time()-t0:.1f}s", file=sys.stderr)

    np.savez(args.output, **out)
    print(f"wrote {args.output}: " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
