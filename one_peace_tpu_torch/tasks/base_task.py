"""Task base (counterpart of ``one_peace_tpu/tasks/base_task.py``): the
tokenizer from ``bpe_dir``, TSV loading, the batch iterator, and the eval
forward.

``eval_model`` takes the role of the JAX package's ``tasks/jit_eval.py``:
an eager forward on the model's device under ``torch.inference_mode()``
with the model in eval mode (its training mode is put back after), on the
given parameters through ``torch.func.functional_call`` or on the model's
own.  Nothing is compiled, so there are no shape buckets: batches keep
their own lengths, and ``eval_compiles`` is 0.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import FrameworkConfig, TaskConfig
from ..data.collate import collate
from ..data.iterators import EpochBatchIterator, shard_iterator
from ..data.tokenizer import TextTokenizer, find_bpe_dir
from ..data.tsv import load_tables


def shard_reducers(task, split: str, num_shards: int) -> None:
    """A sharded evaluation split: the task's reducer merges the ranks'
    parts (``metrics/gather.py``); one shard, or the training split, leaves
    it alone."""
    if split != "train" and hasattr(task, "metric"):
        task.metric.num_shards = num_shards


class BaseTask:
    dataset_cls = None  # set by subclasses
    criterion_name = ""

    def __init__(self, cfg: TaskConfig, framework_cfg: Optional[FrameworkConfig] = None):
        self.cfg = cfg
        self.framework_cfg = framework_cfg
        bpe_dir = find_bpe_dir(cfg.bpe_dir or None)
        if bpe_dir is None:
            raise FileNotFoundError(
                "BPE assets not found; set task.bpe_dir or $ONE_PEACE_BPE_DIR")
        self.tokenizer = TextTokenizer(bpe_dir, max_src_length=cfg.max_src_length)
        self.datasets: Dict[str, object] = {}

    @property
    def dictionary(self):
        return self.tokenizer.dictionary

    def dataset_kwargs(self) -> Dict:
        """Per-task constructor args drawn from the task config."""
        return {
            "max_src_length": self.cfg.max_src_length,
            "patch_image_size": self.cfg.patch_image_size,
        }

    def head_kwargs(self) -> Dict:
        """The classify head this task trains and evaluates:
        ``OnePeaceClassifyModel``'s ``num_classes`` and any head argument
        that differs from its default."""
        return {"num_classes": self.cfg.num_classes}

    def audio_conv_spec(self):
        """The model's audio-frontend frame arithmetic, for the data layer's
        padding masks (ref base_task.py:65).  The fbank frontend's frame
        count, 1 + (len - n_fft) // hop, is a one-layer conv recurrence:
        ((0, n_fft, hop),)."""
        fc = self.framework_cfg
        if fc is not None:
            ad = fc.model.encoder.audio_adapter
            if getattr(ad, "frontend", "waveform") == "fbank":
                return ((0, ad.fbank_n_fft, ad.fbank_hop),)
            return tuple(tuple(layer) for layer in ad.feature_encoder_spec)
        from ..data.datasets import DEFAULT_SPEC

        return DEFAULT_SPEC

    def load_dataset(self, split: str):
        spec = self.cfg.data if split == "train" else self.cfg.valid_data
        table = load_tables(spec, self.cfg.selected_cols or None,
                            self.cfg.reader_separator)
        dataset_dir = os.path.dirname(os.path.abspath(
            spec.split(",")[0])) if spec else ""
        cls, kwargs = self.dataset_for(split)
        self.datasets[split] = cls(split, table, self.tokenizer, dataset_dir=dataset_dir,
                                   **kwargs)
        return self.datasets[split]

    def dataset_for(self, split: str):
        """(dataset class, constructor args) of ``split``; one class for
        every split unless a task says otherwise."""
        return self.dataset_cls, self.dataset_kwargs()

    def get_batch_iterator(self, split: str, batch_size: int, seed: int = 3407,
                           shard_id: int = 0, num_shards: int = 1,
                           ensure_equal_batch: bool = True,
                           skip_remainder_batch: bool = False) -> EpochBatchIterator:
        """Batches of ``batch_size`` samples, the global batch; with
        ``num_shards`` data ranks, rank ``shard_id``'s contiguous slice of
        each (``data.iterators.RankSliceIterator``), and the evaluation
        reducer merges the ranks' parts."""
        dataset = self.datasets[split]
        pad = self.tokenizer.pad
        shard_reducers(self, split, num_shards)
        return shard_iterator(EpochBatchIterator(
            dataset,
            collate_fn=lambda samples: collate(samples, pad_idx=pad),
            batch_size=batch_size,
            seed=seed,
            shuffle=(split == "train"),
            ensure_equal_batch=ensure_equal_batch,
            skip_remainder_batch=skip_remainder_batch,
        ), shard_id, num_shards)

    # evaluation hooks (overridden per task family)
    def begin_valid_epoch(self, model, params):
        pass

    def valid_step(self, model, params, batch):
        raise NotImplementedError

    def merge_results(self) -> Dict:
        raise NotImplementedError

    def eval_model(self, model, params, net_input, **kwargs):
        """``model(**net_input, **kwargs)`` on ``params`` (a name ->
        tensor dict for ``functional_call``, or None for the model's own),
        eager, under ``torch.inference_mode()`` in eval mode.  Array inputs
        move to the model's device."""
        device = next(model.parameters()).device
        net = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
               .to(device) for k, v in net_input.items()}
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                if params is None:
                    return model(**net, **kwargs)
                return torch.func.functional_call(model, params, (), {**net, **kwargs})
        finally:
            model.train(was_training)

    @property
    def eval_compiles(self) -> int:
        return 0
