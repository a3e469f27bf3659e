"""Training metrics aggregation + logging.

The port's copy of ``one_peace_tpu/core/metrics.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``), with one change: the logging
process is rank 0 of ``torch.distributed`` when a process group is set up,
and the only process otherwise.

Replaces fairseq's nested aggregation contexts over MetersDict
(ref: fairseq/logging/metrics.py:44-60, logging/meters.py:33-321):
``aggregate()`` contexts collect ``log_scalar`` calls into weighted
averages; a simple/json console writer plus JSONL, TensorBoard, W&B and Aim
sinks (each imported lazily) mirror progress_bar.py.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional


class AverageMeter:
    def __init__(self, round_digits: Optional[int] = 3):
        self.sum = 0.0
        self.count = 0.0
        self.round = round_digits

    def update(self, value: float, weight: float = 1.0):
        self.sum += float(value) * weight
        self.count += weight

    @property
    def avg(self) -> float:
        v = self.sum / self.count if self.count > 0 else 0.0
        return round(v, self.round) if self.round is not None else v


class TimeMeter:
    """items/sec (ref meters.py TimeMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()
        self.n = 0

    def update(self, n: int = 1):
        self.n += n

    @property
    def avg(self) -> float:
        dt = time.time() - self.start
        return round(self.n / dt, 2) if dt > 0 else 0.0


class MetersDict:
    def __init__(self):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()

    def log_scalar(self, key: str, value: float, weight: float = 1.0,
                   round_digits: int = 3):
        if key not in self.meters:
            self.meters[key] = AverageMeter(round_digits)
        self.meters[key].update(value, weight)

    def as_dict(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}


_AGGREGATORS: List[MetersDict] = []


@contextlib.contextmanager
def aggregate(new_root: bool = False):
    """Nested aggregation context (ref metrics.py:44-60): scalars logged
    inside flow to every active context (or only this one if new_root)."""
    agg = MetersDict()
    if new_root:
        saved, _AGGREGATORS[:] = _AGGREGATORS[:], [agg]
    else:
        _AGGREGATORS.append(agg)
    try:
        yield agg
    finally:
        if new_root:
            _AGGREGATORS[:] = saved
        else:
            _AGGREGATORS.pop()


def log_scalar(key: str, value: float, weight: float = 1.0, round_digits: int = 3):
    for agg in _AGGREGATORS:
        agg.log_scalar(key, value, weight, round_digits)


class MetricsSink:
    """A destination for scalar training/eval stats — the pluggable-sink
    interface of the reference's progress bars (ref
    logging/progress_bar.py:27-583: TensorBoard/W&B/Aim/AzureML wrappers).
    Subclasses override ``log_stats``; failures to construct a backend
    degrade to a no-op so a missing/offline service never kills a run."""

    def log_stats(self, tag: str, stats: Dict[str, float], step: int):
        raise NotImplementedError

    def close(self):
        pass


class TensorBoardSink(MetricsSink):
    """ref logging/progress_bar.py TensorboardProgressBarWrapper."""

    def __init__(self, logdir: str):
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            self._tb = None

    def log_stats(self, tag, stats, step):
        if self._tb is None:
            return
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                self._tb.add_scalar(f"{tag}/{k}", v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


class JsonlFileSink(MetricsSink):
    """Append-a-JSON-line-per-log file sink (the log_file analogue of the
    reference's json progress format — machine-readable without any
    external service, so observability survives zero-egress hosts)."""

    def __init__(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log_stats(self, tag, stats, step):
        clean = {k: v for k, v in stats.items()
                 if isinstance(v, (int, float, str))}
        self._f.write(json.dumps({"step": step, "tag": tag, **clean}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class WandbSink(MetricsSink):
    """ref logging/progress_bar.py WandBProgressBarWrapper; no-op when the
    wandb client is not installed/configured (this image has no egress)."""

    def __init__(self, project: str, run_name: str = ""):
        self._wandb = None
        try:
            import wandb  # type: ignore

            wandb.init(project=project, name=run_name or None,
                       reinit=False)
            self._wandb = wandb
        except Exception:
            self._wandb = None

    def log_stats(self, tag, stats, step):
        if self._wandb is None:
            return
        self._wandb.log({f"{tag}/{k}": v for k, v in stats.items()
                         if isinstance(v, (int, float))}, step=step)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()


class AimSink(MetricsSink):
    """ref logging/progress_bar.py AimProgressBarWrapper; no-op without
    the aim client."""

    def __init__(self, repo: str):
        self._run = None
        try:
            from aim import Run  # type: ignore

            self._run = Run(repo=repo)
        except Exception:
            self._run = None

    def log_stats(self, tag, stats, step):
        if self._run is None:
            return
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                self._run.track(v, name=k, step=step, context={"tag": tag})

    def close(self):
        if self._run is not None:
            self._run.close()


def _is_logging_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def build_sinks(common_cfg) -> List[MetricsSink]:
    """Construct the sink list from CommonConfig (tensorboard_logdir,
    log_file, wandb_project, aim_repo — the reference wires the same set
    in train.py:222-256).  Multi-process runs get sinks only on process 0
    (the reference's progress bars live on the logging rank) — otherwise
    every rank would open its own W&B run / append to the same JSONL."""
    sinks: List[MetricsSink] = []
    if not _is_logging_process():
        return sinks
    if getattr(common_cfg, "tensorboard_logdir", ""):
        sinks.append(TensorBoardSink(common_cfg.tensorboard_logdir))
    if getattr(common_cfg, "log_file", ""):
        sinks.append(JsonlFileSink(common_cfg.log_file))
    if getattr(common_cfg, "wandb_project", ""):
        sinks.append(WandbSink(common_cfg.wandb_project))
    if getattr(common_cfg, "aim_repo", ""):
        sinks.append(AimSink(common_cfg.aim_repo))
    return sinks


class ProgressLogger:
    """simple/json console logging + pluggable sinks
    (ref logging/progress_bar.py:27-583)."""

    def __init__(self, log_format: str = "simple", log_interval: int = 10,
                 tensorboard_logdir: str = "", tag: str = "train",
                 sinks: Optional[List[MetricsSink]] = None):
        self.log_format = log_format
        self.log_interval = log_interval
        self.tag = tag
        self.sinks = list(sinks) if sinks is not None else []
        if tensorboard_logdir and not any(
                isinstance(s, TensorBoardSink) for s in self.sinks):
            # same rank gate as build_sinks: on rank>0 the passed sink list
            # is empty BY DESIGN, and this fallback must not re-open a
            # writer there (N processes interleaving events in one logdir)
            if _is_logging_process():
                self.sinks.append(TensorBoardSink(tensorboard_logdir))

    def log(self, stats: Dict[str, float], step: int):
        # log_interval <= 0 disables per-step printing (a modulo by zero
        # would kill the run at the first batch)
        if self.log_interval <= 0 or step % self.log_interval != 0:
            return
        self.print(stats, step)

    def print(self, stats: Dict[str, float], step: int):
        if self.log_format == "json":
            print(json.dumps({"step": step, "tag": self.tag, **stats}),
                  file=sys.stderr, flush=True)
        else:
            body = " | ".join(f"{k} {v}" for k, v in stats.items())
            print(f"[{self.tag}] step {step} | {body}", file=sys.stderr, flush=True)
        for sink in self.sinks:
            sink.log_stats(self.tag, stats, step)

    def close(self):
        for sink in self.sinks:
            sink.close()
