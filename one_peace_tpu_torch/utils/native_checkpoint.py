"""Checkpoints (counterpart of ``one_peace_tpu/utils/native_checkpoint.py``).

Two formats:

- **Parameter exports**, ``save_params`` / ``load_params``: the JAX
  package's flat ``.npz`` layout exactly -- the tree's keys joined with
  "/", bf16 leaves stored as uint16 bit views and listed in
  ``__bf16_keys__``, an optional JSON ``__metadata__``.  The port writes
  the JAX package's tree (``utils/checkpoint.params_to_jax``), so either
  package reads what the other wrote.
- **Train-state bundles**, ``save_train_state`` / ``restore_train_state``:
  ``step_<n>/state.pt`` under the run's directory, one ``torch.save`` of a
  host-side state (``Trainer.state_dict`` copies every tensor to the host).
  The bundle is not an orbax checkpoint: the JAX package cannot read it,
  nor the port an orbax directory.  The write runs on one background writer
  thread with one save in flight, as orbax's async save does: a bundle is
  written under ``step_<n>.partial`` and renamed when complete, and
  ``wait_for_saves`` joins the writer.

Retention follows the JAX package: the newest ``keep`` bundles stay
(``_prune_old``), and ``save_best_k`` keeps the k best parameter exports
under the same file names (``checkpoint.best_{key}_{value:.4f}.step{N}.npz``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        # only a CONTIGUOUS 0..n-1 digit key set round-trips a sequence
        if (keys and all(k.isdigit() for k in keys)
                and sorted(int(k) for k in keys) == list(range(len(keys)))):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, params, metadata: Optional[Dict] = None) -> None:
    """Flat .npz export of a parameter tree whose leaves are numpy arrays or
    tensors; bf16 leaves are stored as uint16 bit views plus a key
    manifest, as the JAX package stores them."""
    flat = {}
    bf16_keys = []
    for k, v in _flatten(params).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                bf16_keys.append(k)
                v = v.view(torch.int16).numpy().view(np.uint16)
            else:
                v = v.numpy()
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":
            bf16_keys.append(k)
            arr = arr.view(np.uint16)
        flat[k] = arr
    if bf16_keys:
        flat["__bf16_keys__"] = np.frombuffer(
            json.dumps(bf16_keys).encode(), dtype=np.uint8)
    if metadata is not None:
        flat["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str):
    """The parameter tree of a flat ``.npz`` export, its leaves tensors on
    the host (bf16 ones bf16 again).  ``utils/checkpoint.params_from_jax``
    turns it into a ``state_dict``."""
    special = ("__metadata__", "__bf16_keys__")
    with np.load(path) as data:
        bf16_keys = (set(json.loads(data["__bf16_keys__"].tobytes()))
                     if "__bf16_keys__" in data.files else set())
        flat = {}
        for k in data.files:
            if k in special:
                continue
            t = torch.from_numpy(np.array(data[k]))
            flat[k] = t.view(torch.bfloat16) if k in bf16_keys else t
    return _unflatten(flat)


def load_metadata(path: str) -> Optional[Dict]:
    with np.load(path) as data:
        if "__metadata__" in data.files:
            return json.loads(bytes(data["__metadata__"]).decode())
    return None


# ---------------------------------------------------------------------------
# Train-state bundles
# ---------------------------------------------------------------------------


class _Writer:
    """One background thread writing one bundle at a time."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None

    def wait(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.error is not None:
            error, self.error = self.error, None
            raise RuntimeError("a checkpoint save failed") from error

    def start(self, fn) -> None:
        def run():
            try:
                fn()
            except Exception as e:  # raised in the caller's thread by the next wait()
                self.error = e

        self.thread = threading.Thread(target=run, name="checkpoint-writer", daemon=False)
        self.thread.start()


_WRITER = _Writer()


def save_train_state(ckpt_dir: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    """Save the train-state bundle ``state`` (host tensors and Python
    values) as ``step_<step>/state.pt``, keeping the newest ``keep``.

    Returns once the writer thread has the bundle; the write overlaps the
    next train steps.  A second save first waits for the one in flight.
    Call :func:`wait_for_saves` before reading the directory or exiting."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    _WRITER.wait()  # one save in flight at a time

    def write():
        partial = path + ".partial"
        shutil.rmtree(partial, ignore_errors=True)
        os.makedirs(partial)
        torch.save(state, os.path.join(partial, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(partial, path)
        _prune_old(ckpt_dir, keep)

    _WRITER.start(write)
    return path


def wait_for_saves() -> None:
    """Block until the save in flight, if any, is on disk."""
    _WRITER.wait()


def _steps(ckpt_dir: str) -> list:
    return sorted(int(n[5:]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and n[5:].isdigit())


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    wait_for_saves()  # an in-flight save from this process counts
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{steps[-1]}")


def restore_train_state(path: str) -> Dict[str, Any]:
    """The bundle saved under ``path`` (a ``step_<n>`` directory), its
    tensors on the host."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _prune_old(ckpt_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


_BEST_RE = re.compile(
    r"^checkpoint\.best_(?P<key>.+)_(?P<value>-?\d+(?:\.\d+)?)"
    r"\.step(?P<step>\d+)\.npz$")


def best_k_checkpoints(ckpt_dir: str, key: str) -> list:
    """[(value, step, path)] of existing k-best exports for ``key``,
    parsed from filenames (the ranking state lives in the directory itself,
    so it survives a resume; ref checkpoint_utils.py:206-238)."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = _BEST_RE.match(name)
        if m and m.group("key") == key:
            out.append((float(m.group("value")), int(m.group("step")),
                        os.path.join(ckpt_dir, name)))
    return out


def save_best_k(ckpt_dir: str, key: str, value: float, maximize: bool,
                k: int, params, step: int) -> Optional[str]:
    """Keep the k best param exports by ``key``
    (ref checkpoint_utils.py:37-189 keep_best_checkpoints): write
    ``checkpoint.best_{key}_{value}.step{N}.npz`` when the value ranks
    within the current top k, then delete exports that fell out.  Returns
    the written path, or None if the value did not rank.

    Ranking compares at the 4-decimal filename precision (what a restart
    can re-parse), so metrics within 1e-4 of the current k-th best count
    as ties and do not rank; the step suffix keeps equal-valued exports
    from different validations distinct on disk.  Non-finite values never
    rank."""
    if k <= 0 or not np.isfinite(value):
        return None
    value = round(float(value), 4)
    # rank best-first in BOTH directions; at equal values the later step
    # is the keeper (so the tie-break must be on -step, not reverse-step)
    rank_key = (lambda t: (-t[0], -t[1])) if maximize else \
        (lambda t: (t[0], -t[1]))
    ranked = sorted(best_k_checkpoints(ckpt_dir, key), key=rank_key)
    if len(ranked) >= k:
        worst = ranked[k - 1][0]
        if (value <= worst) if maximize else (value >= worst):
            return None
    path = os.path.join(
        ckpt_dir, f"checkpoint.best_{key}_{value:.4f}.step{step}.npz")
    save_params(path, params, metadata={key: float(value), "step": step})
    ranked = sorted(best_k_checkpoints(ckpt_dir, key), key=rank_key)
    for _, _, stale in ranked[k:]:
        if os.path.abspath(stale) != os.path.abspath(path):
            try:
                os.remove(stale)
            except OSError:
                pass
    return path
