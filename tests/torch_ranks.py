"""Several processes of the port over gloo on the CPU, for the tests of data
parallelism and FSDP.

``run_ranks(world, fn, *args, tmp_path=...)`` spawns ``world`` processes;
each opens a gloo group over a ``FileStore`` under ``tmp_path`` (no port to
race for under xdist) with a timeout, caps torch at one thread, runs
``fn(rank, world, *args)`` and writes what it returns to ``tmp_path``.  The
parent waits ``timeout`` seconds at most for all of them, kills what is
left, and raises if a rank failed or hung, so that a collective waiting for
a dead rank fails its own test instead of the suite's clock.  ``fn`` must be
importable by name (a module-level function), and this module imports
nothing of JAX, so the ranks start quickly.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 120


def _entry(rank, world, store_path, out_dir, fn, args):
    torch.set_num_threads(1)
    status = {"ok": False}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        status = {"ok": True, "result": fn(rank, world, *args)}
    except BaseException:  # noqa: BLE001 - reported to the parent
        status = {"ok": False, "error": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(status, fh)
        if dist.is_initialized() and status["ok"]:
            dist.destroy_process_group()


def run_ranks(world: int, fn, *args, tmp_path, timeout: float = 150.0):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results in
    rank order."""
    out_dir = tempfile.mkdtemp(prefix=f"ranks_{fn.__name__}_{world}_", dir=str(tmp_path))
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, store, out_dir, fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for p in procs:
        left = (deadline - datetime.datetime.now()).total_seconds()
        p.join(max(left, 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    results, errors = [], []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(path, "rb") as fh:
            status = pickle.load(fh)
        if not status["ok"]:
            errors.append(f"rank {r}:\n{status['error']}")
        else:
            results.append(status["result"])
    if hung:
        errors.insert(0, f"ranks {hung} did not finish within {timeout} s")
    if errors:
        raise AssertionError("\n".join(errors))
    return results
