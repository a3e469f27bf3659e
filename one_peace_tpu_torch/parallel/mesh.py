"""Device mesh and process bootstrap (counterpart of
``one_peace_tpu/parallel/mesh.py``).

The JAX package drives its whole mesh from one process; here one process
drives one card, started by ``torchrun``, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those processes with the
JAX function's axes in its order: ``dp`` (replicas), ``fsdp`` (parameters and
optimizer state sharded, ZeRO-3) and ``tp``, a leading ``pp`` when ``pp > 1``
and a trailing ``sp`` when ``sp > 1``.  ``dp=-1`` absorbs the processes the
other axes leave, and a product that is not the world size is refused, as
the JAX ``make_mesh`` asserts.

This slice runs the ``dp`` x ``fsdp`` layout: ``tp``, ``pp`` and ``sp``
above 1 raise ``NotImplementedError`` (the model-parallel slice ports them).

``init_distributed`` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), sets the
card to ``LOCAL_RANK`` and opens NCCL, or gloo when the caller asks for the
CPU.  Without ``torchrun`` (no ``WORLD_SIZE``) the world is one process and
nothing is opened.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")
NEXT_SLICE = "the model-parallel slice (TP, ring attention, pipeline) is not ported yet"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(dp: int = -1, fsdp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
               world: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the mesh over ``world`` processes, by the JAX
    ``make_mesh``'s rule; raises ``ValueError`` where it asserts."""
    n = world
    if dp == -1:
        if n % (pp * fsdp * tp * sp):
            raise ValueError(f"mesh pp={pp} fsdp={fsdp} tp={tp} sp={sp} does not divide "
                             f"{n} processes{_override_hint(n)}")
        dp = n // (pp * fsdp * tp * sp)
    if dp * fsdp * tp * pp * sp != n:
        raise ValueError(f"mesh pp={pp} {dp}x{fsdp}x{tp} sp={sp} != {n} processes"
                         f"{_override_hint(n)}")
    names = AXES + (("sp",) if sp > 1 else ())
    shape = (dp, fsdp, tp) + ((sp,) if sp > 1 else ())
    if pp > 1:
        return (pp,) + shape, ("pp",) + names
    return shape, names


def _override_hint(n: int) -> str:
    if n == 1:
        return ("; one process runs the recipe with distributed.fsdp=1 "
                "(and distributed.dp=-1), or launch it under torchrun")
    return f"; set distributed.dp / distributed.fsdp so that their product is {n}"


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
              device_type: str = "cuda"):
    """The ``DeviceMesh`` over the open process group, or None without one
    (after the same check against a world of one process)."""
    shape, names = mesh_shape(dp, fsdp, tp, pp, sp, world_size())
    for axis, size in (("tp", tp), ("pp", pp), ("sp", sp)):
        if size > 1:
            raise NotImplementedError(f"distributed.{axis}={size}: {NEXT_SLICE}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_from_config(dcfg, device: torch.device):
    """``make_mesh`` from a config's ``distributed`` section."""
    return make_mesh(dcfg.dp, dcfg.fsdp, dcfg.tp, dcfg.pp, dcfg.sp, device_type=device.type)


_OPENED = []  # the group init_distributed opened, for close_distributed


def init_distributed(device: str = "cuda", timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Open the process group that ``torchrun`` describes in the environment
    and return (rank, world size); (0, 1) and nothing opened without it.
    ``device`` "cuda" sets the card to ``LOCAL_RANK`` and opens NCCL; "cpu"
    opens gloo.  A collective that waits longer than ``timeout_s`` raises.
    A group the caller opened already is used as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=timeout_s)
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", rank=rank, world_size=world, timeout=timeout,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world, timeout=timeout)
    _OPENED.append(True)
    return rank, world


def local_device(device: str) -> torch.device:
    """The card of this process (``cuda:LOCAL_RANK`` under ``torchrun``), or
    ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def close_distributed() -> None:
    """Close the group ``init_distributed`` opened (not one the caller did)."""
    if _OPENED and dist.is_initialized():
        dist.destroy_process_group()
    _OPENED.clear()


def data_rank_world() -> Tuple[int, int]:
    """This process's rank among the data ranks and their count: every rank
    in the ``dp`` x ``fsdp`` layout."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


__all__ = ["AXES", "close_distributed", "data_rank_world", "init_distributed",
           "local_device", "make_mesh", "mesh_from_config", "mesh_shape", "world_size"]
