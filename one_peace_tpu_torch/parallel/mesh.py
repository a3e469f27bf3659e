"""Device mesh and process bootstrap (counterpart of
``one_peace_tpu/parallel/mesh.py``).

The JAX package drives its whole mesh from one process; here one process
drives one card, started by ``torchrun``, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those processes with the
JAX function's axes in its order: a leading ``pp`` when ``pp > 1``, then
``dp`` (replicas), ``fsdp`` (parameters and optimizer state sharded, ZeRO-3)
and ``tp`` (tensor parallelism), and a trailing ``sp`` (ring attention) when
``sp > 1``.  ``dp=-1`` absorbs the processes the other axes leave, and a
product that is not the world size is refused, as the JAX ``make_mesh``
asserts.

``make_layout`` opens the mesh and names its sub-groups (``Layout``): *data*
(``dp`` x ``fsdp``: the ranks that split the global batch), ``tp``, ``sp``
and ``pp``; it is the process's current layout from then on
(``current_layout``), which ring attention and the data helpers read.
``check_split`` refuses a model the layout cannot split.

``init_distributed`` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), sets the
card to ``LOCAL_RANK`` and opens NCCL, or gloo when the caller asks for the
CPU.  Without ``torchrun`` (no ``WORLD_SIZE``) the world is one process and
nothing is opened.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


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


def check_split(encoders, tp: int = 1, pp: int = 1) -> None:
    """Raise ``ValueError`` naming the divisibility a layout needs of a
    model's encoder configs ``encoders`` (the first one is the pipelined
    stack): heads and FFN width by ``tp``, the first stack's depth by
    ``pp``.  The JAX package falls back to XLA's materialising path where
    they do not divide; the port does not split such a model."""
    for i, enc in enumerate(encoders):
        if tp > 1 and enc.attention_heads % tp:
            raise ValueError(f"distributed.tp={tp} does not divide the {enc.attention_heads} "
                             f"attention heads: tensor parallelism splits the heads")
        if tp > 1 and enc.ffn_embed_dim % tp:
            raise ValueError(f"distributed.tp={tp} does not divide the FFN width "
                             f"{enc.ffn_embed_dim}: tensor parallelism splits it")
        if i == 0 and pp > 1 and enc.layers % pp:
            raise ValueError(f"distributed.pp={pp} does not divide the encoder's {enc.layers} "
                             f"layers: each pipeline stage holds an equal share")


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
              device_type: str = "cuda"):
    """The ``DeviceMesh`` over the open process group, or None without one
    (after the same check against a world of one process)."""
    shape, names = mesh_shape(dp, fsdp, tp, pp, sp, world_size())
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_from_config(dcfg, device: torch.device):
    """``make_mesh`` from a config's ``distributed`` section."""
    return make_mesh(dcfg.dp, dcfg.fsdp, dcfg.tp, dcfg.pp, dcfg.sp, device_type=device.type)


class Layout:
    """The mesh and this process's place in it: for each of ``data``,
    ``tp``, ``sp`` and ``pp`` its process group (None where the axis has
    one process), its global ranks in axis order, this process's index
    among them and their count."""

    def __init__(self, mesh, groups: Dict[str, Optional[object]], ranks: Dict[str, List[int]]):
        self.mesh = mesh
        self.groups = groups
        self.ranks = ranks
        me = dist.get_rank()
        self.index = {k: r.index(me) for k, r in ranks.items()}

    def size(self, axis: str) -> int:
        return len(self.ranks[axis])

    def group(self, axis: str):
        return self.groups[axis]

    def rank(self, axis: str) -> int:
        return self.index[axis]


_LAYOUT: List[Optional[Layout]] = [None]


def current_layout() -> Optional[Layout]:
    """The layout ``make_layout`` opened last, or None."""
    return _LAYOUT[0] if dist.is_initialized() else None


def set_layout(layout: Optional[Layout]) -> None:
    _LAYOUT[0] = layout


def make_layout(dcfg, device: torch.device) -> Optional[Layout]:
    """``mesh_from_config`` with its named sub-groups, made the current
    layout; None without a process group.  Every process of the world calls
    it (the data groups are opened by all of them, in one order)."""
    mesh = mesh_from_config(dcfg, device)
    if mesh is None:
        return None
    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh  # global ranks by mesh coordinate
    coord = mesh.get_coordinate()
    groups, ranks = {}, {}
    for axis in ("tp", "sp", "pp"):
        if axis in names:
            i = names.index(axis)
            index = list(coord)
            index[i] = slice(None)
            ranks[axis] = grid[tuple(index)].flatten().tolist()
            groups[axis] = mesh.get_group(axis) if len(ranks[axis]) > 1 else None
        else:
            ranks[axis], groups[axis] = [dist.get_rank()], None
    # the data ranks: every (dp, fsdp) coordinate at this process's others
    di, fi = names.index("dp"), names.index("fsdp")
    others = [i for i in range(len(names)) if i not in (di, fi)]
    flat = grid.permute(*others, di, fi).reshape(-1, grid.shape[di] * grid.shape[fi])
    world = dist.get_world_size()
    for row in flat.tolist():  # every process opens every data group, in order
        group = dist.new_group(row) if 1 < len(row) < world else None
        if dist.get_rank() in row:
            ranks["data"], groups["data"] = row, group
    if len(ranks["data"]) == world > 1:
        groups["data"] = dist.group.WORLD
    layout = Layout(mesh, groups, ranks)
    set_layout(layout)
    return layout


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
    set_layout(None)
    if _OPENED and dist.is_initialized():
        dist.destroy_process_group()
    _OPENED.clear()


def data_group():
    """The process group of the data ranks (None: the whole world, or no
    group at all)."""
    layout = current_layout()
    return None if layout is None else layout.group("data")


def data_rank_world() -> Tuple[int, int]:
    """This process's rank among the data ranks (``dp`` x ``fsdp``) and
    their count: the world's rank and size before a layout is open."""
    if not dist.is_initialized():
        return 0, 1
    layout = current_layout()
    if layout is None:
        return dist.get_rank(), dist.get_world_size()
    return layout.rank("data"), layout.size("data")


__all__ = ["AXES", "Layout", "check_split", "close_distributed", "current_layout", "data_group",
           "data_rank_world", "init_distributed", "local_device", "make_layout", "make_mesh",
           "mesh_from_config", "mesh_shape", "set_layout", "world_size"]
