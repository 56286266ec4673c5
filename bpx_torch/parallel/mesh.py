"""The process group and the (data, fsdp, tensor) device mesh (counterpart:
``bpx/parallel/mesh.py``).

The JAX package runs one process over every device it sees and builds its
mesh from ``jax.devices()``.  The port runs one process per card, as
``torchrun`` starts them: :func:`initialize_distributed` joins the
process group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), and :func:`make_mesh` lays the world out as the
``(data, fsdp, tensor)`` mesh of a :class:`~bpx_torch.config.MeshConfig`
with ``init_device_mesh``.

Two pieces of the JAX package have no counterpart here:

* ``mesh_scoped``, which runs a jitted step under an ambient mesh so that
  the model's GSPMD pins resolve against it: the port is eager, each rank
  runs its own part of the step, and there is no ambient mesh to trace
  under (``sharding.py`` says where the collectives go instead);
* the multi-host hybrid mesh (``create_hybrid_device_mesh``, DCN on the
  data axis): torchrun gives every card of every host its own rank, and
  the mesh's rank order already keeps ``data`` outermost.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from bpx_torch.config import MeshConfig

DIM_NAMES = ("data", "fsdp", "tensor")


def env_world_size() -> int:
    """The world torchrun started (``WORLD_SIZE``), 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    """The process group's size, or torchrun's world before it starts."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return env_world_size()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def local_rank() -> int:
    """The card of this process on its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device_type: str = "cuda",
                           init_method: Optional[str] = None,
                           world: Optional[int] = None,
                           rank_: Optional[int] = None,
                           timeout_s: float = 600.0) -> int:
    """Join the process group (NCCL for ``cuda``, gloo for ``cpu``) and
    return the world size.  Without arguments, from torchrun's environment
    (``env://``); a test passes an ``init_method`` such as a ``file://``
    store with ``world`` and ``rank_``.  At a world of 1 without an
    ``init_method`` it does nothing and returns 1; a group already
    started is kept.  For ``cuda`` each rank takes card ``LOCAL_RANK``."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = env_world_size() if world is None else world
    if world <= 1 and init_method is None:
        return 1
    rank_ = int(os.environ.get("RANK", "0")) if rank_ is None else rank_
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
        kw["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=init_method or "env://",
        world_size=world, rank=rank_,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return world


def mesh_shape(config: MeshConfig, world: int) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) for ``world`` ranks; ``data == -1`` absorbs
    the remainder.  A layout that does not divide the world raises, as the
    JAX package's asserts do."""
    data, fsdp, tensor = config.data, config.fsdp, config.tensor
    if fsdp < 1 or tensor < 1 or data == 0 or data < -1:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor}: sizes must be >= 1 "
                         f"(data -1 for the remainder)")
    if data == -1:
        if world % (fsdp * tensor):
            raise ValueError(f"{world} ranks not divisible by "
                             f"fsdp*tensor={fsdp * tensor}")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {world} ranks")
    return data, fsdp, tensor


def make_mesh(config: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The ``(data, fsdp, tensor)`` DeviceMesh over the process group's
    ranks (``init_device_mesh``; rank r at coordinates in row-major
    order, so ``tensor`` is innermost)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = mesh_shape(config, world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=DIM_NAMES)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
