"""Multi-process scale-out on ``torch.distributed``, one process per card.

Counterpart of ``cuda_optical_flow_2_tpu.parallel.multihost``.  Within one
process the mesh APIs (``parallel/batching.py``, ``parallel/spatial.py``)
shard over that process's devices; this module adds the layer for a frame
stream that outgrows one host: the process group, a global mesh of every
process's devices, and per-process input feeding for batch (DP) sharding.
Frame pairs are independent, so DP needs no collective: no frame crosses
processes, and the group carries only what the caller adds to it.

Layout, as the JAX module orders it: the batch axis is outer and aligned
to processes, so each process feeds only its own slice
(:func:`host_local_batch`); a spatial (TP) axis stays inside one process's
devices, so every halo exchange stays on that host.

A :class:`~cuda_optical_flow_2_torch.parallel.batching.Mesh` entry is a
``torch.device`` as the process that owns it names it: the global mesh
lists every process's devices in process order, and a process computes on
its own block of them.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from cuda_optical_flow_2_torch.parallel.batching import Mesh, sharded_flow

__all__ = [
    "initialize",
    "make_global_mesh",
    "host_local_batch",
    "sharded_flow_from_local",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group (a no-op if this process already has one).

    ``coordinator_address`` is ``host:port`` of process 0 (a ``tcp://`` or
    other ``init_method`` URL is taken as it is); with no arguments the
    group reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` from the environment.  ``backend`` defaults to ``nccl`` when
    CUDA is present, else ``gloo``; pass ``"gloo"`` for processes that
    share one card (NCCL refuses two ranks on one GPU).  Under NCCL the
    process's current card becomes its own, one process per card
    (``LOCAL_RANK``, else the rank modulo this host's cards): its default
    global mesh and the group's collectives use it.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = None
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if backend == "nccl":
        torch.cuda.set_device(_own_card(dist.get_rank()))


def _own_card(rank: int) -> int:
    """The card of process ``rank`` under one process per card: the
    ``LOCAL_RANK`` a launcher such as ``torchrun`` sets, else the rank
    modulo this host's card count (ranks numbered host by host)."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % torch.cuda.device_count()


def _process() -> tuple[int, int]:
    """(process count, this process's index): (1, 0) without a group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _local_devices(devices: Sequence | None) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_global_mesh found no CUDA device (torch.cuda.is_available() is False); "
            "pass devices= to build a mesh over others, e.g. [torch.device('cpu')] * 2"
        )
    return [torch.device("cuda", torch.cuda.current_device())]


def make_global_mesh(
    batch_axis: str = "batch",
    space_axis: str | None = None,
    devices: Sequence | None = None,
) -> Mesh:
    """Global mesh over ALL processes' devices, in process order.

    ``devices`` are this process's devices (default: its current CUDA
    device, one process per card, which :func:`initialize` sets under
    NCCL); every process passes its own.  The
    batch axis spans processes (DP has no collectives); when ``space_axis``
    is given, the spatial axis is sized to one process's device count, so
    every halo exchange stays inside a process.
    """
    local = _local_devices(devices)
    world, _ = _process()
    names = [[str(d) for d in local]]
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, [str(d) for d in local])
    flat = np.array([torch.device(d) for proc in names for d in proc], dtype=object)
    if space_axis is None:
        return Mesh(flat, (batch_axis,))
    if flat.size % len(local) != 0:
        raise ValueError(
            f"{flat.size} devices not divisible by local count {len(local)}"
        )
    return Mesh(flat.reshape(-1, len(local)), (batch_axis, space_axis))


def host_local_batch(
    global_batch: int, mesh: Mesh, batch_axis: str = "batch"
) -> tuple[int, int]:
    """(this process's batch slice size, its offset) for feeding a global
    batch: each process makes only its own frame pairs."""
    n = mesh.shape[batch_axis]
    if global_batch % n != 0:
        raise ValueError(f"batch {global_batch} not divisible by {n}")
    world, rank = _process()
    per = global_batch // world
    return per, per * rank


def sharded_flow_from_local(
    local_prev,
    local_nxt,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
) -> torch.Tensor:
    """DP flow over a multi-process mesh from this process's LOCAL batch.

    The multi-process twin of ``parallel.sharded_flow``: each process
    passes only its own (B_local, H, W) frame pairs (the
    :func:`host_local_batch` slice) and gets their (B_local, H, W, 2) flow,
    computed on its block of the mesh's batch axis: the part of the global
    flow that the JAX package lets a process address.  Arrays are taken as
    float32 tensors; tensors keep their device until they are sharded.  On
    CUDA each shard replays its family's captured entry, as in
    ``sharded_flow``; no collective lies on the flow's path.
    """
    world, rank = _process()
    devs = mesh.axis_devices(batch_axis)
    if len(devs) % world != 0:
        raise ValueError(f"mesh axis {batch_axis} of {len(devs)} not divisible by {world} processes")
    k = len(devs) // world
    own = Mesh(devs[rank * k:(rank + 1) * k], (batch_axis,))
    prev = torch.as_tensor(local_prev, dtype=torch.float32)
    nxt = torch.as_tensor(local_nxt, dtype=torch.float32)
    return sharded_flow(prev, nxt, config, own, batch_axis)
