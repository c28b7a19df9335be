"""Frame-pair batch sharding over a device mesh, and the mesh itself.

Counterpart of ``cuda_optical_flow_2_tpu.parallel.batching``.  JAX runs one
program over a ``jax.sharding.Mesh``; here one process drives a
:class:`Mesh`, an array of ``torch.device`` with named axes, and a sharded
tensor is a list of per-device shards.  Data parallelism needs no
collectives: :func:`sharded_flow` runs each device's slice of the batch in
turn and gathers the flows on the mesh's first device.

Captured entries, as the JAX package jits these: each device's shard
replays its family's ``pyramidal_<family>_jit`` on that device (one graph
per shard shape, on a mesh of several cards as on one), and
:func:`chunked_flow` replays one graph over its whole chunk loop, keyed on
the batch shape and ``chunk``.  Their eager bodies stay as ``.eager``; on
CPU tensors every entry runs its eager body.

A mesh may list one device more than once: ``make_mesh(devices=[cuda] * 3)``
gives three shards on one card, the counterpart of JAX's virtual CPU
devices, with real shards and real halos (``parallel/spatial.py``).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.models import _jit_entry, pyramidal_flow

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "sharded_flow",
    "sharded_pyramidal_lk",
    "chunked_flow",
]


class Mesh:
    """An n-D array of ``torch.device`` with one name per axis.

    ``devices`` is a nested sequence (or array) of devices or device
    strings; ``mesh.shape[name]`` is the size of axis ``name``, as for
    ``jax.sharding.Mesh``.  Two meshes of the same devices in the same
    layout under the same axis names are equal and hash alike, as JAX's
    meshes do: a captured entry keys a call on its mesh by value.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.vectorize(torch.device, otypes=[object])(np.array(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.devices.ndim}-D device array needs {self.devices.ndim} axis names, "
                f"got {self.axis_names}"
            )

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name``, at index 0 of the other axes."""
        ax = self.axis_names.index(axis_name)
        return list(np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)[:, 0])

    def _value(self) -> tuple:
        return self.devices.shape, tuple(self.devices.reshape(-1)), self.axis_names

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._value() == other._value()

    def __hash__(self) -> int:
        return hash(self._value())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = "batch",
    devices: Sequence | None = None,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default: all).

    ``devices`` defaults to the CUDA devices; without one this raises, so a
    mesh never falls back to the CPU unasked.  Pass ``devices`` to build a
    mesh over others, e.g. ``[torch.device("cpu")] * 8``, or over one card
    several times.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh found no CUDA device (torch.cuda.is_available() is False); pass "
                "devices= to build a mesh over others, e.g. [torch.device('cpu')] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def shard_batch(x: torch.Tensor, mesh: Mesh, axis_name: str = "batch") -> list[torch.Tensor]:
    """Split a (B, ...) tensor's leading axis over the mesh axis: one shard
    per device, each on its device."""
    devs = mesh.axis_devices(axis_name)
    if x.shape[0] % len(devs) != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by mesh axis size {len(devs)}")
    return [s.to(d) for s, d in zip(x.chunk(len(devs)), devs)]


def sharded_flow(
    prev_batch: torch.Tensor,
    next_batch: torch.Tensor,
    config,
    mesh: Mesh,
    axis_name: str = "batch",
) -> torch.Tensor:
    """Dense flow for a batch of frame pairs, sharded over ``mesh``.

    Model-generic: the config type picks the model; each shard replays the
    family's captured entry (``pyramidal_<family>_jit``) on its device.

    Args:
      prev_batch / next_batch: (B, H, W) planar grayscale; B must be divisible
        by the mesh axis size.
    Returns: (B, H, W, 2) flow on the mesh's first device.
    """
    return _sharded(_jit_entry(config), prev_batch, next_batch, config, mesh, axis_name)


def _sharded(flow_fn, prev_batch, next_batch, config, mesh: Mesh, axis_name: str):
    b = prev_batch.shape[0]
    n = mesh.shape[axis_name]
    if b % n != 0:
        raise ValueError(f"batch {b} not divisible by mesh axis size {n}")
    flows = [
        flow_fn(p, q, config)
        for p, q in zip(shard_batch(prev_batch, mesh, axis_name),
                        shard_batch(next_batch, mesh, axis_name))
    ]
    first = flows[0].device
    return torch.cat([f.to(first) for f in flows])


def _sharded_flow_eager(
    prev_batch: torch.Tensor,
    next_batch: torch.Tensor,
    config,
    mesh: Mesh,
    axis_name: str = "batch",
) -> torch.Tensor:
    """:func:`sharded_flow` with each shard through the eager
    ``models.pyramidal_flow``."""
    return _sharded(pyramidal_flow, prev_batch, next_batch, config, mesh, axis_name)


sharded_flow.eager = _sharded_flow_eager


def sharded_pyramidal_lk(
    prev_batch: torch.Tensor,
    next_batch: torch.Tensor,
    config,
    mesh: Mesh,
    axis_name: str = "batch",
) -> torch.Tensor:
    """LK-typed alias of :func:`sharded_flow` (the original batching entry)."""
    return sharded_flow(prev_batch, next_batch, config, mesh, axis_name)


sharded_pyramidal_lk.eager = _sharded_flow_eager


@captured
def chunked_flow(
    prev_batch: torch.Tensor,
    next_batch: torch.Tensor,
    config,
    chunk: int = 2,
) -> torch.Tensor:
    """Large-batch flow with the batch run in ``chunk``-pair steps on the
    frames' device (the JAX package's ``lax.map`` over sub-batches).  On
    CUDA frames one captured graph runs the whole loop (one per batch
    shape, config and ``chunk``)."""
    b = prev_batch.shape[0]
    if b % chunk != 0:
        raise ValueError(f"batch {b} not divisible by chunk {chunk}")
    return torch.cat([
        pyramidal_flow(prev_batch[i : i + chunk], next_batch[i : i + chunk], config)
        for i in range(0, b, chunk)
    ])
