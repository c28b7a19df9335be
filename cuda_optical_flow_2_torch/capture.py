"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

``captured(fn)`` wraps an entry point whose tensors are its data and whose
other arguments (configs, which are frozen dataclasses; flags; ``None``)
select the program.  On CUDA tensors each call is keyed on those arguments
by value and on each tensor's shape, dtype and device (an optional tensor
that is ``None``, as ``FlowState.flow``, is part of the key).  The first
call for a key

1. runs ``fn`` eagerly ``WARMUP`` times on a side stream, which also builds
   the kernel library outside any capture;
2. copies the arguments into static buffers;
3. captures one ``torch.cuda.CUDAGraph`` of ``fn`` under ``torch.no_grad()``
   into the graph's own private memory pool, and caches it.

Every call then copies its tensors into the static buffers on the current
stream, replays the graph and returns clones of the static outputs (as
``jax.jit`` returns fresh arrays): no caller holds a buffer that the next
replay overwrites.  Each entry keeps at most ``CACHE_SIZE`` graphs, the least
recently used dropped first, since each graph holds its pool.

``fn`` runs eagerly, with nothing captured, in two cases: on CPU
tensors (the kernels' plain versions, as every entry of the port runs
there), and when autograd records and an input requires grad (a replay
records no autograd graph, while ``jax.jit`` is transparent to
``jax.grad``; the kernels refuse such inputs as before).  An entry may add
its own rule through ``prepare`` (the spatial-TP entries run eagerly on a
mesh over several cards).  A capture or a replay that fails raises with
its key and the CUDA error; nothing falls back to the eager body.

A replay runs no Python, so the kernels' launch counters (the ``launches*``
attributes of the wrappers in ``kernels/``) would stand still.  A capture
therefore records each counter's change over the captured call and adds it
back on every replay, and sets the counters back to what they were before
its warm-up: a call counts the launches of one eager call, captured or not.
"""

from __future__ import annotations

import collections
import functools
import importlib
import inspect
import pkgutil
import time
from typing import Any, Callable

import torch

from cuda_optical_flow_2_torch import kernels

__all__ = [
    "CACHE_SIZE", "WARMUP", "Graph", "GraphCache", "captured", "clear", "graphs_captured",
    "counters", "snapshot", "delta", "add_counts", "restore",
    "flatten", "unflatten", "clone_outputs", "runs_eagerly",
]

CACHE_SIZE = 8  # graphs kept per entry
WARMUP = 2      # eager runs on a side stream before a capture

_TENSOR, _STATIC, _SEQ = "tensor", "static", "seq"
_caches: list[GraphCache] = []
_captured = 0


# --- launch counters -------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _registry() -> dict[str, tuple[Callable, str]]:
    found = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for fname, obj in sorted(vars(mod).items()):
            if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
                for attr, value in sorted(vars(obj).items()):
                    if attr.startswith("launches") and isinstance(value, int):
                        found[f"{info.name}.{fname}.{attr}"] = (obj, attr)
    return found


def counters() -> list[str]:
    """The name (``module.wrapper.attribute``) of every launch counter in
    ``kernels/``: the int attributes named ``launches*`` of the functions
    each module defines."""
    return list(_registry())


def snapshot() -> dict[str, int]:
    """Every launch counter's value."""
    return {name: getattr(obj, attr) for name, (obj, attr) in _registry().items()}


def delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    """The counters that changed from ``before`` to ``after``, by how much."""
    return {name: after[name] - before[name] for name in after if after[name] != before[name]}


def add_counts(change: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``change`` to the counters (a replay's launches)."""
    registry = _registry()
    for name, n in change.items():
        obj, attr = registry[name]
        setattr(obj, attr, getattr(obj, attr) + n * times)


def restore(values: dict[str, int]) -> None:
    """Set the counters to a :func:`snapshot`."""
    registry = _registry()
    for name, n in values.items():
        obj, attr = registry[name]
        setattr(obj, attr, n)


# --- arguments and outputs -------------------------------------------------


def flatten(tree) -> tuple[tuple, list[torch.Tensor]]:
    """(a hashable spec of ``tree``, its tensors in order).

    The spec holds each tensor's shape, dtype and device, the type and
    length of each tuple or list (a NamedTuple such as ``FlowState``
    included), and every other leaf (a config, a flag, ``None``) by type and
    value: it is the key of a capture."""
    tensors: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return (_TENSOR, tuple(x.shape), x.dtype, x.device)
        if isinstance(x, (tuple, list)):
            return (_SEQ, type(x), tuple(walk(v) for v in x))
        try:
            hash(x)
        except TypeError:
            raise TypeError(
                f"the non-tensor arguments of a captured entry must be hashable (a frozen "
                f"config), got {type(x).__name__}"
            ) from None
        return (_STATIC, type(x), x)

    return walk(tree), tensors


def unflatten(spec: tuple, tensors) -> Any:
    """The tree of ``spec`` with ``tensors`` in its tensor leaves."""
    it = iter(tensors)

    def build(s):
        if s[0] == _TENSOR:
            return next(it)
        if s[0] == _STATIC:
            return s[2]
        items = [build(c) for c in s[2]]
        return s[1](*items) if hasattr(s[1], "_fields") else s[1](items)

    return build(spec)


def clone_outputs(tree) -> Any:
    """``tree`` with each distinct tensor cloned once (a tensor that appears
    twice, as a warm step's flow in its state, stays one tensor)."""
    spec, tensors = flatten(tree)
    clones: dict[int, torch.Tensor] = {}
    for t in tensors:
        if id(t) not in clones:
            clones[id(t)] = t.clone()
    return unflatten(spec, [clones[id(t)] for t in tensors])


def runs_eagerly(tensors) -> bool:
    """Whether a call on ``tensors`` runs its entry eagerly: none of them is
    a CUDA tensor, or autograd records and one of them requires grad."""
    if not any(t.is_cuda for t in tensors):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# --- graphs ----------------------------------------------------------------


class Graph:
    """One captured call of ``body(*inputs)`` on ``device``.

    With ``copy`` the inputs are copied into static buffers of the graph,
    which :meth:`replay` refills; without it they are used as they are
    (buffers of another graph that replays first).  ``name`` and ``key``
    go into every error.  ``outputs`` are the static outputs, ``delta`` the
    counters' change over the captured call, ``seconds`` the warm-up and
    capture time, ``replays`` the replays so far.

    The CUDA work is in three methods (:meth:`_warm_up`, :meth:`_capture`,
    :meth:`_launch`); the bookkeeping around them (buffers, counters,
    errors) is this class's on any device."""

    def __init__(self, body: Callable, inputs, device: torch.device, name: str, key,
                 copy: bool = True):
        global _captured
        self.name, self.key, self.device = name, key, device
        self.inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs] if copy \
            else list(inputs)
        before = snapshot()
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                self._warm_up(body)
                start = snapshot()
                try:
                    self.outputs = self._capture(body)
                except Exception as exc:
                    raise RuntimeError(f"capture of {name} failed for key {key}: {exc}") from exc
            self.delta = delta(start, snapshot())
        finally:
            restore(before)
        self.seconds = time.perf_counter() - t0
        self.replays = 0
        _captured += 1

    def _warm_up(self, body: Callable) -> None:
        """``WARMUP`` eager runs of the body on a side stream (the kernels
        build, the allocator settles, outside any capture)."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    body(*self.inputs)
            torch.cuda.current_stream(self.device).wait_stream(side)

    def _capture(self, body: Callable) -> Any:
        """Capture the body into ``self.graph``; returns its static outputs."""
        with torch.cuda.device(self.device):
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                return body(*self.inputs)

    def _launch(self) -> None:
        """Replay the graph on the current stream."""
        with torch.cuda.device(self.device):
            self.graph.replay()

    def replay(self, inputs=None) -> Any:
        """Copy ``inputs``, when given, into the static input buffers, replay
        on the current stream and count its launches; returns the static
        outputs, which the next replay overwrites."""
        if inputs is not None:
            for dst, src in zip(self.inputs, inputs, strict=True):
                dst.copy_(src)
        try:
            self._launch()
        except Exception as exc:
            raise RuntimeError(f"replay of {self.name} failed for key {self.key}: {exc}") from exc
        add_counts(self.delta)
        self.replays += 1
        return self.outputs


class GraphCache:
    """Key -> what one key captured, least recently used dropped first when
    more than ``CACHE_SIZE`` keys would be held (before the new capture, so
    its pool can reuse the freed memory)."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()
        _caches.append(self)

    def get(self, key, build: Callable[[], Any]) -> Any:
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        while len(self.entries) >= CACHE_SIZE:
            self.entries.popitem(last=False)
        value = self.entries[key] = build()
        return value

    def clear(self) -> None:
        self.entries.clear()


def clear() -> None:
    """Drop every cached graph of every entry (their pools go back to the
    caching allocator)."""
    for cache in _caches:
        cache.clear()


def graphs_captured() -> int:
    """Graphs captured in this process so far."""
    return _captured


def captured(fn: Callable, prepare: Callable | None = None) -> Callable:
    """``fn`` as a captured entry (module docstring).  The wrapper keeps
    ``fn`` as ``.eager``, its cache as ``.cache`` and the key of a call as
    ``.key(*args, **kwargs)``.

    ``prepare``, when given, runs on every call before the key, outside any
    graph, with the call's arguments: it returns the ``(args, kwargs)`` to
    key and run on (e.g. frames moved to the card the graph runs on, which
    a capture cannot do from pageable host memory, or arrays made tensors),
    or None for a call that runs ``fn`` eagerly on its own arguments."""
    signature = inspect.signature(fn)
    cache = GraphCache()

    def key(*args, **kwargs) -> tuple:
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        return flatten(tuple(bound.arguments.values()))

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if prepare is not None:
            prepared = prepare(*args, **kwargs)
            if prepared is None:
                return fn(*args, **kwargs)
            args, kwargs = prepared
        spec, tensors = key(*args, **kwargs)
        if runs_eagerly(tensors):
            return fn(*args, **kwargs)
        device = next((t.device for t in tensors if t.is_cuda), tensors[0].device)

        def body(*static):
            return fn(*unflatten(spec, static))

        graph = cache.get(spec, lambda: Graph(body, tensors, device, fn.__qualname__, spec))
        return clone_outputs(graph.replay(tensors))

    call.eager = fn
    call.cache = cache
    call.key = lambda *args, **kwargs: key(*args, **kwargs)[0]
    return call
