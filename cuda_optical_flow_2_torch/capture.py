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
mesh over cards that cannot reach each other's memory).  A capture or a
replay that fails raises with its key and the CUDA error; nothing falls
back to the eager body.

A call whose tensors lie on several cards (a TP entry whose row blocks
were placed on their cards) is ONE multi-device graph, as JAX's jitted
``shard_map`` is one program: the capture begins on the first card's
stream, each other card's capture stream joins it through an event, its
allocations go to a pool of that card (``torch.cuda.use_mem_pool``), and
it joins back before the capture ends.  PyTorch orders a copy between
cards against both cards' current streams with an event pair, and in the
capture those pairs become the graph's edges between the cards.  A replay
is launched on the first card's current stream after that stream waits
for every other card's current stream (where the inputs were copied in),
and every other card's stream then waits for it (its next copy-in must not
overwrite what the replay reads); successive replays of one graph are
ordered by CUDA.  This is the design the card's torch and CUDA support
with no code of our own.  The other, one graph per card linked by
external events, needs every copy between cards issued outside PyTorch
(its copy enqueues on the source card's stream behind an event from the
destination card's, which would join the two captures), and on two H100s
(torch 2.11, CUDA 12.8, ``torch.cuda.Event(external=True)``) a graph's
wait on the other card's external record ran before that card's record of
the same replay: each of 20 replays of a toy band exchange copied the
previous replay's halo.

``cond(pred, true_fn, false_fn, *operands)`` is the port's ``lax.cond``:
eagerly it runs the branch ``bool(pred)`` picks; inside a capture both
branches go into the graph as CUDA conditional nodes (``csrc/graph_cond.cu``)
and a replay runs the one that the predicate, a bool on the device, picks
there: the host reads nothing.

``captured(fn, donate_argnums=...)`` is JAX's donation: the donated
arguments are not copied into static buffers on each call.  A key whose
``fn`` returns new values of the donated arguments with their shapes (a
serving step's state) captures two graphs over two buffer sets S0 and S1:
G0 reads S0 and writes the new values into S1, G1 reads S1 and writes S0.
The call returns the set just written, so the next call passes it back and
replays the other graph with only the other arguments copied in (the
reference's pointer swap).  A donated value that is neither set is copied
into S0 once.  The buffers of a returned value are written again only once
the caller holds none of the returned tensors (nor a view of one): a value
stays valid while it is held, so every use that JAX allows still works.
When a call would write a set the caller still holds (two streams of one
key, or a value passed twice), it replays a third graph of the key that
copies everything in and clones everything out instead.

A replay runs no Python, so the kernels' launch counters (the ``launches*``
attributes of the wrappers in ``kernels/``) would stand still.  A capture
therefore records each counter's change over the captured call and adds it
back on every replay, and sets the counters back to what they were before
its warm-up: a call counts the launches of one eager call, captured or not.
A branch of a ``cond`` counts on the device instead (a pair of int64 per
cond, one add in each branch), since the host does not know which branch a
replay ran: :func:`settle` reads those pairs once and adds each branch's
launches times the replays that took it.  :func:`snapshot` and
:func:`restore` settle first.

Spans and counters.  While ``torch.profiler`` is active, every call of a
captured entry records its spans (``utils/profiling.span``, in memory, on
the profiler's clock; none otherwise): the root ``capture.call`` (attributes
``entry``, the function's ``__qualname__``, and ``path``: ``replay``,
``capture``, ``eager`` or ``plain``) and under it ``capture.key``
(``prepare``, binding, :func:`flatten`, the cache lookup and, for a donating
entry, the choice of buffer set and the held checks), ``capture.capture``
(warm-up and capture on a miss, eviction included), ``capture.copy_in`` (the
static-input copies of :meth:`Graph.replay`), ``capture.launch``
(:meth:`Graph._launch`), ``capture.clone`` (the output clones and the donated
views), ``capture.plain`` (a donating key's copy-in, clone-out graph) and
``capture.eager`` (a call that ran its body eagerly); ``capture.settle`` is
the host sync of :func:`settle`.  The counters are always on: per entry
(:class:`GraphCache`) the calls, captures, evictions, eager and plain calls;
per graph its replays, copies, ``seconds``, the conds' ``taken`` counts,
``pool_bytes`` (its private pool's, its cond branch pool's and its peer
pools' segments per card, from the allocator's snapshot once it is
captured) and ``launches`` (the counters' change over its captured call, and
per cond branch).  :func:`stats` settles once and returns them all.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import importlib
import inspect
import pkgutil
import time
import weakref
from typing import Any, Callable

import torch

from cuda_optical_flow_2_torch import kernels
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.utils.profiling import span as _span

__all__ = [
    "CACHE_SIZE", "WARMUP", "Graph", "DonatingGraphs", "GraphCache", "captured", "clear",
    "graphs_captured", "cond", "settle", "counters", "snapshot", "delta", "add_counts", "restore",
    "flatten", "unflatten", "clone_outputs", "runs_eagerly", "stats", "pool_bytes",
]

CACHE_SIZE = 8  # graphs kept per entry
WARMUP = 2      # eager runs on a side stream before a capture
CONDS = 4       # conds per captured call

_TENSOR, _STATIC, _SEQ = "tensor", "static", "seq"
_caches: list[GraphCache] = []
_captured = 0
# What a cond runs as: None (eagerly), _WARM_UP (both branches, outside any
# capture), or the Graph that is capturing (conditional nodes).
_WARM_UP = "warm-up"
_mode: contextvars.ContextVar = contextvars.ContextVar("capture_mode", default=None)
# graphs with conds replayed since the last settle()
_pending: dict[int, Graph] = {}
_branch_streams: dict[int, torch.cuda.ExternalStream] = {}
_capture_streams: dict[int, torch.cuda.Stream] = {}


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


def _counts() -> dict[str, int]:
    return {name: getattr(obj, attr) for name, (obj, attr) in _registry().items()}


def _set_counts(values: dict[str, int]) -> None:
    registry = _registry()
    for name, n in values.items():
        obj, attr = registry[name]
        setattr(obj, attr, n)


def snapshot() -> dict[str, int]:
    """Every launch counter's value, after :func:`settle`."""
    settle()
    return _counts()


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
    """Set the counters to a :func:`snapshot`, after :func:`settle` (so no
    branch replayed before counts after)."""
    settle()
    _set_counts(values)


def settle() -> None:
    """Add the launches of the ``cond`` branches that replays took since the
    last settle: wait for the device and read each such graph's taken
    counts once.  Call it before reading the counters' attributes directly
    (:func:`snapshot` and :func:`restore` do)."""
    if not _pending:
        return
    with _span("capture.settle"):
        while _pending:
            _, graph = _pending.popitem()
            graph._settle()


# --- arguments and outputs -------------------------------------------------


def _walk(x, tensors: list[torch.Tensor]) -> tuple:
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (_TENSOR, tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return (_SEQ, type(x), tuple(_walk(v, tensors) for v in x))
    try:
        hash(x)
    except TypeError:
        raise TypeError(
            f"the non-tensor arguments of a captured entry must be hashable (a frozen "
            f"config), got {type(x).__name__}"
        ) from None
    return (_STATIC, type(x), x)


def flatten(tree) -> tuple[tuple, list[torch.Tensor]]:
    """(a hashable spec of ``tree``, its tensors in order).

    The spec holds each tensor's shape, dtype and device, the type and
    length of each tuple or list (a NamedTuple such as ``FlowState``
    included), and every other leaf (a config, a flag, ``None``) by type and
    value: it is the key of a capture."""
    tensors: list[torch.Tensor] = []
    return _walk(tree, tensors), tensors


def _build_tree(s: tuple, it) -> Any:
    if s[0] == _TENSOR:
        return next(it)
    if s[0] == _STATIC:
        return s[2]
    items = [_build_tree(c, it) for c in s[2]]
    return s[1](*items) if hasattr(s[1], "_fields") else s[1](items)


def unflatten(spec: tuple, tensors) -> Any:
    """The tree of ``spec`` with ``tensors`` in its tensor leaves."""
    # module-level helpers, not nested closures: a recursive closure is a
    # reference cycle that would keep the tensors alive until the collector runs
    return _build_tree(spec, iter(tensors))


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


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are one buffer: the same memory, dtype,
    device, shape and strides."""
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype and a.device == b.device
            and a.shape == b.shape and a.stride() == b.stride())


@contextlib.contextmanager
def _as_mode(mode):
    token = _mode.set(mode)
    try:
        yield
    finally:
        _mode.reset(token)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that ``device``'s graphs are captured on, one per card.
    ``torch.cuda.graph``'s own default is one stream for the process, made
    on the card current at the first capture: a capture on another card
    then captures nothing (its body runs eagerly there, and every replay of
    the empty graph hands back the first call's outputs)."""
    stream = _capture_streams.get(device.index)
    if stream is None:
        stream = _capture_streams[device.index] = torch.cuda.Stream(device)
    return stream


def _branch_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream that ``device``'s branch bodies are captured on: one of
    its own (a pooled stream of PyTorch's may be the capturing one),
    created once, outside any capture."""
    stream = _branch_streams.get(device.index)
    if stream is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            status = _build.library().of2_stream_create(ctypes.byref(handle))
        if status != 0:
            raise RuntimeError(f"of2_stream_create: CUDA error {status}")
        stream = torch.cuda.ExternalStream(handle.value, device=device)
        _branch_streams[device.index] = stream
    return stream


# --- cond ------------------------------------------------------------------


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands) -> Any:
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``: the
    port's ``jax.lax.cond``.

    ``pred`` is a one-element bool tensor.  Eagerly the host reads it and
    runs one branch.  While a :class:`Graph` warms up, both branches run and
    the picked one's result is returned, so both have built their kernels
    before the capture.  While a Graph captures, both branches go into the
    graph as two CUDA IF nodes that a kernel sets from ``pred`` on the
    device: each replay runs one branch, and the host reads nothing.  The
    branches return tensors of the same shapes and dtypes (in a replay that
    takes the false branch, its outputs are copied into the true branch's,
    which the rest of the graph reads), and the true branch's outputs are
    tensors it made, not operands.  In a capture a cond must not sit inside
    a branch of another."""
    mode = _mode.get()
    if isinstance(mode, Graph):
        return mode._cond(pred, true_fn, false_fn, operands)
    if mode is _WARM_UP:
        if pred.is_cuda:
            _branch_stream(pred.device)
        outs = true_fn(*operands), false_fn(*operands)
        return outs[0] if bool(pred) else outs[1]
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("capture.cond inside a CUDA graph capture that capture.Graph did not "
                           "begin: the host cannot read the predicate there")
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


# --- graphs ----------------------------------------------------------------


class Graph:
    """One captured call of ``body(*inputs)`` on ``device`` and the cards
    in ``peers`` (the other cards its inputs lie on: one multi-device
    graph, module docstring).

    With ``copy`` the inputs are copied into static buffers of the graph,
    which :meth:`replay` refills; without it they are used as they are
    (buffers that the caller owns).  ``name`` and ``key`` go into every
    error.  ``outputs`` are the static outputs, ``delta`` the counters'
    change over the captured call outside its conds' branches, ``seconds``
    the warm-up and capture time, ``replays`` the replays so far, ``copied``
    the tensors copied into the static inputs so far, ``taken``, per
    cond, how many replays ran its true and its false branch (as of the
    last :func:`settle`), and ``pool_bytes`` the bytes of its pools'
    segments per card index once it was captured (:func:`pool_bytes`).
    The device counts behind ``taken`` live in a buffer made before the
    capture: memory allocated during it may be memory that earlier nodes
    of every replay write.

    The CUDA work is in six methods (:meth:`_warm_up`, :meth:`_capture`,
    :meth:`_launch`, :meth:`_pool_bytes`, and a cond's :meth:`_open_cond`
    and :meth:`_branch`);
    the bookkeeping around them (buffers, counters, conds, errors) is this
    class's on any device."""

    def __init__(self, body: Callable, inputs, device: torch.device, name: str, key,
                 copy: bool = True, peers: tuple[torch.device, ...] = ()):
        global _captured
        self.name, self.key, self.device, self.peers = name, key, device, tuple(peers)
        self.inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs] if copy \
            else list(inputs)
        self.replays = self.copied = 0
        # per cond: the replays that ran its (true, false) branch, on the device
        self._taken_device = torch.zeros((CONDS, 2), dtype=torch.int64, device=device)
        self._conds = 0
        self._branch_deltas: list[tuple[dict, dict]] = []
        self._in_branch = False
        self._pool = self._branch_pool = None  # set by a capture on the card
        self._peer_pools = []
        before = _counts()
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                with _as_mode(_WARM_UP):
                    self._warm_up(body)
                start = _counts()
                try:
                    with _as_mode(self):
                        self.outputs = self._capture(body)
                except Exception as exc:
                    raise RuntimeError(f"capture of {name} failed for key {key}: {exc}") from exc
                self._taken_device.zero_()  # the capture ran nothing
            self.delta = delta(start, _counts())
        finally:
            _set_counts(before)
        self.taken = [[0, 0] for _ in range(self._conds)]
        self.seconds = time.perf_counter() - t0
        self.pool_bytes = self._pool_bytes()
        _captured += 1

    def _warm_up(self, body: Callable) -> None:
        """``WARMUP`` eager runs of the body on a side stream of each card
        (the kernels build and load on every card, peer access is enabled,
        the allocator settles, outside any capture)."""
        cards = (self.device, *self.peers)
        sides = [torch.cuda.Stream(d) for d in cards]
        for d, side in zip(cards, sides):
            side.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            for side in sides:
                stack.enter_context(torch.cuda.stream(side))
            stack.enter_context(torch.cuda.device(self.device))
            for _ in range(WARMUP):
                body(*self.inputs)
        for d, side in zip(cards, sides):
            torch.cuda.current_stream(d).wait_stream(side)

    def _capture(self, body: Callable) -> Any:
        """Capture the body into ``self.graph``; returns its static outputs."""
        with torch.cuda.device(self.device):
            self.graph = torch.cuda.CUDAGraph()
            pool = self._pool = torch.cuda.graph_pool_handle()  # a new pool, as without one
            self._peer_pools = []
            for d in self.peers:
                torch.cuda.synchronize(d)  # a joining stream starts with nothing pending
                with torch.cuda.device(d):  # a MemPool belongs to the card current at its making
                    self._peer_pools.append(torch.cuda.MemPool())
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=_capture_stream(self.device)):
                    return self._across_peers(body)
            except Exception:
                # A capture that the CUDA runtime ended in error leaves the
                # caching allocator recording into the graph's pool, and a
                # pool released later (a cond's branch pool) then aborts the
                # process: stop the recording unless PyTorch did.
                try:
                    torch._C._cuda_endAllocateToPool(self.device.index, pool)
                except RuntimeError:
                    pass
                raise

    def _across_peers(self, body: Callable) -> Any:
        """Run the body inside the capture with every peer's capture stream
        joined to it and its memory in that card's pool."""
        if not self.peers:
            return body(*self.inputs)
        origin = torch.cuda.current_stream(self.device)
        streams = [_capture_stream(d) for d in self.peers]
        with contextlib.ExitStack() as stack:
            for d, stream, pool in zip(self.peers, streams, self._peer_pools):
                stream.wait_stream(origin)  # the fork: this card's stream joins the capture
                stack.enter_context(torch.cuda.stream(stream))
                stack.enter_context(torch.cuda.use_mem_pool(pool, d))
            stack.enter_context(torch.cuda.device(self.device))
            out = body(*self.inputs)
        for stream in streams:
            origin.wait_stream(stream)  # the join
        return out

    def _pool_bytes(self) -> dict[int, int]:
        """Bytes of the segments of this graph's pools (its private pool,
        its cond branch pool, its peer pools) per card index."""
        if self._pool is None:
            return {}
        ids = {tuple(self._pool)} | {tuple(p.id) for p in self._peer_pools}
        if self._branch_pool is not None:
            ids.add(tuple(self._branch_pool.id))
        return pool_bytes(torch.cuda.memory._snapshot()["segments"], ids)

    def _launch(self) -> None:
        """Replay the graph on the current stream, after every peer's
        current stream and before their next work."""
        with torch.cuda.device(self.device):
            origin = torch.cuda.current_stream(self.device)
            for d in self.peers:
                origin.wait_stream(torch.cuda.current_stream(d))
            self.graph.replay()
            for d in self.peers:
                torch.cuda.current_stream(d).wait_stream(origin)

    def _open_cond(self, pred: torch.Tensor) -> tuple[int, int]:
        """Capture the kernel that sets a true and a false IF handle from
        ``pred``; returns the two handles."""
        handles = (ctypes.c_ulonglong * 2)()
        with torch.cuda.device(self.device):
            if self._branch_pool is None:
                self._branch_pool = torch.cuda.MemPool()
            status = _build.library().of2_cond_open(
                pred.data_ptr(), ctypes.addressof(handles),
                torch.cuda.current_stream(self.device).cuda_stream)
        if status != 0:
            raise RuntimeError(
                f"CUDA conditional graph nodes failed (CUDA error {status}) with torch "
                f"{torch.__version__}, CUDA {torch.version.cuda}: they need CUDA 12.4 or later")
        return handles[0], handles[1]

    @contextlib.contextmanager
    def _branch(self, handle: int):
        """Capture what runs inside into the body of a new IF node on
        ``handle``: on the branch stream, its memory from the graph's branch
        pool (the graph's own pool routes the capturing stream only)."""
        stream = _branch_stream(self.device)
        _build.launch(self.device, "of2_cond_begin_branch", handle, stream.cuda_stream)
        try:
            with torch.cuda.stream(stream), torch.cuda.use_mem_pool(self._branch_pool, self.device):
                yield
        finally:
            status = _build.library().of2_cond_end_branch(stream.cuda_stream)
        if status != 0:
            raise RuntimeError(f"of2_cond_end_branch: CUDA error {status}")

    def _cond(self, pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands) -> Any:
        """:func:`cond` while this graph captures: both branches, each in
        an IF node, each counting its runs on the device."""
        if self._in_branch:
            raise RuntimeError(f"capture of {self.name}: a cond inside a branch of a cond")
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError(f"cond needs a one-element bool predicate, got {pred.dtype} "
                             f"{tuple(pred.shape)}")
        if self._conds == CONDS:
            raise RuntimeError(f"capture of {self.name}: more than {CONDS} conds in one call")
        taken = self._taken_device[self._conds]
        self._conds += 1
        start = _counts()
        handles = self._open_cond(pred)
        outs, deltas = [], []
        for which, fn in enumerate((true_fn, false_fn)):
            before = _counts()
            self._in_branch = True
            try:
                with self._branch(handles[which]):
                    out = fn(*operands)
                    taken[which].add_(1)
                    if outs:
                        _copy_into(outs[0], out)
            finally:
                self._in_branch = False
            deltas.append(delta(before, _counts()))
            outs.append(out)
        _set_counts(start)  # a branch counts at settle(), once per replay that ran it
        self._branch_deltas.append((deltas[0], deltas[1]))
        return outs[0]

    def replay(self, inputs=None) -> Any:
        """Copy ``inputs``, when given, into the static input buffers (an
        input that is its buffer is not copied), replay on the current
        stream and count its launches; returns the static outputs, which the
        next replay overwrites."""
        if inputs is not None:
            with _span("capture.copy_in"):
                for dst, src in zip(self.inputs, inputs, strict=True):
                    if src is not dst:
                        dst.copy_(src)
                        self.copied += 1
        try:
            with _span("capture.launch"):
                self._launch()
        except Exception as exc:
            raise RuntimeError(f"replay of {self.name} failed for key {self.key}: {exc}") from exc
        add_counts(self.delta)
        if self._conds:
            _pending[id(self)] = self
        self.replays += 1
        return self.outputs

    def _settle(self) -> None:
        """Add the branch launches of the replays since the last settle."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = self._taken_device[:self._conds].tolist()
        for (t, f), (t0, f0), (dt, df) in zip(now, self.taken, self._branch_deltas, strict=True):
            add_counts(dt, t - t0)
            add_counts(df, f - f0)
        self.taken = now


def pool_bytes(segments, pool_ids) -> dict[int, int]:
    """Bytes per card index of the allocator's ``segments`` (the
    ``segments`` of ``torch.cuda.memory._snapshot()``) whose pool is one
    of ``pool_ids``."""
    out: dict[int, int] = {}
    for seg in segments:
        if tuple(seg["segment_pool_id"]) in pool_ids:
            out[seg["device"]] = out.get(seg["device"], 0) + seg["total_size"]
    return out


def _copy_into(dst_tree, src_tree) -> None:
    dst_spec, dst = flatten(dst_tree)
    src_spec, src = flatten(src_tree)
    if dst_spec != src_spec:
        raise RuntimeError(f"the branches of a cond return different outputs: {dst_spec} and "
                           f"{src_spec}")
    for d, s in zip(dst, src):
        d.copy_(s)


def _tensor_leaves(spec: tuple) -> int:
    if spec[0] == _TENSOR:
        return 1
    return sum(_tensor_leaves(c) for c in spec[2]) if spec[0] == _SEQ else 0


class DonatingGraphs:
    """The graphs of one key of an entry that donates arguments (module
    docstring): ``fn`` returns a tuple whose first ``len(donate_argnums)``
    items are the donated arguments' new values.

    ``graphs`` holds G0 and G1 when those values keep the donated arguments'
    shapes (they swap the buffer sets ``sets[0]`` and ``sets[1]``), else one
    graph that copies in and clones out; ``plain`` is the copy-in, clone-out
    graph built when a call would write a set the caller still holds."""

    def __init__(self, fn: Callable, spec: tuple, tensors, donate_argnums: tuple[int, ...],
                 device: torch.device, name: str):
        self.fn, self.spec, self.device, self.name = fn, spec, device, name
        args = spec[2]
        self.mask = [i in donate_argnums for i, a in enumerate(args)
                     for _ in range(_tensor_leaves(a))]
        self.donated_spec = (_SEQ, tuple, tuple(args[i] for i in donate_argnums))
        self.n_donated = len(donate_argnums)
        static = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        donated = [t for t, d in zip(static, self.mask) if d]
        # both sets outside every graph's pool, so no graph's temporaries sit in them
        self.sets = (donated, [torch.empty_like(t) for t in donated])
        self.handed: tuple[list, list] = ([], [])  # weak references to what each set returned
        self.swaps = False
        self.plain: Graph | None = None
        self.graphs = [Graph(self._body(0), static, device, name, spec, copy=False)]
        if self.swaps:
            self.graphs.append(Graph(self._body(1), self._with_set(static, 1), device, name,
                                     spec, copy=False))
        else:
            self.sets = (donated, [])

    def _body(self, k: int) -> Callable:
        """The body that reads set ``k`` and writes the new values into the other."""

        def body(*static):
            out = self.fn(*unflatten(self.spec, static))
            new_spec, new = flatten(tuple(out[:self.n_donated]))
            self.swaps = new_spec == self.donated_spec
            if not self.swaps:
                return out
            for dst, src in zip(self.sets[1 - k], new, strict=True):
                dst.copy_(src)
            return (*unflatten(new_spec, self.sets[1 - k]), *out[self.n_donated:])

        return body

    def _with_set(self, tensors, k: int) -> list:
        """``tensors`` with the donated ones replaced by set ``k``."""
        it = iter(self.sets[k])
        return [next(it) if d else t for t, d in zip(tensors, self.mask)]

    def _held(self, k: int) -> bool:
        return any(ref() is not None for ref in self.handed[k])

    def choose(self, tensors: list[torch.Tensor]) -> tuple[int, list] | None:
        """``(k, inputs)``: a call on ``tensors`` replays ``graphs[k]`` on
        ``inputs``; None when it would write a set the caller still holds
        (the plain graph runs instead)."""
        if len(self.graphs) == 1:
            return 0, tensors
        passed = [t for t, d in zip(tensors, self.mask) if d]
        k = next((k for k in (0, 1) if all(map(_same, passed, self.sets[k]))), None)
        if k is None:  # another key's, or the caller's: copied into set 0
            return None if self._held(0) or self._held(1) else (0, tensors)
        return None if self._held(1 - k) else (k, self._with_set(tensors, k))

    def run(self, choice: tuple[int, list], tensors: list[torch.Tensor]) -> Any:
        """Replay the graph :meth:`choose` picked; returns the donated
        arguments' new values as views of the set just written, then
        clones of the other outputs."""
        k, inputs = choice
        out = self.graphs[k].replay(inputs)
        with _span("capture.clone"):
            if len(self.graphs) == 1:
                return clone_outputs(out)
            views = [t.detach() for t in self.sets[1 - k]]  # tensors of their own, to track
            self.handed[1 - k][:] = [weakref.ref(v) for v in views]
            return (*unflatten(self.donated_spec, views),
                    *clone_outputs(tuple(out[self.n_donated:])))

    def run_plain(self, tensors: list[torch.Tensor]) -> Any:
        """The copy-in, clone-out graph of the key, captured at its first use."""
        if self.plain is None:
            with _span("capture.capture"):
                self.plain = Graph(lambda *static: self.fn(*unflatten(self.spec, static)),
                                   tensors, self.device, f"{self.name} (a held value)", self.spec)
        out = self.plain.replay(tensors)
        with _span("capture.clone"):
            return clone_outputs(out)

    def all_graphs(self) -> list[Graph]:
        return self.graphs + ([self.plain] if self.plain is not None else [])


class GraphCache:
    """Key -> what one key captured, least recently used dropped first when
    more than ``CACHE_SIZE`` keys would be held (before the new capture, so
    its pool can reuse the freed memory).

    It also holds the entry's counters: ``calls``, ``captures`` (graphs),
    ``evictions`` (keys dropped), ``eager`` (calls that ran the body
    eagerly) and ``plain`` (calls of a donating key that ran its plain
    graph).  ``name`` is the entry's ``module.qualname``."""

    def __init__(self, name: str):
        self.name = name
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.calls = self.captures = self.evictions = self.eager = self.plain = 0
        _caches.append(self)

    def lookup(self, key) -> Any:
        """What ``key`` captured, made the most recently used; None on a miss."""
        value = self.entries.get(key)
        if value is not None:
            self.entries.move_to_end(key)
        return value

    def put(self, key, build: Callable[[], Any]) -> Any:
        """Drop the least recently used keys to make room, then ``build()``
        the value of ``key``."""
        while len(self.entries) >= CACHE_SIZE:
            settle()
            self.entries.popitem(last=False)
            self.evictions += 1
        value = self.entries[key] = build()
        return value

    def clear(self) -> None:
        settle()
        self.entries.clear()


def clear() -> None:
    """Drop every cached graph of every entry (their pools go back to the
    caching allocator)."""
    for cache in _caches:
        cache.clear()


def graphs_captured() -> int:
    """Graphs captured in this process so far."""
    return _captured


def _graphs(value) -> list[Graph]:
    return value.all_graphs() if isinstance(value, DonatingGraphs) else [value]


def stats() -> dict:
    """The capture counters, after one :func:`settle`: ``entries``, one dict
    per entry that was called (``name``, ``calls``, ``replays`` (summed over
    its graphs), ``captures``, ``evictions``, ``eager``, ``plain``, and
    ``graphs``: per cached graph its ``replays``, ``copied``, ``seconds``,
    ``pool_bytes``, ``taken``, ``launches`` (each launch counter's change
    over the captured call outside its conds' branches, which every replay
    adds: :attr:`Graph.delta`) and ``branch_launches`` (per cond, the
    changes of its true and its false branch, which :func:`settle` adds per
    replay that took it)); ``graphs_captured``; ``seconds`` and
    ``pool_bytes`` (per card index) summed over the cached graphs."""
    settle()
    entries, seconds, pools = [], 0.0, {}
    for cache in _caches:
        if not cache.calls:
            continue
        graphs = [{"replays": g.replays, "copied": g.copied, "seconds": g.seconds,
                   "pool_bytes": dict(g.pool_bytes), "taken": [list(t) for t in g.taken],
                   "launches": dict(g.delta),
                   "branch_launches": [[dict(t), dict(f)] for t, f in g._branch_deltas]}
                  for value in cache.entries.values() for g in _graphs(value)]
        for g in graphs:
            seconds += g["seconds"]
            for card, n in g["pool_bytes"].items():
                pools[card] = pools.get(card, 0) + n
        entries.append({"name": cache.name, "calls": cache.calls,
                        "replays": sum(g["replays"] for g in graphs), "captures": cache.captures,
                        "evictions": cache.evictions, "eager": cache.eager, "plain": cache.plain,
                        "graphs": graphs})
    return {"entries": entries, "graphs_captured": _captured, "seconds": seconds,
            "pool_bytes": pools}


def captured(fn: Callable, prepare: Callable | None = None,
             donate_argnums: tuple[int, ...] = ()) -> Callable:
    """``fn`` as a captured entry (module docstring).  The wrapper keeps
    ``fn`` as ``.eager``, its cache as ``.cache`` and the key of a call as
    ``.key(*args, **kwargs)``.

    ``prepare``, when given, runs on every call before the key, outside any
    graph, with the call's arguments: it returns the ``(args, kwargs)`` to
    key and run on (e.g. frames moved to the card the graph runs on, which
    a capture cannot do from pageable host memory, or arrays made tensors),
    or None for a call that runs ``fn`` eagerly on its own arguments.

    ``donate_argnums`` are the positions of ``fn``'s parameters whose
    values are donated (:class:`DonatingGraphs`); ``fn`` then returns a
    tuple that starts with their new values."""
    signature = inspect.signature(fn)
    cache = GraphCache(f"{fn.__module__}.{fn.__qualname__}")
    donate_argnums = tuple(donate_argnums)

    def key(*args, **kwargs) -> tuple:
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        return flatten(tuple(bound.arguments.values()))

    def find(args, kwargs):
        """``(args, kwargs, spec, tensors)`` of a call, ``spec`` None for
        one that runs ``fn`` eagerly on ``args`` and ``kwargs``."""
        if prepare is not None:
            prepared = prepare(*args, **kwargs)
            if prepared is None:
                return args, kwargs, None, None
            args, kwargs = prepared
        spec, tensors = key(*args, **kwargs)
        if runs_eagerly(tensors):
            return args, kwargs, None, None
        return args, kwargs, spec, tensors

    def build(spec, tensors):
        cards = list(dict.fromkeys(t.device for t in tensors if t.is_cuda))
        device = cards[0] if cards else tensors[0].device
        if donate_argnums:
            return DonatingGraphs(fn, spec, tensors, donate_argnums, device, fn.__qualname__)

        def body(*static):
            return fn(*unflatten(spec, static))

        return Graph(body, tensors, device, fn.__qualname__, spec, peers=tuple(cards[1:]))

    @functools.wraps(fn)
    def call(*args, **kwargs):
        cache.calls += 1
        with _span("capture.call", entry=fn.__qualname__) as root:
            with _span("capture.key"):
                args, kwargs, spec, tensors = find(args, kwargs)
                entry = cache.lookup(spec) if spec is not None else None
                choice = entry.choose(tensors) if donate_argnums and entry is not None else None
            if spec is None:
                cache.eager += 1
                root.set("path", "eager")
                with _span("capture.eager"):
                    return fn(*args, **kwargs)
            if entry is None:
                root.set("path", "capture")
                with _span("capture.capture"):
                    entry = cache.put(spec, lambda: build(spec, tensors))
                cache.captures += len(_graphs(entry))
                if donate_argnums:
                    choice = entry.choose(tensors)
            else:
                root.set("path", "replay")
            if not donate_argnums:
                out = entry.replay(tensors)
                with _span("capture.clone"):
                    return clone_outputs(out)
            if choice is not None:
                return entry.run(choice, tensors)
            cache.plain += 1
            cache.captures += entry.plain is None
            root.set("path", "plain")
            with _span("capture.plain"):
                return entry.run_plain(tensors)

    call.eager = fn
    call.cache = cache
    call.key = lambda *args, **kwargs: key(*args, **kwargs)[0]
    return call
