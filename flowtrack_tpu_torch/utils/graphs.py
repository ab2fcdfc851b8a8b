"""CUDA graphs: the port's counterpart of ``jax.jit``.

The reference compiles each of its device programs once per static shape
with ``jax.jit``: the clip (``tracking/clip_pipeline.py``), the per-frame
pose and flow programs (``pipeline.py``), the streaming tracker's
propagate, NMS and match steps (``tracking/tracker.py``), the pose and flow
train steps and their validation steps. The port captures each of them as
one CUDA graph per shape and replays it:

* ``Graph``: one program ``fn(*inputs)`` captured on the card. Its inputs
  are static device buffers that each run fills by ``copy_``; the capture
  follows one eager warm-up run on a side stream (library handles and
  workspaces, cuDNN's algorithm choice, the kernels' first
  ``cudaFuncSetAttribute``, the ops' cached constants all happen outside
  it), or an eager call that the caller made just before (a train step's
  first, which also makes the optimizer's moments), runs with the inputs'
  card current, and allocates from a
  pool that a cache's graphs share; ``run`` replays and returns clones of
  the outputs (the next replay overwrites them), in ``fn``'s structure.
  ``capture_ms`` and ``pool_bytes`` (what the pool grew by) say what the
  capture cost; with tracing on (``utils/profiling``) the warm-up (or the
  wait for the caller's) and the capture are the spans ``graphs.warmup``
  and ``graphs.capture``, and ``graphs.captures`` counts them. A capture
  that fails raises: there is no eager fallback.
* ``GraphCache``: a dict of graphs by key (the program's shapes), all
  captured while the state they read beside their inputs (a net's
  parameters and buffers, an optimizer's moments and rate: ``net_state``)
  held the tensors that ``state_key`` names. When the key changes (a net
  moved, replaced or loaded into new tensors, an optimizer's state loaded)
  every graph is dropped, with its pool, and the next run captures anew.
  ``run`` runs ``fn`` eagerly on CPU tensors (``on_card``): the eager
  program is the graph's plain version. ``lookup`` and ``capture`` are
  its two halves, for a caller whose first call is not a warm-up alone.
* ``kept``: a cache kept per net across an entry point's calls.

A program replays without running Python, so it must take no data from the
host and give none back (no ``.item()``, no branch on a device value, no
tensor made from host data) and keep its Python side effects out of the
device work (a train step's host step count, its schedule's rate: written
before each replay, not inside it).
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from flowtrack_tpu_torch.utils import profiling


def net_state(*nets) -> list:
    """What a captured program reads of its nets beside its inputs: their
    parameters and buffers, and a fused net's checked blocks
    (``stage_blocks``), which keep the transposed weights that its kernel
    launches read."""
    state = []
    for net in nets:
        # every module's own tensors, walked without named_modules' prefix
        # strings: this runs before each replay
        stack = [net]
        while stack:
            m = stack.pop()
            state += [t for t in (*m._parameters.values(),
                                  *m._buffers.values()) if t is not None]
            stack += m._modules.values()
        if hasattr(net, "stage_blocks"):
            state += net.stage_blocks()
    return state


def state_key(state) -> tuple:
    """Identity of ``net_state``'s objects and of the memory each tensor
    holds: it changes when a net is replaced, moved or loaded into new
    tensors (a fused net then checks and transposes its blocks anew), and
    not when new values are copied into the same tensors."""
    return tuple((id(o), o.data_ptr() if isinstance(o, torch.Tensor) else 0)
                 for o in state)


_KEPT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def kept(owner, key, make: Callable):
    """``make()``, made once for (``owner``, ``key``) and kept while
    ``owner`` lives: a program's graphs kept across calls, as ``jax.jit``
    keeps a program across calls, so that an entry point called again on
    the same net (a validation every epoch) replays what it captured. The
    graphs read the net's tensors by address, so they see the weights that
    training updates in place."""
    per_owner = _KEPT.setdefault(owner, {})
    if key not in per_owner:
        per_owner[key] = make()
    return per_owner[key]


class Graph:
    """``fn(*args)`` captured as a CUDA graph on ``args``' card.

    ``state()`` lists what ``fn`` reads beside its inputs; ``held`` keeps
    it, as it was once the graph was captured, so that nothing the graph
    reads is freed while it exists. ``warmup=False``: the caller ran
    ``fn``'s work eagerly just before on ``stream`` (a train step's first
    call, a real step, under ``GraphCache.warming``), which stands for the
    warm-up."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor],
                 state: Callable[[], list], pool, stream,
                 warmup: bool = True):
        self.device = args[0].device
        # capture with the card of the inputs current: the kernels'
        # launches and their per-device attributes, and the capture's
        # allocations, are that card's whichever device the caller made
        # current
        with torch.cuda.device(self.device):
            self._capture(fn, args, pool, stream, warmup)
        self.held = [o.detach() if isinstance(o, torch.Tensor) else o
                     for o in state()]

    @staticmethod
    def resources(device) -> tuple:
        """A memory pool and a capture stream for a cache's graphs."""
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    @staticmethod
    @contextlib.contextmanager
    def warming(stream, device):
        """Eager work on the stream that captures, after what the current
        stream queued and before what it queues next: a capture's warm-up
        (the libraries' handles and workspaces are made for that stream,
        outside the capture)."""
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield
        current.wait_stream(stream)

    def _capture(self, fn, args, pool, stream, warmup):
        dev = self.device
        self.inputs = [a.clone() for a in args]
        with profiling.span("graphs.warmup"):
            if warmup:
                with self.warming(stream, dev):
                    fn(*self.inputs)
            stream.synchronize()
        with profiling.span("graphs.capture"):
            # torch.cuda.graph empties the allocator's cache on entry; doing
            # it first leaves what the capture reserves as the pool's growth
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                out = fn(*self.inputs)
            torch.cuda.synchronize(dev)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        profiling.count("graphs.captures")
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.outputs, self._spec = tree_flatten(out)

    def run(self, args):
        """Fill the inputs, replay, and return clones of the outputs."""
        with torch.cuda.device(self.device):
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
            self.graph.replay()
            out = [t.clone() for t in self.outputs]
        return tree_unflatten(out, self._spec)


class GraphCache(dict):
    """Graphs by key, captured while the state they read held the same
    tensors, into one memory pool on one capture stream (a cache's graphs
    replay one after another on one stream, each replay's outputs cloned
    before the next; a cached block serves only the stream it was
    allocated on)."""

    def __init__(self):
        super().__init__()
        self._state_key = None
        self._resources = None

    @staticmethod
    def on_card(t: torch.Tensor) -> bool:
        """Whether a program on ``t`` replays a graph: a CUDA tensor. Every
        other tensor runs the program eagerly."""
        return t.is_cuda

    def run(self, key, fn: Callable, args: Sequence[torch.Tensor],
            state: Callable[[], list] = list):
        """``fn(*args)``: eagerly on CPU tensors; on a card the replay of
        ``key``'s graph, captured first if there is none (or the state
        changed)."""
        if not self.on_card(args[0]):
            return fn(*args)
        graph = self.lookup(key, state)
        if graph is None:
            graph = self.capture(key, fn, args, state)
        return graph.run(args)

    def lookup(self, key, state: Callable[[], list]):
        """``key``'s graph, or None; every graph is dropped first if the
        state's tensors changed."""
        self._hold(state)
        return self.get(key)

    def capture(self, key, fn: Callable, args: Sequence[torch.Tensor],
                state: Callable[[], list], warmup: bool = True) -> Graph:
        """``fn(*args)`` captured as ``key``'s graph (``Graph``)."""
        # an eager call just before (warmup=False) may have made state, as
        # an optimizer's first step makes its moments
        self._hold(state)
        graph = self[key] = Graph(fn, args, state,
                                  *self._pool_and_stream(args[0].device),
                                  warmup=warmup)
        return graph

    @contextlib.contextmanager
    def warming(self, device):
        """Run the caller's eager call on the stream that captures next, as
        ``Graph``'s own warm-up runs (the libraries' handles and
        workspaces are made for that stream, outside the capture): the
        warm-up of a ``capture(..., warmup=False)``."""
        with Graph.warming(self._pool_and_stream(device)[1], device):
            yield

    def _pool_and_stream(self, device):
        if self._resources is None:
            self._resources = Graph.resources(device)
        return self._resources

    def _hold(self, state):
        now = state_key(state())
        if now != self._state_key:
            if self:
                # every graph read the former tensors; a new pool, as the
                # allocator frees one only when no graph uses it
                self.clear()
                self._resources = None
            self._state_key = now
