"""The port's one way to replay work as CUDA graphs.

A ``Runner`` replays a function as one CUDA graph a key, and the key is
derived from the call: the function, the shapes, dtypes and devices of the
tensors among its arguments (nested tuples included), and the values of
the rest, the settings.

A runner lives at module level in the module that replays the function,
as long as the process: ``models/lio._INSERT_GRAPHS`` (the surfel insert)
and ``ops/pgo._PCG_GRAPHS`` (the PCG's blocks).  Callers of one key share
its graph, which keeps nothing of a caller between calls.

On the card the first load of a key makes zero buffers of the tensors and
captures the function on them (``capture``); every load copies the
caller's tensors in, and every call replays and returns clones of the
outputs.  As the capture runs before anything is loaded, the function may
write its arguments in place; it may read nothing on the host.  Off the
card a call is the function on the caller's own tensors.  The tracer
counts ``graph_captures`` and ``graph_replays`` on the open spans.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import profiling


def capture(fn, device: torch.device) -> torch.cuda.CUDAGraph:
    """``fn()`` warmed up on a side stream of ``device`` and captured as a
    CUDA graph there.  ``fn`` must read and write only tensors that outlive
    the graph: a replay runs the captured kernels on those same buffers."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    return graph


def _on_card(tensors) -> bool:
    """Whether a graph can hold a call's tensors: all on a CUDA device."""
    return bool(tensors) and all(t.is_cuda for t in tensors)


class Graph:
    """``fn`` on one key's arguments, flattened to ``leaves`` (``spec``
    rebuilds them).  With a ``device`` the tensors are buffers of the
    graph captured there; without one they are the caller's own."""

    def __init__(self, fn, leaves: list, spec, device=None):
        if device is not None:
            leaves = [torch.zeros_like(x) if isinstance(x, torch.Tensor)
                      else x for x in leaves]
        self.fn, self.leaves, self.out, self.graph = fn, leaves, None, None
        # (args, kwargs) that a call runs ``fn`` on: on the card the
        # graph's buffers, which a function writing in place updates
        self.inputs = pytree.tree_unflatten(leaves, spec)
        if device is not None:
            self.graph = capture(self._run, device)
            profiling.add("graph_captures", 1)

    def _run(self):
        self.out = self.fn(*self.inputs[0], **self.inputs[1])

    def __call__(self):
        """``fn`` on the loaded arguments: off the card its outputs, on the
        card one replay and clones of the graph's outputs."""
        if self.graph is None:
            self._run()
            return self.out
        self.graph.replay()
        profiling.add("graph_replays", 1)
        return pytree.tree_map_only(torch.Tensor, torch.clone, self.out)


class Runner:
    """A module's graphs, one a key (``graphs``)."""

    def __init__(self):
        self.graphs: dict = {}

    def load(self, fn, *args, **kwargs) -> Graph:
        """The ``Graph`` of ``fn`` for this call's key, loaded with its
        arguments (captured on the key's first load)."""
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not _on_card(tensors):
            return Graph(fn, leaves, spec)
        key = (fn, spec, tuple((x.shape, x.dtype, x.device)
                               if isinstance(x, torch.Tensor) else x
                               for x in leaves))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = Graph(fn, leaves, spec,
                                             tensors[0].device)
        for dst, src in zip(graph.leaves, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        return graph

    def __call__(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` through its graph: outputs the caller
        owns."""
        return self.load(fn, *args, **kwargs)()
