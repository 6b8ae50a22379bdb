"""The port's one rule for capturing a CUDA graph.

``pgo.PCGBlock`` (8 PCG iterations) and ``surfel_map.InsertGraph`` (one
surfel insert) both capture through ``capture``: the function is run once
on a side stream first, as ``torch.cuda.graphs`` asks, so that lazy
initialisation and allocator warm-up stay out of the graph, and then once
under capture on the tensors' device.
"""
from __future__ import annotations

import torch


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
