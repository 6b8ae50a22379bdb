"""The port's CUDA-graph runner (``utils/cuda_graph.py``) on the CPU: its
key derived from the call, the function run on the caller's own tensors
off the card with no graph counted, and, with CPU tensors taken for the
card's (``torch_graph_stub.cpu_as_card``), the card's protocol: a capture
on zero buffers before anything is loaded, copies in, a replay a call and
clones out."""
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.utils import cuda_graph, profiling

import torch_graph_stub

card_graphs = torch_graph_stub.card_graphs


def _axpy(x, y, *, a, clip=None):
    """y += a x in place (clipped at ``clip``); returns (y, its sum)."""
    y.add_(a * x)
    if clip is not None:
        y.clamp_(max=clip)
    return y, y.sum()


def _args(n=4, dtype=torch.float32, a=2.0, clip=None):
    return (torch.arange(n, dtype=dtype), torch.ones(n, dtype=dtype)), \
        dict(a=a, clip=clip)


CHANGES = {"shape": dict(n=5), "dtype": dict(dtype=torch.float64),
           "setting": dict(a=3.0), "optional setting": dict(clip=1.5)}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_the_key_is_derived_from_the_call(card_graphs, change):
    """Tensors of the same shapes and dtypes with the same settings share
    one graph whatever their values; a changed shape, dtype or setting
    gets another, kept beside the first."""
    runner = cuda_graph.Runner()
    args, kw = _args()
    a = runner.load(_axpy, *args, **kw)
    other, kw2 = _args()
    assert runner.load(_axpy, other[0] * 7, other[1], **kw2) is a
    args_b, kw_b = _args(**CHANGES[change])
    b = runner.load(_axpy, *args_b, **kw_b)
    assert b is not a and runner.load(_axpy, *args_b, **kw_b) is b
    assert runner.load(_axpy, *args, **kw) is a and len(runner.graphs) == 2


def test_off_the_card_the_function_runs_on_the_callers_tensors():
    """Off the card a call is the function itself: it writes the caller's
    own tensors, returns its own outputs, and the runner holds nothing."""
    runner = cuda_graph.Runner()
    (x, y), kw = _args()
    ptrs = (x.data_ptr(), y.data_ptr())
    g = runner.load(_axpy, x, y, **kw)
    assert g.graph is None and runner.graphs == {}
    assert [t.data_ptr() for t in g.inputs[0]] == list(ptrs)
    out, total = g()
    assert out is y and torch.equal(y, torch.tensor([1.0, 3.0, 5.0, 7.0]))
    out, _ = runner(_axpy, x, y, **kw)
    assert out.data_ptr() == y.data_ptr() == ptrs[1]
    assert runner.graphs == {}


def test_counters_read_zero_on_the_cpu():
    p = profiling.Profiler("cpu")
    runner = cuda_graph.Runner()
    with p.span("insert"):
        for _ in range(3):
            runner(_axpy, *_args()[0], a=1.0)
    (rec,) = p.records()
    assert rec.graph_captures == rec.graph_replays == 0
    assert "graph_captures" not in p.summary()["insert"]
    assert "graph_replays" not in p.summary()["insert"]


def test_on_the_card_buffers_are_loaded_and_outputs_cloned(card_graphs):
    """A key's first load captures once on zero buffers (so a function
    writing in place warms up on them, not on the caller's tensors), every
    load copies the caller's tensors in, every call replays once and
    returns clones that no later call writes; the counters count both."""
    seen = []

    def fn(x, y, *, a):
        seen.append(float(y.sum()))
        return _axpy(x, y, a=a)
    runner = cuda_graph.Runner()
    p = profiling.Profiler("cpu")
    (x, y), _ = _args()
    with p.span("opt"):
        g = runner.load(fn, x, y, a=2.0)
        assert seen == [0.0]                     # the capture, on zeros
        bx, by = g.inputs[0]
        assert {bx.data_ptr(), by.data_ptr()}.isdisjoint(
            {x.data_ptr(), y.data_ptr()})
        out1, s1 = g()
        out2, s2 = runner(fn, x, y, a=2.0)
    assert torch.equal(y, torch.ones(4))         # the caller's, untouched
    assert torch.equal(out1, out2) and float(s1) == float(s2) == 16.0
    assert out1.data_ptr() not in {out2.data_ptr(), by.data_ptr(),
                                   g.out[0].data_ptr()}
    assert seen == [0.0, 4.0, 4.0]
    (rec,) = p.records()
    assert (rec.graph_captures, rec.graph_replays) == (1, 2)
