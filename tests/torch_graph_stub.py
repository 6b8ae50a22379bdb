"""The port's CUDA-graph runner (``fast_lio_sam_qn_tpu_torch/utils/
cuda_graph.py``) on the CPU as it runs on the card, for the tests of the
runner, the surfel insert's graph, the PCG's blocks and Quatro's coarse
solve: ``cpu_as_card`` and the fixture ``card_graphs``."""
from types import SimpleNamespace

import pytest

from fast_lio_sam_qn_tpu_torch.models import lio
from fast_lio_sam_qn_tpu_torch.ops import pgo, quatro
from fast_lio_sam_qn_tpu_torch.utils import cuda_graph


def cpu_as_card(monkeypatch):
    """Make the runners treat CPU tensors as the card's: a key's first load
    makes its buffers and "captures", which runs the function once (the
    warm-up) and returns a stand-in whose replay runs it again on the
    buffers, as a replay runs the captured kernels on them.  The LIO's
    insert, the pose-graph solve and Quatro's solve get fresh runners, so
    that no graph outlives the test."""
    def capture(fn, device):
        fn()
        return SimpleNamespace(replay=fn)

    monkeypatch.setattr(cuda_graph, "capture", capture)
    monkeypatch.setattr(cuda_graph, "_on_card", lambda tensors: bool(
        tensors) and all(t.device.type == "cpu" for t in tensors))
    monkeypatch.setattr(lio, "_INSERT_GRAPHS", cuda_graph.Runner())
    monkeypatch.setattr(pgo, "_PCG_GRAPHS", cuda_graph.Runner())
    monkeypatch.setattr(quatro, "_SOLVE_GRAPHS", cuda_graph.Runner())


@pytest.fixture
def card_graphs(monkeypatch):
    """``cpu_as_card`` for the whole test."""
    cpu_as_card(monkeypatch)
