"""The reference's building blocks against their definitions and against
the port where both define the same thing: the voxel hash that orders
voxels under a capacity, the map table's probe slots, and the
rigid-motion maps."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench.reference import geometry as G  # noqa: E402


def test_voxel_hash_equals_the_ports():
    from fast_lio_sam_qn_tpu_torch.ops import voxel

    g = torch.Generator().manual_seed(5)
    c = torch.randint(-6000, 6000, (50000, 3), generator=g,
                      dtype=torch.int32)
    c[:2] = torch.tensor([[2 ** 31 - 1, -2 ** 31, 0], [-1, -1, -1]])
    assert (voxel.spatial_hash(c).long().numpy()
            == G.voxel_hash(c.numpy())).all()


def test_probe_slots_equal_the_ports():
    from fast_lio_sam_qn_tpu_torch.ops import hashgrid

    g = torch.Generator().manual_seed(8)
    c = torch.randint(-6000, 6000, (50000, 3), generator=g,
                      dtype=torch.int32)
    for t in (1 << 14, 1 << 19):
        assert torch.equal(hashgrid._probe_slots(c, t),
                           G.probe_slots(c.long(), t))


def test_keys_round_trip_and_sort_as_coordinates():
    g = torch.Generator().manual_seed(6)
    c = torch.randint(-4000, 4000, (1000, 3), generator=g)
    assert torch.equal(G.unpack(G.pack(c)), c)
    order = torch.argsort(G.pack(c))
    lex = sorted(range(1000), key=lambda i: tuple(c[i].tolist()))
    assert order.tolist() == lex


def test_exp_and_log_invert_and_match_the_ports():
    from fast_lio_sam_qn_tpu_torch.ops import se3

    g = torch.Generator().manual_seed(7)
    xi = torch.randn(500, 6, generator=g, dtype=torch.float64) * 0.6
    xi[:3] *= 1e-9
    T = G.exp_se3(xi)
    assert torch.allclose(G.log_se3(T), xi, atol=1e-12)
    assert torch.allclose(T, se3.se3_exp(xi), atol=1e-12)
    assert torch.allclose(G.inverse(T) @ T,
                          torch.eye(4, dtype=torch.float64).expand_as(T),
                          atol=1e-12)
