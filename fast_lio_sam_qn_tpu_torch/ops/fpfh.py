"""FPFH descriptor helpers — the slice of fast_lio_sam_qn_tpu/ops/fpfh.py
that the streaming backend uses (the kNN-based FPFH backend is not ported
yet)."""
from __future__ import annotations

import torch

FPFH_DIM = 33
_NBINS = 11


def distinctive(desc: torch.Tensor, valid: torch.Tensor,
                planarity_threshold: float = 90.0) -> torch.Tensor:
    """Drop degenerate (planar) descriptors before matching: keep points
    whose mean per-block max mass is below the threshold (blocks sum to
    100).  Leading axes are a batch of clouds."""
    mx = torch.stack([torch.max(desc[..., s:s + _NBINS], dim=-1).values
                      for s in range(0, FPFH_DIM, _NBINS)], dim=-1)
    return valid & (torch.mean(mx, dim=-1) < planarity_threshold)
