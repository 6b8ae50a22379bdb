"""Rotations, rigid transforms and voxel keys for the plain reference, in
whatever floating type the caller's tensors carry (float64 for the
reference, float32 for its control).

Tangent vectors are ordered (rotation, translation), perturbations act on
the right: T <- T Exp(xi).
"""
from __future__ import annotations

import numpy as np
import torch

SMALL = 1e-6     # below this angle the series forms are used
KEY_BIAS = 1 << 20   # voxel coordinates packed as 21-bit fields


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with hat(a) b = a x b."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _coeffs(theta: torch.Tensor):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3, with series for
    small t."""
    t2 = theta * theta
    small = theta < SMALL
    ts = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1 - t2 / 6, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(ts)) / (ts * ts))
    c = torch.where(small, 1 / 6 - t2 / 120, (ts - torch.sin(ts)) / ts ** 3)
    return a[..., None, None], b[..., None, None], c[..., None, None]


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    a, b, _ = _coeffs(torch.linalg.norm(w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), for angles below pi."""
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    sn = torch.linalg.norm(s, dim=-1)
    theta = torch.atan2(sn, c)
    small = sn < SMALL
    scale = torch.where(small, 1 + theta * theta / 6,
                        theta / torch.where(small, torch.ones_like(sn), sn))
    return s * scale[..., None]


def _v_matrix(w: torch.Tensor) -> torch.Tensor:
    """The left Jacobian of SO(3): t = V v in Exp of se(3)."""
    _, b, c = _coeffs(torch.linalg.norm(w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + b * W + c * (W @ W)


def pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1
    return T


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    w, v = xi[..., :3], xi[..., 3:]
    return pose(exp_so3(w), (_v_matrix(w) @ v[..., None])[..., 0])


def log_se3(T: torch.Tensor) -> torch.Tensor:
    w = log_so3(T[..., :3, :3])
    v = torch.linalg.solve(_v_matrix(w), T[..., :3, 3:])[..., 0]
    return torch.cat([w, v], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return pose(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6): xi' = Ad(T) xi for (rotation,
    translation) tangents."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    A[..., :3, :3] = R
    A[..., 3:, 3:] = R
    A[..., 3:, :3] = hat(t) @ R
    return A


def small_adjoint(xi: torch.Tensor) -> torch.Tensor:
    A = torch.zeros(xi.shape[:-1] + (6, 6), dtype=xi.dtype, device=xi.device)
    W = hat(xi[..., :3])
    A[..., :3, :3] = W
    A[..., 3:, 3:] = W
    A[..., 3:, :3] = hat(xi[..., 3:])
    return A


def orthonormal(R: torch.Tensor) -> torch.Tensor:
    """The nearest rotation (the polar factor, by SVD)."""
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh


# ---------------------------------------------------------------------------
# voxels
# ---------------------------------------------------------------------------

def voxel_of(points: torch.Tensor, res: float) -> torch.Tensor:
    """Integer voxel coordinates floor(p / res), int64."""
    return torch.floor(points / res).to(torch.int64)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 voxel coordinates -> one sortable int64 key."""
    c = coords + KEY_BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def unpack(keys: torch.Tensor) -> torch.Tensor:
    m = (1 << 21) - 1
    return torch.stack([(keys >> 42) & m, (keys >> 21) & m, keys & m],
                       -1) - KEY_BIAS


M32 = np.uint64(0xFFFFFFFF)
PROBES = 4               # slots a voxel may take in the map's table


def _u32(coords: np.ndarray) -> np.ndarray:
    return coords.astype(np.int64).astype(np.uint64) & M32


def _mix(c: np.ndarray, a: int, b: int, d: int, shifts) -> np.ndarray:
    """(x a + y b + z d) mod 2^32, then xorshift-multiply rounds, in
    wrapping unsigned arithmetic."""
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.uint64(a) + c[:, 1] * np.uint64(b)
             + c[:, 2] * np.uint64(d)) & M32
        for s, k in shifts:
            h ^= h >> np.uint64(s)
            if k:
                h = (h * np.uint64(k)) & M32
    return h


def voxel_hash(coords: np.ndarray) -> np.ndarray:
    """The configurations' 31-bit voxel hash, which orders voxels where a
    capacity keeps the first ones."""
    h = _mix(_u32(coords), 0x8DA6B343, 0xD8163841, 0xCB1AB31F,
             ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, 0)))
    return (h >> np.uint64(1)).astype(np.int64)


def probe_slots(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """(N, PROBES) slots of the map's table, in probe order, that voxels
    may take: h1 + p (h2 | 1) mod the table size, from two of the
    configurations' hashes."""
    c = _u32(coords.cpu().numpy())
    h1 = _mix(c, 0x8DA6B343, 0xD8163841, 0xCB1AB31F,
              ((16, 0x85EBCA6B), (13, 0)))
    h2 = _mix(c, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D,
              ((15, 0x27D4EB2F), (13, 0)))
    p = np.arange(PROBES, dtype=np.uint64)
    with np.errstate(over="ignore"):
        s = (h1[:, None] + p * (h2[:, None] | np.uint64(1))) \
            & np.uint64(table_size - 1)
    return torch.from_numpy(s.astype(np.int64)).to(coords.device)


def hash_order(coords: torch.Tensor) -> torch.Tensor:
    """Indices ordering distinct voxels by (hash, x, y, z)."""
    c = coords.cpu().numpy()
    order = np.lexsort((c[:, 2], c[:, 1], c[:, 0], voxel_hash(c)))
    return torch.from_numpy(order).to(coords.device)


def downsample_keys(points: torch.Tensor, mask: torch.Tensor, res: float,
                    cap: int) -> torch.Tensor:
    """The voxels a centroid-per-voxel downsample to ``cap`` rows keeps
    (the first by hash order), as sorted keys."""
    keys = torch.unique(pack(voxel_of(points[mask], res)))
    return torch.sort(keys[hash_order(unpack(keys))][:cap]).values
