"""SE(3)/SO(3) utilities on tensors — the slice of
fast_lio_sam_qn_tpu/ops/se3.py that the LIO, loop closure, the pose graph
and the pipeline use.

Same conventions as the JAX module: 4x4 homogeneous poses, tangent vectors
ordered [rx, ry, rz, tx, ty, tz], every function broadcasts over leading
batch dimensions.  Matmuls are plain fp32 (TF32 is off package-wide).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x from (..., 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, safe near zero. (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye3_like(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) -> (..., 3); safe near identity and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.linalg.norm(w_skew, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    th = theta[..., None]
    scale = torch.where(th < 1e-4, 1.0 + th ** 2 / 6.0,
                        th / torch.clamp(sin_theta[..., None], min=_EPS))
    w_generic = w_skew * scale
    # near-pi branch: the axis from the diagonal of (R + I) / 2, signs
    # fixed from the off-diagonals relative to the largest component
    B = (R + _eye3_like(R)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=0.0))
    k = torch.argmax(diag, dim=-1)

    def sgn(x):
        return torch.where(x < 0, -1.0, 1.0).to(R.dtype)

    one = torch.ones_like(trace)
    cand0 = axis * torch.stack([one, sgn(B[..., 1, 0]), sgn(B[..., 2, 0])], -1)
    cand1 = axis * torch.stack([sgn(B[..., 0, 1]), one, sgn(B[..., 2, 1])], -1)
    cand2 = axis * torch.stack([sgn(B[..., 0, 2]), sgn(B[..., 1, 2]), one], -1)
    kk = k[..., None]
    fixed = torch.where(kk == 0, cand0, torch.where(kk == 1, cand1, cand2))
    w_pi = fixed * th
    near_pi = (math.pi - theta)[..., None] < 1e-3
    return torch.where(near_pi, w_pi, w_generic)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye3_like(W) + b * W + c * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    half = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS)) / theta2)
    return _eye3_like(W) - 0.5 * W + cot * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map (..., 6) [w, v] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return make_pose(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map (..., 4, 4) -> (..., 6) [w, v]."""
    R, t = split_pose(T)
    w = so3_log(R)
    v = (_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = R.new_zeros((1, 4))        # [0, 0, 0, 1], filled on the device
    bottom[:, 3:].fill_(1.0)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def split_pose(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def identity_pose(device: torch.device | str,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def compose3(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """3x3 rotation composition Ra @ Rb (fp32; TF32 is off)."""
    return Ra @ Rb


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = split_pose(T)
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def orthonormalize3(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) by Newton iteration for the
    orthogonal polar factor, X <- X (3I - X^T X) / 2 (see the JAX
    module's docstring for why rotation chains need it)."""
    eye = _eye3_like(R)
    for _ in range(iters):
        R = 0.5 * (R @ (3.0 * eye - R.transpose(-1, -2) @ R))
    return R


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Pose composition Ta @ Tb."""
    return Ta @ Tb


def pose_between(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """a.between(b) = a^-1 @ b (GTSAM semantics)."""
    return pose_inverse(Ta) @ Tb


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3)."""
    R, t = split_pose(T)
    return points @ R.transpose(-1, -2) + t[..., None, :]


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) (roll, pitch, yaw) -> (..., 3, 3) R = Rz(yaw) Ry(pitch)
    Rx(roll), the ZYX convention of tf createQuaternionFromRPY and gtsam
    Rot3::RzRyRx."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], dim=-2)


def rot_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """The inverse of ``rpy_to_rot``: tf Matrix3x3::getRPY's solution 1,
    the pitch's sine clipped to [-1, 1]."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def pose_distance(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Euclidean translation distance — the keyframe gate's predicate."""
    return torch.linalg.norm(Ta[..., :3, 3] - Tb[..., :3, 3], dim=-1)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (through float64), as XLA's;
    torch's vectorized CPU sqrt may land one ulp off."""
    return torch.sqrt(x.double()).to(x.dtype)


def _unit(q: torch.Tensor) -> torch.Tensor:
    """q over its norm.  The reference's fused program sums the squares
    with fused multiply-adds, in order; each step is taken here in float64
    (a product of two fp32 values is exact there) and rounded to fp32,
    which gives the same bits."""
    qd = q.double()
    acc = (qd[..., 0] * qd[..., 0]).to(q.dtype)
    for i in range(1, q.shape[-1]):
        acc = (qd[..., i] * qd[..., i] + acc.double()).to(q.dtype)
    return q / torch.clamp(_sqrt32(acc), min=_EPS)[..., None]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3); normalizes the input."""
    q = _unit(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) xyzw with w >= 0: Shepperd's method, the
    best-conditioned of four constructions picked per rotation."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return _sqrt32(torch.clamp(x, min=0.0)) * 0.5

    def over(x, q):
        return x / torch.clamp(4 * q, min=_EPS)

    qw0 = half_sqrt(1.0 + tr)
    c0 = torch.stack([over(m21 - m12, qw0), over(m02 - m20, qw0),
                      over(m10 - m01, qw0), qw0], -1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([qx1, over(m01 + m10, qx1), over(m02 + m20, qx1),
                      over(m21 - m12, qx1)], -1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([over(m01 + m10, qy2), qy2, over(m12 + m21, qy2),
                      over(m02 - m20, qy2)], -1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([over(m02 + m20, qz3), over(m12 + m21, qz3), qz3,
                      over(m10 - m01, qz3)], -1)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = _unit(q)
    return torch.where(q[..., 3:4] < 0, -q, q)
