"""The PyTorch port's small ops held against the JAX package on the CPU:
se3, linalg3, voxel_downsample, distinctive, the keyframe store and the
numpy converters.  Inputs are made from numpy seeds and fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models import keyframes as jkf
from fast_lio_sam_qn_tpu.ops import fpfh as jfpfh
from fast_lio_sam_qn_tpu.ops import linalg3 as jlinalg3
from fast_lio_sam_qn_tpu.ops import se3 as jse3
from fast_lio_sam_qn_tpu.ops import voxel as jvoxel
from fast_lio_sam_qn_tpu_torch import convert
from fast_lio_sam_qn_tpu_torch.models import keyframes
from fast_lio_sam_qn_tpu_torch.ops import fpfh, linalg3, se3, voxel

torch.set_num_threads(1)

# fp32 transcendental and matmul rounding differ between the two
# frameworks by a few ulp; geometry results are compared at 1e-5
GEOM_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_tangent(rng, n, scale=1.0):
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def _rand_poses(rng, n):
    return np.asarray(jse3.se3_exp(jnp.asarray(_rand_tangent(rng, n))))


@pytest.mark.parametrize("name", ["hat", "so3_exp", "se3_exp"])
def test_exp_maps_match_jax(name):
    rng = np.random.default_rng(0)
    xi = _rand_tangent(rng, 64)
    # include near-zero vectors (Taylor branch)
    xi[:4] *= 1e-6
    arg = xi[:, :3] if name != "se3_exp" else xi
    want = np.asarray(getattr(jse3, name)(jnp.asarray(arg)))
    got = getattr(se3, name)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=GEOM_TOL)


@pytest.mark.parametrize("angle", [0.3, 1e-6, np.pi - 1e-4])
def test_log_maps_match_jax(angle):
    """so3_log / se3_log on generic, near-identity and near-pi rotations."""
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    xi = np.concatenate([axes * angle, rng.normal(size=(16, 3))], 1)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))
    np.testing.assert_allclose(
        se3.so3_log(_t(T[:, :3, :3])).numpy(),
        np.asarray(jse3.so3_log(jnp.asarray(T[:, :3, :3]))), atol=1e-4)
    np.testing.assert_allclose(
        se3.se3_log(_t(T)).numpy(), np.asarray(jse3.se3_log(jnp.asarray(T))),
        atol=1e-4)


@pytest.mark.parametrize("name", ["compose", "pose_between"])
def test_pose_pairs_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = _rand_poses(rng, 32), _rand_poses(rng, 32)
    want = np.asarray(getattr(jse3, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(se3, name)(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=GEOM_TOL)


def test_rpy_conversions_match_jax():
    """rpy_to_rot and rot_to_rpy on 64 seeded angles in (-1.2, 1.2) against
    the JAX package's within 1e-6 (fp32 sin / cos / atan2 / asin, a few
    ulp apart), and the round trip as tests/test_se3.py holds it: angles
    back within 1e-5, the rotation within 1e-6."""
    rng = np.random.default_rng(5)
    rpy = rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
    want_R = np.asarray(jse3.rpy_to_rot(jnp.asarray(rpy)))
    R = se3.rpy_to_rot(_t(rpy))
    np.testing.assert_allclose(R.numpy(), want_R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        se3.rot_to_rpy(_t(want_R)).numpy(),
        np.asarray(jse3.rot_to_rpy(jnp.asarray(want_R))), rtol=0, atol=1e-6)
    rpy2 = se3.rot_to_rpy(R)
    np.testing.assert_allclose(rpy2.numpy(), rpy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(se3.rpy_to_rot(rpy2).numpy(), R.numpy(),
                               rtol=0, atol=1e-6)
    assert se3.rpy_to_rot(_t(rpy).reshape(4, 16, 3)).shape == (4, 16, 3, 3)


def test_pose_inverse_make_pose_transform_points():
    rng = np.random.default_rng(3)
    T = _rand_poses(rng, 8)
    pts = rng.normal(size=(8, 50, 3)).astype(np.float32) * 10
    np.testing.assert_allclose(
        se3.pose_inverse(_t(T)).numpy(),
        np.asarray(jse3.pose_inverse(jnp.asarray(T))), atol=GEOM_TOL)
    np.testing.assert_allclose(
        se3.make_pose(_t(T[:, :3, :3]), _t(T[:, :3, 3])).numpy(), T)
    np.testing.assert_allclose(
        se3.transform_points(_t(pts), _t(T)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(pts), jnp.asarray(T))),
        atol=1e-4)


def test_orthonormalize3_matches_jax():
    rng = np.random.default_rng(4)
    R = _rand_poses(rng, 16)[:, :3, :3]
    R = (R + rng.normal(size=R.shape) * 1e-3).astype(np.float32)
    got = se3.orthonormalize3(_t(R)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jse3.orthonormalize3(jnp.asarray(R))), atol=GEOM_TOL)
    eye = np.broadcast_to(np.eye(3), R.shape)
    np.testing.assert_allclose(np.swapaxes(got, 1, 2) @ got, eye, atol=1e-5)


def test_eigh3_matches_jax_signs_and_order():
    """Same Jacobi sweeps -> same eigenvalue order and eigenvector signs
    (which torch.linalg.eigh would not give)."""
    rng = np.random.default_rng(7)
    B = rng.normal(size=(257, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, -1, -2) + 0.01 * np.eye(3, dtype=np.float32)
    A[:8] = np.diag([1.0, 1.0, 2.0]).astype(np.float32)  # repeated values
    wv, wV = jlinalg3.eigh3(jnp.asarray(A))
    gv, gV = linalg3.eigh3(_t(A))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gV.numpy(), np.asarray(wV), atol=1e-4)


def test_inv3_and_solve6_match_jax():
    rng = np.random.default_rng(8)
    B = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(linalg3.inv3(_t(A)).numpy(),
                               np.asarray(jlinalg3.inv3(jnp.asarray(A))),
                               rtol=1e-4, atol=1e-4)
    C = rng.normal(size=(6, 6)).astype(np.float32)
    H = C @ C.T + np.eye(6, dtype=np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(
        linalg3.solve6(_t(H), _t(b), damping=1e-6).numpy(),
        np.asarray(jlinalg3.solve6(jnp.asarray(H), jnp.asarray(b),
                                   damping=1e-6)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_cap", [300, 2048])
def test_voxel_downsample_matches_jax(out_cap):
    """Masks exact, centroids to 1e-6: same (hash, coords) order, same
    sequential segment sums.  out_cap 300 truncates (lowest-hash voxels
    win), 2048 pads.  Masked slots are padding: the port zeroes them, the
    reference leaves unspecified values there."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-4, 4, (1500, 3)).astype(np.float32)
    pts[:500] = pts[:500] * 0.05 + 1.0  # a dense clump: many-point voxels
    mask = rng.random(1500) > 0.2
    wp, wm = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                     0.3, out_cap=out_cap)
    gp, gm = voxel.voxel_downsample(_t(pts), _t(mask), 0.3, out_cap=out_cap)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    m = np.asarray(wm)
    np.testing.assert_allclose(gp.numpy()[m], np.asarray(wp)[m], atol=1e-6)
    assert not gp.numpy()[~m].any()


def test_voxel_downsample_padded_tail():
    """A cloud that is mostly masked padding (as a submap or a padded
    keyframe is): same result as the JAX package, and bit for bit the
    result of the unpadded cloud, so the padding adds no segment work."""
    rng = np.random.default_rng(12)
    pts = rng.uniform(-4, 4, (4000, 3)).astype(np.float32)
    pts[:100] = pts[:100] * 0.05 + 1.0
    mask = np.zeros(4000, bool)
    mask[:300] = True
    wp, wm = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                     0.3, out_cap=512)
    gp, gm = voxel.voxel_downsample(_t(pts), _t(mask), 0.3, out_cap=512)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    m = np.asarray(wm)
    np.testing.assert_allclose(gp.numpy()[m], np.asarray(wp)[m], atol=1e-6)
    up, um = voxel.voxel_downsample(_t(pts[:300]), _t(mask[:300]), 0.3,
                                    out_cap=512)
    assert torch.equal(gp, up) and torch.equal(gm, um)


def test_spatial_hash_bit_identical():
    rng = np.random.default_rng(10)
    c = rng.integers(-2000, 2000, (4096, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        voxel.spatial_hash(_t(c)).numpy(),
        np.asarray(jvoxel.spatial_hash(jnp.asarray(c))))


def test_distinctive_matches_jax():
    rng = np.random.default_rng(11)
    desc = rng.dirichlet(np.ones(11) * 0.3, size=(400, 3)).reshape(400, 33)
    desc = (desc * 100).astype(np.float32)
    valid = rng.random(400) > 0.1
    for thr in (65.0, 90.0):
        np.testing.assert_array_equal(
            fpfh.distinctive(_t(desc), _t(valid), thr).numpy(),
            np.asarray(jfpfh.distinctive(jnp.asarray(desc),
                                         jnp.asarray(valid),
                                         jnp.float32(thr))))


def test_keyframe_store_append_and_convert():
    """append writes the same fields as the JAX store; the converter
    carries a JAX-built store across unchanged."""
    rng = np.random.default_rng(12)
    js = jkf.empty_store(4, 16)
    ts = keyframes.empty_store(4, 16, "cpu")
    for i in range(3):
        cloud = rng.normal(size=(16, 3)).astype(np.float32)
        m = rng.random(16) > 0.3
        T = _rand_poses(rng, 1)[0]
        js = jkf.append(js, jnp.asarray(cloud), jnp.asarray(m),
                        jnp.asarray(T), jnp.asarray(T), jnp.float32(i))
        ts = keyframes.append(ts, *convert.tensors_from_numpy(
            cloud, m, T, T, device="cpu"), float(i))
    carried = convert.keyframe_store_from_numpy(
        *[np.asarray(f) for f in js], device="cpu")
    for a, b, c in zip(ts, carried, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    assert int(ts.count) == 3
