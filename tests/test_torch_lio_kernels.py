"""Kernels K6 (``linalg3.eigh3_soa``, csrc/eigh3.cu) and K7
(``ieskf.propagate``, csrc/propagate.cu), the LIO step's two loops, on the
CPU: their plain versions against the JAX package on the same numpy
inputs, the wrappers' routing, and the wrappers' packing and unpacking
around a model of each kernel.  The kernels themselves run only on the
card, where chip_smoke.py holds them against the plain versions.

- ``eigh3_soa_plain`` against the JAX ``eigh3_soa`` on the refit's edge
  cases (zero, rank 1, repeated eigenvalues, 1e3 scale, no rows),
  surfel-like covariances and a (B, N) batch, at the tolerance of
  tests/test_torch_ops.py::test_eigh3_matches_jax_signs_and_order
  (eigenvalues rtol / atol 1e-5, eigenvectors atol 1e-4) on the matrix
  scaled to a largest entry of at most 1 (an eigenvalue's rounding error
  scales with its matrix, so atol is 1e-5 of that entry at the 1e3 scale);
  where eigenvalues coincide the eigenvectors are not unique, so a
  cluster of equal eigenvalues is held by the projector onto its span;
- ``propagate_plain`` against the JAX ``propagate`` at 18 and 24 dims on
  64 valid samples, one, duplicate stamps and IMU dropout, at the
  tolerance of tests/test_torch_lio_ops.py (R, p, v and the log 1e-5, P
  rtol 1e-4 with 1e-4 of its largest entry);
- CPU tensors never load the kernel library and never count a launch;
- the wrappers' glue with the launch replaced by a torch model of the
  kernel (the same arithmetic, read from the packed operands): equal to
  the plain version bit for bit, strided and non-viewable components, a
  (B, N) batch and no rows included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import ieskf as jieskf
from fast_lio_sam_qn_tpu.ops import linalg3 as jlinalg3
from fast_lio_sam_qn_tpu_torch import kernels
from fast_lio_sam_qn_tpu_torch.ops import ieskf, linalg3
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls

torch.set_num_threads(1)


def _eigh_cases():
    cases = ls.eigh3_edge_cases()
    cases["surfel"] = ls.covariance_rows(512)
    return cases


EIGH_CASES = sorted(_eigh_cases()) + ["batch"]


def _eigh_input(case):
    """(..., 6) components: a case of ``_eigh_cases`` or a (4, 128) batch."""
    if case == "batch":
        return ls.covariance_rows(512, seed=1).reshape(4, 128, 6)
    return _eigh_cases()[case]


def _flat(evals, evecs):
    """(3, n) eigenvalues and (3, 3, n) eigenvectors as numpy."""
    e = np.stack([np.asarray(x).reshape(-1) for x in evals])
    v = np.stack([np.stack([np.asarray(x).reshape(-1) for x in row])
                  for row in evecs])
    return e, v


@pytest.mark.parametrize("case", EIGH_CASES)
def test_eigh3_plain_matches_jax(case):
    a = _eigh_input(case)
    we, wv = _flat(*jlinalg3.eigh3_soa(*jnp.moveaxis(jnp.asarray(a), -1, 0)))
    ge, gv = _flat(*linalg3.eigh3_soa_plain(
        *torch.from_numpy(a).movedim(-1, 0)))
    assert ge.shape == we.shape == (3, a[..., 0].size)
    # an eigenvalue's rounding error scales with its matrix: compared on
    # the matrix over its largest entry (where that is above 1)
    scale = np.maximum(1.0, np.abs(a.reshape(-1, 6)).max(-1, initial=0))
    np.testing.assert_allclose(ge / scale, we / scale, rtol=1e-5, atol=1e-5)
    for i in range(we.shape[1]):
        e = we[:, i]
        # eigenvalues within 1e-4 of the scale are one cluster
        cluster = np.abs(e[:, None] - e[None, :]) <= 1e-4 * scale[i]
        for j in range(3):
            members = np.flatnonzero(cluster[j])
            if len(members) == 1:
                np.testing.assert_allclose(gv[:, j, i], wv[:, j, i],
                                           atol=1e-4)
            else:
                proj = [v[:, members, i] @ v[:, members, i].T
                        for v in (gv, wv)]
                np.testing.assert_allclose(*proj, atol=1e-4)


def _np_args(case, dim):
    nav, P0, t, g, a, m, t0, t1, noise = ls.propagate_case(case, dim)
    return nav, (P0, t, g, a, m, t0, t1, noise)


def _torch_propagate(fn, case, dim):
    nav, rest = _np_args(case, dim)
    return fn(ieskf.NavState(*map(torch.from_numpy, nav)),
              *(torch.from_numpy(np.asarray(x)) for x in rest))


@pytest.mark.parametrize("dim", [18, 24])
@pytest.mark.parametrize("case", ls.PROPAGATE_CASES)
def test_propagate_plain_matches_jax(case, dim):
    nav, rest = _np_args(case, dim)
    ws, wP, wlog = jieskf.propagate(jieskf.NavState(*map(jnp.asarray, nav)),
                                    *map(jnp.asarray, rest))
    s, P, log = _torch_propagate(ieskf.propagate_plain, case, dim)
    for x, y in zip(s[:3], ws[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-5)
    wP = np.asarray(wP)
    np.testing.assert_allclose(P.numpy(), wP, rtol=1e-4,
                               atol=1e-4 * float(np.abs(wP).max()))
    for x, y in zip(log, wlog):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-5)


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    """With the library made to raise, CPU tensors still run both wrappers
    (and ``eigh3``) and neither counter moves."""
    def no_library():
        raise RuntimeError("the kernel library must not be loaded")

    monkeypatch.setattr(kernels, "load_library", no_library)
    monkeypatch.setattr(linalg3.eigh3_soa, "launches", 0)
    monkeypatch.setattr(ieskf.propagate, "launches", 0)
    comps = torch.from_numpy(ls.covariance_rows(64)).unbind(1)
    linalg3.eigh3_soa(*comps)
    linalg3.eigh3(torch.eye(3).expand(5, 3, 3))
    _torch_propagate(ieskf.propagate, "full", 18)
    assert linalg3.eigh3_soa.launches == 0
    assert ieskf.propagate.launches == 0


def _eigh3_model(flat, sweeps, out):
    """K6's contract in torch: the plain solve of the strided views."""
    evals, evecs = linalg3.eigh3_soa_plain(*flat, sweeps=sweeps)
    out.copy_(torch.stack(list(evals) + [x for row in evecs for x in row]))


def _propagate_model(R, p, v, grav, P, mask, table, F_free, any_imu):
    """K7's walk in torch ops over the packed operands: row i of the table
    ([dt, a_c, rot, q]) and of F_free for sample i, skipped where masked,
    row K the tail's (its acceleration zeroed under dropout)."""
    k = mask.shape[0]
    log = []
    for i in range(k + 1):
        tail = i == k
        if tail or bool(mask[i]):
            row = table[i]
            dt, a, rot, q = row[0], row[1:4], row[4:13].view(3, 3), row[13:]
            a_w = R @ a + grav
            if tail:
                a_w = torch.where(any_imu[0], a_w, 0.0)
            F = ieskf._with_state_blocks(F_free[i], R, a, dt)
            P = F @ P @ F.T + torch.diag(q)
            R, p, v = (R @ rot, p + v * dt + 0.5 * a_w * dt * dt,
                       v + a_w * dt)
        if not tail:
            log.append((R, p, v))
    return torch.cat([R.reshape(-1), p, v, P.reshape(-1)]
                     + [torch.stack(x).reshape(-1) for x in zip(*log)])


@pytest.fixture
def modelled_kernels(monkeypatch):
    """The wrappers take their kernel path on CPU tensors, their launches
    replaced by the torch models; the counters start at 0."""
    monkeypatch.setattr(kernels, "on_cuda", lambda name, t: True)
    monkeypatch.setattr(linalg3, "_launch_eigh3", _eigh3_model)
    monkeypatch.setattr(ieskf, "_launch_propagate", _propagate_model)
    monkeypatch.setattr(linalg3.eigh3_soa, "launches", 0)
    monkeypatch.setattr(ieskf.propagate, "launches", 0)


def _equal(got, want):
    got, want = _flat(*got), _flat(*want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("layout", ["columns", "transposed", "batch",
                                    "empty"])
def test_eigh3_wrapper_around_a_model(modelled_kernels, layout):
    rows = torch.from_numpy(ls.covariance_rows(512))
    if layout == "columns":      # cov[:, j] views at stride 6, as the refit
        comps = rows.unbind(1)
    elif layout == "transposed":  # (16, 32) views no flat stride can read
        comps = rows.view(32, 16, 6).transpose(0, 1).unbind(2)
    elif layout == "batch":
        comps = rows.view(4, 128, 6).unbind(2)
    else:
        comps = rows[:0].unbind(1)
    evals, evecs = linalg3.eigh3_soa(*comps)
    assert all(x.shape == comps[0].shape for x in evals)
    _equal((evals, evecs), linalg3.eigh3_soa_plain(*comps))
    assert linalg3.eigh3_soa.launches == (layout != "empty")


@pytest.mark.parametrize("dim", [18, 24])
@pytest.mark.parametrize("case", ls.PROPAGATE_CASES)
def test_propagate_wrapper_around_a_model(modelled_kernels, case, dim):
    s, P, log = _torch_propagate(ieskf.propagate, case, dim)
    ws, wP, wlog = _torch_propagate(ieskf.propagate_plain, case, dim)
    for got, want in zip([*s, P, *log], [*ws, wP, *wlog]):
        assert got.shape == want.shape and torch.equal(got, want)
    assert ieskf.propagate.launches == 1
