"""Unit tests for the batched small-tensor core vs NumPy oracles
(the reference's own oracle pattern: tests/Constitutive/*.py, SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nlpartsol.ops import tensor as tn


def rand_spd(rng, n, d):
    a = rng.standard_normal((n, d, d))
    return (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d)).astype(np.float32)


def rand_mat(rng, n, d):
    a = rng.standard_normal((n, d, d)).astype(np.float32)
    # keep determinants away from zero
    return a + 3.0 * np.eye(d, dtype=np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_det_inv_adj(d):
    rng = np.random.default_rng(0)
    a = rand_mat(rng, 64, d)
    np.testing.assert_allclose(tn.det(a), np.linalg.det(a), rtol=2e-5)
    np.testing.assert_allclose(tn.inv(a), np.linalg.inv(a), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(
        tn.adj(a), np.linalg.inv(a) * np.linalg.det(a)[:, None, None], rtol=5e-4, atol=5e-5
    )
    np.testing.assert_allclose(
        tn.inv_transpose(a),
        np.linalg.inv(a).transpose(0, 2, 1),
        rtol=5e-4,
        atol=5e-5,
    )


@pytest.mark.parametrize("d", [2, 3])
def test_invariants(d):
    rng = np.random.default_rng(1)
    a = rand_mat(rng, 16, d)
    np.testing.assert_allclose(tn.I1(a), np.trace(a, axis1=1, axis2=2), rtol=1e-6)
    np.testing.assert_allclose(tn.I3(a), np.linalg.det(a), rtol=2e-5)
    if d == 3:
        # I2 via eigenvalue symmetric functions on SPD matrices
        s = rand_spd(rng, 16, 3)
        w = np.linalg.eigvalsh(s)
        i2 = w[:, 0] * w[:, 1] + w[:, 0] * w[:, 2] + w[:, 1] * w[:, 2]
        np.testing.assert_allclose(tn.I2(s), i2, rtol=1e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_sym_eig(d):
    rng = np.random.default_rng(2)
    s = rand_spd(rng, 128, d)
    w, V = tn.sym_eig(s)
    w = np.asarray(w)
    V = np.asarray(V)
    w_ref = np.linalg.eigvalsh(s)
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-4)
    # Reconstruction and orthogonality
    rec = (V * w[:, None, :]) @ V.transpose(0, 2, 1)
    np.testing.assert_allclose(rec, s, rtol=1e-4, atol=1e-4)
    eye = np.eye(d, dtype=np.float32)
    np.testing.assert_allclose(
        V.transpose(0, 2, 1) @ V, np.broadcast_to(eye, s.shape), atol=1e-5
    )


def test_sym_eig_degenerate():
    # Repeated eigenvalues (identity, isotropic) must not NaN
    a = np.broadcast_to(np.eye(3, dtype=np.float32) * 2.0, (4, 3, 3)).copy()
    w, V = tn.sym_eig(a)
    assert np.all(np.isfinite(np.asarray(w)))
    assert np.all(np.isfinite(np.asarray(V)))
    np.testing.assert_allclose(np.asarray(w), 2.0, atol=1e-6)


def test_sym_func_log():
    rng = np.random.default_rng(3)
    s = rand_spd(rng, 32, 3)
    lg = np.asarray(tn.sym_func(s, jnp.log))
    w, v = np.linalg.eigh(s)
    ref = (v * np.log(w)[:, None, :]) @ v.transpose(0, 2, 1)
    np.testing.assert_allclose(lg, ref, rtol=1e-3, atol=1e-4)
