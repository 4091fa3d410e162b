"""P2G/G2P transfer tests: scatter-add vs dense NumPy matmul oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from nlpartsol.ops import sparse


def dense_from_pattern(ids, mask, w, n_nodes):
    """Build the dense (Np, n_nodes) interpolation matrix."""
    np_, k = ids.shape
    A = np.zeros((np_, n_nodes))
    for p in range(np_):
        for j in range(k):
            if mask[p, j]:
                A[p, ids[p, j]] += w[p, j]
    return A


def test_p2g_g2p_match_dense():
    rng = np.random.default_rng(0)
    np_, k, n_nodes = 40, 6, 25
    ids = rng.integers(0, n_nodes, (np_, k)).astype(np.int32)
    mask = rng.uniform(size=(np_, k)) > 0.3
    w = rng.standard_normal((np_, k)).astype(np.float32)
    A = dense_from_pattern(ids, mask, w, n_nodes)

    # scalar scatter
    out = np.asarray(sparse.p2g(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(w), n_nodes))
    np.testing.assert_allclose(out, A.sum(0), rtol=1e-5, atol=1e-5)

    # vector scatter: w * per-particle vector
    vec = rng.standard_normal((np_, 3)).astype(np.float32)
    vals = w[..., None] * vec[:, None, :]
    out_v = np.asarray(
        sparse.p2g(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vals), n_nodes)
    )
    np.testing.assert_allclose(out_v, A.T @ vec, rtol=1e-4, atol=1e-4)

    # gather (transpose SpMV)
    field = rng.standard_normal((n_nodes, 3)).astype(np.float32)
    got = np.asarray(
        sparse.g2p(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(field))
    )
    np.testing.assert_allclose(got, A @ field, rtol=1e-4, atol=1e-4)

    scal = rng.standard_normal((n_nodes,)).astype(np.float32)
    got_s = np.asarray(
        sparse.g2p(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(scal))
    )
    np.testing.assert_allclose(got_s, A @ scal, rtol=1e-4, atol=1e-4)


def test_out_of_range_dropped():
    ids = jnp.array([[0, 99]], jnp.int32)  # 99 out of range for 10 nodes
    mask = jnp.array([[True, True]])
    w = jnp.array([[1.0, 1.0]], jnp.float32)
    out = np.asarray(sparse.p2g(ids, mask, w, 10))
    assert out[0] == 1.0 and out.sum() == 1.0


class TestNonsymmetricKrylov:
    """BiCGStab / GMRES(m) against numpy LU on random nonsymmetric systems
    (the matrix-free replacement for the reference's dense LAPACK solves,
    U-pw-Newmark-beta.c:2238-2285)."""

    def _system(self, n=40, seed=0):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((n, n)).astype(np.float32) * 0.3
        A += np.eye(n, dtype=np.float32) * n  # diagonally dominant
        b = rng.standard_normal(n).astype(np.float32)
        return A, b

    def test_bicgstab(self):
        from nlpartsol.ops.solvers import bicgstab

        A, b = self._system()
        res = jax.jit(
            lambda b: bicgstab(lambda v: jnp.asarray(A) @ v, b, tol=1e-6, maxiter=200)
        )(jnp.asarray(b))
        x_ref = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-4, atol=2e-5)

    def test_gmres(self):
        from nlpartsol.ops.solvers import gmres

        A, b = self._system(seed=1)
        res = jax.jit(
            lambda b: gmres(lambda v: jnp.asarray(A) @ v, b, tol=1e-6, restart=20)
        )(jnp.asarray(b))
        x_ref = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-4, atol=2e-5)

    def test_gmres_preconditioned(self):
        from nlpartsol.ops.solvers import gmres

        A, b = self._system(seed=2)
        Minv = 1.0 / np.diag(A)
        res = gmres(
            lambda v: jnp.asarray(A) @ v,
            jnp.asarray(b),
            M_inv=lambda r: jnp.asarray(Minv) * r,
            tol=1e-6,
            restart=15,
        )
        x_ref = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-4, atol=2e-5)

    def test_bicgstab_matches_shape_2d(self):
        from nlpartsol.ops.solvers import bicgstab

        A, b = self._system(n=36, seed=3)
        b2 = b.reshape(12, 3)
        res = bicgstab(
            lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(12, 3),
            jnp.asarray(b2),
            tol=1e-6,
        )
        x_ref = np.linalg.solve(A, b).reshape(12, 3)
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-4, atol=2e-5)


def test_dense_lu_direct_fallback():
    """ops/solvers.dense_lu — the reference's LAPACK dgetrs fallback
    (src/Linear-Solvers/dgetrs-LAPACK.c:14) as a matrix-free direct solve."""
    import numpy as np
    import jax.numpy as jnp
    from nlpartsol.ops import solvers

    rng = np.random.default_rng(0)
    n = 24
    A_np = rng.standard_normal((n, n))
    A_np = A_np @ A_np.T + n * np.eye(n)  # SPD
    A_j = jnp.asarray(A_np, jnp.float32)
    b = jnp.asarray(rng.standard_normal((n,)), jnp.float32)
    res = solvers.dense_lu(lambda v: A_j @ v, b)
    np.testing.assert_allclose(
        np.asarray(res.x), np.linalg.solve(A_np, np.asarray(b)), rtol=2e-4
    )
    # shaped unknowns + Dirichlet-style free mask
    b2 = b.reshape(12, 2)
    fm = jnp.ones((12, 2), bool).at[0, :].set(False)
    res2 = solvers.dense_lu(lambda v: (A_j @ v.reshape(-1)).reshape(12, 2), b2,
                            free_mask=fm)
    assert np.allclose(np.asarray(res2.x)[0], 0.0)
    assert float(res2.residual) < 1e-3
