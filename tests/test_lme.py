"""LME shape-function tests: partition of unity, first-order consistency,
gradient consistency, NumPy cross-check of the λ-Newton solution.

Oracle relations (from the LME construction, reference LME.c):
  Σ_a p_a = 1            (partition of unity)
  Σ_a p_a x_a = x_p      (first-order consistency ⇔ r = 0 at converged λ)
  Σ_a ∇p_a = 0
  Σ_a ∇p_a ⊗ x_a = I     (gradient consistency)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid
from nlpartsol.shapefun import lme


def make_grid(d, n=9, h=0.5):
    return Grid(dims=(n,) * d, spacing=h, origin=(0.0,) * d)


@pytest.mark.parametrize(
    "d,gamma",
    [(2, 0.8), (2, 3.0), (3, 3.0)],  # γ=0.8 in 3D ⇒ K=13³ window: too slow for CI
)
def test_lme_consistency(d, gamma):
    grid = make_grid(d, n=9 if d == 2 else 7)
    params = lme.LMEParams(gamma=gamma)
    rng = np.random.default_rng(42)
    # interior particles (away from the boundary by one support radius)
    lo = grid.spacing * lme.window_halfwidth(params, grid.spacing)
    hi = grid.spacing * (np.array(grid.dims) - 1) - lo
    npts = 32
    x = (rng.uniform(0, 1, (npts, d)) * (hi - lo) + lo).astype(np.float32)
    lam0 = jnp.zeros((npts, d), jnp.float32)

    out = jax.jit(lme.evaluate, static_argnums=())(grid, jnp.asarray(x), lam0, params)
    N = np.asarray(out["N"])
    dN = np.asarray(out["dN"])
    ids = np.asarray(out["node_ids"])
    mask = np.asarray(out["mask"])

    coords = np.asarray(grid.node_coords())
    xa = coords[ids]  # (Np, K, d)

    # partition of unity
    np.testing.assert_allclose(N.sum(-1), 1.0, atol=1e-5)
    # first-order consistency
    np.testing.assert_allclose(
        np.einsum("pk,pkd->pd", N, np.where(mask[..., None], xa, 0.0)), x, atol=2e-4
    )
    # gradient: sums to zero, reproduces identity
    np.testing.assert_allclose(dN.sum(1), 0.0, atol=2e-3)
    grad_consistency = np.einsum("pki,pkj->pij", dN, np.where(mask[..., None], xa, 0.0))
    np.testing.assert_allclose(
        grad_consistency, np.broadcast_to(np.eye(d), (npts, d, d)), atol=5e-3
    )


def test_lme_matches_numpy_newton():
    """Cross-check λ and p against an independent float64 NumPy Newton."""
    d, h, gamma = 2, 0.25, 1.5
    grid = make_grid(d, n=11, h=h)
    params = lme.LMEParams(gamma=gamma, max_iter=40)
    beta = gamma / h**2
    x = np.array([[1.07, 1.33]], dtype=np.float32)

    out = lme.evaluate(grid, jnp.asarray(x), jnp.zeros((1, d), jnp.float32), params)
    ids = np.asarray(out["node_ids"])[0]
    mask = np.asarray(out["mask"])[0]
    coords = np.asarray(grid.node_coords())
    la = (x[0][None, :] - coords[ids])[mask]  # valid l vectors, float64

    lam = np.zeros(d)
    for _ in range(100):
        f = -beta * (la**2).sum(-1) + la @ lam
        p = np.exp(f - f.max())
        p /= p.sum()
        r = p @ la
        if np.linalg.norm(r) < 1e-12:
            break
        J = np.einsum("k,ki,kj->ij", p, la, la) - np.outer(r, r)
        lam = lam - np.linalg.solve(J, r)

    np.testing.assert_allclose(np.asarray(out["lam"])[0], lam, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out["N"])[0][mask], p, atol=1e-5)

    # gradient oracle
    J = np.einsum("k,ki,kj->ij", p, la, la) - np.outer(p @ la, p @ la)
    dp_ref = -p[:, None] * (la @ np.linalg.inv(J).T)
    np.testing.assert_allclose(np.asarray(out["dN"])[0][mask], dp_ref, atol=1e-4)


def test_boundary_particle_partition_of_unity():
    """Particles near the domain edge see a truncated window but the masked
    softmax still partitions unity."""
    grid = make_grid(2, n=7, h=1.0)
    params = lme.LMEParams(gamma=1.0)
    x = jnp.array([[0.1, 0.1], [5.9, 0.2], [0.05, 5.95]], jnp.float32)
    out = lme.evaluate(grid, x, jnp.zeros((3, 2), jnp.float32), params)
    np.testing.assert_allclose(np.asarray(out["N"]).sum(-1), 1.0, atol=1e-5)
    assert np.all(np.isfinite(np.asarray(out["dN"])))
