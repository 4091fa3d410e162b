"""uGIMP and aLME shape-function tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.shapefun import alme, gimp, lme
from nlpartsol.models import materials as M
from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
from nlpartsol.formulations.courant import courant_dt

from tests.test_explicit import bar_setup, C, E_


def make_grid(d, n=9, h=0.5):
    return Grid(dims=(n,) * d, spacing=h, origin=(0.0,) * d)


@pytest.mark.parametrize("d", [2, 3])
def test_gimp_partition_of_unity_and_consistency(d):
    grid = make_grid(d)
    rng = np.random.default_rng(0)
    lo, hi = 2 * grid.spacing, (np.array(grid.dims) - 3) * grid.spacing
    x = (rng.uniform(0, 1, (24, d)) * (hi - lo) + lo).astype(np.float32)
    lp = jnp.full((24,), 0.25 * grid.spacing, jnp.float32)
    out = gimp.evaluate(grid, jnp.asarray(x), lp)
    N, dN, ids, mask = (np.asarray(out[k]) for k in ("N", "dN", "node_ids", "mask"))
    np.testing.assert_allclose(N.sum(-1), 1.0, atol=1e-5)
    coords = np.asarray(grid.node_coords())
    xa = np.where(mask[..., None], coords[ids], 0.0)
    np.testing.assert_allclose(np.einsum("pk,pkd->pd", N, xa), x, atol=1e-4)
    np.testing.assert_allclose(dN.sum(1), 0.0, atol=1e-4)
    gc = np.einsum("pki,pkj->pij", dN, xa)
    np.testing.assert_allclose(gc, np.broadcast_to(np.eye(d), gc.shape), atol=1e-3)


def test_gimp_matches_1d_kernel():
    """Cross-check the tensor-product against the 1D kernel directly."""
    grid = make_grid(1 + 1, n=9, h=1.0)  # 2D
    x = jnp.asarray([[4.3, 4.0]], jnp.float32)
    lp = jnp.asarray([0.25], jnp.float32)
    out = gimp.evaluate(grid, x, lp)
    N = np.asarray(out["N"])[0]
    ids = np.asarray(out["node_ids"])[0]
    coords = np.asarray(grid.node_coords())

    def sip(L, lpv, dx):
        a = abs(dx)
        if a <= lpv:
            return 1 - 0.5 * (dx * dx + lpv * lpv) / (L * lpv)
        if a <= L - lpv:
            return 1 - a / L
        if a < L + lpv:
            return 0.25 * (L + lpv - a) ** 2 / (L * lpv)
        return 0.0

    for k in range(len(ids)):
        dx = 4.3 - coords[ids[k], 0]
        dy = 4.0 - coords[ids[k], 1]
        ref = sip(1.0, 0.25, dx) * sip(1.0, 0.25, dy)
        assert abs(N[k] - ref) < 1e-6, (k, N[k], ref)


def test_alme_reduces_to_lme_with_isotropic_beta():
    grid = make_grid(2, n=9, h=0.5)
    params_l = lme.LMEParams(gamma=3.0)
    params_a = alme.ALMEParams(gamma=3.0, max_stretch=1.0)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(1.2, 2.8, (16, 2)), jnp.float32)
    lam0 = jnp.zeros((16, 2), jnp.float32)
    beta_t = alme.init_lme_beta(16, params_a, grid.spacing, 2)
    out_a = alme.evaluate(grid, x, lam0, beta_t, params_a)
    out_l = lme.evaluate(grid, x, lam0, params_l)
    # same window sizes here (max_stretch=1) — N and dN must agree
    np.testing.assert_allclose(np.asarray(out_a["N"]), np.asarray(out_l["N"]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_a["dN"]), np.asarray(out_l["dN"]), atol=1e-3)


def test_alme_anisotropic_partition_of_unity():
    grid = make_grid(2, n=11, h=0.5)
    params = alme.ALMEParams(gamma=2.0, max_stretch=1.5)
    x = jnp.asarray([[2.3, 2.6], [2.8, 2.2]], jnp.float32)
    beta_iso = alme.init_lme_beta(2, params, grid.spacing, 2)
    # stretch the metric anisotropically (as a sheared ΔF would)
    DF = jnp.asarray([[[1.3, 0.1], [0.0, 0.8]]] * 2, jnp.float32)
    beta_t = alme.update_beta(beta_iso, DF)
    out = alme.evaluate(grid, x, jnp.zeros((2, 2), jnp.float32), beta_t, params)
    np.testing.assert_allclose(np.asarray(out["N"]).sum(-1), 1.0, atol=1e-5)
    assert np.all(np.isfinite(np.asarray(out["dN"])))


def test_gimp_explicit_step_runs():
    grid, p, mats, L, h = bar_setup()
    cfg = ExplicitConfig(dt=courant_dt(0.25, h, C), shapefun="gimp", kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(explicit_step, static_argnums=(3,))
    p1, diag = step(p, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
    assert np.all(np.isfinite(np.asarray(p1.x)))
    assert int(diag["nnz"]) > 0


def test_alme_explicit_step_runs():
    grid, p, mats, L, h = bar_setup()
    params = alme.ALMEParams(gamma=3.0, max_stretch=1.2)
    p = p.replace(lme_beta=alme.init_lme_beta(p.count, params, h, 2))
    cfg = ExplicitConfig(
        dt=courant_dt(0.25, h, C), shapefun="alme", alme_params=params, kinds=(M.NEO_HOOKEAN,)
    )
    step = jax.jit(explicit_step, static_argnums=(3,))
    p1, diag = step(p, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
    assert np.all(np.isfinite(np.asarray(p1.x)))
    # beta was pulled back (identity ΔF at rest ⇒ unchanged)
    np.testing.assert_allclose(np.asarray(p1.lme_beta), np.asarray(p.lme_beta), rtol=1e-4)
