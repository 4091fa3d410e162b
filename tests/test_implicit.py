"""Implicit Newmark-β / quasi-static driver tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.models import materials as M
from nlpartsol.formulations.implicit import (
    ImplicitConfig,
    implicit_step,
    newmark_parameters,
    run,
)
from nlpartsol.formulations.courant import courant_dt, celerity
from nlpartsol.ops.solvers import pcg, newton_krylov

from tests.test_explicit import bar_setup, E_, RHO, C


def test_newmark_parameters_match_reference():
    """α₁..α₆ exactly as U-Newmark-beta.c:497-514."""
    beta, gamma, dt = 0.25, 0.5, 0.01
    nm = newmark_parameters(beta, gamma, dt)
    assert nm.alpha_1 == pytest.approx(1 / (beta * dt**2))
    assert nm.alpha_2 == pytest.approx(1 / (beta * dt))
    assert nm.alpha_3 == pytest.approx((1 - 2 * beta) / (2 * beta))
    assert nm.alpha_4 == pytest.approx(gamma / (beta * dt))
    assert nm.alpha_5 == pytest.approx(1 - gamma / beta)
    assert nm.alpha_6 == pytest.approx((1 - gamma / (2 * beta)) * dt)


def test_pcg_solves_spd_system():
    rng = np.random.default_rng(0)
    n = 32
    Amat = rng.standard_normal((n, n)).astype(np.float32)
    Amat = Amat @ Amat.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    res = pcg(lambda v: jnp.asarray(Amat) @ v, jnp.asarray(b), tol=1e-6, maxiter=200)
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(Amat, b), rtol=1e-3, atol=1e-4)


def test_newton_krylov_nonlinear():
    """Solve a small nonlinear system with a known root."""

    def residual(x):
        return x**3 + x - jnp.asarray([2.0, 10.0], jnp.float32)

    res = newton_krylov(residual, jnp.zeros(2, jnp.float32), tol=1e-6, maxiter=30)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 2.0], atol=1e-4)


def test_implicit_bar_vibration():
    """Same oracle as the explicit test (BASELINE config 1), implicit
    Newmark-β with a larger stable step."""
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))

    dt = courant_dt(1.0, h, C)  # 4x the explicit test's step: implicit is stable
    cfg = ImplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    runj = jax.jit(run, static_argnums=(3, 4))
    p1, diags = runj(p, grid, mats, cfg, n_quarter)

    xs = np.asarray(p.x)[:, 0]
    u_ref = (V / omega) * np.sin(np.pi * xs / L)
    u_num = np.asarray(p1.dis)[:, 0]
    err = np.abs(u_num - u_ref).max() / (V / omega)
    assert err < 0.12, f"quarter-period displacement error {err:.3f}"
    assert np.all(np.asarray(diags["newton_iters"]) <= 20)


def test_quasi_static_gravity_column():
    """Quasi-static column under gravity: stress at depth y ≈ ρ g (H − y).
    Exercises the U_Static analog (gravity pre-load of the -ff flow)."""
    nx, ny = 2, 10
    h = 0.1
    H = ny * h
    dims = (nx + 1, ny + 1)
    n_nodes = dims[0] * dims[1]
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 2), bool)
    dmask[ids[:, 0], 1] = True  # bottom: fix y
    dmask[:, 0] = True  # 1D column: fix all x
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 2), jnp.float32),
    )
    ppc = 2
    xs = []
    for i in range(nx):
        for j in range(ny):
            for a in range(ppc):
                for b in range(ppc):
                    xs.append([(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h])
    x = np.array(xs, np.float32)
    vol = (h / ppc) ** 2
    p = make_particles(x, mass=np.full(len(x), RHO * vol), vol0=np.full(len(x), vol))
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)])

    g = 9.81
    cfg = ImplicitConfig(dt=1.0, shapefun="fem", kinds=(M.NEO_HOOKEAN,), quasi_static=True)
    step = jax.jit(implicit_step, static_argnums=(3,))
    p1, diag = step(p, grid, mats, cfg, jnp.asarray([0.0, -g], jnp.float32))
    assert bool(diag["converged"])

    y = np.asarray(p1.x)[:, 1]
    s_yy = np.asarray(p1.stress)[:, 1, 1]
    s_ref = -RHO * g * (H - y)
    # MPM surface/quadrature error: compare in the bulk with 15% tolerance
    bulk = (y > 0.15) & (y < 0.85)
    err = np.abs(s_yy[bulk] - s_ref[bulk]).max() / (RHO * g * H)
    assert err < 0.15, f"lithostatic stress error {err:.3f}"


def test_implicit_dense_lu_matches_cg():
    """linear='dense' (direct LU fallback) reproduces the Newton-CG step."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M
    from nlpartsol.types import Grid, make_particles

    nx = 6
    h = 1.0 / nx
    dims = (nx + 1, 3)
    nn = dims[0] * dims[1]
    ids = np.arange(nn).reshape(dims)
    dmask = np.zeros((nn, 2), bool)
    dmask[ids[0, :], 0] = True
    dmask[:, 1] = True
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0),
                dirichlet_mask=jnp.asarray(dmask),
                dirichlet_value=jnp.zeros((nn, 2), jnp.float32))
    xs = [[(i + 0.5) * h, (j + 0.5) * h] for i in range(nx) for j in range(2)]
    x = np.array(xs, np.float32)
    p = make_particles(x, mass=np.full(len(x), 1000.0 * h * h, np.float32),
                       vol0=np.full(len(x), h * h, np.float32))
    rng = np.random.default_rng(3)
    p = p.replace(v=jnp.asarray(0.05 * rng.standard_normal(x.shape), jnp.float32))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    common = dict(dt=1e-3, shapefun="lme", kinds=(M.NEO_HOOKEAN,),
                  newton_tol=1e-7, newton_maxiter=15)
    body = jnp.zeros((2,), jnp.float32)
    stepj = jax.jit(implicit_step, static_argnums=(3,))
    p_cg, d_cg = stepj(p, grid, mats, ImplicitConfig(**common), body)
    p_lu, d_lu = stepj(p, grid, mats, ImplicitConfig(linear="dense", **common), body)
    assert bool(d_cg["converged"]) and bool(d_lu["converged"])
    np.testing.assert_allclose(np.asarray(p_lu.x), np.asarray(p_cg.x),
                               rtol=1e-5, atol=1e-7)
    assert int(d_lu["newton_iters"]) <= int(d_cg["newton_iters"])
