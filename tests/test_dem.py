"""Discrete Energy-Momentum integrator tests.

Oracle: the defining property of the scheme — exact conservation of total
(kinetic + strain) energy and of linear momentum for free hyperelastic
motion (Gonzalez discrete gradient), which neither Newmark nor the explicit
integrators provide exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nlpartsol.models import materials as M
from nlpartsol.formulations.dem import DEMConfig, dem_step, run
from nlpartsol.formulations.courant import courant_dt

from tests.test_explicit import bar_setup, E_, RHO, C


def _energies(p, mats, kinds):
    from nlpartsol.formulations.dem import _strain_energy

    ke = 0.5 * float(jnp.sum(p.mass * jnp.sum(p.v**2, -1)))
    se = float(jnp.sum(_strain_energy(p.F, p, mats, kinds) * p.vol0))
    return ke, se


def test_dem_conserves_energy_svk():
    """SVK bar vibration at a step 4x the explicit CFL: total energy must be
    conserved to solver tolerance over 20 steps (the scheme's raison d'etre;
    reference U-Discrete-Energy-Momentum.c:116)."""
    grid, p, mats, L, h = bar_setup("fem")
    mats = M.material_table(
        [M.material(kind="Saint-Venant-Kirchhoff", E=E_, nu=0.3, rho0=RHO)]
    )
    kinds = (M.SAINT_VENANT_KIRCHHOFF,)
    V = 0.05  # finite-amplitude so nonlinearity matters
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))

    dt = courant_dt(1.0, h, C)
    cfg = DEMConfig(dt=dt, shapefun="fem", kinds=kinds, newton_tol=1e-7)
    ke0, se0 = _energies(p, mats, kinds)
    E0 = ke0 + se0
    assert E0 > 0

    # (a) grid-level per-step conservation — the discrete-gradient property
    # itself: ΔKE_grid + ΔW = 0 to solver tolerance on every step
    step = jax.jit(dem_step, static_argnums=(3,))
    pp = p
    for _ in range(6):
        pp, diag = step(pp, grid, mats, cfg, jnp.zeros(2, jnp.float32))
        rel = abs(float(diag["grid_energy_increment"])) / E0
        assert rel < 5e-3, f"grid energy increment {rel:.2e} of E0"  # f32 Newton floor

    # (b) particle-level total energy over 20 steps: bounded drift (FLIP
    # transfer error only — Newmark at this Δt decays or blows the energy
    # much faster)
    runj = jax.jit(run, static_argnums=(3, 4))
    p1, diags = runj(p, grid, mats, cfg, 20)
    ke = np.asarray(diags["kinetic_energy"])
    se = np.asarray(diags["strain_energy"])
    Etot = ke + se
    drift = np.abs(Etot - E0).max() / E0
    assert drift < 5e-2, f"energy drift {drift:.2e}"
    assert np.all(np.asarray(diags["newton_iters"]) <= 30)


def test_dem_conserves_momentum_free_flight():
    """A free body (no Dirichlet, no gravity) keeps its linear momentum
    bit-for-bit (structural: internal forces are equal-and-opposite)."""
    grid, p, mats, L, h = bar_setup("fem")
    grid = grid.replace(dirichlet_mask=None, dirichlet_value=None)
    v0 = np.full((p.count, 2), 0.0, np.float32)
    v0[:, 0] = 0.02
    v0[:, 1] = 0.01 * np.sin(2 * np.pi * np.asarray(p.x)[:, 0] / L)  # + wiggle
    p = p.replace(v=jnp.asarray(v0))
    mom0 = np.asarray(jnp.sum(p.mass[:, None] * p.v, axis=0))

    dt = courant_dt(1.0, h, C)
    cfg = DEMConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(dem_step, static_argnums=(3,))
    for _ in range(5):
        p, diag = step(p, grid, mats, cfg, jnp.zeros(2, jnp.float32))
    mom = np.asarray(jnp.sum(p.mass[:, None] * p.v, axis=0))
    np.testing.assert_allclose(mom, mom0, rtol=1e-4, atol=1e-6)
    assert np.isfinite(np.asarray(p.x)).all()


def test_dem_matches_newmark_small_amplitude():
    """Small-amplitude vibration: DEM and Newmark agree on displacement."""
    from nlpartsol.formulations.implicit import ImplicitConfig, run as run_nm

    grid, p, mats, L, h = bar_setup("fem")
    V = 0.002
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    dt = courant_dt(0.5, h, C)
    n = max(4, int(round((np.pi / 4 / omega) / dt)))

    cfg_d = DEMConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    cfg_n = ImplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    p_d, _ = jax.jit(run, static_argnums=(3, 4))(p, grid, mats, cfg_d, n)
    p_n, _ = jax.jit(run_nm, static_argnums=(3, 4))(p, grid, mats, cfg_n, n)
    ud, un = np.asarray(p_d.dis), np.asarray(p_n.dis)
    scale = np.abs(un).max()
    assert np.abs(ud - un).max() / scale < 0.08


def test_dem_pallas_parity_and_energy():
    """Fused-pallas DEM: matches the windowed
    engine and keeps the discrete-gradient grid-energy identity."""
    import jax

    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import windowed as win
    from nlpartsol.shapefun import lme as lme_mod

    grid, p, mats, L, h = bar_setup("lme")
    box = win.full_box(grid, capacity=8)
    cel = np.sqrt(E_ / RHO)
    n_steps = 10
    outs = {}
    for transfer in ("windowed", "pallas"):
        cfg = DEMConfig(
            dt=1.0 * h / cel,
            shapefun="lme",
            lme_params=lme_mod.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)
        step = jax.jit(dem_step, static_argnums=(3,))
        einc = []
        for _ in range(n_steps):
            pp, diag = step(pp, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
            assert bool(diag["converged"])
            einc.append(float(diag["grid_energy_increment"]))
            escale = float(diag["grid_kinetic_energy"]) + 1e-12
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        outs[transfer] = (
            np.asarray(pp.x)[act][order],
            np.asarray(pp.v)[act][order],
            np.abs(np.asarray(einc)).max() / escale,
        )
    xw, vw, ew = outs["windowed"]
    xp, vp, ep = outs["pallas"]
    np.testing.assert_allclose(xp, xw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vp, vw, rtol=0, atol=1e-5)
    # energy-exactness of the discrete gradient survives the fused engine
    assert ep < 5e-4, ep
