"""Two-phase soil-water (-upw) formulation tests.

Oracle: 1D consolidation physics — an undrained saturated column under
self-weight builds pore pressure; with drainage at the top it consolidates
(pore pressure decays, effective stress grows).  Validates the coupled
mixture equilibrium + mass balance without requiring the (unpublished)
reference numbers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.models import materials as M
from nlpartsol.formulations.upw import (
    MixtureTable,
    UpwConfig,
    init_mixture_state,
    make_mixture_table,
    upw_step,
)

E_SOIL, RHO_S, RHO_F = 1e7, 2700.0, 1000.0
KF = 2.2e9  # water bulk modulus


def column_setup(ny=10, h=0.1):
    nx = 2
    dims = (nx + 1, ny + 1)
    n_nodes = dims[0] * dims[1]
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 2), bool)
    dmask[ids[:, 0], 1] = True  # bottom fixed in y
    dmask[:, 0] = True  # 1D column: no x motion
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 2), jnp.float32),
    )
    ppc = 2
    xs = [
        [(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h]
        for i in range(nx)
        for j in range(ny)
        for a in range(ppc)
        for b in range(ppc)
    ]
    x = np.array(xs, np.float32)
    vol = (h / ppc) ** 2
    p = make_particles(x, mass=np.full(len(x), vol), vol0=np.full(len(x), vol))

    mats = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=E_SOIL, nu=0.3, rho0=RHO_S),
            M.material(kind="Newtonian-Fluid-Compressible", rho0=RHO_F, compressibility=KF),
        ]
    )
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)]
    )
    p = init_mixture_state(p, mats, mix)
    return grid, p, mats, mix, h, ny * h


def test_mixture_init():
    grid, p, mats, mix, h, H = column_setup()
    rho_mix = 2700 * 0.6 + 1000 * 0.4
    np.testing.assert_allclose(np.asarray(p.rho), rho_mix, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p.phi_f), 0.4)
    np.testing.assert_allclose(np.asarray(p.mass), rho_mix * np.asarray(p.vol0), rtol=1e-5)


def mixture_celerity(p, phi_f):
    """Undrained p-wave speed: (constrained skeleton + Biot modulus K_f/φ_f)
    over mixture density (DeltaT_Coussy__SolversLib__ uses only sqrt(E/ρ) —
    insufficient for stability with a stiff fluid)."""
    return np.sqrt((E_SOIL + KF / phi_f) / float(p.rho[0]))


def test_upw_gravity_loading_builds_pore_pressure():
    """Sudden gravity on a saturated column: pore pressure becomes positive
    (compression-positive convention, as the reference's mass balance) with
    magnitude growing with depth, and the run is stable."""
    grid, p, mats, mix, h, H = column_setup()
    cel = mixture_celerity(p, 0.4)
    dt = 0.3 * h / cel
    cfg = UpwConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(upw_step, static_argnums=(4,))
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    for _ in range(60):
        p, diag = step(p, grid, mats, mix, cfg, body)
    assert np.all(np.isfinite(np.asarray(p.x)))
    pw = np.asarray(p.pw)
    y = np.asarray(p.x)[:, 1]
    # compression ⇒ positive pore pressure, larger at depth
    deep = pw[y < 0.3 * H].mean()
    shallow = pw[y > 0.7 * H].mean()
    assert deep > 0, f"expected compressive (positive) pore pressure at depth, got {deep}"
    assert deep > shallow, "pore pressure must increase with depth"
    # fluid density and porosity responded
    assert np.asarray(p.phi_f).min() > 0.0
    assert abs(float(jnp.max(p.J)) - 1.0) < 0.1


def test_upw_incompressible_limit_total_stress():
    """With huge K_f and permeability→0 (undrained), the short-time total
    vertical stress must approach the lithostatic ρ_mix·g·(H−y) profile."""
    grid, p, mats, mix, h, H = column_setup()
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=0.0)]
    )
    rho_mix = float(p.rho[0])
    cel = mixture_celerity(p, 0.4)
    dt = 0.25 * h / cel
    cfg = UpwConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(upw_step, static_argnums=(4,))
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    # the undrained system has no dissipation: the p-wave rings forever, so
    # compare the TIME-AVERAGED total stress over full ring periods with the
    # lithostatic profile (the oscillation averages out)
    n_settle, n_avg = 200, 200
    for _ in range(n_settle):
        p, _ = step(p, grid, mats, mix, cfg, body)
    acc = None
    for _ in range(n_avg):
        p, _ = step(p, grid, mats, mix, cfg, body)
        s = np.asarray(p.stress)[:, 1, 1] - np.asarray(p.pw)
        acc = s if acc is None else acc + s
    s_total = acc / n_avg
    y = np.asarray(p.x)[:, 1]
    s_ref = -rho_mix * 9.81 * (H - y)
    bulk = (y > 0.15 * H) & (y < 0.85 * H)
    assert bulk.sum() > 0
    err = np.abs(s_total[bulk] - s_ref[bulk]).max() / (rho_mix * 9.81 * H)
    assert err < 0.30, f"time-averaged total stress error {err:.2f}"


def test_upw_implicit_matches_explicit():
    """Implicit monolithic Newmark vs explicit Verlet on the gravity-loaded
    column: after the same physical time the pore-pressure and displacement
    fields must agree (cross-integrator oracle; the reference has no
    published numbers)."""
    from nlpartsol.formulations.upw import UpwImplicitConfig, upw_newmark_step

    grid, p0, mats, mix, h, H = column_setup()
    cel = mixture_celerity(p0, 0.4)
    dt_exp = 0.25 * h / cel
    n_exp = 80
    T = n_exp * dt_exp

    body = jnp.asarray([0.0, -9.81], jnp.float32)
    cfg_e = UpwConfig(dt=dt_exp, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step_e = jax.jit(upw_step, static_argnums=(4,))
    pe = p0
    for _ in range(n_exp):
        pe, _ = step_e(pe, grid, mats, mix, cfg_e, body)

    n_imp = 20
    cfg_i = UpwImplicitConfig(dt=T / n_imp, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step_i = jax.jit(upw_newmark_step, static_argnums=(4,))
    pi = p0
    iters = []
    for _ in range(n_imp):
        pi, diag = step_i(pi, grid, mats, mix, cfg_i, body)
        iters.append(int(diag["newton_iters"]))
    assert max(iters) <= 20

    # displacement comparison
    ue = np.asarray(pe.dis)[:, 1]
    ui = np.asarray(pi.dis)[:, 1]
    scale = max(np.abs(ue).max(), 1e-12)
    err_u = np.abs(ui - ue).max() / scale
    assert err_u < 0.35, f"implicit vs explicit displacement mismatch {err_u:.3f}"
    # both build compressive pore pressure increasing with depth
    pwi = np.asarray(pi.pw)
    y = np.asarray(pi.x)[:, 1]
    assert pwi[y < 0.3 * H].mean() > 0
    assert pwi[y < 0.3 * H].mean() > pwi[y > 0.7 * H].mean()


def test_upw_implicit_drained_pressure_decays():
    """Open drainage at the top (θ = 0 Dirichlet) with nonzero permeability:
    pore pressure must decay toward the drained state (consolidation)."""
    from nlpartsol.formulations.upw import UpwImplicitConfig, upw_newmark_step

    grid, p0, mats, mix, h, H = column_setup(ny=6)
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-3)]
    )
    dims = grid.dims
    n_nodes = dims[0] * dims[1]
    ids = np.arange(n_nodes).reshape(dims)
    pw_mask = np.zeros((n_nodes,), bool)
    pw_mask[ids[:, -1]] = True  # top row drained
    pw_mask = jnp.asarray(pw_mask)
    pw_val = jnp.zeros((n_nodes,), jnp.float32)

    # consolidation timescale: c_v = k·E_oed/γ_w ≈ 1.4 m²/s, t_c = H²/c_v
    # ≈ 0.26 s — step well past the wave timescale (implicit: unconditionally
    # stable) and run ~1.5·t_c
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    cfg = UpwImplicitConfig(dt=0.01, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(upw_newmark_step, static_argnums=(4,))
    pi = p0
    peak, final = None, None
    for i in range(40):
        pi, diag = step(pi, grid, mats, mix, cfg, body, pw_mask, pw_val)
        mean_pw = float(np.asarray(pi.pw).mean())
        if i == 0:
            peak = mean_pw
        final = mean_pw
    assert np.isfinite(final)
    assert peak is not None and peak > 0
    assert final < 0.8 * peak, f"pore pressure did not consolidate: {peak} -> {final}"


def test_pallas_transfer_rejected_without_fused_path():
    """Steps WITHOUT a fused-pallas engine must fail loudly on
    transfer='pallas' instead of silently falling through to a
    ScatterEngine whose grid-axis psum would sum mismatched halo strips.
    The remaining fused-less steps are the FE /
    Generalized-α integrators."""
    from nlpartsol.formulations.explicit import ExplicitConfig
    from nlpartsol.formulations.integrators import forward_euler_step
    from nlpartsol.ops import windowed

    grid, p, mats, mix, h, H = column_setup()
    box = windowed.full_box(grid, capacity=8)
    cfg = ExplicitConfig(
        dt=1e-5, shapefun="lme", transfer="pallas", active_box=box,
        kinds=(M.NEO_HOOKEAN,), scheme="FE",
    )
    with pytest.raises(ValueError, match="no fused-pallas"):
        forward_euler_step(p, grid, mats, cfg, jnp.zeros((2,), jnp.float32))


def test_upw_implicit_pallas_parity():
    """Fused-pallas monolithic implicit u-pw step matches
    the windowed engine on a gravity-loaded column: positions and pore
    pressure.  (Both engines share the nondimensionalised Newton-GMRES;
    the residual agreement between the engines is ~1e-10 — the remaining
    spread is converged-tolerance slack of two distinct f32 Krylov
    paths.)"""
    from nlpartsol.formulations.upw import UpwImplicitConfig, upw_newmark_step
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme as lme_mod

    grid, p, mats, mix, h, H = column_setup()
    box = windowed.full_box(grid, capacity=8)
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    outs = {}
    for transfer in ("windowed", "pallas"):
        cfg = UpwImplicitConfig(
            dt=2e-3,
            shapefun="lme",
            lme_params=lme_mod.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)
        step = jax.jit(upw_newmark_step, static_argnums=(4,))
        for _ in range(5):
            pp, diag = step(pp, grid, mats, mix, cfg, body)
        assert bool(diag["converged"])
        assert int(diag["lost"]) == 0
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        outs[transfer] = (
            np.asarray(pp.x)[act][order],
            np.asarray(pp.pw)[act][order],
        )
    xw, pww = outs["windowed"]
    xp, pwp = outs["pallas"]
    np.testing.assert_allclose(xp, xw, rtol=0, atol=1e-6)
    pw_scale = float(np.abs(pww).max())
    assert pw_scale > 1e3, "no pore pressure built up - weak test"
    np.testing.assert_allclose(pwp, pww, rtol=0, atol=1e-2 * pw_scale)


def test_up_pallas_parity():
    """Fused-pallas mixed u-p step matches the windowed
    engine: positions and pressure multiplier over a gravity-loading
    run."""
    from nlpartsol.formulations.up import UpConfig, up_step
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme as lme_mod

    grid, p, mats, mix, h, H = column_setup()
    box = windowed.full_box(grid, capacity=8)
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    outs = {}
    for transfer in ("windowed", "pallas"):
        cfg = UpConfig(
            dt=2e-3,
            shapefun="lme",
            lme_params=lme_mod.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)
        step = jax.jit(up_step, static_argnums=(3,))
        for _ in range(5):
            pp, diag = step(pp, grid, mats, cfg, body)
        assert bool(diag["converged"])
        assert int(diag["lost"]) == 0
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        outs[transfer] = (
            np.asarray(pp.x)[act][order],
            np.asarray(pp.pw)[act][order],
        )
    xw, lw = outs["windowed"]
    xp, lp = outs["pallas"]
    np.testing.assert_allclose(xp, xw, rtol=0, atol=1e-6)
    l_scale = max(1.0, float(np.abs(lw).max()))
    np.testing.assert_allclose(lp, lw, rtol=0, atol=1e-2 * l_scale)


def test_upw_pallas_parity():
    """Fused-pallas two-phase step matches the windowed
    engine: positions, pore pressure, and porosity over a gravity-loading
    run."""
    from nlpartsol.formulations.upw import UpwConfig
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme as lme_mod

    grid, p, mats, mix, h, H = column_setup()
    box = windowed.full_box(grid, capacity=8)
    c_mix = np.sqrt((KF / 0.4) / 1700.0)
    n_steps = 25
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    outs = {}
    for transfer in ("windowed", "pallas"):
        cfg = UpwConfig(
            dt=0.2 * h / c_mix,
            shapefun="lme",
            lme_params=lme_mod.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)
        step = jax.jit(upw_step, static_argnums=(4,))
        for _ in range(n_steps):
            pp, diag = step(pp, grid, mats, mix, cfg, body)
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        outs[transfer] = (
            np.asarray(pp.x)[act][order],
            np.asarray(pp.pw)[act][order],
            np.asarray(pp.phi_f)[act][order],
        )
        assert int(diag["lost"]) == 0
    xw, pww, ffw = outs["windowed"]
    xp, pwp, ffp = outs["pallas"]
    np.testing.assert_allclose(xp, xw, rtol=0, atol=1e-6)
    pw_scale = max(1.0, float(np.abs(pww).max()))
    assert np.abs(pww).max() > 1.0, "no pore pressure built up - weak test"
    np.testing.assert_allclose(pwp, pww, rtol=0, atol=1e-5 * pw_scale)
    np.testing.assert_allclose(ffp, ffw, rtol=0, atol=1e-6)
