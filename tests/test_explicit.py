"""End-to-end explicit MPM: elastic bar vibration (BASELINE.json config 1).

Oracle: 1D axial vibration of a bar fixed at both ends, initial velocity
v(x,0) = V sin(πx/L).  Exact solution u(x,t) = (V/ω) sin(πx/L) sin(ωt) with
ω = πc/L, c = sqrt(E/ρ).  With ν = 0 the 2D plane-strain model reduces to
the 1D problem.  Validates the whole explicit pipeline: LME/FEM shape
functions, P2G/G2P, lumped solve, Dirichlet, constitutive, corrector.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.models import materials as M
from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step, run
from nlpartsol.formulations.courant import courant_dt, celerity
from nlpartsol.shapefun import lme


E_, RHO = 1e7, 1000.0
C = celerity(E_, RHO)  # 100 m/s


def bar_setup(shapefun="lme", nx=20, ppc=2):
    """Bar of length 1 along x, 2 cells tall, fixed x-displacement at ends."""
    L = 1.0
    h = L / nx
    ny = 2
    dims = (nx + 1, ny + 1)
    # Dirichlet: u_x fixed on the end columns of nodes; u_y fixed everywhere
    n_nodes = dims[0] * dims[1]
    dmask = np.zeros((n_nodes, 2), bool)
    ids = np.arange(n_nodes).reshape(dims)
    dmask[ids[0, :], 0] = True
    dmask[ids[-1, :], 0] = True
    dmask[:, 1] = True  # suppress transverse motion: 1D behavior
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 2), jnp.float32),
    )
    # particles: ppc x ppc per cell over the full bar
    xs = []
    for i in range(nx):
        for j in range(ny):
            for a in range(ppc):
                for b in range(ppc):
                    xs.append(
                        [
                            (i + (a + 0.5) / ppc) * h,
                            (j + (b + 0.5) / ppc) * h,
                        ]
                    )
    x = np.array(xs, np.float32)
    vol = (h / ppc) ** 2
    p = make_particles(x, mass=np.full(len(x), RHO * vol, np.float32), vol0=np.full(len(x), vol, np.float32))
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)])
    return grid, p, mats, L, h


@pytest.mark.parametrize("shapefun", ["fem", "lme"])
def test_bar_vibration(shapefun):
    grid, p, mats, L, h = bar_setup(shapefun)
    V = 0.01  # small amplitude: linear regime
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))

    dt = courant_dt(0.25, h, C)
    cfg = ExplicitConfig(
        dt=dt,
        shapefun=shapefun,
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
    )
    # quarter period: displacement peaks at u(x) = V/ω sin(πx/L)
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    runj = jax.jit(run, static_argnums=(3, 4))
    p1, energies = runj(p, grid, mats, cfg, n_quarter)

    xs = np.asarray(p.x)[:, 0]
    u_ref = (V / omega) * np.sin(np.pi * xs / L)
    u_num = np.asarray(p1.dis)[:, 0]
    err = np.abs(u_num - u_ref).max() / (V / omega)
    assert err < 0.08, f"quarter-period displacement error {err:.3f}"

    # energy conservation: total energy within 5% of initial kinetic energy
    ke0 = 0.5 * float(jnp.sum(p.mass * jnp.sum(p.v**2, -1)))
    etot = np.asarray(energies["kinetic_energy"]) + np.asarray(energies["strain_energy"])
    assert abs(etot[-1] - ke0) / ke0 < 0.05, f"energy drift {(etot[-1]-ke0)/ke0:.3f}"


def test_step_is_jittable_and_stable():
    grid, p, mats, L, h = bar_setup()
    cfg = ExplicitConfig(dt=courant_dt(0.25, h, C), kinds=(M.NEO_HOOKEAN,))
    step = jax.jit(explicit_step, static_argnums=(3,))
    body = jnp.zeros((2,), jnp.float32)
    p1, diag = step(p, grid, mats, cfg, body)
    p2, _ = step(p1, grid, mats, cfg, body)
    assert np.all(np.isfinite(np.asarray(p2.x)))
    assert int(diag["nnz"]) > 0
    # At rest with no forces: nothing moves
    np.testing.assert_allclose(np.asarray(p2.x), np.asarray(p.x), atol=1e-7)


def test_adaptive_rebin_period(tmp_path):
    """Driver adaptivity: starts at the largest safe rebin
    period and shrinks it at chunk boundaries as particle speeds grow."""
    from nlpartsol.driver import safe_rebin_period, run_simulation
    from nlpartsol.io.builder import SimulationSetup, SolverParams
    from nlpartsol.models import materials as M

    # unit math
    assert safe_rebin_period(np.zeros((5, 2)), 0.1, 1e-3) == 16
    # vmax*dt = 0.01*spacing -> k = 1/(2*0.01) = 50 -> clamp 16
    assert safe_rebin_period(np.full((5, 2), 1.0), 0.1, 1e-3) == 16
    # vmax*dt = 0.05*spacing -> k = 10 -> rounded down to the power of 2
    assert safe_rebin_period(np.full((5, 2), 5.0), 0.1, 1e-3) == 8

    # integration: still particles + gravity => v grows every step; the
    # period must shrink from 16 by the end of the run
    h = 0.1
    grid = Grid(dims=(41, 41), spacing=h, origin=(0.0, 0.0))
    xs = np.stack(
        np.meshgrid(np.linspace(1.05, 2.0, 10), np.linspace(2.0, 2.95, 10)),
        -1,
    ).reshape(-1, 2).astype(np.float32)
    vol = (h / 2) ** 2
    p = make_particles(xs, mass=np.full(len(xs), RHO * vol),
                       vol0=np.full(len(xs), vol))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.2, rho0=RHO)]
    )
    n = 100
    setup = SimulationSetup(
        solver=SolverParams(scheme="NPC-FS", cfl=0.25, cel=C, n_steps=n),
        grid=grid,
        particles=p,
        materials=mats,
        kinds=(M.NEO_HOOKEAN,),
        gravity=np.tile(np.array([0.0, -1500.0]), (n, 1)),
        out_dir=str(tmp_path / "out"),
        out_every=20,
    )
    p_out, hist = run_simulation(
        setup, transfer="pallas", write_outputs=False, progress=False
    )
    assert np.all(np.isfinite(np.asarray(p_out.x)))
    assert hist["rebin_every"] < 16, "period never adapted down"
    assert hist["rebin_every"] >= 2
