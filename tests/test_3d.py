"""3D end-to-end: the reference's compile-time `NumberDimensions=3` build
(Macros.h:33-37, T4/H8 elements) is a runtime dimension here — same bar and
lithostatic oracles as the 2D tests, on a 3D structured grid."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.models import materials as M
from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
from nlpartsol.formulations.courant import courant_dt, celerity
from nlpartsol.shapefun import lme

E_, RHO = 1e7, 1000.0
C = celerity(E_, RHO)


def bar_setup_3d(nx=8, ppc=2):
    L, h = 1.0, 1.0 / nx
    ny = nz = 2
    dims = (nx + 1, ny + 1, nz + 1)
    n_nodes = dims[0] * dims[1] * dims[2]
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 3), bool)
    dmask[ids[0].ravel(), 0] = True
    dmask[ids[-1].ravel(), 0] = True
    dmask[:, 1] = True
    dmask[:, 2] = True
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 3), jnp.float32),
    )
    ii, jj, kk, a, b, c = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz),
        np.arange(ppc), np.arange(ppc), np.arange(ppc), indexing="ij",
    )
    x = np.stack(
        [
            (ii + (a + 0.5) / ppc) * h,
            (jj + (b + 0.5) / ppc) * h,
            (kk + (c + 0.5) / ppc) * h,
        ],
        -1,
    ).reshape(-1, 3).astype(np.float32)
    vol = (h / ppc) ** 3
    p = make_particles(
        x,
        mass=np.full(len(x), RHO * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)]
    )
    return grid, p, mats, L, h


@pytest.mark.parametrize("shapefun", ["fem", "lme"])
def test_bar_vibration_3d(shapefun):
    grid, p, mats, L, h = bar_setup_3d()
    V = 0.01
    omega = np.pi * C / L
    x = np.asarray(p.x)
    v = np.zeros_like(x)
    v[:, 0] = V * np.sin(np.pi * x[:, 0] / L)
    p = p.replace(v=jnp.asarray(v))
    dt = courant_dt(0.25, h, C)
    cfg = ExplicitConfig(
        dt=dt,
        shapefun=shapefun,
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
    )
    step = jax.jit(explicit_step, static_argnums=(3,))
    body = jnp.zeros((3,), jnp.float32)
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    for _ in range(n_quarter):
        p, _ = step(p, grid, mats, cfg, body)
    xs = np.asarray(p.x)[:, 0] - np.asarray(p.dis)[:, 0]
    u_ref = (V / omega) * np.sin(np.pi * xs / L)
    err = np.abs(np.asarray(p.dis)[:, 0] - u_ref).max() / (V / omega)
    tol = 0.05 if shapefun == "fem" else 0.15
    assert err < tol, f"3D {shapefun} bar error {err:.3f}"


def test_quasi_static_gravity_column_3d():
    """3D lithostatic column (implicit quasi-static, H8-window FEM)."""
    nx = ny = 2
    nz = 8
    h = 0.125
    H = nz * h
    dims = (nx + 1, ny + 1, nz + 1)
    n_nodes = dims[0] * dims[1] * dims[2]
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 3), bool)
    dmask[ids[:, :, 0].ravel(), 2] = True  # bottom: fix z
    dmask[:, 0] = True
    dmask[:, 1] = True
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 3), jnp.float32),
    )
    ppc = 2
    ii, jj, kk, a, b, c = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz),
        np.arange(ppc), np.arange(ppc), np.arange(ppc), indexing="ij",
    )
    x = np.stack(
        [
            (ii + (a + 0.5) / ppc) * h,
            (jj + (b + 0.5) / ppc) * h,
            (kk + (c + 0.5) / ppc) * h,
        ],
        -1,
    ).reshape(-1, 3).astype(np.float32)
    vol = (h / ppc) ** 3
    p = make_particles(
        x, mass=np.full(len(x), RHO * vol), vol0=np.full(len(x), vol)
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)]
    )
    g = 9.81
    cfg = ImplicitConfig(
        dt=1.0, shapefun="fem", kinds=(M.NEO_HOOKEAN,), quasi_static=True
    )
    step = jax.jit(implicit_step, static_argnums=(3,))
    p1, diag = step(p, grid, mats, cfg, jnp.asarray([0.0, 0.0, -g], jnp.float32))
    assert bool(diag["converged"])
    z = np.asarray(p1.x)[:, 2]
    s_zz = np.asarray(p1.stress)[:, 2, 2]
    s_ref = -RHO * g * (H - z)
    bulk = (z > 0.15) & (z < 0.85)
    err = np.abs(s_zz[bulk] - s_ref[bulk]).max() / (RHO * g * H)
    assert err < 0.15, f"3D lithostatic stress error {err:.3f}"
