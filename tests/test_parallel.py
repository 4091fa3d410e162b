"""Replicated-grid BASELINE parallelism tests (parallel/mesh.py, the
explicitly-demoted oracle path): the particle-sharded step with a
replicated grid must match the single-device step to float tolerance.
The production domain-decomposed backend (parallel/domain.py) is covered
by tests/test_domain.py; this file only keeps the baseline fixture honest
so it can serve as a cross-check."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
from nlpartsol.models import materials as M
from nlpartsol.parallel.mesh import (
    PARTICLE_AXIS,
    make_mesh,
    pad_particles,
    sharded_explicit,
    sharded_implicit,
)

from tests.test_explicit import bar_setup, C, E_, RHO
from nlpartsol.formulations.courant import courant_dt


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_explicit_matches_single():
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))

    dt = courant_dt(0.25, h, C)
    body = jnp.zeros((2,), jnp.float32)

    cfg1 = ExplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    p_ref, diag_ref = jax.jit(explicit_step, static_argnums=(3,))(
        p, grid, mats, cfg1, body
    )

    mesh = make_mesh(8)
    p8 = pad_particles(p, 8)
    cfgN = cfg1.replace(axis_name=PARTICLE_AXIS)
    step = jax.jit(sharded_explicit(mesh, cfgN))
    p_out, diag = step(p8, grid, mats, body)

    n = p.count
    np.testing.assert_allclose(
        np.asarray(p_out.x)[:n], np.asarray(p_ref.x), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(p_out.v)[:n], np.asarray(p_ref.v), rtol=1e-4, atol=1e-6
    )
    assert int(diag["nnz"]) == int(diag_ref["nnz"])
    np.testing.assert_allclose(
        float(diag["kinetic_energy"]), float(diag_ref["kinetic_energy"]), rtol=1e-4
    )


def test_sharded_implicit_matches_single():
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))

    dt = courant_dt(1.0, h, C)
    body = jnp.zeros((2,), jnp.float32)

    cfg1 = ImplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    p_ref, _ = jax.jit(implicit_step, static_argnums=(3,))(p, grid, mats, cfg1, body)

    mesh = make_mesh(8)
    p8 = pad_particles(p, 8)
    cfgN = cfg1.replace(axis_name=PARTICLE_AXIS)
    step = jax.jit(sharded_implicit(mesh, cfgN))
    p_out, diag = step(p8, grid, mats, body)

    n = p.count
    np.testing.assert_allclose(
        np.asarray(p_out.x)[:n], np.asarray(p_ref.x), rtol=1e-4, atol=1e-7
    )
    assert bool(diag["converged"])
