"""Windowed (scatter-free) transfer engine: must match the scatter backend
bit-for-tolerance on identical particle sets."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.formulations.courant import courant_dt
from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step, run
from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
from nlpartsol.models import materials as M
from nlpartsol.ops import sparse, windowed
from nlpartsol.shapefun import lme
from nlpartsol.types import Grid, make_particles

from tests.test_explicit import bar_setup, C, E_, RHO


def _by_pid(p, arr):
    """Sort a particle array by pid, dropping inactive slots."""
    pid = np.asarray(p.pid)
    act = np.asarray(p.active)
    order = np.argsort(pid[act])
    return np.asarray(arr)[act][order]


def test_binning_roundtrip():
    grid = Grid(dims=(9, 9), spacing=0.5, origin=(0.0, 0.0))
    box = windowed.full_box(grid, capacity=4)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.01, 3.99, (50, 2)).astype(np.float32)
    p = make_particles(x, mass=np.ones(50), vol0=np.ones(50))
    b = windowed.bin_particles(grid, box, p.x, p.active)
    assert int(b.lost) == 0
    ps = windowed.permute_to_slots(p, b)
    # every original particle appears exactly once among valid slots
    pids = np.asarray(ps.pid)[np.asarray(ps.active)]
    assert sorted(pids.tolist()) == list(range(50))
    # slot cell matches the particle position's cell
    cells = windowed.slot_cells(box)
    got = np.asarray(ps.x)[np.asarray(ps.active)]
    cell_of = np.floor(got / grid.spacing).astype(int)
    slot_cell = cells[np.asarray(ps.active)]
    np.testing.assert_array_equal(cell_of, slot_cell)


def test_binning_overflow_counts_lost():
    grid = Grid(dims=(5, 5), spacing=1.0, origin=(0.0, 0.0))
    box = windowed.full_box(grid, capacity=2)
    x = np.full((5, 2), 0.5, np.float32)  # 5 particles in one cell, C=2
    p = make_particles(x, mass=np.ones(5), vol0=np.ones(5))
    b = windowed.bin_particles(grid, box, p.x, p.active)
    assert int(b.lost) == 3


@pytest.mark.parametrize("shapefun", ["fem", "lme"])
def test_windowed_step_matches_scatter(shapefun):
    grid, p, mats, L, h = bar_setup(shapefun)
    V = 0.01
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    dt = courant_dt(0.25, h, C)
    body = jnp.zeros((2,), jnp.float32)

    cfg_s = ExplicitConfig(
        dt=dt, shapefun=shapefun, lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,)
    )
    p_s, diag_s = jax.jit(explicit_step, static_argnums=(3,))(p, grid, mats, cfg_s, body)

    box = windowed.full_box(grid, capacity=6)
    cfg_w = cfg_s.replace(transfer="windowed", active_box=box)
    p_w, diag_w = jax.jit(explicit_step, static_argnums=(3,))(p, grid, mats, cfg_w, body)

    assert int(diag_w["lost"]) == 0
    assert int(diag_w["nnz"]) == int(diag_s["nnz"])
    np.testing.assert_allclose(_by_pid(p_w, p_w.x), _by_pid(p_s, p_s.x), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_by_pid(p_w, p_w.v), _by_pid(p_s, p_s.v), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        _by_pid(p_w, p_w.stress), _by_pid(p_s, p_s.stress), rtol=1e-3, atol=2.0
    )
    np.testing.assert_allclose(
        float(diag_w["kinetic_energy"]), float(diag_s["kinetic_energy"]), rtol=1e-4
    )


def test_windowed_implicit_matches_scatter():
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    dt = courant_dt(1.0, h, C)
    body = jnp.zeros((2,), jnp.float32)

    cfg_s = ImplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    p_s, diag_s = jax.jit(implicit_step, static_argnums=(3,))(p, grid, mats, cfg_s, body)

    box = windowed.full_box(grid, capacity=6)
    cfg_w = cfg_s.replace(transfer="windowed", active_box=box)
    p_w, diag_w = jax.jit(implicit_step, static_argnums=(3,))(p, grid, mats, cfg_w, body)

    assert bool(diag_w["converged"])
    np.testing.assert_allclose(_by_pid(p_w, p_w.x), _by_pid(p_s, p_s.x), rtol=1e-4, atol=1e-6)


def test_windowed_multistep_run():
    """Full windowed run conserves energy like the scatter path."""
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    dt = courant_dt(0.25, h, C)
    box = windowed.full_box(grid, capacity=6)
    cfg = ExplicitConfig(
        dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,), transfer="windowed", active_box=box
    )
    n = int(round((np.pi / 2 / omega) / dt))
    p1, en = jax.jit(run, static_argnums=(3, 4))(p, grid, mats, cfg, n)
    ke0 = 0.5 * float(jnp.sum(p.mass * jnp.sum(p.v**2, -1)))
    etot = float(en["kinetic_energy"][-1] + en["strain_energy"][-1])
    assert abs(etot - ke0) / ke0 < 0.05


def test_fbar_nearly_incompressible_column():
    """F-bar keeps a nearly-incompressible column from volumetric locking:
    just verify it runs, stays finite, and changes the response vs no-fbar."""
    grid, p, mats_old, L, h = bar_setup("fem")
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.49, rho0=RHO, alpha_fbar=0.9)]
    )
    vx = 0.05 * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    box = windowed.full_box(grid, capacity=6)
    dt = courant_dt(0.2, h, C * 3)
    base = ExplicitConfig(
        dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,), transfer="windowed", active_box=box
    )
    stepj = jax.jit(explicit_step, static_argnums=(3,))
    body = jnp.zeros((2,), jnp.float32)
    p_fb = to_slot = None
    from nlpartsol.formulations.explicit import to_slot_layout

    p0 = to_slot_layout(p, grid, box)
    pa, pb = p0, p0
    cfg_fb = base.replace(fbar=True)
    for _ in range(10):
        pa, _ = stepj(pa, grid, mats, base, body)
        pb, _ = stepj(pb, grid, mats, cfg_fb, body)
    assert np.all(np.isfinite(np.asarray(pb.x)))
    # F-bar must alter the stress response for nu→0.5
    sa = np.asarray(pa.stress)[np.asarray(pa.active)]
    sb = np.asarray(pb.stress)[np.asarray(pb.active)]
    assert not np.allclose(sa, sb, rtol=1e-3)


def test_local_rebin_matches_global_binning():
    """local_rebin (neighbour compaction, no sort/gather) must place exactly
    the same particle set per cell as the global argsort binning, preserving
    every particle's full state row."""
    rng = np.random.default_rng(11)
    n_side, n = 14, 260
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side, n_side), spacing=h, origin=(0.0, 0.0))
    x = rng.uniform(0.12, 0.88, size=(n, 2)).astype(np.float32)
    from nlpartsol.types import make_particles

    p = make_particles(
        x,
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        vol0=rng.uniform(0.5, 2.0, n).astype(np.float32),
    )
    p = p.replace(v=jnp.asarray(rng.standard_normal((n, 2)), jnp.float32))
    box = windowed.default_box(grid, x)
    from nlpartsol.formulations.explicit import to_slot_layout

    p0 = to_slot_layout(p, grid, box)
    # drift each particle by up to ±0.9 cells
    drift = rng.uniform(-0.9, 0.9, size=(box.n_slots, 2)).astype(np.float32) * h
    x_new = jnp.where(p0.active[:, None], p0.x + jnp.asarray(drift), p0.x)
    p1 = p0.replace(x=x_new)

    loc, lost = jax.jit(windowed.local_rebin, static_argnums=(2,))(p1, grid, box)
    assert int(lost) == 0

    binning = windowed.bin_particles(grid, box, p1.x, p1.active)
    ref = windowed.permute_to_slots(p1, binning)

    # same particle set per cell (order within a cell may differ)
    cells = windowed.slot_cells(box)
    for arr_name in ("pid",):
        pass
    pid_loc = np.asarray(loc.pid)
    pid_ref = np.asarray(ref.pid)
    act_loc = np.asarray(loc.active)
    act_ref = np.asarray(ref.active)
    assert act_loc.sum() == act_ref.sum() == int(np.asarray(p1.active).sum())
    cid = cells[:, 0] * box.cdims[1] + cells[:, 1]
    for c in np.unique(cid):
        sl = cid == c
        s_loc = sorted(pid_loc[sl][act_loc[sl]].tolist())
        s_ref = sorted(pid_ref[sl][act_ref[sl]].tolist())
        assert s_loc == s_ref, f"cell {c}: {s_loc} vs {s_ref}"

    # full state preserved per pid
    big_l, _, _ = windowed.flatten_soa(loc)
    big_r, _, _ = windowed.flatten_soa(ref)
    order_l = np.argsort(pid_loc[act_loc])
    order_r = np.argsort(pid_ref[act_ref])
    np.testing.assert_allclose(
        np.asarray(big_l)[act_loc][order_l], np.asarray(big_r)[act_ref][order_r],
        rtol=0, atol=0,
    )


def test_local_rebin_loses_fast_and_escaping_particles():
    rng = np.random.default_rng(12)
    n_side = 10
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side, n_side), spacing=h, origin=(0.0, 0.0))
    x = np.array([[0.5, 0.5], [0.5, 0.6], [0.3, 0.3]], np.float32)
    from nlpartsol.types import make_particles

    p = make_particles(x, mass=np.ones(3, np.float32), vol0=np.ones(3, np.float32))
    box = windowed.default_box(grid, x)
    from nlpartsol.formulations.explicit import to_slot_layout

    p0 = to_slot_layout(p, grid, box)
    # teleport one particle 3 cells away (faster than CFL allows)
    sel = np.asarray(p0.pid) == 1
    x_new = np.asarray(p0.x).copy()
    x_new[sel] += 3.1 * h
    p1 = p0.replace(x=jnp.asarray(x_new))
    loc, lost = windowed.local_rebin(p1, grid, box)
    assert int(lost) == 1
    assert int(np.asarray(loc.active).sum()) == 2
