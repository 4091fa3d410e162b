"""Eigenerosion / Eigensoftening fracture tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.models import fracture, materials as M
from nlpartsol.ops import windowed
from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step, to_slot_layout
from nlpartsol.formulations.courant import courant_dt

from tests.test_explicit import C, E_, RHO


def slot_problem():
    grid = Grid(dims=(9, 9), spacing=1.0, origin=(0.0, 0.0))
    box = windowed.full_box(grid, capacity=4)
    rng = np.random.default_rng(0)
    x = rng.uniform(1.1, 6.9, (40, 2)).astype(np.float32)
    p = make_particles(x, mass=np.ones(40), vol0=np.ones(40))
    p = to_slot_layout(p, grid, box)
    return grid, box, p


def test_neighbor_sums_match_bruteforce():
    grid, box, p = slot_problem()
    act = np.asarray(p.active)
    xs = np.asarray(p.x)
    vals = np.where(act, np.arange(p.count, dtype=np.float32) + 1.0, 0.0)
    radius = 1.5
    sums = fracture._neighbor_pair_sums(
        grid,
        box,
        p.x,
        p.active,
        {"v": jnp.asarray(vals)},
        radius=jnp.full((p.count,), radius, jnp.float32),
        reach=2,
    )
    got = np.asarray(sums["v"])
    # brute force oracle (includes self)
    for i in np.where(act)[0]:
        dist = np.linalg.norm(xs - xs[i], axis=1)
        ref = vals[(dist <= radius) & act].sum()
        assert abs(got[i] - ref) < 1e-3, (i, got[i], ref)


def test_eigenerosion_erodes_energetic_region():
    grid, box, p = slot_problem()
    act = p.active
    # localised high strain energy blob around (4, 4)
    xs = np.asarray(p.x)
    W = np.where(np.linalg.norm(xs - 4.0, axis=1) < 1.5, 100.0, 0.0).astype(np.float32)
    stress = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32) * 10.0, (p.count, 2, 2))
    out = fracture.eigenerosion(
        grid,
        box,
        x=p.x,
        active=act,
        damage_n=jnp.zeros((p.count,), jnp.float32),
        W=jnp.asarray(W),
        J_n1=jnp.ones((p.count,), jnp.float32),
        vol0=p.vol0,
        stress=stress,
        stress_zz=jnp.zeros((p.count,), jnp.float32),
        Ceps=jnp.full((p.count,), 1.0, jnp.float32),
        Gf=jnp.full((p.count,), 50.0, jnp.float32),
        reach=1,
    )
    dmg = np.asarray(out.damage)
    actv = np.asarray(act)
    inner = actv & (np.linalg.norm(xs - 4.0, axis=1) < 1.0)
    outer = actv & (np.linalg.norm(xs - 4.0, axis=1) > 3.0)
    assert dmg[inner].min() == 1.0, "energetic core must erode"
    assert dmg[outer].max() == 0.0, "far field must stay intact"


def test_eigenerosion_requires_tension():
    grid, box, p = slot_problem()
    stress_comp = jnp.broadcast_to(-10.0 * jnp.eye(2, dtype=jnp.float32), (p.count, 2, 2))
    out = fracture.eigenerosion(
        grid,
        box,
        x=p.x,
        active=p.active,
        damage_n=jnp.zeros((p.count,), jnp.float32),
        W=jnp.full((p.count,), 1e6, jnp.float32),
        J_n1=jnp.ones((p.count,), jnp.float32),
        vol0=p.vol0,
        stress=stress_comp,
        stress_zz=jnp.full((p.count,), -10.0, jnp.float32),
        Ceps=jnp.ones((p.count,), jnp.float32),
        Gf=jnp.zeros((p.count,), jnp.float32),
        reach=1,
    )
    assert np.asarray(out.damage).max() == 0.0, "compression must not erode"


def test_eigensoftening_two_phase():
    grid, box, p = slot_problem()
    n = p.count
    # tensile stretch: F = diag(1.2, 1)
    F = jnp.broadcast_to(jnp.asarray([[1.2, 0.0], [0.0, 1.0]], jnp.float32), (n, 2, 2))
    stress = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32) * 100.0, (n, 2, 2))
    kw = dict(
        grid=grid,
        box=box,
        x=p.x,
        active=p.active,
        mass=p.mass,
        F_n1=F,
        stress=stress,
        stress_zz=jnp.zeros((n,), jnp.float32),
        ft=jnp.full((n,), 50.0, jnp.float32),
        heps=jnp.full((n,), 1.0, jnp.float32),
        wcrit=jnp.full((n,), 1.0, jnp.float32),
        Ceps=jnp.ones((n,), jnp.float32),
        reach=1,
    )
    # phase 1: trigger records failure strain, no damage yet
    out1 = fracture.eigensoftening(
        damage_n=jnp.zeros((n,), jnp.float32), strain_f_n=jnp.zeros((n,), jnp.float32), **kw
    )
    act = np.asarray(p.active)
    assert np.asarray(out1.strain_f)[act].max() > 0.0
    assert np.asarray(out1.damage)[act].max() == 0.0
    # phase 2: with recorded strain and further stretch, damage grows
    F2 = jnp.broadcast_to(jnp.asarray([[1.4, 0.0], [0.0, 1.0]], jnp.float32), (n, 2, 2))
    kw2 = dict(kw)
    kw2["F_n1"] = F2
    out2 = fracture.eigensoftening(
        damage_n=out1.damage, strain_f_n=out1.strain_f, **kw2
    )
    assert np.asarray(out2.damage)[act].max() > 0.0


def test_step_with_eigenerosion_runs():
    grid = Grid(dims=(9, 9), spacing=0.1, origin=(0.0, 0.0))
    box = windowed.full_box(grid, capacity=6)
    xs = np.stack(
        np.meshgrid(np.linspace(0.25, 0.55, 8), np.linspace(0.25, 0.55, 8)), -1
    ).reshape(-1, 2).astype(np.float32)
    vol = 0.05**2
    p = make_particles(xs, mass=np.full(len(xs), RHO * vol), vol0=np.full(len(xs), vol))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.2, rho0=RHO, Ceps=1.5, Gf=10.0)]
    )
    cfg = ExplicitConfig(
        dt=courant_dt(0.25, 0.1, C),
        shapefun="fem",
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
        damage="eigenerosion",
        beps_reach=2,
    )
    p = to_slot_layout(p, grid, box)
    step = jax.jit(explicit_step, static_argnums=(3,))
    p1, diag = step(p, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
    assert np.all(np.isfinite(np.asarray(p1.x)))


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_implicit_fracture_staggered(transfer):
    """Implicit Newmark-beta with eigenerosion: the
    staggered damage update fires at the converged state — pre-stretched
    band erodes, far field stays intact; windowed and pallas paths agree."""
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.shapefun import lme as lme_mod

    h = 0.1
    grid = Grid(dims=(17, 9), spacing=h, origin=(0.0, 0.0))
    box = windowed.full_box(grid, capacity=4)
    xs = np.stack(
        np.meshgrid(np.linspace(0.25, 1.35, 12), np.linspace(0.25, 0.55, 4)),
        -1,
    ).reshape(-1, 2).astype(np.float32)
    vol = (h / 2) ** 2
    p = make_particles(
        xs, mass=np.full(len(xs), RHO * vol), vol0=np.full(len(xs), vol)
    )
    # pre-stretch a central band => large strain energy + tensile stress
    band = (np.abs(xs[:, 0] - 0.8) < 0.15).astype(np.float32)
    F0 = np.tile(np.eye(2, dtype=np.float32), (len(xs), 1, 1))
    F0[:, 0, 0] = 1.0 + 0.3 * band
    p = p.replace(F=jnp.asarray(F0), J=jnp.asarray(F0[:, 0, 0] * F0[:, 1, 1]))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.2, rho0=RHO,
                    Ceps=1.5, Gf=1.0)]
    )
    cfg = ImplicitConfig(
        dt=1e-4,
        shapefun="lme",
        lme_params=lme_mod.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
        transfer=transfer,
        active_box=box,
        damage="eigenerosion",
        beps_reach=2,
    )
    p0 = to_slot_layout(p, grid, box)
    step = jax.jit(implicit_step, static_argnums=(3,))
    p1, diag = step(p0, grid, mats, cfg, jnp.zeros((2,), jnp.float32))
    assert bool(diag["converged"])
    act = np.asarray(p1.active)
    dmg = np.asarray(p1.damage)
    x1 = np.asarray(p1.x)
    # the stretched band must erode; particles far away must stay intact
    in_band = act & (np.abs(x1[:, 0] - 0.8) < 0.1)
    far = act & (np.abs(x1[:, 0] - 0.8) > 0.5)
    assert dmg[in_band].min() == 1.0
    assert dmg[far].max() == 0.0
    # parity across engines: same eroded pid set
    if not hasattr(test_implicit_fracture_staggered, "_eroded"):
        test_implicit_fracture_staggered._eroded = {}
    pid = np.asarray(p1.pid)[act & (dmg > 0.5)]
    test_implicit_fracture_staggered._eroded[transfer] = set(pid.tolist())
    got = test_implicit_fracture_staggered._eroded
    if len(got) == 2:
        assert got["windowed"] == got["pallas"]
