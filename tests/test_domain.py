"""Block-partitioned grid + halo exchange (parallel/domain.py).

Parity oracle: the single-device windowed engine.  The sharded runs use 8
virtual CPU devices (conftest), a 1-D grid decomposition along axis 0, and
particles whose velocity carries them across shard seams — exercising halo
P2G adds, ghost fills, phantom-plane masking at the global edge, Dirichlet
strip stacking, distributed Newton-CG dots, and particle migration.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.formulations.explicit import (
    ExplicitConfig,
    explicit_step,
    to_slot_layout,
)
from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
from nlpartsol.models import materials as M
from nlpartsol.ops import windowed
from nlpartsol.parallel import domain
from nlpartsol.shapefun import lme
from nlpartsol.types import Grid, make_particles

S = 8  # shards (virtual CPU devices)


def _problem(n0=25, n1=9, ppc=1, vx=0.3, E=1e4):
    """Particles filling the lower-left band, moving +x so they cross
    several shard seams (soft material => large CFL dt => real migration)."""
    h = 1.0 / 8.0
    dims = (n0, n1)
    n_nodes = n0 * n1
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 2), bool)
    dmask[ids[:, 0], 1] = True  # roller floor: u_y = 0 on j=0 plane
    grid = Grid(
        dims=dims,
        spacing=h,
        origin=(0.0, 0.0),
        dirichlet_mask=jnp.asarray(dmask),
        dirichlet_value=jnp.zeros((n_nodes, 2), jnp.float32),
    )
    xs = []
    for i in range(2, 10):
        for j in range(1, 5):
            for a in range(ppc):
                for b in range(ppc):
                    xs.append(
                        [(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h]
                    )
    x = np.array(xs, np.float32)
    vol = (h / ppc) ** 2
    rho = 1000.0
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    v = np.zeros_like(x)
    v[:, 0] = vx  # uniform advection across seams
    v[:, 1] = 0.05 * np.sin(3.0 * x[:, 0])
    p = p.replace(v=jnp.asarray(v))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
    )
    return grid, p, mats, h, np.sqrt(E / rho)


def _by_pid(p):
    """Dict pid → (x, v) for active particles (works for any layout)."""
    act = np.asarray(p.active)
    pid = np.asarray(p.pid)[act]
    x = np.asarray(p.x)[act]
    v = np.asarray(p.v)[act]
    J = np.asarray(p.J)[act]
    order = np.argsort(pid)
    return pid[order], x[order], v[order], J[order]


def test_decompose_structure():
    grid, p, mats, h, cel = _problem()
    box = windowed.full_box(grid, capacity=2)
    offs = lme.offsets_for(2, lme.LMEParams(gamma=3.0))
    dec = domain.decompose(grid, box, S, offs)
    assert dec.spec.bc * S == box.cdims[0]
    # per-device grid memory is a strip, not the full grid
    assert dec.local_grid.n_nodes < grid.n_nodes
    assert dec.local_grid.dims[0] == dec.spec.bc + dec.spec.wlo + dec.spec.whi
    # uneven split: auto-padded with empty cell planes
    dec7 = domain.decompose(grid, box, 7, offs)
    assert dec7.global_box.cdims[0] % 7 == 0
    assert dec7.global_box.cdims[0] >= box.cdims[0]
    # slabs thinner than the halo stay a loud error
    with pytest.raises(ValueError):
        domain.decompose(grid, box, 12, offs)


def test_shard_roundtrip():
    grid, p, mats, h, cel = _problem()
    box = windowed.full_box(grid, capacity=2)
    offs = lme.offsets_for(2, lme.LMEParams(gamma=3.0))
    dec = domain.decompose(grid, box, S, offs)
    ps = domain.shard_particles(p, dec)
    assert ps.x.shape[0] == S * dec.local_box.n_slots
    back = domain.unshard_particles(ps, dec)
    pid0, x0, v0, _ = _by_pid(p)
    pid1, x1, v1, _ = _by_pid(back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x0, x1, atol=1e-6)
    np.testing.assert_allclose(v0, v1, atol=1e-6)


def _single_device_run(grid, p, mats, cfg, n_steps):
    box = cfg.active_box
    p = to_slot_layout(p, grid, box)
    body = jnp.zeros((grid.dim,), jnp.float32)

    @jax.jit
    def run(p):
        def bd(pp, _):
            pp, diag = (
                explicit_step(pp, grid, mats, cfg, body)
                if isinstance(cfg, ExplicitConfig)
                else implicit_step(pp, grid, mats, cfg, body)
            )
            return pp, None

        return jax.lax.scan(bd, p, None, length=n_steps)[0]

    return run(p)


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_halo_explicit_parity_with_migration(sharded_transfer):
    grid, p, mats, h, cel = _problem(vx=0.5)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    dt = 0.3 * h / cel
    n_steps = 40  # fastest band crosses > 1 shard seam
    cfg = ExplicitConfig(
        dt=dt,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    # the sharded run may use the fused-pallas engine (CPU: its XLA-fallback
    # semantics twin) — one path for perf AND scale
    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose(grid, box, S, offs)
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    body = jnp.zeros((2,), jnp.float32)
    p_out, diag = run(ps, gs, mats, body)
    assert int(diag["lost"]) == 0

    # particles crossed seams: the fastest band moves vx*dt*n ≈ > bc*h? not
    # necessarily whole strips, but several particles change owner
    p_back = domain.unshard_particles(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=5e-4)
    np.testing.assert_allclose(J1, J0, rtol=0, atol=5e-5)


def test_migration_changes_owner():
    """Verify migration actually fires: after enough steps the fastest
    particles live on a different shard than at t=0."""
    grid, p, mats, h, cel = _problem(vx=0.5)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    cfg = ExplicitConfig(
        dt=0.3 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose(grid, box, S, offs)
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)

    def owner_of(p_stacked):
        ns = dec.local_box.n_slots
        act = np.asarray(p_stacked.active)
        pid = np.asarray(p_stacked.pid)
        owners = {}
        for s in range(S):
            sl = slice(s * ns, (s + 1) * ns)
            for q in pid[sl][act[sl]]:
                owners[int(q)] = s
        return owners

    own0 = owner_of(ps)
    n_steps = 25
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((2,), jnp.float32))
    assert int(diag["lost"]) == 0
    own1 = owner_of(p_out)
    assert set(own0) == set(own1)  # nobody vanished
    moved = sum(1 for q in own0 if own0[q] != own1[q])
    assert moved > 0, "no particle changed owner - migration untested"


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_halo_implicit_parity(sharded_transfer):
    grid, p, mats, h, cel = _problem(vx=0.2)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    dt = 0.5 * h / cel
    n_steps = 3
    cfg = ImplicitConfig(
        dt=dt,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
        cg_maxiter=100,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose(grid, box, S, offs)
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_implicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((2,), jnp.float32))
    assert int(diag["lost"]) == 0
    assert bool(np.all(np.asarray(diag["converged"])))

    p_back = domain.unshard_particles(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=2e-3)
    np.testing.assert_allclose(J1, J0, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_halo_upw_parity(sharded_transfer):
    """Sharded two-phase (upw) explicit run matches the single-device run
    on BOTH engines."""
    from nlpartsol.formulations.upw import (
        UpwConfig, init_mixture_state, make_mixture_table, upw_step,
    )

    grid, p, mats0, h, cel = _problem(vx=0.4)
    mats = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=1e4, nu=0.3, rho0=1000.0),
            M.material(
                kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                compressibility=2.2e6,
            ),
        ]
    )
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)]
    )
    p = init_mixture_state(p, mats, mix)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 20
    # CFL on the MIXTURE celerity (fluid compressibility dominates:
    # c ~ sqrt((K_f/phi_f)/rho_mix) ~ 74 m/s >> soil cel; Courant.c:60)
    c_mix = np.sqrt((2.2e6 / 0.4) / 1000.0 + cel * cel)
    cfg = UpwConfig(
        dt=0.3 * h / c_mix,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    body = jnp.zeros((2,), jnp.float32)

    p_ref = to_slot_layout(p, grid, box)

    @jax.jit
    def ref_run(pp):
        def bd(c, _):
            c, _d = upw_step(c, grid, mats, mix, cfg, body)
            return c, None

        return jax.lax.scan(bd, pp, None, length=n_steps)[0]

    p_ref = ref_run(p_ref)

    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose(grid, box, S, offs)
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_upw_run(mesh, dec, cfg, mix, n_steps))
    p_out, diag = run(ps, gs, mats, body)
    assert int(diag["lost"]) == 0

    p_back = domain.unshard_particles(p_out, dec)

    def by_pid_pw(pp):
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        return (
            pid[order],
            np.asarray(pp.x)[act][order],
            np.asarray(pp.pw)[act][order],
            np.asarray(pp.phi_f)[act][order],
        )

    pid0, x0, pw0, ff0 = by_pid_pw(p_ref)
    pid1, x1, pw1, ff1 = by_pid_pw(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    pw_scale = max(1.0, float(np.abs(pw0).max()))
    np.testing.assert_allclose(pw1, pw0, rtol=0, atol=2e-4 * pw_scale)
    np.testing.assert_allclose(ff1, ff0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_halo_fracture_parity(sharded_transfer):
    """Sharded eigenerosion: Beps neighbourhood sums crossing shard seams
    must match the single-device run (particle halo via
    domain.slot_plane_halo), on BOTH sharded engines (the
    fused-pallas halo path calls the same _damage_update)."""
    grid, p, mats0, h, cel = _problem(vx=0.3, E=1e4)
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e4, nu=0.3, rho0=1000.0,
                    Ceps=1.5, Gf=1e-4)]
    )
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 15
    cfg = ExplicitConfig(
        dt=0.3 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
        damage="eigenerosion",
        beps_reach=2,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)
    dmg_ref = np.asarray(p_ref.damage)[np.asarray(p_ref.active)]
    assert dmg_ref.max() > 0.0, "no erosion fired - fracture halo untested"

    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose(grid, box, S, offs)
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((2,), jnp.float32))
    assert int(diag["lost"]) == 0

    p_back = domain.unshard_particles(p_out, dec)

    def dmg_by_pid(pp):
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        return (np.asarray(pp.damage)[act][order],
                np.asarray(pp.x)[act][order])

    d0, x0 = dmg_by_pid(p_ref)
    d1, x1 = dmg_by_pid(p_back)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(d1 > 0.5, d0 > 0.5)  # same eroded set


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_halo_3d_parity(sharded_transfer):
    """3D halo sharding: strips along axis 0 of a 3D grid, both transfer
    engines (the 3D fused kernels take the same per-device valid-plane
    bounds as 2D)."""
    h = 1.0 / 8.0
    dims = (17, 6, 6)
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0, 0.0))
    xs = []
    for i in range(2, 8):
        for j in range(1, 4):
            for k in range(1, 4):
                xs.append([(i + 0.5) * h, (j + 0.5) * h, (k + 0.5) * h])
    x = np.array(xs, np.float32)
    vol = h**3
    rho, E = 1000.0, 1e4
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    v = np.zeros_like(x)
    v[:, 0] = 0.4
    v[:, 1] = 0.05 * np.sin(3.0 * x[:, 0])
    p = p.replace(v=jnp.asarray(v))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
    )
    cel = np.sqrt(E / rho)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 10
    cfg = ExplicitConfig(
        dt=0.3 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(3, lp)
    S3 = 4  # 16 cells along axis 0 -> 4 planes per shard (halo w=3)
    dec = domain.decompose(grid, box, S3, offs)
    mesh = domain.make_mesh(S3)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((3,), jnp.float32))
    assert int(diag["lost"]) == 0

    p_back = domain.unshard_particles(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=5e-4)
    np.testing.assert_allclose(J1, J0, rtol=0, atol=5e-5)


def test_halo_explicit_parity_kperiodic_migration():
    """k-periodic seam migration: the sharded pallas engine
    with rebin_every=4 + margin-1 halos must match the per-step-rebin
    single-device run — migration fires every 4th step only."""
    grid, p, mats, h, cel = _problem(n0=41, vx=0.5)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    dt = 0.3 * h / cel
    n_steps = 40
    cfg = ExplicitConfig(
        dt=dt,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    cfg = cfg.replace(transfer="pallas", rebin_every=4)
    offs = lme.offsets_for(2, lp)
    with pytest.raises(ValueError, match="margin"):
        # margin-less decomposition must be rejected for k > 1
        domain.sharded_explicit_run(
            domain.make_mesh(S), domain.decompose(grid, box, S, offs), cfg, 40
        )
    dec = domain.decompose(grid, box, S, offs, margin=1)
    assert dec.spec.wlo == 4 and dec.margin == 1
    mesh = domain.make_mesh(S)
    ps = domain.shard_particles(p, dec)
    gs = domain.shard_grid(grid, dec)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    body = jnp.zeros((2,), jnp.float32)
    p_out, diag = run(ps, gs, mats, body)
    assert int(diag["lost"]) == 0
    assert diag["nnz"].shape == (n_steps,)

    p_back = domain.unshard_particles(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=5e-4)
    np.testing.assert_allclose(J1, J0, rtol=0, atol=5e-5)


def _problem2(n0=25, n1=17, vx=0.4, vy=0.35, E=1e4):
    """Band of particles advecting diagonally — crosses seams of BOTH axes
    of the 2-D decomposition."""
    h = 1.0 / 8.0
    dims = (n0, n1)
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0))
    xs = [
        [(i + 0.5) * h, (j + 0.5) * h]
        for i in range(2, 10)
        for j in range(2, 7)
    ]
    x = np.array(xs, np.float32)
    vol = h * h
    rho = 1000.0
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    v = np.zeros_like(x)
    v[:, 0] = vx + 0.05 * np.sin(3.0 * x[:, 1])
    v[:, 1] = vy
    p = p.replace(v=jnp.asarray(v))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
    )
    return grid, p, mats, h, np.sqrt(E / rho)


@pytest.mark.parametrize("sharded_transfer", ["windowed", "pallas"])
def test_2d_decomposition_explicit_parity(sharded_transfer):
    """2-D (S0 x S1) grid decomposition: two-phase halo
    exchange on both axes (corners via two hops), two-phase seam migration,
    per-axis phantom-plane masking — parity against the single-device run
    on a 2x4 virtual mesh, both engines."""
    grid, p, mats, h, cel = _problem2()
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 30
    cfg = ExplicitConfig(
        dt=0.3 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    cfg = cfg.replace(transfer=sharded_transfer)
    offs = lme.offsets_for(2, lp)
    dec = domain.decompose2(grid, box, (2, 4), offs)
    assert dec.spec.bc == (12, 4) and dec.spec.ln == (18, 10)
    mesh = domain.make_mesh2((2, 4))
    ps = domain.shard_particles2(p, dec)
    gs = domain.shard_grid2(grid, dec)
    run = jax.jit(domain.sharded_explicit_run2(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((2,), jnp.float32))
    assert int(diag["lost"]) == 0

    p_back = domain.unshard_particles2(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=5e-4)
    np.testing.assert_allclose(J1, J0, rtol=0, atol=5e-5)


def test_2d_decomposition_implicit_parity():
    """Implicit Newmark on the 2-D decomposition: distributed Newton-CG
    with psums over both mesh axes."""
    grid, p, mats, h, cel = _problem2(vx=0.3, vy=0.25)
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 6
    cfg = ImplicitConfig(
        dt=1.0 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
        newton_maxiter=12,
        cg_maxiter=100,
    )
    p_ref = _single_device_run(grid, p, mats, cfg, n_steps)

    offs = lme.offsets_for(2, lp)
    dec = domain.decompose2(grid, box, (2, 4), offs)
    mesh = domain.make_mesh2((2, 4))
    ps = domain.shard_particles2(p, dec)
    gs = domain.shard_grid2(grid, dec)
    run = jax.jit(domain.sharded_implicit_run2(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, jnp.zeros((2,), jnp.float32))
    assert int(diag["lost"]) == 0
    assert bool(np.all(np.asarray(diag["converged"])))

    p_back = domain.unshard_particles2(p_out, dec)
    pid0, x0, v0, J0 = _by_pid(p_ref)
    pid1, x1, v1, J1 = _by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=2e-3)
