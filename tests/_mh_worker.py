"""Multi-host parity worker: one process of a 2-process x 4-device CPU run
(launched by tests/test_multihost.py; usage: _mh_worker.py <rank>).

Builds the same advecting-band problem as tests/test_domain._problem, runs
the halo-sharded explicit driver over a process-spanning 8-device mesh, and
(every rank, deterministically) checks parity against a local single-device
reference run.  Prints MH_PARITY_OK on success.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def problem(n0=25, n1=9, vx=0.5, E=1e4):
    import jax.numpy as jnp

    from nlpartsol.models import materials as M
    from nlpartsol.types import Grid, make_particles

    h = 1.0 / 8.0
    dims = (n0, n1)
    n_nodes = n0 * n1
    ids = np.arange(n_nodes).reshape(dims)
    dmask = np.zeros((n_nodes, 2), bool)
    dmask[ids[:, 0], 1] = True
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
            xs.append([(i + 0.5) * h, (j + 0.5) * h])
    x = np.array(xs, np.float32)
    vol = h * h
    rho = 1000.0
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    v = np.zeros_like(x)
    v[:, 0] = vx
    v[:, 1] = 0.05 * np.sin(3.0 * x[:, 0])
    p = p.replace(v=jnp.asarray(v))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
    )
    return grid, p, mats, h, np.sqrt(E / rho)


def main(rank: int, nprocs: int = 2, port: int = 23357):
    from nlpartsol.parallel import domain, multihost

    multihost.initialize(
        f"localhost:{port}", num_processes=nprocs, process_id=rank
    )
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    assert jax.process_count() == nprocs
    S = jax.device_count()
    assert S == 8, S

    grid, p, mats, h, cel = problem()
    box = windowed.full_box(grid, capacity=2)
    lp = lme.LMEParams(gamma=3.0)
    n_steps = 20
    cfg = ExplicitConfig(
        dt=0.3 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    body = jnp.zeros((2,), jnp.float32)

    # single-device reference (local; identical on every process)
    p_ref = to_slot_layout(p, grid, box)

    @jax.jit
    def ref_run(pp):
        def bd(c, _):
            c, _d = explicit_step(c, grid, mats, cfg, body)
            return c, None

        return jax.lax.scan(bd, pp, None, length=n_steps)[0]

    p_ref = ref_run(p_ref)

    # process-spanning sharded run
    offs = lme.offsets_for(2, lp)
    mesh = multihost.global_mesh()
    dec = domain.decompose(grid, box, S, offs)
    ps = multihost.shard_particles_global(p, dec, mesh)
    gs = multihost.shard_grid_global(grid, dec, mesh)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, body)
    lost = int(np.asarray(diag["lost"].addressable_shards[0].data))
    assert lost == 0, f"lost={lost}"

    p_all = multihost.gather_particles(p_out)
    p_back = domain.unshard_particles(p_all, dec)

    def by_pid(pp):
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        return (
            pid[order],
            np.asarray(pp.x)[act][order],
            np.asarray(pp.v)[act][order],
        )

    pid0, x0, v0 = by_pid(p_ref)
    pid1, x1, v1 = by_pid(p_back)
    np.testing.assert_array_equal(pid0, pid1)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=5e-4)

    # ---- gather-free per-shard output: every process
    # writes only its own shards; the union across ranks must cover every
    # active particle exactly once ----
    import tempfile

    from jax.experimental import multihost_utils

    outdir = os.path.join(tempfile.gettempdir(), f"mh_shard_out_{rank}")
    os.makedirs(outdir, exist_ok=True)
    paths = multihost.write_shard_vtk(outdir, 0, p_out, dec)
    assert len(paths) == len(multihost.my_shard_ids(mesh))
    mine = sum(
        int(np.asarray(loc.active).sum())
        for _, loc in multihost.addressable_particles(p_out, dec)
    )
    totals = multihost_utils.process_allgather(
        jnp.asarray([mine], jnp.int32), tiled=True
    )
    assert int(np.sum(totals)) == len(pid0), (totals, len(pid0))
    # world-frame positions in the shard files must be a subset of the
    # global set (shift undone correctly)
    _, loc0 = multihost.addressable_particles(p_out, dec)[0]
    act0 = np.asarray(loc0.active)
    if act0.any():
        xs0 = np.asarray(loc0.x)[act0]
        d0 = np.min(
            np.linalg.norm(xs0[:, None, :] - x1[None, :, :], axis=-1), axis=1
        )
        assert d0.max() < 1e-6

    # ---- implicit (Newmark-beta) 2-process parity ----
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step

    icfg = ExplicitConfig  # noqa: F841 (keep imports obvious)
    icfg = ImplicitConfig(
        dt=1.0 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
        newton_maxiter=12,
        cg_maxiter=100,
    )
    n_imp = 5

    @jax.jit
    def ref_imp(pp):
        def bd(c, _):
            c, _d = implicit_step(c, grid, mats, icfg, body)
            return c, None

        return jax.lax.scan(bd, pp, None, length=n_imp)[0]

    p_ref_i = ref_imp(to_slot_layout(p, grid, box))
    run_i = jax.jit(domain.sharded_implicit_run(mesh, dec, icfg, n_imp))
    p_out_i, diag_i = run_i(ps, gs, mats, body)
    assert int(np.asarray(diag_i["lost"].addressable_shards[0].data)) == 0
    p_back_i = domain.unshard_particles(
        multihost.gather_particles(p_out_i), dec
    )
    pid0i, x0i, v0i = by_pid(p_ref_i)
    pid1i, x1i, v1i = by_pid(p_back_i)
    np.testing.assert_array_equal(pid0i, pid1i)
    np.testing.assert_allclose(x1i, x0i, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v1i, v0i, rtol=0, atol=2e-3)

    # ---- two-phase (upw) 2-process parity ----
    from nlpartsol.formulations.upw import (
        UpwConfig, init_mixture_state, make_mixture_table, upw_step,
    )

    mats2 = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=1e4, nu=0.3, rho0=1000.0),
            M.material(
                kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                compressibility=2.2e6,
            ),
        ]
    )
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4,
              permeability=1e-5)]
    )
    p_upw = init_mixture_state(p, mats2, mix)
    c_mix = np.sqrt((2.2e6 / 0.4) / 1000.0 + cel * cel)
    ucfg = UpwConfig(
        dt=0.3 * h / c_mix,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="windowed",
        active_box=box,
    )
    n_upw = 12

    @jax.jit
    def ref_upw(pp):
        def bd(c, _):
            c, _d = upw_step(c, grid, mats2, mix, ucfg, body)
            return c, None

        return jax.lax.scan(bd, pp, None, length=n_upw)[0]

    p_ref_u = ref_upw(to_slot_layout(p_upw, grid, box))
    ps_u = multihost.shard_particles_global(p_upw, dec, mesh)
    run_u = jax.jit(domain.sharded_upw_run(mesh, dec, ucfg, mix, n_upw))
    p_out_u, diag_u = run_u(ps_u, gs, mats2, body)
    assert int(np.asarray(diag_u["lost"].addressable_shards[0].data)) == 0
    p_back_u = domain.unshard_particles(
        multihost.gather_particles(p_out_u), dec
    )

    def by_pid_pw(pp):
        act = np.asarray(pp.active)
        pid = np.asarray(pp.pid)[act]
        order = np.argsort(pid)
        return (
            pid[order],
            np.asarray(pp.x)[act][order],
            np.asarray(pp.pw)[act][order],
        )

    pid0u, x0u, pw0 = by_pid_pw(p_ref_u)
    pid1u, x1u, pw1 = by_pid_pw(p_back_u)
    np.testing.assert_array_equal(pid0u, pid1u)
    np.testing.assert_allclose(x1u, x0u, rtol=0, atol=5e-5)
    pw_scale = max(1.0, float(np.abs(pw0).max()))
    np.testing.assert_allclose(pw1, pw0, rtol=0, atol=2e-4 * pw_scale)

    print(f"MH_PARITY_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
