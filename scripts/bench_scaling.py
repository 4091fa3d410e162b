"""Weak-scaling benchmark over the (virtual) device mesh
(BASELINE.md self-measured metric #3: >=70% nnz/s efficiency at N hosts).

Fixed per-device load: each shard owns a BASE x BASE cell slab with ppc^2
particles per cell; the global problem grows with S along grid axis 0.
For S in {1, 2, 4, 8}: runs the halo-sharded explicit LME step
(parallel/domain.py — ppermute halo exchange + sort-free seam migration)
under lax.scan and reports

  step_ms          per-step wall time (whole mesh)
  nnz_per_s        aggregate edge throughput
  efficiency       nnz_per_s(S) / (S * nnz_per_s(1))
  halo_mb_step     per-device ppermute halo traffic per step (analytic)
  mig_mb_step      per-device migration buffer traffic per step (analytic)
  node_mb_dev      per-device node-strip memory
  slot_mb_dev      per-device particle slot memory

On real multi-chip hardware this script runs unchanged (the mesh picks up
real devices); on this box it runs on the 8-device virtual CPU mesh, where
step_ms measures the design's parallel overheads under core contention and
the analytic columns are the ICI-relevant quantities.  Writes one JSON line
per S plus a summary line.

Env: SCALE_BASE (default 32 cells/shard), SCALE_PPC (2), SCALE_STEPS (10),
     SCALE_SHARDS (comma list, default '1,2,4,8'),
     SCALE_TRANSFER (pallas | windowed),
     SCALE_MESH (e.g. '2x4': 2-D decomposition over an S0 x S1 mesh —
     fixed per-device load grows the global grid along BOTH axes;
     per-step two-phase halo exchange + seam migration).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    if os.environ.get("SCALE_PLATFORM", "cpu") == "cpu":
        # default: 8-device virtual CPU mesh; set SCALE_PLATFORM=gpu on a
        # machine with several GPUs
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import ExplicitConfig
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.parallel import domain
    from nlpartsol.shapefun import lme
    from nlpartsol.types import Grid, make_particles

    base = int(os.environ.get("SCALE_BASE", "32"))
    ppc = int(os.environ.get("SCALE_PPC", "2"))
    n_steps = int(os.environ.get("SCALE_STEPS", "10"))
    shards = [int(s) for s in os.environ.get("SCALE_SHARDS", "1,2,4,8").split(",")]
    transfer = os.environ.get("SCALE_TRANSFER", "pallas")
    lp = lme.LMEParams(gamma=3.0)
    offs = lme.offsets_for(2, lp)
    rho, E = 1000.0, 1e7
    cel = np.sqrt(E / rho)

    mesh2 = os.environ.get("SCALE_MESH")
    if mesh2:
        S0, S1 = (int(v) for v in mesh2.split("x"))
        return run_2d(S0, S1, base, ppc, n_steps, transfer)

    results = {}
    for S in shards:
        if S > len(jax.devices()):
            break
        n0c = base * S          # global cells along the sharded axis
        n1c = base              # lateral cells
        h = 1.0 / base
        grid = Grid(dims=(n0c + 1, n1c + 1), spacing=h, origin=(0.0, 0.0))
        box = windowed.ActiveBox(offset=(0, 0), cdims=(n0c, n1c), capacity=ppc * ppc + 2)
        i, j, a, b = np.meshgrid(
            np.arange(n0c), np.arange(n1c), np.arange(ppc), np.arange(ppc),
            indexing="ij",
        )
        x = np.stack(
            [(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h], axis=-1
        ).reshape(-1, 2).astype(np.float32)
        vol = (h / ppc) ** 2
        p = make_particles(
            x,
            mass=np.full(len(x), rho * vol, np.float32),
            vol0=np.full(len(x), vol, np.float32),
        )
        rng = np.random.default_rng(0)
        p = p.replace(v=jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32))
        mats = M.material_table(
            [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
        )
        # k-periodic seam migration (default for pallas): margin-1 kernels
        # + every-k-th-step migrate_local, the sharded analog of the
        # single-chip rebin amortisation
        k_default = "16" if transfer == "pallas" else "1"
        k = int(os.environ.get("SCALE_REBIN_EVERY", k_default))
        if transfer != "pallas":
            k = 1
        steps = ((n_steps + k - 1) // k) * k
        cfg = ExplicitConfig(
            dt=0.25 * h / cel,
            shapefun="lme",
            lme_params=lp,
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
            rebin_every=k,
        )
        dec = domain.decompose(grid, box, S, offs, margin=1 if k > 1 else 0)
        mesh = domain.make_mesh(S)
        ps = domain.shard_particles(p, dec)
        gs = domain.shard_grid(grid, dec)
        run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, steps))
        body = jnp.zeros((2,), jnp.float32)
        p1, diag = run(ps, gs, mats, body)
        jax.block_until_ready(diag["nnz"])
        t0 = time.perf_counter()
        p2, diag = run(p1, gs, mats, body)
        jax.block_until_ready(diag["nnz"])
        t1 = time.perf_counter()
        nnz_tot = int(np.asarray(diag["nnz"]).astype(np.int64).sum())
        spec = dec.spec
        n1n = grid.dims[1]
        # analytic per-device comm volume per step (f32 bytes):
        #   halo: exchange_add (2 dirs) on scatter outputs + fill (2 dirs)
        #   on gather inputs; channel counts of the explicit step:
        #   scatter1 cout=3, gather1 cg=4(2 gN+2 grad... node planes), # wait:
        #   count node-array channels actually exchanged per step:
        #     xadd(nodes1: 3ch) + fill(d_dis: 2ch) + xadd(nodes2: 3ch)
        #     + fill(accel: 2ch) = 10 channels
        halo_planes = spec.wlo + spec.whi
        halo_mb = 10 * halo_planes * n1n * 4 / 1e6 if S > 1 else 0.0
        mig_mb = (
            2 * box.capacity * n1c * 4 * 56 / 1e6 / k if S > 1 else 0.0
        )  # 2 seam-plane slot buffers x full SoA width, amortised over k
        res = dict(
            S=S,
            np_total=len(x),
            step_ms=1e3 * (t1 - t0) / steps,
            nnz_per_s=nnz_tot / (t1 - t0),
            halo_mb_step=halo_mb,
            mig_mb_step=mig_mb,
            node_mb_dev=dec.local_grid.n_nodes * 4 * 4 / 1e6,
            slot_mb_dev=dec.local_box.n_slots * 56 * 4 / 1e6,
        )
        results[S] = res
        print(json.dumps({"metric": "weak_scaling", **res}), flush=True)

    if 1 in results:
        base_nnzs = results[1]["nnz_per_s"]
        for S, r in results.items():
            r["efficiency"] = r["nnz_per_s"] / (S * base_nnzs)
        print(
            json.dumps(
                {
                    "metric": "weak_scaling_efficiency",
                    "value": {S: round(r["efficiency"], 3) for S, r in results.items()},
                    "backend": jax.default_backend(),
                    "transfer": transfer,
                }
            ),
            flush=True,
        )
    return results


def run_2d(S0, S1, base, ppc, n_steps, transfer):
    import jax
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import ExplicitConfig
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.parallel import domain
    from nlpartsol.shapefun import lme
    from nlpartsol.types import Grid, make_particles

    lp = lme.LMEParams(gamma=3.0)
    offs = lme.offsets_for(2, lp)
    rho, E = 1000.0, 1e7
    cel = np.sqrt(E / rho)
    n0c, n1c = base * S0, base * S1
    h = 1.0 / base
    grid = Grid(dims=(n0c + 1, n1c + 1), spacing=h, origin=(0.0, 0.0))
    box = windowed.ActiveBox(
        offset=(0, 0), cdims=(n0c, n1c), capacity=ppc * ppc + 2
    )
    i, j, a, b = np.meshgrid(
        np.arange(n0c), np.arange(n1c), np.arange(ppc), np.arange(ppc),
        indexing="ij",
    )
    x = np.stack(
        [(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    vol = (h / ppc) ** 2
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    rng = np.random.default_rng(0)
    p = p.replace(v=jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=rho)]
    )
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer=transfer,
        active_box=box,
    )
    dec = domain.decompose2(grid, box, (S0, S1), offs)
    mesh = domain.make_mesh2((S0, S1))
    ps = domain.shard_particles2(p, dec)
    gs = domain.shard_grid2(grid, dec)
    run = jax.jit(domain.sharded_explicit_run2(mesh, dec, cfg, n_steps))
    body = jnp.zeros((2,), jnp.float32)
    p1, diag = run(ps, gs, mats, body)
    jax.block_until_ready(diag["nnz"])
    t0 = time.perf_counter()
    p2, diag = run(p1, gs, mats, body)
    jax.block_until_ready(diag["nnz"])
    t1 = time.perf_counter()
    nnz_tot = int(np.asarray(diag["nnz"]).astype(np.int64).sum())
    spec = dec.spec
    # per-device halo traffic: both axes, 10 node channels/step
    halo_mb = 10 * 4 * (
        (spec.wlo[0] + spec.whi[0]) * spec.ln[1]
        + (spec.wlo[1] + spec.whi[1]) * spec.ln[0]
    ) / 1e6
    res = dict(
        mesh=f"{S0}x{S1}",
        np_total=len(x),
        step_ms=1e3 * (t1 - t0) / n_steps,
        nnz_per_s=nnz_tot / (t1 - t0),
        lost=int(np.asarray(diag["lost"])),
        halo_mb_step=halo_mb,
        node_mb_dev=dec.local_grid.n_nodes * 4 * 4 / 1e6,
    )
    print(json.dumps({"metric": "weak_scaling_2d", **res}), flush=True)
    return res


if __name__ == "__main__":
    main()
