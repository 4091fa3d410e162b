"""Headline benchmark: P2G+G2P throughput (nnz/s) of the full explicit LME
MPM step on one chip (BASELINE.md self-measured metric #1).

Counts every particle→node edge (nnz of the dynamic CSR pattern) touched per
step; one step does 3 P2G scatters + 2 G2P gathers + LME evaluation +
constitutive over that pattern, so nnz/s here is end-to-end pipeline
throughput, not an isolated-scatter microbenchmark.

Needs a GPU: with none it exits non-zero.  BENCH_CPU_DEVICES=n is the one
explicit exception (the sharded leg's smoke on n virtual CPU devices), and
its line then says ``"platform": "cpu"``.

Prints ONE JSON line: {"metric", "value", "unit", "platform",
"device_kind", "device_count", ...}.
"""

import json
import os
import sys
import time

import numpy as np


def build_problem(n_side=512, ppc=2):
    import jax.numpy as jnp

    from nlpartsol.types import Grid, make_particles
    from nlpartsol.models import materials as M

    h = 1.0 / (n_side - 1)
    dims = (n_side, n_side)
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0))
    # particles fill the central half of the domain
    lo_cell, hi_cell = n_side // 4, 3 * n_side // 4
    ncell = hi_cell - lo_cell
    i, j, a, b = np.meshgrid(
        np.arange(ncell), np.arange(ncell), np.arange(ppc), np.arange(ppc), indexing="ij"
    )
    x = np.stack(
        [
            (lo_cell + i + (a + 0.5) / ppc) * h,
            (lo_cell + j + (b + 0.5) / ppc) * h,
        ],
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)
    vol = (h / ppc) ** 2
    rho = 1000.0
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
    # small random velocity field so the deformation path is nontrivial
    rng = np.random.default_rng(0)
    p = p.replace(v=jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32))
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=rho)]
    )
    return grid, p, mats, h


def main():
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    if os.environ.get("BENCH_CPU_DEVICES"):
        # CPU smoke of the sharded leg on a virtual device mesh
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(os.environ["BENCH_CPU_DEVICES"]))
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not os.environ.get("BENCH_CPU_DEVICES"):
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev.platform}")
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
    from nlpartsol.models import materials as M
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "32"))  # 2 outer scans of the 16-step rebin period (matches the warmed compile cache)
    grid, p, mats, h = build_problem(
        n_side=int(os.environ.get("BENCH_GRID", "512")),
        ppc=int(os.environ.get("BENCH_PPC", "2")),
    )
    cel = np.sqrt(1e7 / 1000.0)
    from nlpartsol.ops import windowed
    n_side = grid.dims[0]
    # particles occupy the central half; active box covers it + margin
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2,
        cdims=(n_side // 2 + 4,) * 2,
        capacity=6,
    )
    transfer = os.environ.get("BENCH_TRANSFER", "pallas")
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
        transfer=transfer,
        active_box=box,
        # local (sort-free) rebin amortised over 16 steps: the margin-1
        # kernels need drift ≤ 1 cell between re-bins, i.e. particle speed
        # ≤ c/(k·CFL) = c/4 at k=16 — solids in MPM rarely exceed ~0.1·c
        # (the bench's particles move at ~1e-4·c) — and violations are
        # counted LOUDLY (windowed.local_rebin lost), never silent.  The
        # driver picks the period from the particle speeds
        # (driver.safe_rebin_period).
        rebin_mode="local",
        rebin_every=int(os.environ.get("BENCH_REBIN_EVERY", "16")),
    )
    body = jnp.zeros((2,), jnp.float32)

    if os.environ.get("BENCH_SHARDED"):
        # halo-sharded leg (BENCH_SHARDS devices, default 1): same fused
        # transfers + k-periodic seam migration under shard_map; at S=1 it
        # measures the sharded-vs-unsharded overhead on one card
        from nlpartsol.parallel import domain

        S = int(os.environ.get("BENCH_SHARDS", "1"))
        k = cfg.rebin_every
        offs = lme.offsets_for(2, cfg.lme_params)
        dec = domain.decompose(grid, box, S, offs, margin=1 if k > 1 else 0)
        mesh = domain.make_mesh(S)
        ps = domain.shard_particles(p, dec)
        gs = domain.shard_grid(grid, dec)
        steps = ((n_steps + k - 1) // k) * k
        fn = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, steps))
        # TWO warmups: the host-built shards carry SingleDeviceSharding but
        # the run's outputs carry the mesh NamedSharding, so the first
        # evolved-state call compiles a second executable — time only after
        # both cache entries exist
        p1, diag = fn(ps, gs, mats, body)
        jax.block_until_ready(diag["nnz"])
        p1, diag = fn(p1, gs, mats, body)
        jax.block_until_ready(diag["nnz"])
        t0 = time.perf_counter()
        p2, diag = fn(p1, gs, mats, body)
        jax.block_until_ready(diag["nnz"])
        t1 = time.perf_counter()
        total_nnz = int(np.asarray(diag["nnz"]).astype(np.int64).sum())
        print(json.dumps({
            "metric": "p2g_g2p_nnz_per_s_sharded",
            "value": total_nnz / (t1 - t0),
            "unit": "nnz/s",
            "shards": S,
            "lost": int(np.asarray(diag["lost"])),
            **device,
        }))
        return

    from nlpartsol.formulations.explicit import to_slot_layout

    p = to_slot_layout(p, grid, box)

    def many_steps(p):
        k = cfg.rebin_every
        if k > 1:
            # k-periodic nested scan with STATIC rebin flags (see
            # formulations/explicit.run): k-1 plain steps + one rebin step
            def inner(pp, _):
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=False)
                return pp, diag["nnz"]

            def outer(pp, _):
                pp, nnz1 = jax.lax.scan(inner, pp, None, length=k - 1)
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=True)
                return pp, jnp.concatenate([nnz1, diag["nnz"][None]])

            n_outer = max(1, n_steps // k)
            if n_outer * k != n_steps:
                print(f"# note: running {n_outer * k} steps "
                      f"(BENCH_STEPS={n_steps} rounded to the rebin period {k})",
                      file=sys.stderr)
            pf, nnz = jax.lax.scan(outer, p, None, length=n_outer)
            return pf, nnz.reshape(-1)

        def bd(carry, i):
            pp = carry
            pp, diag = explicit_step(pp, grid, mats, cfg, body)
            return pp, diag["nnz"]

        return jax.lax.scan(bd, p, jnp.arange(n_steps), length=n_steps)

    fn = jax.jit(many_steps)
    # warmup + compile
    p1, nnz = fn(p)
    p1.x.block_until_ready()
    steps_run = (
        max(1, n_steps // cfg.rebin_every) * cfg.rebin_every
        if cfg.rebin_every > 1
        else n_steps
    )
    # timed run (continue from warmed state so the pattern is realistic)
    t0 = time.perf_counter()
    p2, nnz = fn(p1)
    p2.x.block_until_ready()
    t1 = time.perf_counter()

    total_nnz = int(np.asarray(nnz).astype(np.int64).sum())
    value = total_nnz / (t1 - t0)

    # --- on-device value-parity gate ---
    # The headline number alone would not notice a miscompiled kernel.
    # Recompute the warmup trajectory (steps_run fused steps from the same
    # start state) through the XLA windowed engine ON THE SAME DEVICE and
    # require agreement; a lowering bug produces O(1) divergence, engine
    # summation-order noise stays ~1e-5.
    extra = {}
    if transfer == "pallas" and os.environ.get("BENCH_PARITY", "1") != "0":
        cfg_w = cfg.replace(transfer="windowed", rebin_every=1)

        def wd(pp, _):
            pp, diag = explicit_step(pp, grid, mats, cfg_w, body)
            return pp, diag["nnz"]

        wfn = jax.jit(lambda pp: jax.lax.scan(wd, pp, None, length=steps_run))
        pw, _ = wfn(p)
        pw.x.block_until_ready()

        def by_pid(pp):
            act = np.asarray(pp.active)
            pid = np.asarray(pp.pid)[act]
            o = np.argsort(pid)
            return np.asarray(pp.x)[act][o], np.asarray(pp.v)[act][o], pid[o]

        xp_, vp_, pid_p = by_pid(p1)
        xw_, vw_, pid_w = by_pid(pw)
        if len(pid_p) != len(pid_w) or not np.array_equal(pid_p, pid_w):
            extra = {"parity_ok": False, "parity_error": "particle sets differ"}
        else:
            rel_dx = float(np.max(np.abs(xp_ - xw_)) / h)
            v_scale = max(float(np.max(np.abs(vw_))), 1e-12)
            rel_dv = float(np.max(np.abs(vp_ - vw_)) / v_scale)
            extra = {
                "parity_ok": bool(rel_dx < 1e-3 and rel_dv < 1e-2),
                "parity_rel_dx": rel_dx,
                "parity_rel_dv": rel_dv,
            }
        if not extra.get("parity_ok", False):
            print(f"# PARITY FAILURE: {extra}", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "explicit_lme_step_p2g_g2p_throughput",
                "value": value,
                "unit": "nnz/s",
                **device,
                **extra,
            }
        )
    )


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
