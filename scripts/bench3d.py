"""3D explicit fused-Pallas step benchmark.

Same accounting as bench.py (end-to-end nnz/s of the full explicit LME
step, scanned) on a 3D problem: N³ node grid, 1 particle/cell over the
central half, K = (2w+1)³ = 343 window (γ = 3).

Run on a GPU:  python scripts/bench3d.py
Env: BENCH_GRID (default 96), BENCH_STEPS (default 10),
     BENCH_TRANSFER (pallas | windowed).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_problem3(n_side=96, ppc=1):
    import jax.numpy as jnp

    from nlpartsol.types import Grid, make_particles
    from nlpartsol.models import materials as M

    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side,) * 3, spacing=h, origin=(0.0, 0.0, 0.0))
    lo_cell, hi_cell = n_side // 4, 3 * n_side // 4
    ncell = hi_cell - lo_cell
    ax = (np.arange(ncell) + lo_cell).astype(np.float64)
    sub = (np.arange(ppc) + 0.5) / ppc
    i, j, k, a, b, c = np.meshgrid(ax, ax, ax, sub, sub, sub, indexing="ij")
    x = np.stack([(i + a) * h, (j + b) * h, (k + c) * h], axis=-1)
    x = x.reshape(-1, 3).astype(np.float32)
    vol = (h / ppc) ** 3
    rho = 1000.0
    p = make_particles(
        x,
        mass=np.full(len(x), rho * vol, np.float32),
        vol0=np.full(len(x), vol, np.float32),
    )
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
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "10"))
    n_side = int(os.environ.get("BENCH_GRID", "96"))
    grid, p, mats, h = build_problem3(n_side=n_side)
    cel = np.sqrt(1e7 / 1000.0)
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 3,
        cdims=(n_side // 2 + 4,) * 3,
        capacity=2,
    )
    transfer = os.environ.get("BENCH_TRANSFER", "pallas")
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
        transfer=transfer,
        active_box=box,
        # 3D default: per-step local rebin.  The 2D-style amortisation
        # widens the window to K1=9 -> 729 basis offsets vs 343; whether
        # that pays on the GPU is not measured
        rebin_mode="local",
        rebin_every=int(os.environ.get("BENCH_REBIN_EVERY", "1")),
    )
    body = jnp.zeros((3,), jnp.float32)
    p = to_slot_layout(p, grid, box)

    def many_steps(p):
        k = cfg.rebin_every
        if k > 1:
            def inner(pp, _):
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=False)
                return pp, diag["nnz"]

            def outer(pp, _):
                pp, nnz1 = jax.lax.scan(inner, pp, None, length=k - 1)
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=True)
                return pp, jnp.concatenate([nnz1, diag["nnz"][None]])

            pf, nnz = jax.lax.scan(outer, p, None, length=max(1, n_steps // k))
            return pf, nnz.reshape(-1)

        def bd(carry, i):
            pp, diag = explicit_step(carry, grid, mats, cfg, body)
            return pp, diag["nnz"]

        return jax.lax.scan(bd, p, jnp.arange(n_steps), length=n_steps)

    fn = jax.jit(many_steps)
    t0 = time.perf_counter()
    p1, nnz = fn(p)
    p1.x.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, nnz = fn(p1)
    p2.x.block_until_ready()
    t1 = time.perf_counter()

    total_nnz = int(np.asarray(nnz).astype(np.int64).sum())
    value = total_nnz / (t1 - t0)
    print(
        json.dumps(
            {
                "metric": "explicit3d_lme_step_p2g_g2p_throughput",
                "value": value,
                "unit": "nnz/s",
                "transfer": transfer,
                "grid": n_side,
                "particles": int(np.asarray(p.active).sum()),
                "nnz_per_step": total_nnz // n_steps,
                "step_ms": (t1 - t0) / n_steps * 1e3,
                "compile_s": compile_s,
            }
        )
    )


if __name__ == "__main__":
    main()
