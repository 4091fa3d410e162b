"""Two-phase (upw) step benchmark: fused-pallas vs XLA windowed engine.

Explicit mode (default; the geotech flagship through the fused
transfers):
same accounting as bench.py — end-to-end nnz/s of the full two-phase step
(3 fused scatters + 5 fused gathers + constitutive + Darcy/mass-balance)
under lax.scan.

--implicit: the monolithic u-pw Newmark-beta step
(upw_newmark_step) — the reference's most expensive path (dense LAPACK LU
per NR iteration, U-pw-Newmark-beta.c:2238) — fused Newton-GMRES vs the
windowed engine, at an implicit-sized dt (20x the explicit CFL step).

Run on a GPU:  python scripts/bench_upw.py [--implicit]
Env: BENCH_GRID (default 512 explicit / 256 implicit), BENCH_STEPS
     (default 16 / 8), BENCH_ENGINES (comma list, 'pallas,windowed').
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main_implicit():
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from bench import build_problem
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.formulations.upw import (
        UpwImplicitConfig, init_mixture_state, make_mixture_table,
        upw_newmark_step,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "8"))
    n_side = int(os.environ.get("BENCH_GRID", "256"))
    grid, p, _, h = build_problem(n_side=n_side, ppc=2)
    mats = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
            M.material(
                kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                compressibility=2.2e7,
            ),
        ]
    )
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)]
    )
    p = init_mixture_state(p, mats, mix)
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2, capacity=6
    )
    c_mix = np.sqrt((2.2e7 / 0.4) / 1700.0)
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    engines = os.environ.get("BENCH_ENGINES", "pallas,windowed").split(",")
    results = {}
    for transfer in engines:
        cfg = UpwImplicitConfig(
            dt=20 * 0.25 * h / c_mix,  # implicit: well past the CFL limit
            shapefun="lme",
            lme_params=lme.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)

        def many(q):
            def bd(c, _):
                c, dg = upw_newmark_step(c, grid, mats, mix, cfg, body)
                return c, (dg["nnz"], dg["lost"], dg["newton_iters"],
                           dg.get("cg_iters", dg["newton_iters"] * 0))

            return jax.lax.scan(bd, q, None, length=n_steps)

        fn = jax.jit(many)
        p1, (nnz, lost, nit, cgit) = fn(pp)
        jax.block_until_ready(nnz)
        assert int(np.asarray(lost).sum()) == 0, f"warmup lost: {np.asarray(lost)}"
        t0 = time.perf_counter()
        p2, (nnz, lost, nit, cgit) = fn(p1)
        jax.block_until_ready(nnz)
        t1 = time.perf_counter()
        assert int(np.asarray(lost).sum()) == 0, f"timed lost: {np.asarray(lost)}"
        total = int(np.asarray(nnz).astype(np.int64).sum())
        assert total > 0, "no active edges - benchmark invalid"
        results[transfer] = dict(
            step_ms=1e3 * (t1 - t0) / n_steps, nnz_per_s=total / (t1 - t0)
        )
        print(json.dumps({
            "metric": f"upw_implicit_step_{transfer}",
            "value": results[transfer]["step_ms"], "unit": "ms",
            "nnz_per_s": results[transfer]["nnz_per_s"],
            "newton_iters_per_step": float(np.asarray(nit).mean()),
            "cg_iters_per_step": float(np.asarray(cgit).mean()),
            "backend": jax.default_backend(),
        }), flush=True)
    if {"pallas", "windowed"} <= set(results):
        print(json.dumps({
            "metric": "upw_implicit_fused_speedup",
            "value": results["windowed"]["step_ms"] / results["pallas"]["step_ms"],
            "unit": "x",
        }), flush=True)
    return results


def main():
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from bench import build_problem
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.formulations.upw import (
        UpwConfig, init_mixture_state, make_mixture_table, upw_step,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "16"))
    n_side = int(os.environ.get("BENCH_GRID", "512"))
    grid, p, _, h = build_problem(n_side=n_side, ppc=2)
    mats = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=2700.0),
            M.material(
                kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                compressibility=2.2e7,
            ),
        ]
    )
    mix = make_mixture_table(
        [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)]
    )
    p = init_mixture_state(p, mats, mix)
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2, capacity=6
    )
    c_mix = np.sqrt((2.2e7 / 0.4) / 1700.0)
    body = jnp.asarray([0.0, -9.81], jnp.float32)
    engines = os.environ.get("BENCH_ENGINES", "pallas,windowed").split(",")
    results = {}
    for transfer in engines:
        cfg = UpwConfig(
            dt=0.25 * h / c_mix,
            shapefun="lme",
            lme_params=lme.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
        )
        pp = to_slot_layout(p, grid, box)

        def many(q):
            def bd(c, _):
                c, dg = upw_step(c, grid, mats, mix, cfg, body)
                return c, (dg["nnz"], dg["lost"])

            return jax.lax.scan(bd, q, None, length=n_steps)

        fn = jax.jit(many)
        p1, (nnz, lost) = fn(pp)
        jax.block_until_ready(nnz)
        assert int(np.asarray(lost).sum()) == 0, f"warmup lost particles: {np.asarray(lost)}"
        t0 = time.perf_counter()
        p2, (nnz, lost) = fn(p1)
        jax.block_until_ready(nnz)
        t1 = time.perf_counter()
        assert int(np.asarray(lost).sum()) == 0, f"timed run lost particles: {np.asarray(lost)}"
        total = int(np.asarray(nnz).astype(np.int64).sum())
        assert total > 0, "no active edges - benchmark invalid"
        results[transfer] = dict(
            step_ms=1e3 * (t1 - t0) / n_steps, nnz_per_s=total / (t1 - t0)
        )
        print(json.dumps({
            "metric": f"upw_explicit_step_{transfer}",
            "value": results[transfer]["step_ms"], "unit": "ms",
            "nnz_per_s": results[transfer]["nnz_per_s"],
            "backend": jax.default_backend(),
        }), flush=True)
    if {"pallas", "windowed"} <= set(results):
        print(json.dumps({
            "metric": "upw_fused_speedup",
            "value": results["windowed"]["step_ms"] / results["pallas"]["step_ms"],
            "unit": "x",
        }), flush=True)
    return results


if __name__ == "__main__":
    if "--implicit" in sys.argv:
        main_implicit()
    else:
        main()
