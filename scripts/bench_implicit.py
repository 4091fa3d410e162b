"""Implicit Newmark-β step benchmark (BASELINE.md self-measured metric #2).

Measures wall time per implicit step (Newton + Jacobi-preconditioned CG,
matrix-free JVP tangent) and edge throughput on the bench problem, for both
the fused-Pallas and the XLA windowed transfer engines.

Run on a GPU:  python scripts/bench_implicit.py
Env: BENCH_GRID (default 256), BENCH_STEPS (default 5).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from bench import build_problem
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_side = int(os.environ.get("BENCH_GRID", "256"))
    n_steps = int(os.environ.get("BENCH_STEPS", "5"))
    grid, p, mats, h = build_problem(n_side=n_side, ppc=2)
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2,
        cdims=(n_side // 2 + 4,) * 2,
        capacity=6,
    )
    cel = np.sqrt(1e7 / 1000.0)
    body = jnp.zeros((2,), jnp.float32)
    p = to_slot_layout(p, grid, box)
    results = {}
    for transfer in ("pallas", "windowed"):
        cfg = ImplicitConfig(
            dt=2.0 * h / cel,  # implicit: several× the explicit CFL step
            shapefun="lme",
            lme_params=lme.LMEParams(gamma=3.0),
            kinds=(M.NEO_HOOKEAN,),
            transfer=transfer,
            active_box=box,
            cg_maxiter=60,
            newton_maxiter=10,
            forcing=os.environ.get("BENCH_FORCING", "ew"),
        )

        def many(pp):
            def bd(c, _):
                c, dg = implicit_step(c, grid, mats, cfg, body)
                return c, (dg["nnz"], dg["newton_iters"], dg["cg_iters"], dg["converged"])
            return jax.lax.scan(bd, pp, None, length=n_steps)

        fn = jax.jit(many)
        pf, aux = fn(p)
        pf.x.block_until_ready()
        t0 = time.perf_counter()
        pf, (nnz, iters, ksp, conv) = fn(p)
        pf.x.block_until_ready()
        t1 = time.perf_counter()
        step_ms = (t1 - t0) / n_steps * 1e3
        nnzs = int(np.asarray(nnz).astype(np.int64).sum()) / (t1 - t0)
        results[transfer] = dict(
            step_ms=step_ms,
            nnz_per_s=nnzs,
            newton_iters=np.asarray(iters).tolist(),
            cg_iters=np.asarray(ksp).tolist(),
            converged=bool(np.asarray(conv).all()),
        )
        print(json.dumps({"metric": f"implicit_newmark_step_time_{transfer}",
                          "value": step_ms, "unit": "ms",
                          "newton_iters": np.asarray(iters).tolist(),
                          "cg_iters": np.asarray(ksp).tolist(),
                          "converged": results[transfer]["converged"]}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
