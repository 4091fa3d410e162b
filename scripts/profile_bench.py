"""Profile the headline bench step on the GPU (PERF.md accounting).

Runs the exact bench.py problem, times the warm scan, and captures a
jax.profiler trace of a few scan invocations.  Prints a JSON timing line
and the trace directory for offline inspection.
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

    import bench
    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "30"))
    grid, p, mats, h = bench.build_problem(
        n_side=int(os.environ.get("BENCH_GRID", "512")),
        ppc=int(os.environ.get("BENCH_PPC", "2")),
    )
    cel = np.sqrt(1e7 / 1000.0)
    n_side = grid.dims[0]
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2,
        cdims=(n_side // 2 + 4,) * 2,
        capacity=6,
    )
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,),
        transfer=os.environ.get("BENCH_TRANSFER", "pallas"),
        active_box=box,
        rebin_mode="local",
        rebin_every=int(os.environ.get("BENCH_REBIN_EVERY", "4")),
    )
    body = jnp.zeros((2,), jnp.float32)
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

            pf, nnz = jax.lax.scan(outer, p, None, length=n_steps // k)
            return pf, nnz.reshape(-1)

        def bd(pp, i):
            pp, diag = explicit_step(pp, grid, mats, cfg, body)
            return pp, diag["nnz"]

        return jax.lax.scan(bd, p, jnp.arange(n_steps), length=n_steps)

    fn = jax.jit(many_steps)
    p1, nnz = fn(p)
    p1.x.block_until_ready()
    t0 = time.perf_counter()
    p2, _ = fn(p1)
    p2.x.block_until_ready()
    t_scan = time.perf_counter() - t0

    if os.environ.get("SKIP_SINGLE"):
        out = {"scan_step_ms": 1e3 * t_scan / n_steps, "n_steps": n_steps}
        trace_dir = os.environ.get("TRACE_DIR")
        if trace_dir:
            with jax.profiler.trace(trace_dir):
                p4, _ = fn(p1)
                p4.x.block_until_ready()
            out["trace_dir"] = trace_dir
        print(json.dumps(out))
        return

    # single jitted step on its own (returns the FULL state, so no
    # dead-code elimination of state-channel writes)
    def one(p):
        return explicit_step(p, grid, mats, cfg, body)[0]

    fo = jax.jit(one)
    p3 = fo(p1)
    p3.x.block_until_ready()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        p3 = fo(p3)
    p3.x.block_until_ready()
    t_one = (time.perf_counter() - t0) / reps

    out = {
        "scan_step_ms": 1e3 * t_scan / n_steps,
        "single_step_ms": 1e3 * t_one,
        "n_steps": n_steps,
    }

    trace_dir = os.environ.get("TRACE_DIR")
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            p4, _ = fn(p1)
            p4.x.block_until_ready()
        out["trace_dir"] = trace_dir
    print(json.dumps(out))


if __name__ == "__main__" and not os.environ.get("DUMP_HLO"):
    main()


def dump_hlo(path="/tmp/many_steps_hlo.txt"):
    """Dump the optimized HLO of the bench scan for fusion attribution."""
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    import bench
    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout,
    )
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_steps = int(os.environ.get("BENCH_STEPS", "30"))
    grid, p, mats, h = bench.build_problem(
        n_side=int(os.environ.get("BENCH_GRID", "512")), ppc=2
    )
    cel = np.sqrt(1e7 / 1000.0)
    n_side = grid.dims[0]
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2, cdims=(n_side // 2 + 4,) * 2, capacity=6
    )
    cfg = ExplicitConfig(
        dt=0.25 * h / cel, shapefun="lme", lme_params=lme.LMEParams(gamma=3.0),
        kinds=(M.NEO_HOOKEAN,), transfer="pallas", active_box=box,
    )
    body = jnp.zeros((2,), jnp.float32)
    p = to_slot_layout(p, grid, box)

    def many_steps(p):
        def bd(pp, i):
            pp, diag = explicit_step(pp, grid, mats, cfg, body)
            return pp, diag["nnz"]

        return jax.lax.scan(bd, p, jnp.arange(n_steps), length=n_steps)

    txt = jax.jit(many_steps).lower(p).compile().as_text()
    open(path, "w").write(txt)
    print(path, len(txt))


if __name__ == "__main__" and os.environ.get("DUMP_HLO"):
    dump_hlo()
