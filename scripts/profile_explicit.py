"""Per-stage timing breakdown of the explicit Pallas step.

Times each pipeline stage in isolation on the real device (jit + scan of the
stage alone, amortised over many iterations) and prints a table plus the
implied roofline numbers.  Run on a GPU:  python scripts/profile_explicit.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fn, *args, iters=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    from bench import build_problem
    from nlpartsol.formulations.explicit import (
        ExplicitConfig,
        explicit_step,
        to_slot_layout,
    )
    from nlpartsol.models import dispatch as con
    from nlpartsol.models import materials as M
    from nlpartsol.ops import pallas_transfer as pt
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    n_side = int(os.environ.get("BENCH_GRID", "512"))
    grid, p, mats, h = build_problem(n_side=n_side, ppc=2)
    cel = np.sqrt(1e7 / 1000.0)
    box = windowed.ActiveBox(
        offset=(n_side // 4 - 2,) * 2,
        cdims=(n_side // 2 + 4,) * 2,
        capacity=6,
    )
    lp = lme.LMEParams(gamma=3.0)
    cfg = ExplicitConfig(
        dt=0.25 * h / cel,
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer="pallas",
        active_box=box,
    )
    body = jnp.zeros((2,), jnp.float32)
    p = to_slot_layout(p, grid, box)
    C, nc = box.capacity, box.n_cells
    margin = 0

    Np = int(np.asarray(p.active).sum())
    print(f"Np={Np}  slots={box.n_slots}  cells={box.cdims}  capacity={C}", flush=True)
    nnz = Np * 45

    def rpt(name, t):
        print(f"{name:32s} {t * 1e3:8.3f} ms   {nnz / t / 1e9:7.2f} Gnnz/s-equiv", flush=True)

    # full step (no rebin)
    f_step = jax.jit(
        lambda pp: explicit_step(pp, grid, mats, cfg, body)[0].x
    )
    t_step = timeit(f_step, p); rpt("full step (incl local rebin)", t_step)

    # global rebin (round-1 flow: argsort + wide row gather)
    def rebin(pp):
        b = windowed.bin_particles(grid, box, pp.x, pp.active)
        return windowed.permute_to_slots(pp, b).x

    t_rebin = timeit(jax.jit(rebin), p); rpt("global rebin (argsort)", t_rebin)

    # local rebin (neighbour compaction)
    t_lrebin = timeit(
        jax.jit(lambda pp: windowed.local_rebin(pp, grid, box)[0].x), p
    ); rpt("local rebin (compaction)", t_lrebin)

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(p.active.astype(p.x.dtype), C, nc)
    fN3 = jnp.stack([pt.to_channel_leading(c, C, nc)[0] for c in (p.mass, p.mass, p.mass)])
    G_t = pt.to_channel_leading(jnp.zeros((box.n_slots, 4), jnp.float32), C, nc)
    dummy = pt.to_channel_leading(jnp.zeros_like(p.mass), C, nc)
    nodes = jnp.zeros((grid.n_nodes, 2), jnp.float32)

    # scatter with solve (scatter #1)
    f_s1 = jax.jit(
        lambda: pt.fused_scatter(grid, box, lp, x_t, lam_t, act_t, fN3, solve=True, margin=margin)[0]
    )
    t_s1 = timeit(f_s1); rpt("scatter#1 solve+3ch", t_s1)

    # scatter without solve (scatter #2, with G)
    f_s2 = jax.jit(
        lambda: pt.fused_scatter(grid, box, lp, x_t, lam_t, act_t, dummy, G_t=G_t, solve=False, margin=margin)[0]
    )
    t_s2 = timeit(f_s2); rpt("scatter#2 G", t_s2)

    # gather with grad (gather #1)
    f_g1 = jax.jit(
        lambda: pt.fused_gather(grid, box, lp, x_t, lam_t, act_t, gN=nodes, g_grad=nodes, margin=margin)[0]
    )
    t_g1 = timeit(f_g1); rpt("gather#1 N+grad", t_g1)

    # gather N only (gather #2)
    f_g2 = jax.jit(
        lambda: pt.fused_gather(grid, box, lp, x_t, lam_t, act_t, gN=nodes, margin=margin)[0]
    )
    t_g2 = timeit(f_g2); rpt("gather#2 N", t_g2)

    # constitutive alone
    eye = jnp.tile(jnp.eye(2, dtype=jnp.float32), (box.n_slots, 1, 1))

    def constit(F):
        cs = con.stress_integration(
            F_n1=F, DF=F, dFdt_n1=jnp.zeros_like(F), bemi=eye,
            bemi_zz=jnp.ones(box.n_slots), eps=p.eps, kappa=p.kappa,
            back_stress=p.back_stress, mat_id=p.mat_id, mats=mats,
            kinds=cfg.kinds,
        )
        return cs.tau

    t_con = timeit(jax.jit(constit), eye); rpt("constitutive", t_con)

    acc = t_s1 + t_s2 + t_g1 + t_g2 + t_con + t_lrebin
    print(f"{'sum of stages':32s} {acc * 1e3:8.3f} ms")
    print(f"{'unaccounted (step - stages)':32s} {(t_step - acc) * 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
