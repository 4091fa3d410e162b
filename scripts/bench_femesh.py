"""Unstructured-mesh meshfree-LME benchmark.

The reference's flagship configuration is meshfree LME over the node
cloud of an unstructured GiD mesh (GramsShapeFun Type=LME;
/root/reference/nl-partsol/src/Nodes/LME.c:895-1015 local_search +
tributary sets).  This measures the full explicit LME step on a
genuinely non-Cartesian perturbed T3 triangulation through the
configured transfer engine, with the same nnz/s accounting as bench.py.

Run on a GPU:  python scripts/bench_femesh.py
Env: BENCH_NX (node grid edge, default 192), BENCH_STEPS (default 10),
     BENCH_TRANSFER (scatter | binned).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_problem(nx=192, perturb=0.2, seed=0):
    import jax.numpy as jnp

    from nlpartsol.shapefun import femesh
    from nlpartsol.shapefun import lme as lme_mod
    from nlpartsol.types import make_particles
    from nlpartsol.models import materials as M

    rng = np.random.default_rng(seed)
    L = 1.0
    xs = np.linspace(0, L, nx + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], -1)
    h = L / nx
    interior = (
        (coords[:, 0] > 1e-9) & (coords[:, 0] < L - 1e-9)
        & (coords[:, 1] > 1e-9) & (coords[:, 1] < L - 1e-9)
    )
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) * h
    ids = np.arange((nx + 1) ** 2).reshape(nx + 1, nx + 1)
    tris = []
    for i in range(nx):
        for j in range(nx):
            a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
            if (i + j) % 2 == 0:
                tris += [[a, b, c], [a, c, d]]
            else:
                tris += [[a, b, d], [b, c, d]]
    tris = np.asarray(tris)
    mesh = femesh.build_femesh(coords, tris, "T3")
    lp = lme_mod.LMEParams(gamma=3.0)
    mesh = femesh.with_node_bins(mesh, lme_mod.support_radius(lp, mesh.h_avg))

    # 3 particles per triangle at barycentric points
    xe = coords[tris]
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    pts = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    e1, e2 = xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    vol = np.repeat(area / 3.0, 3)
    rho = 1000.0
    p = make_particles(
        pts.astype(np.float32),
        mass=(rho * vol).astype(np.float32),
        vol0=vol.astype(np.float32),
    )
    p = p.replace(
        v=jnp.asarray(0.01 * rng.standard_normal(pts.shape), jnp.float32)
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e7, nu=0.3, rho0=rho)]
    )
    return mesh, p, mats, lp


def main():
    import jax

    from nlpartsol.utils import compile_cache

    compile_cache.enable()

    from nlpartsol.formulations.explicit import ExplicitConfig, run
    from nlpartsol.formulations.courant import courant_dt
    from nlpartsol.models import materials as M

    n_steps = int(os.environ.get("BENCH_STEPS", "10"))
    nx = int(os.environ.get("BENCH_NX", "192"))
    transfer = os.environ.get("BENCH_TRANSFER", "scatter")
    mesh, p, mats, lp = build_problem(nx=nx)
    cel = np.sqrt(1e7 / 1000.0)
    cfg = ExplicitConfig(
        dt=courant_dt(0.25, mesh.spacing, cel),
        shapefun="lme",
        lme_params=lp,
        kinds=(M.NEO_HOOKEAN,),
        transfer=transfer,
    )
    runj = jax.jit(run, static_argnums=(3, 4))
    t0 = time.perf_counter()
    p1, diag = runj(p, mesh, mats, cfg, n_steps)
    jax.block_until_ready(p1.x)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, diag = runj(p1, mesh, mats, cfg, n_steps)
    jax.block_until_ready(p2.x)
    t1 = time.perf_counter()

    total_nnz = int(np.asarray(diag["nnz"]).astype(np.int64).sum())
    value = total_nnz / (t1 - t0)
    print(
        json.dumps(
            {
                "metric": "femesh_lme_step_throughput",
                "value": value,
                "unit": "nnz/s",
                "transfer": transfer,
                "nodes": int(mesh.n_nodes),
                "particles": int(p.count),
                "nnz_per_step": total_nnz // n_steps,
                "step_ms": (t1 - t0) / n_steps * 1e3,
                "compile_s": compile_s,
            }
        )
    )


if __name__ == "__main__":
    main()
