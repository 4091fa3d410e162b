"""Fused LME transfers on the GPU: the Triton kernels against their XLA
reference and against the windowed engine.

For each grid size (bench.py's problem: particles in the central half at
2×2 per cell, box = that half + 2 cells, capacity 6, γ = 3):

* per call, each transfer the explicit step makes (P2G with the λ solve
  over 3 channels, P2G of Σ G·∇N, G2P of N and ∇N, G2P of N), through the
  Triton kernels and through their XLA reference, at margin 1 (the
  amortised-rebin window the explicit step uses);
* per explicit step end to end (a 32-step scan): transfer='pallas' with
  the Triton kernels, transfer='pallas' with the XLA reference in their
  place, and transfer='windowed'.

Prints one JSON line per measurement, each with the card's name and power
limit.  Needs a GPU.

    python scripts/compare_transfer.py [--sizes 512 1024] [--steps 32]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _ms(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _trace(compiled, p, out_dir, emit, **kw):
    """Trace one call of ``compiled`` and emit the device time per kernel
    name (summed over the window), the busy time and the idle share."""
    import jax

    jax.block_until_ready(compiled(p))
    with jax.profiler.trace(out_dir):
        jax.block_until_ready(compiled(p))
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.end_ns, e.name) for e in line.events]
            if not evs:
                continue
            per = {}
            for a, b, n in evs:
                per[n] = per.get(n, 0.0) + (b - a)
            spans = sorted((a, b) for a, b, _ in evs)
            busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
            for a, b in spans[1:]:
                if a > cur_b:
                    busy += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            busy += cur_b - cur_a
            window = spans[-1][1] - spans[0][0]
            top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
            emit(metric="trace", plane=plane.name, line=line.name, events=len(evs),
                 window_ms=window / 1e6, busy_ms=busy / 1e6,
                 idle_share=1.0 - busy / max(window, 1.0),
                 top_ms={n[:80]: t / 1e6 for n, t in top}, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace one timed scan of each engine at the largest size "
                    "and print the device time per kernel")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from nlpartsol.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's first device is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    from bench import build_problem
    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout)
    from nlpartsol.models import materials as M
    from nlpartsol.ops import pallas_transfer as pt
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    def emit(**kw):
        print(json.dumps({**kw, "device_kind": dev.device_kind, "card": card}), flush=True)

    params = lme.LMEParams(gamma=3.0)
    triton_impl = pt.transfer_impl

    def xla_impl(platform, interpret=False):
        return "xla"

    for n_side in args.sizes:
        grid, p, mats, h = build_problem(n_side=n_side, ppc=2)
        box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2,
                                 cdims=(n_side // 2 + 4,) * 2, capacity=6)
        p = to_slot_layout(p, grid, box)
        C, nc = box.capacity, box.n_cells
        rng = np.random.default_rng(0)
        x_t = pt.to_channel_leading(p.x, C, nc)
        lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
        act_t = pt.to_channel_leading(p.active.astype(jnp.float32), C, nc)
        fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0]
                        for c in (p.mass, p.mass * p.v[:, 0], p.mass * p.v[:, 1])])
        G_t = pt.to_channel_leading(
            jnp.asarray(rng.standard_normal((p.count, 4)), jnp.float32), C, nc)
        u = jnp.asarray(rng.standard_normal((grid.n_nodes, 2)), jnp.float32)
        lam_c = pt._scatter_xla(grid, box, params, x_t, lam_t, act_t, fN, None,
                                True, 1)[1]
        calls = {
            "p2g_solve_3ch": (
                lambda s, x, l, a: s(grid, box, params, x, l, a, fN, solve=True, margin=1),
                lam_t),
            "p2g_G": (
                lambda s, x, l, a: s(grid, box, params, x, l, a, fN[:1], G_t=G_t,
                                     solve=False, margin=1), lam_c),
            "g2p_N_grad": (
                lambda s, x, l, a: s(grid, box, params, x, l, a, gN=u, g_grad=u,
                                     margin=1), lam_c),
            "g2p_N": (
                lambda s, x, l, a: s(grid, box, params, x, l, a, gN=u, margin=1),
                lam_c),
        }
        for name, (f, lam_in) in calls.items():
            row = {}
            for impl in ("triton", "xla"):
                pt.transfer_impl = xla_impl if impl == "xla" else triton_impl
                op = pt.fused_gather if name.startswith("g2p") else pt.fused_scatter
                fn = jax.jit(lambda x, l, a, f=f, op=op: f(op, x, l, a))
                row[impl + "_ms"] = _ms(fn, x_t, lam_in, act_t)
            pt.transfer_impl = triton_impl
            emit(metric="transfer_call_ms", call=name, grid=n_side,
                 slots=box.n_slots, **row)

        cel = np.sqrt(1e7 / 1000.0)
        body = jnp.zeros((2,), jnp.float32)
        for engine in ("pallas-triton", "pallas-xla", "windowed"):
            k = 16 if engine.startswith("pallas") else 1
            cfg = ExplicitConfig(
                dt=0.25 * h / cel, shapefun="lme", lme_params=params,
                kinds=(M.NEO_HOOKEAN,),
                transfer="windowed" if engine == "windowed" else "pallas",
                active_box=box, rebin_mode="local", rebin_every=k)
            pt.transfer_impl = xla_impl if engine == "pallas-xla" else triton_impl

            def inner(pp, _, cfg=cfg):
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=False)
                return pp, diag["nnz"]

            def outer(pp, _, cfg=cfg, k=k):
                pp, nnz1 = jax.lax.scan(inner, pp, None, length=k - 1)
                pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=True)
                return pp, jnp.concatenate([nnz1, diag["nnz"][None]])

            fn = jax.jit(lambda pp, k=k: jax.lax.scan(outer, pp, None,
                                                       length=args.steps // k))
            t0 = time.perf_counter()
            compiled = fn.lower(p).compile()
            compile_s = time.perf_counter() - t0
            p1, _ = compiled(p)
            jax.block_until_ready(p1.x)
            t0 = time.perf_counter()
            p2, nnz = compiled(p1)
            jax.block_until_ready(p2.x)
            dt = time.perf_counter() - t0
            if args.trace and n_side == max(args.sizes):
                _trace(compiled, p2, os.path.join(args.trace, engine), emit,
                       engine=engine, grid=n_side, steps=args.steps)
            pt.transfer_impl = triton_impl
            emit(metric="explicit_step_ms", engine=engine, grid=n_side,
                 particles=int(np.asarray(p.active).sum()), slots=box.n_slots,
                 rebin_every=k, steps=args.steps, step_ms=dt / args.steps * 1e3,
                 nnz_per_s=int(np.asarray(nnz).astype(np.int64).sum()) / dt,
                 compile_s=compile_s,
                 lost=int(np.asarray(p.active).sum()) - int(np.asarray(p2.active).sum()))


if __name__ == "__main__":
    main()
