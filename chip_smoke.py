"""Smoke test of the system on an NVIDIA GPU: the main path, end to end.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the halo-sharded runs on four cards

One card runs four phases in one process, in order:

1. device — a GPU is JAX's first device; its name and power limit
   (nvidia-smi), JAX's version and the compile cache in use;
2. kernels — each Triton LME transfer kernel against its plain XLA
   reference at the bench widths (512² grid, 260² box cells, capacity 6,
   γ = 3, margins 0 and 1), with both timed per call; then the tests
   marked ``gpu``;
3. main path — a 2D explicit NPC-FS LME Neo-Hookean run through
   ``driver.run_simulation(transfer="auto")`` on a 1024² grid with
   1,048,576 particles, checked against the windowed engine over the same
   64 steps; then the same step timed (ms/step, compile time, memory);
4. other paths — one implicit Newmark step (256², 65,536 particles) and a
   few 3D explicit steps (96³ grid, 110,592 particles).

``--four`` runs only the four-card path: the 1-D (S = 4) and 2-D (2 × 2)
halo-sharded explicit runs and a sharded implicit step, each against the
single-card run of the same steps on device 0.

A phase that fails ends the script with a non-zero exit before the last
line.  The last line of standard output, printed only when every phase
passed, is one JSON object: {"ok": true, "device": {"platform", "kind",
"count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's parity gate: a miscompiled kernel diverges by O(1); two
# engines that sum in another order agree to ~1e-5 in Δx/h after tens of
# steps
PARITY_DX, PARITY_DV = 1e-3, 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _median_ms(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _by_pid(p):
    act = np.asarray(p.active)
    pid = np.asarray(p.pid)[act]
    o = np.argsort(pid)
    return pid[o], np.asarray(p.x)[act][o], np.asarray(p.v)[act][o]


def _parity(p_a, p_b, h, what: str) -> None:
    pid_a, x_a, v_a = _by_pid(p_a)
    pid_b, x_b, v_b = _by_pid(p_b)
    if len(pid_a) != len(pid_b) or not np.array_equal(pid_a, pid_b):
        fail(f"{what}: the particle sets differ")
    rel_dx = float(np.max(np.abs(x_a - x_b)) / h)
    rel_dv = float(np.max(np.abs(v_a - v_b)) / max(float(np.max(np.abs(v_b))), 1e-12))
    log(f"{what}: max|dx|/h = {rel_dx:.3e} (tol {PARITY_DX:g}), "
        f"max|dv|/max|v| = {rel_dv:.3e} (tol {PARITY_DV:g}), particles {len(pid_a)}")
    if not (rel_dx < PARITY_DX and rel_dv < PARITY_DV):
        fail(f"{what}: parity outside tolerance")


def _check_state(p, n_expected: int, what: str) -> None:
    act = np.asarray(p.active)
    if int(act.sum()) != n_expected:
        fail(f"{what}: {int(act.sum())} active particles, expected {n_expected}")
    for name in ("x", "v", "F", "stress"):
        if not np.all(np.isfinite(np.asarray(getattr(p, name))[act])):
            fail(f"{what}: non-finite {name}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_phase(n_cards: int = 1) -> dict:
    import jax

    from nlpartsol.utils import compile_cache

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        fail(f"JAX's first device is {d.platform!r} ({d.device_kind}); a GPU is required")
    if len(devs) < n_cards:
        fail(f"{n_cards} cards required, JAX sees {len(devs)}")
    cache = compile_cache.enable()
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax {jax.__version__}; compile cache: {cache}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


# Kernel vs reference tolerances (max |Δ| over max |ref|), f32 throughout.
# The kernels evaluate l = x − x_A, the exponent and ∇N = −N·J⁻¹(l − r)
# with the reference's expressions, so the two differ only in the order of
# their sums (over the window, the capacity slots and the Newton moments):
# a few ulp (6e-8) of the largest term.  ∇N passes through the 2×2 inverse
# of a moment matrix, which costs about a decade more.
KERNEL_TOL = {"N": (1e-5, "f32, summation order only"),
              "dN": (1e-4, "f32, summation order through the 2x2 inverse of J"),
              "lam": (1e-5, "f32, Newton moments summed in another order")}


def kernel_phase(n_side: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from bench import build_problem
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import pallas_transfer as pt
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    log(f"matmul precision: {jax.config.jax_default_matmul_precision} "
        "(the reference's einsums; the kernels do no matrix products)")
    grid, p, _, _ = build_problem(n_side=n_side, ppc=2)
    box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2,
                             cdims=(n_side // 2 + 4,) * 2, capacity=6)
    p = to_slot_layout(p, grid, box)
    params = lme.LMEParams(gamma=3.0)
    C, nc = box.capacity, box.n_cells
    rng = np.random.default_rng(0)
    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(p.active.astype(jnp.float32), C, nc)
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0]
                    for c in (p.mass, p.mass * p.v[:, 0], p.mass * p.v[:, 1])])
    G_t = pt.to_channel_leading(
        jnp.asarray(rng.standard_normal((p.count, 4)), jnp.float32), C, nc)
    field = jnp.asarray(rng.standard_normal((grid.n_nodes, 2)), jnp.float32)
    act = np.asarray(p.active)
    log(f"kernel inputs: grid {grid.dims}, box {box.cdims} x C={C} "
        f"({box.n_slots} slots, {int(act.sum())} particles)")

    def check(name, kind, got, ref):
        tol, why = KERNEL_TOL[kind]
        e = _rel_err(got, ref)
        log(f"  {name}: max rel err {e:.3e} (tol {tol:g}: {why})")
        if not e < tol:
            fail(f"kernel {name} outside tolerance")

    for margin in (0, 1):
        def scatter(ref, **kw):
            f = pt._scatter_xla if ref else pt.fused_scatter
            return jax.jit(lambda x, l, a, fn, g: f(
                grid, box, params, x, l, a, fn, G_t=g if kw.get("G") else None,
                solve=kw.get("solve", False), margin=margin, gnorm=kw.get("gnorm", False)))

        def gather(ref, N, grad):
            f = pt._gather_xla if ref else pt.fused_gather
            return jax.jit(lambda x, l, a, u: f(
                grid, box, params, x, l, a, gN=u if N else None,
                g_grad=u if grad else None, margin=margin))

        timed = []
        name = f"scatter solve=True channels=3 margin={margin}"
        kf, rf = scatter(False, solve=True), scatter(True, solve=True)
        args = (x_t, lam_t, act_t, fN, G_t)
        k1, r1 = kf(*args), rf(*args)
        log(f"{name}: nnz {int(k1[2])} (reference {int(r1[2])})")
        if int(k1[2]) != int(r1[2]):
            fail(f"{name}: edge counts differ")
        check(name + " nodes", "N", k1[0], r1[0])
        check(name + " lambda", "lam", np.asarray(k1[1]).reshape(2, -1)[:, act],
              np.asarray(r1[1]).reshape(2, -1)[:, act])
        timed.append((name, kf, rf, args))
        lam_c = r1[1]

        name = f"scatter G+gnorm margin={margin}"
        kf, rf = scatter(False, G=True, gnorm=True), scatter(True, G=True, gnorm=True)
        args = (x_t, lam_c, act_t, fN, G_t)
        check(name + " nodes", "dN", kf(*args)[0], rf(*args)[0])
        timed.append((name, kf, rf, args))

        for N, grad in ((True, False), (False, True), (True, True)):
            name = f"gather gN={N} g_grad={grad} margin={margin}"
            kf, rf = gather(False, N, grad), gather(True, N, grad)
            args = (x_t, lam_c, act_t, field)
            for part, kind, g_, r_ in zip(("N", "grad"), ("N", "dN"), kf(*args), rf(*args)):
                if r_ is not None:
                    check(f"{name} {part}", kind, g_, r_)
            timed.append((name, kf, rf, args))
        for name, kf, rf, args in timed:
            log(f"  time {name}: triton {_median_ms(kf, *args):.3f} ms/call, "
                f"xla {_median_ms(rf, *args):.3f} ms/call")
    run_gpu_tests()


def run_gpu_tests() -> None:
    """The tests marked ``gpu``, in this process (conftest.py leaves the
    platform alone under NLPS_TESTS_ON_DEVICE=1)."""
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.failed:
                Count.failed += 1
            elif report.when == "call" and report.passed:
                Count.passed += 1
            elif report.skipped:
                Count.skipped += 1

    os.environ["NLPS_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_pallas_transfer.py")],
                     plugins=[Count()])
    log(f"gpu tests: rc={int(rc)} passed={Count.passed} failed={Count.failed} "
        f"skipped={Count.skipped}")
    if int(rc) != 0 or Count.passed == 0 or Count.failed or Count.skipped:
        fail("the tests marked gpu did not all pass")


def _explicit_setup(n_side: int, steps: int):
    """The main-path simulation: bench.py's problem (particles in the
    central half at 2×2 per cell, Neo-Hookean E = 1e7, a small random
    velocity field) as a SimulationSetup, and bench.py's active box."""
    from bench import build_problem
    from nlpartsol.io.builder import SimulationSetup, SolverParams
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed

    grid, p, mats, h = build_problem(n_side=n_side, ppc=2)
    setup = SimulationSetup(
        solver=SolverParams(scheme="NPC-FS", cfl=0.25, cel=float(np.sqrt(1e7 / 1e3)),
                            n_steps=steps),
        grid=grid, particles=p, materials=mats, kinds=(M.NEO_HOOKEAN,),
        shapefun="lme", shapefun_params={"gamma": 3.0},
        out_dir=os.path.join(REPO, ".smoke_out"), out_every=10 * steps,
    )
    box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2,
                             cdims=(n_side // 2 + 4,) * 2, capacity=6)
    return setup, box, h


def _step_scan(cfg, grid, mats, body, n_steps):
    """n_steps explicit steps as one program: the k-periodic nested scan
    with static rebin flags (bench.py, driver.run_simulation)."""
    import jax
    import jax.numpy as jnp

    from nlpartsol.formulations.explicit import explicit_step

    k = max(1, int(cfg.rebin_every))

    def inner(pp, _):
        pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=False)
        return pp, diag["nnz"]

    def outer(pp, _):
        pp, nnz1 = jax.lax.scan(inner, pp, None, length=k - 1)
        pp, diag = explicit_step(pp, grid, mats, cfg, body, rebin=True)
        return pp, jnp.concatenate([nnz1, diag["nnz"][None]])

    return lambda p: jax.lax.scan(outer, p, None, length=n_steps // k)


def main_path_phase(n_side: int = 1024, steps: int = 64) -> None:
    import jax
    import jax.numpy as jnp

    from nlpartsol.driver import make_step_config, run_simulation
    from nlpartsol.formulations.explicit import to_slot_layout

    setup, box, h = _explicit_setup(n_side, steps)
    n_part = setup.particles.count
    log(f"main path: grid {setup.grid.dims}, {n_part} particles, box {box.cdims} "
        f"x C={box.capacity} ({box.n_slots} slots), {steps} steps")
    t0 = time.perf_counter()
    p_f, hist = run_simulation(setup, transfer="auto", active_box=box,
                               write_outputs=False, progress=False)
    log(f"run_simulation(transfer='auto'): {time.perf_counter() - t0:.1f} s wall "
        f"(compile included), rebin_every={hist['rebin_every']}")
    _check_state(p_f, n_part, "main path")
    log("main path: state finite, lost == 0")
    p_w, _ = run_simulation(setup, transfer="windowed", active_box=box,
                            write_outputs=False, progress=False)
    _check_state(p_w, n_part, "windowed engine")
    _parity(p_f, p_w, h, "main path vs windowed engine")

    cfg = make_step_config(setup, transfer="pallas", active_box=box)
    body = jnp.zeros((2,), jnp.float32)
    n = (steps // cfg.rebin_every) * cfg.rebin_every
    fn = jax.jit(_step_scan(cfg, setup.grid, setup.materials, body, n))
    p0 = to_slot_layout(setup.particles, setup.grid, box)
    t0 = time.perf_counter()
    compiled = fn.lower(p0).compile()
    compile_s = time.perf_counter() - t0
    log(f"step scan ({n} steps, rebin_every={cfg.rebin_every}): compile {compile_s:.1f} s")
    log(f"memory_analysis: {compiled.memory_analysis()}")
    p1, _ = compiled(p0)
    jax.block_until_ready(p1.x)
    t0 = time.perf_counter()
    p2, nnz = compiled(p1)
    jax.block_until_ready(p2.x)
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    log(f"main path timing: {dt / n * 1e3:.3f} ms/step, "
        f"{int(np.asarray(nnz).astype(np.int64).sum()) / dt:.4e} nnz/s, "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')}")
    _check_state(p2, n_part, "timed steps")


def other_paths_phase(n_implicit: int = 256, n3d: int = 96, steps3d: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    from bench import build_problem
    from scripts.bench3d import build_problem3
    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout)
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.shapefun import lme

    cel = float(np.sqrt(1e7 / 1e3))
    # one implicit Newmark u step at scripts/bench_implicit.py's size
    grid, p, mats, h = build_problem(n_side=n_implicit, ppc=2)
    box = windowed.ActiveBox(offset=(n_implicit // 4 - 2,) * 2,
                             cdims=(n_implicit // 2 + 4,) * 2, capacity=6)
    p = to_slot_layout(p, grid, box)
    cfg = ImplicitConfig(dt=2.0 * h / cel, shapefun="lme",
                         lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                         transfer="pallas", active_box=box, cg_maxiter=60,
                         newton_maxiter=10)
    step = jax.jit(lambda q: implicit_step(q, grid, mats, cfg, jnp.zeros((2,), jnp.float32)))
    t0 = time.perf_counter()
    p1, diag = step(p)
    jax.block_until_ready(p1.x)
    log(f"implicit step ({grid.dims}, {int(np.asarray(p.active).sum())} particles): "
        f"converged={bool(diag['converged'])} newton_iters={int(diag['newton_iters'])} "
        f"cg_iters={np.asarray(diag['cg_iters']).tolist()} "
        f"residual={float(diag['newton_residual']):.3e}, "
        f"{time.perf_counter() - t0:.1f} s with compile")
    if not bool(diag["converged"]) or int(diag["lost"]) != 0:
        fail("the implicit step did not converge")
    _check_state(p1, int(np.asarray(p.active).sum()), "implicit step")

    # a few 3D explicit steps at scripts/bench3d.py's size (XLA path)
    grid, p, mats, h = build_problem3(n_side=n3d)
    box = windowed.ActiveBox(offset=(n3d // 4 - 2,) * 3, cdims=(n3d // 2 + 4,) * 3,
                             capacity=2)
    p = to_slot_layout(p, grid, box)
    cfg = ExplicitConfig(dt=0.25 * h / cel, shapefun="lme",
                         lme_params=lme.LMEParams(gamma=3.0), kinds=(M.NEO_HOOKEAN,),
                         transfer="pallas", active_box=box, rebin_mode="local")
    body = jnp.zeros((3,), jnp.float32)

    def run(q):
        def bd(c, _):
            c, dg = explicit_step(c, grid, mats, cfg, body)
            return c, dg["lost"]
        return jax.lax.scan(bd, q, None, length=steps3d)

    t0 = time.perf_counter()
    p1, lost = jax.jit(run)(p)
    jax.block_until_ready(p1.x)
    n_part = int(np.asarray(p.active).sum())
    log(f"3D explicit ({grid.dims}, {n_part} particles, {box.n_slots} slots): "
        f"{steps3d} steps, lost={int(np.asarray(lost).sum())}, "
        f"{time.perf_counter() - t0:.1f} s with compile")
    if int(np.asarray(lost).sum()) != 0:
        fail("3D steps lost particles")
    _check_state(p1, n_part, "3D explicit")


def four_phase(n_side: int = 1024, steps: int = 16, n_implicit: int = 256) -> None:
    """The halo-sharded grid decomposition on four cards, each run against
    the single-card run of the same steps on device 0."""
    import jax
    import jax.numpy as jnp

    from bench import build_problem
    from nlpartsol.formulations.explicit import (
        ExplicitConfig, explicit_step, to_slot_layout)
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M
    from nlpartsol.ops import windowed
    from nlpartsol.parallel import domain
    from nlpartsol.shapefun import lme

    setup, box, h = _explicit_setup(n_side, steps)
    grid, mats = setup.grid, setup.materials
    lp = lme.LMEParams(gamma=3.0)
    offs = lme.offsets_for(2, lp)
    cel = float(np.sqrt(1e7 / 1e3))
    body = jnp.zeros((2,), jnp.float32)
    # per-step migration (rebin_every = 1) on both sides
    cfg = ExplicitConfig(dt=0.25 * h / cel, shapefun="lme", lme_params=lp,
                         kinds=(M.NEO_HOOKEAN,), transfer="pallas", active_box=box,
                         rebin_mode="local")

    def single(p0, g, c, stepper, n):
        def bd(q, _):
            return stepper(q, g, mats, c, body)[0], None
        return jax.jit(lambda q: jax.lax.scan(bd, q, None, length=n)[0])(p0)

    p_ref = single(to_slot_layout(setup.particles, grid, box), grid, cfg, explicit_step,
                   steps)
    n_part = setup.particles.count
    _check_state(p_ref, n_part, "single card")
    log(f"four cards: grid {grid.dims}, {n_part} particles, {steps} steps")

    dec = domain.decompose(grid, box, 4, offs)
    t0 = time.perf_counter()
    run = jax.jit(domain.sharded_explicit_run(domain.make_mesh(4), dec, cfg, steps))
    p_out, diag = run(domain.shard_particles(setup.particles, dec),
                      domain.shard_grid(grid, dec), mats, body)
    p_back = domain.unshard_particles(p_out, dec)
    log(f"S=4 strips: lost={int(diag['lost'])}, {time.perf_counter() - t0:.1f} s with compile")
    if int(diag["lost"]) != 0:
        fail("S=4 run lost particles")
    _check_state(p_back, n_part, "S=4")
    _parity(p_back, p_ref, h, "S=4 strips vs single card")

    dec2 = domain.decompose2(grid, box, (2, 2), offs)
    t0 = time.perf_counter()
    run2 = jax.jit(domain.sharded_explicit_run2(domain.make_mesh2((2, 2)), dec2, cfg, steps))
    p_out, diag = run2(domain.shard_particles2(setup.particles, dec2),
                       domain.shard_grid2(grid, dec2), mats, body)
    p_back = domain.unshard_particles2(p_out, dec2)
    log(f"2x2 blocks: lost={int(diag['lost'])}, {time.perf_counter() - t0:.1f} s with compile")
    if int(diag["lost"]) != 0:
        fail("2x2 run lost particles")
    _check_state(p_back, n_part, "2x2")
    _parity(p_back, p_ref, h, "2x2 blocks vs single card")

    # one sharded implicit step against the single-card step
    gridi, p, mats, hi = build_problem(n_side=n_implicit, ppc=2)
    boxi = windowed.ActiveBox(offset=(n_implicit // 4 - 2,) * 2,
                                     cdims=(n_implicit // 2 + 4,) * 2, capacity=6)
    cfgi = ImplicitConfig(dt=2.0 * hi / cel, shapefun="lme", lme_params=lp,
                          kinds=(M.NEO_HOOKEAN,), transfer="pallas", active_box=boxi,
                          cg_maxiter=60, newton_maxiter=10)
    pi_ref = single(to_slot_layout(p, gridi, boxi), gridi, cfgi, implicit_step, 1)
    deci = domain.decompose(gridi, boxi, 4, offs)
    runi = jax.jit(domain.sharded_implicit_run(domain.make_mesh(4), deci, cfgi, 1))
    p_out, diag = runi(domain.shard_particles(p, deci), domain.shard_grid(gridi, deci),
                       mats, body)
    log(f"sharded implicit step: converged={bool(np.all(np.asarray(diag['converged'])))} "
        f"newton_iters={np.asarray(diag['newton_iters']).tolist()} lost={int(diag['lost'])}")
    if not bool(np.all(np.asarray(diag["converged"]))) or int(diag["lost"]) != 0:
        fail("the sharded implicit step did not converge")
    _parity(domain.unshard_particles(p_out, deci), pi_ref, hi,
            "sharded implicit vs single card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the halo-sharded path on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    dev = device_phase(4 if args.four else 1)
    if args.four:
        four_phase()
    else:
        kernel_phase()
        main_path_phase()
        other_paths_phase()
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
