"""Simulation driver: runs a SimulationSetup end-to-end with outputs.

The analog of the reference's per-scheme driver functions dispatched from
main (driver-nl-partsol.c:349-379): owns the time loop, feeds per-step curve
values (Dirichlet/gravity/tractions) into the jitted step, and writes
VTK/CSV results every ``out_every`` steps.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from . import config
from .formulations.courant import courant_dt
from .formulations.explicit import ExplicitConfig, explicit_step, to_slot_layout
from .formulations.implicit import ImplicitConfig, implicit_step
from .io.builder import SimulationSetup
from .io import vtk
from .ops import windowed
from .shapefun import lme as lme_mod

EXPLICIT_SCHEMES = {"NPC-FS", "Verlet"}
# momentum-form forward Euler and Generalized-alpha run through the same
# slot-layout engines but their own step functions
# (U-Forward-Euler.c:19, U-Generalized-Alpha.c:18; dispatched from
# driver-nl-partsol.c:349-379)
FE_SCHEMES = {"FE", "Forward-Euler"}
GA_SCHEMES = {"Generalized-alpha"}
IMPLICIT_SCHEMES = {"Newmark-beta-Finite-Strains", "Newmark-beta"}
STATIC_SCHEMES = {"Static"}
DEM_SCHEMES = {"Discrete-Energy-Momentum"}


def make_step_config(setup: SimulationSetup, transfer: str = "scatter", active_box=None, dt=None):
    sp = setup.solver
    from .shapefun.femesh import FEMesh

    if isinstance(setup.grid, FEMesh):
        transfer = "scatter"  # no slot layout on unstructured meshes
    if transfer == "auto":
        # the fused LME transfers whenever the step is eligible (the check
        # below takes the XLA windowed engine otherwise); choosing by
        # measurement per platform is an open item (ROADMAP.md)
        transfer = "pallas"
    if dt is None:
        if sp.cel <= 0:
            raise ValueError("solver Cel (celerity) required to compute dt")
        dt = courant_dt(sp.cfl, setup.grid.spacing, sp.cel)
    shp_kw = {}
    if setup.shapefun == "lme":
        shp_kw["lme_params"] = lme_mod.LMEParams(**setup.shapefun_params)
    formulation_ = getattr(setup, "formulation", "u")
    _pallas_formulations = (
        # -u: explicit + implicit + static + DEM; -upw: explicit + implicit
        # two-phase; -up: implicit/static mixed
        formulation_ == "u"
        and setup.solver.scheme
        in (EXPLICIT_SCHEMES | IMPLICIT_SCHEMES | STATIC_SCHEMES | DEM_SCHEMES)
    ) or (
        formulation_ == "upw"
        and setup.solver.scheme in EXPLICIT_SCHEMES | IMPLICIT_SCHEMES
    ) or (
        formulation_ == "up"
        and setup.solver.scheme in IMPLICIT_SCHEMES | STATIC_SCHEMES
    )
    if transfer == "pallas" and (
        not _pallas_formulations
        or setup.shapefun != "lme"
        or setup.grid.dim not in (2, 3)
        # the fused kernels implement the plain Newton λ-solve only; the
        # Nelder-Mead guarded wrapper routes to the XLA windowed engine
        or str(setup.shapefun_params.get("wrapper", "Newton-Raphson"))
        .lower().replace("_", "-") == "nelder-mead"
    ):
        # fused kernels cover the explicit+implicit 2D/3D LME -u paths and
        # the explicit two-phase (-upw) path; others take the XLA windowed
        # engine (same slot layout, same physics)
        transfer = "windowed"
    common = dict(
        dt=dt,
        shapefun=setup.shapefun,
        kinds=setup.kinds,
        transfer=transfer,
        active_box=active_box,
        **shp_kw,
    )
    formulation = getattr(setup, "formulation", "u")
    # --- nonlocal fracture activation (--Fracture-Modulus /
    # Fracture-Modulus= deck key; reference driver-nl-partsol.c:133-143) ---
    damage_kw = {}
    fracture_ = getattr(setup, "fracture", None)
    if fracture_ is not None:
        from .models import fracture as frac_mod

        if formulation_ != "u":
            raise ValueError(
                "Fracture-Modulus is wired into the displacement (-u) "
                "formulations only (as in the reference: Driver_EigenErosion "
                "hooks live in the U-* drivers)"
            )
        if setup.solver.scheme in DEM_SCHEMES:
            raise ValueError(
                "Discrete-Energy-Momentum has no fracture hooks; use the "
                "explicit or Newmark-beta schemes"
            )
        if setup.solver.scheme in FE_SCHEMES | GA_SCHEMES:
            raise ValueError(
                "Forward-Euler / Generalized-alpha have no fracture hooks "
                "(the reference wires Driver_EigenErosion into the NPC-FS "
                "and Newmark-beta drivers only); use those schemes"
            )
        if transfer == "scatter":
            raise ValueError(
                "fracture drivers need the slot-layout Beps sums: use "
                "transfer='windowed' or 'pallas' on a structured grid"
            )
        ceps_max = float(np.max(np.asarray(setup.materials.Ceps)))
        if ceps_max <= 0:
            raise ValueError(
                "Fracture-Modulus active but no material defines Ceps > 0 "
                "(the Beps neighbourhood radius is Ceps*DeltaX, Beps.c:15-60)"
            )
        damage_kw = dict(
            damage=fracture_, beps_reach=frac_mod.beps_reach(ceps_max)
        )
    common.update(damage_kw)
    if formulation in ("up", "upw") and sp.scheme in FE_SCHEMES | GA_SCHEMES:
        raise ValueError(
            f"scheme {sp.scheme!r} is a single-phase (-u) integrator; the "
            "mixture formulations support the explicit Verlet and "
            "Newmark-beta schemes only (driver-nl-partsol.c:426-492)"
        )
    if formulation == "up":
        from .formulations.up import UpConfig

        return UpConfig(
            beta=sp.beta,
            gamma=sp.gamma,
            newton_tol=sp.tol,
            newton_maxiter=sp.max_iter,
            quasi_static=sp.scheme in STATIC_SCHEMES,
            **common,
        )
    if formulation == "upw":
        from .formulations.upw import UpwConfig, UpwImplicitConfig

        if sp.scheme in EXPLICIT_SCHEMES:
            return UpwConfig(gamma=sp.gamma, **common)
        return UpwImplicitConfig(
            beta=sp.beta,
            gamma=sp.gamma,
            newton_tol=sp.tol,
            newton_maxiter=sp.max_iter,
            **common,
        )
    if sp.scheme in DEM_SCHEMES:
        from .formulations.dem import DEMConfig

        if setup.neumann:
            raise ValueError(
                "Discrete-Energy-Momentum does not support Neumann traction "
                "loads (dem_step has no traction path); use the Newmark-beta "
                "or explicit schemes"
            )
        return DEMConfig(
            newton_tol=sp.tol,
            newton_maxiter=sp.max_iter,
            **common,
        )
    if sp.scheme in FE_SCHEMES | GA_SCHEMES:
        # forward_euler_step / generalized_alpha_step run through the
        # windowed/scatter engines (no fused-pallas path)
        if transfer == "pallas":
            transfer = "windowed"
        common["transfer"] = transfer
        return ExplicitConfig(
            scheme="FE" if sp.scheme in FE_SCHEMES else "Generalized-alpha",
            ga_rb=sp.rb,
            **common,
        )
    if sp.scheme in EXPLICIT_SCHEMES:
        extra = {}
        if (transfer == "pallas" and not setup.neumann
                and not damage_kw and setup.grid.dim == 2):
            # (fracture keeps rebin_every=1: the Beps cell-offset sweep
            # assumes particles sit in their slot cell — a 1-cell drift
            # would truncate neighbourhoods at the static reach)
            # ADAPTIVE amortised rebin: start from the
            # largest safe period given the CURRENT particle speeds (2x
            # safety margin), and run_simulation shrinks it at chunk
            # boundaries as speeds grow; drift violations between
            # boundaries stay loudly counted (windowed.local_rebin lost).
            # This puts the production default at the k=16 bench
            # configuration for typical MPM speeds instead of a fixed k=4.
            extra["rebin_every"] = safe_rebin_period(
                setup.particles.v, setup.grid.spacing, dt
            )
        return ExplicitConfig(gamma=0.5, **extra, **common)
    if sp.scheme in IMPLICIT_SCHEMES:
        return ImplicitConfig(
            beta=sp.beta,
            gamma=sp.gamma,
            newton_tol=sp.tol,
            newton_maxiter=sp.max_iter,
            **common,
        )
    if sp.scheme in STATIC_SCHEMES:
        return ImplicitConfig(
            quasi_static=True,
            newton_tol=sp.tol,
            newton_maxiter=sp.max_iter,
            **common,
        )
    raise ValueError(f"unknown scheme: {sp.scheme}")


def safe_rebin_period(v, spacing, dt, k_max: int = 16) -> int:
    """Largest POWER-OF-TWO rebin period k such that the fastest particle
    drifts at most half a cell between re-binnings (margin-1 kernels
    tolerate 1 cell; the 2x factor absorbs within-period acceleration).
    Powers of two tile the driver's pow-2 scan chunks exactly, keeping the
    rebin flags static (no lax.cond).  k ∈ [1, k_max]."""
    vmax = float(np.max(np.abs(np.asarray(v)))) if np.size(v) else 0.0
    if vmax * dt <= 0.0:
        k = k_max
    else:
        k = max(1, min(k_max, int(spacing / (2.0 * vmax * dt))))
    return 1 << (k.bit_length() - 1)


def run_simulation(
    setup: SimulationSetup,
    transfer: str = "auto",
    active_box=None,
    write_outputs: bool = True,
    n_steps: Optional[int] = None,
    progress: bool = True,
    check_lost: bool = True,
    profile_dir: Optional[str] = None,
    print_convergence: bool = False,
    backup_every: Optional[int] = None,
    resume: Optional[str] = None,
):
    """Run the configured simulation; returns (particles, history dict).

    ``backup_every``: write a resumable checkpoint snapshot
    (io/checkpoint.py) to ``<out_dir>/backup.npz`` every N steps (overrides
    the deck's ``Out-backup`` key; 0/None = deck value).  ``resume``: path
    to such a snapshot — the run continues the ORIGINAL schedule from the
    saved step (the reference's i0/InitialTimeStep semantics,
    Read_GramsTime.c:140, Types.h:819, with the state actually loaded —
    the reference only ever declared the Backup_* globals, Globals.h:105-109).
    """
    from .shapefun.femesh import FEMesh

    resume_state = None
    if resume:
        from .io.checkpoint import load_checkpoint

        resume_state = load_checkpoint(resume)
        setup.particles = resume_state[0]

    if isinstance(setup.grid, FEMesh):
        # unstructured T3/Q4/T4/H8 background mesh: no cell-window slot
        # layout exists — transfers route through the general ScatterEngine
        transfer = "scatter"
    if transfer == "auto":
        # default: fused kernels when eligible (make_step_config falls back
        # to the windowed engine for ineligible steps)
        transfer = "pallas"
    if transfer in ("windowed", "pallas") and active_box is None:
        # auto-size: full-grid box, capacity = current max per cell × 2
        active_box = windowed.default_box(
            setup.grid, setup.particles.x, setup.particles.active
        )
    cfg = make_step_config(setup, transfer=transfer, active_box=active_box)
    formulation = getattr(setup, "formulation", "u")
    mixtures = getattr(setup, "mixtures", None)
    if formulation == "up":
        from .formulations.up import UpConfig, up_step

        is_implicit = True
        step = jax.jit(up_step, static_argnums=(3,))
    elif formulation == "upw":
        from .formulations.upw import UpwImplicitConfig, upw_newmark_step, upw_step

        is_implicit = isinstance(cfg, UpwImplicitConfig)
        fn = upw_newmark_step if is_implicit else upw_step
        two_phase = jax.jit(fn, static_argnums=(4,))

        def step(p, g, mats, cfg, body, traction=None, t_area=None):
            return two_phase(p, g, mats, mixtures, cfg, body)

    else:
        from .formulations.dem import DEMConfig, dem_step

        if isinstance(cfg, DEMConfig):
            is_implicit = True
            dem_jit = jax.jit(dem_step, static_argnums=(3,))

            def step(pp, g, mats_, cfg_, body, traction=None, t_area=None):
                return dem_jit(pp, g, mats_, cfg_, body)

        elif isinstance(cfg, ExplicitConfig) and cfg.scheme in FE_SCHEMES:
            from .formulations.integrators import forward_euler_step

            is_implicit = False
            step = jax.jit(forward_euler_step, static_argnums=(3,))
        elif isinstance(cfg, ExplicitConfig) and cfg.scheme in GA_SCHEMES:
            from .formulations.integrators import generalized_alpha_step

            is_implicit = False
            ga_jit = jax.jit(generalized_alpha_step, static_argnums=(3, 5))

            def step(pp, g, mats_, cfg_, body, traction=None, t_area=None):
                return ga_jit(pp, g, mats_, cfg_, body, cfg_.ga_rb, traction, t_area)

        else:
            is_implicit = isinstance(cfg, ImplicitConfig)
            step_fn = implicit_step if is_implicit else explicit_step
            step = jax.jit(step_fn, static_argnums=(3,))

    grid = setup.grid
    p = setup.particles
    if transfer in ("windowed", "pallas"):
        p = to_slot_layout(p, grid, active_box, allow_lost=not check_lost)
    if setup.shapefun == "gimp":
        # uGIMP window halfwidth 2 assumes l_p ≤ h (gimp.py:27)
        from .shapefun import gimp as gimp_mod

        lp_max = float(np.max(np.asarray(gimp_mod.voxel_halfwidth(p.vol0, p.dim))))
        if lp_max > grid.spacing:
            raise ValueError(
                f"uGIMP voxel half-width l_p={lp_max:.3g} exceeds grid "
                f"spacing h={grid.spacing:.3g}; the 2-cell support window "
                f"would truncate. Refine particles or coarsen the grid."
            )
    mats = setup.materials
    n = setup.solver.n_steps if n_steps is None else n_steps
    d = p.dim
    n_nodes = grid.n_nodes
    dt = cfg.dt

    # precompute per-step nodal Dirichlet values and traction tables (host)
    have_dirichlet = len(setup.dirichlet_nodes) > 0
    have_traction = len(setup.neumann) > 0
    area0 = None
    if have_traction:
        # reference: A0 = V0 / thickness in 2D (U-Newmark-beta.c:1440-1444)
        area0_np = np.zeros(setup.particles.count, np.float64)
        base_vol = np.asarray(setup.particles.vol0)
        for ids, comp, curve in setup.neumann:
            area0_np[ids] = base_vol[ids] if d == 3 else base_vol[ids] / 1.0
        area0 = jnp.asarray(area0_np, config.dtype())

    # ---- on-device time loop ----
    # The loop runs as lax.scan chunks between output events: per-step curve
    # values are computed ON DEVICE from compact (group-mask, curve-table)
    # pairs, so there is no per-step host sync or table upload — the only
    # host round-trips are at chunk boundaries (VTK/CSV emission, loud
    # particle-loss check, progress print).
    history = {"t": [], "kinetic_energy": [], "strain_energy": [], "newton_iters": []}
    os.makedirs(setup.out_dir, exist_ok=True)

    n_curve_max = 1
    d_masks = d_curves = None
    if have_dirichlet:
        d_masks = np.zeros((len(setup.dirichlet_nodes), n_nodes, d), np.float32)
        cl = max(len(c) for _, _, c in setup.dirichlet_nodes)
        d_curves = np.zeros((len(setup.dirichlet_nodes), cl))
        for gidx, (ids, comp, curve) in enumerate(setup.dirichlet_nodes):
            d_masks[gidx, ids, comp] = 1.0
            d_curves[gidx, : len(curve)] = curve
            d_curves[gidx, len(curve):] = curve[-1]
        d_masks = jnp.asarray(d_masks, config.dtype())
        d_curves = jnp.asarray(d_curves, config.dtype())
        n_curve_max = max(n_curve_max, cl)
    t_masks = t_curves = None
    if have_traction:
        t_masks = np.zeros((len(setup.neumann), setup.particles.count, d), np.float32)
        cl = max(len(c) for _, _, c in setup.neumann)
        t_curves = np.zeros((len(setup.neumann), cl))
        for gidx, (ids, comp, curve) in enumerate(setup.neumann):
            t_masks[gidx, ids, comp] = 1.0
            t_curves[gidx, : len(curve)] = curve
            t_curves[gidx, len(curve):] = curve[-1]
        t_masks = jnp.asarray(t_masks, config.dtype())
        t_curves = jnp.asarray(t_curves, config.dtype())
        n_curve_max = max(n_curve_max, cl)
    g_table = None
    if setup.gravity is not None:
        g_table = jnp.asarray(setup.gravity, config.dtype())

    def make_scan(cfg):
      # (re)build the jitted chunk scanner for a given step config — the
      # adaptive rebin period swaps in a smaller rebin_every at chunk
      # boundaries (one re-jit per distinct k, monotonically shrinking)
      def scan_body(carry, i, rebin=None):
        pp, _ = carry
        g = grid
        if have_dirichlet:
            ci = jnp.minimum(i, d_curves.shape[1] - 1)
            dval = jnp.einsum("g,gnd->nd", d_curves[:, ci], d_masks)
            g = grid.replace(dirichlet_value=dval)
        if g_table is not None:
            body = g_table[jnp.minimum(i, g_table.shape[0] - 1)]
        else:
            body = jnp.zeros((d,), config.dtype())
        traction = t_area = None
        if have_traction:
            ci = jnp.minimum(i, t_curves.shape[1] - 1)
            traction = jnp.einsum("g,gpd->pd", t_curves[:, ci], t_masks)
            # t_masks/area0 are in ORIGINAL seeding order; the carry pp is
            # slot-permuted (and re-permuted every windowed step), so map
            # the tables through the stable particle identity pp.pid
            pid = jnp.minimum(pp.pid, traction.shape[0] - 1)
            sel = pp.active[:, None]
            traction = jnp.where(sel, traction[pid], 0.0)
            t_area = jnp.where(pp.active, area0[pid], 0.0)
        step_kw = {}
        if rebin is not None:
            step_kw["rebin"] = rebin
        pp, diag = step(pp, g, mats, cfg, body, traction, t_area, **step_kw)
        out = dict(
            lost=diag.get("lost", jnp.zeros((), jnp.int32)),
            kinetic_energy=diag.get("kinetic_energy", jnp.zeros(())),
            strain_energy=diag.get("strain_energy", jnp.zeros(())),
            newton_iters=diag.get("newton_iters", jnp.zeros((), jnp.int32)),
            newton_residual=diag.get("newton_residual", jnp.zeros(())),
            cg_iters=(
                diag.get("cg_iters")
                if diag.get("cg_iters") is not None
                else jnp.zeros((), jnp.int32)
            ),
            converged=diag.get("converged", jnp.ones((), bool)),
        )
        # nodal-path CSV events: gather reactions at the recorded node ids
        for eidx, ev in enumerate(csv_events):
            if ev["kind"] == "nodes":
                r = diag.get("reactions")
                ids = jnp.asarray(ev["ids"])
                out[f"react_{eidx}"] = (
                    r[ids] if r is not None else jnp.zeros((len(ev["ids"]), d))
                )
        # nodal reactions ride the CARRY (overwritten each step, so only the
        # chunk-final value survives — no (steps, n_nodes, d) stacking); the
        # chunk boundaries align with output events, so this is exactly the
        # reactions field of the emitted step (nodal_results_vtk,
        # WriteVtk.c / U-Verlet.c:1129)
        react = diag.get("reactions")
        if react is None:
            react = jnp.zeros((n_nodes, d), config.dtype())
        return (pp, react), out

      k = int(getattr(cfg, "rebin_every", 1))

      @jax.jit
      def scan_chunk(pp, idx):
        L = idx.shape[0]
        carry0 = (pp, jnp.zeros((n_nodes, d), config.dtype()))
        if k <= 1:
            (pp, react), out = jax.lax.scan(scan_body, carry0, idx)
            return pp, react, out
        # k-periodic NESTED scan with STATIC rebin flags: k−1 plain steps +
        # one rebin step per inner period, rebin on the chunk's LAST step —
        # no lax.cond (whose untaken branch may copy the whole particle
        # carry every step).  The schedule is
        # chunk-RELATIVE: every chunk ends freshly re-binned, so gaps never
        # exceed k regardless of the chunk's global phase.  Chunk lengths
        # are powers of two and k ∈ {2,4,8,16}, so L % k == 0 whenever
        # L ≥ k; short tails run one plain sub-scan + a final rebin step.
        if L % k == 0:
            def inner(c, i):
                return scan_body(c, i, rebin=False)

            def outer(c, ij):
                c, o1 = jax.lax.scan(inner, c, ij[: k - 1])
                c, o2 = scan_body(c, ij[k - 1], rebin=True)
                out = jax.tree_util.tree_map(
                    lambda a, b: jnp.concatenate([a, b[None]]), o1, o2
                )
                return c, out

            (pp, react), out = jax.lax.scan(
                outer, carry0, idx.reshape(L // k, k)
            )
            out = jax.tree_util.tree_map(
                lambda a: a.reshape((L,) + a.shape[2:]), out
            )
            return pp, react, out
        # tail form: only valid when the whole sub-chunk fits inside one
        # rebin period (the single rebin fires on the last step)
        assert L <= k, f"sub-chunk of {L} steps exceeds rebin period {k}"
        c, o1 = jax.lax.scan(
            lambda c, i: scan_body(c, i, rebin=False), carry0, idx[:-1]
        )
        (pp, react), o2 = scan_body(c, idx[-1], rebin=True)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b[None]]), o1, o2
        )
        return pp, react, out

      return scan_chunk

    scan_chunk = make_scan(cfg)

    def consume(i_first, out):
        lost = np.asarray(out["lost"])
        if check_lost and lost.max() > 0:
            i_bad = i_first + int(np.argmax(lost > 0))
            raise RuntimeError(
                f"step {i_bad}: {int(lost.max())} active particles dropped "
                f"by the transfer ActiveBox (overflowed cell capacity or "
                f"left the box). Re-run with a larger box/capacity "
                f"(windowed.required_capacity) or check_lost=False if "
                f"particles legitimately exit the domain."
            )
        for k in range(len(lost)):
            i = i_first + k
            history["t"].append((i + 1) * dt)
            if is_implicit:
                history["newton_iters"].append(int(out["newton_iters"][k]))
                if print_convergence:
                    # reference __monitor (U-Newmark-beta.c:2076-2152):
                    # per-step Newton iteration count, residual norm, reason
                    conv = bool(np.asarray(out["converged"][k]))
                    print(
                        f"  [NR] step {i}: iters="
                        f"{int(out['newton_iters'][k])} "
                        f"ksp={int(out['cg_iters'][k])} "
                        f"|R|={float(out['newton_residual'][k]):.6e} "
                        f"{'CONVERGED' if conv else 'DIVERGED'}",
                        flush=True,
                    )
            history["kinetic_energy"].append(float(out["kinetic_energy"][k]))
            history["strain_energy"].append(float(out["strain_energy"][k]))

    # Event-driven CSV outputs (reference NLPS-Out-*-path-csv.c flow)
    from .io import csv_out

    csv_events = list(getattr(setup, "csv_events", None) or [])
    recorders = []
    for ev in csv_events:
        if ev["kind"] == "particles":
            recorders.append(csv_out.PathRecorder(ev["ids"], ev["fields"]))
        else:
            recorders.append(csv_out.NodeRecorder(ev["ids"]))

    # observability (SURVEY §5.1): coarse per-stage wall timers always on
    # (cheap; summarised in history); full device trace when profile_dir set
    from .utils import profiling

    stages = profiling.StageTimer()
    prof_ctx = (
        profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext()
    )

    t0 = time.time()
    i0 = setup.solver.i0
    i_end = i0 + n
    backup_every = (
        int(getattr(setup, "backup_every", 0) or 0)
        if backup_every is None
        else int(backup_every)
    )
    if resume_state is not None:
        # continue the ORIGINAL schedule from the saved step (i0 semantics)
        step0 = resume_state[1]
        if not (i0 <= step0 <= i_end):
            raise ValueError(
                f"resume checkpoint at step {step0} outside the schedule "
                f"[{i0}, {i_end}] (i0={i0}, N={n})"
            )
        i0 = step0
        n = i_end - i0
        if n == 0:
            if progress:
                print("resume: schedule already complete")
            return p, history
    nnz_total = 0
    # chunk layout: boundaries at every output event (VTK multiples of
    # out_every + each CSV event's i_start/i_step/i_end schedule) so every
    # emission observes the exact post-step state; chunk-size set stays
    # small, so only a handful of distinct scan jits compile
    bounds = {i_end - 1}
    bounds.update(s for s in range(i0, i_end) if s % setup.out_every == 0)
    if backup_every:
        bounds.update(
            s for s in range(i0, i_end) if (s + 1) % backup_every == 0
        )
    for ev in csv_events:
        bounds.update(
            s
            for s in range(max(i0, ev["i_start"]), min(i_end, ev["i_end"] + 1))
            if (s - ev["i_start"]) % ev["i_step"] == 0
        )
    i = i0
    with prof_ctx:
        for b in sorted(bounds):
            if b < i:
                continue
            t_chunk0 = time.time()
            # FIXED-LENGTH sub-chunks {128, k, 1}: jax.lax.scan retraces +
            # recompiles per distinct length, so arbitrary inter-event gaps
            # would each pay a compile.  Restricting sub-chunk
            # lengths to at most three values bounds the compiles for the
            # WHOLE run at three scan programs.
            with stages("step_chunks"):
                j = i
                outs = []
                kk = max(1, int(getattr(cfg, "rebin_every", 1)))
                while j <= b:
                    L = b - j + 1
                    s_len = (128 if (L >= 128 and 128 % kk == 0)
                             else (kk if L >= kk else 1))
                    p, react, out_s = scan_chunk(p, jnp.arange(j, j + s_len))
                    outs.append(out_s)
                    j += s_len
                jax.block_until_ready(outs[-1]["lost"])
                out = (
                    outs[0]
                    if len(outs) == 1
                    else jax.tree_util.tree_map(
                        lambda *xs: np.concatenate([np.asarray(x) for x in xs]),
                        *outs,
                    )
                )
                history.setdefault("chunk_wall_s", []).append(
                    (time.time() - t_chunk0, b - i + 1)
                )
            with stages("host_consume"):
                consume(i, out)
                # adaptive rebin period: shrink k when particle speeds grew
                # past the half-cell-per-period safety bound (the chunk
                # boundary is already a host sync; re-jit only on change)
                if getattr(cfg, "rebin_every", 1) > 1:
                    # floor at 2: dropping to 1 would swap in margin-0
                    # kernels whose windows assume the exact slot
                    # invariant, which in-flight drifted particles violate
                    k_safe = max(2, safe_rebin_period(
                        p.v, setup.grid.spacing, dt, k_max=cfg.rebin_every
                    ))
                    if k_safe < cfg.rebin_every:
                        if progress:
                            print(
                                f"  [rebin] period {cfg.rebin_every} -> "
                                f"{k_safe} (particle speeds grew)",
                                flush=True,
                            )
                        cfg = cfg.replace(rebin_every=k_safe)
                        scan_chunk = make_scan(cfg)
            i = b + 1
            last = b
            if backup_every and (last + 1) % backup_every == 0:
                # periodic resumable snapshot (rolling single file; written
                # independently of write_outputs — it is state persistence,
                # not a result)
                from .io.checkpoint import save_checkpoint

                with stages("backup"):
                    save_checkpoint(
                        os.path.join(setup.out_dir, "backup.npz"), p, last + 1
                    )
            if write_outputs and (last % setup.out_every == 0):
                with stages("vtk_output"):
                    vtk.write_particles_vtk(
                        os.path.join(setup.out_dir, f"particles_{last:06d}.vtk"),
                        p,
                        **(
                            dict(fields=setup.vtk_fields)
                            if getattr(setup, "vtk_fields", None) is not None
                            else {}
                        ),
                    )
                    # nodal mesh + reactions, emitted alongside the particle
                    # cloud as the reference does (WriteVtk.c:53-100;
                    # nodal_results_vtk call, U-Verlet.c:1129); structured
                    # grids only — FEMesh backgrounds have no box layout
                    if hasattr(grid, "dims"):
                        vtk.write_grid_vtk(
                            os.path.join(setup.out_dir, f"nodes_{last:06d}.vtk"),
                            grid,
                            point_data={"REACTIONS": np.asarray(react)},
                        )
            for eidx, (ev, rec) in enumerate(zip(csv_events, recorders)):
                due = (
                    ev["i_start"] <= last <= ev["i_end"]
                    and (last - ev["i_start"]) % ev["i_step"] == 0
                )
                if not due:
                    continue
                with stages("csv_output"):
                    if ev["kind"] == "particles":
                        rec.record((last + 1) * dt, p)
                    else:
                        rec.record(
                            (last + 1) * dt, np.asarray(out[f"react_{eidx}"][-1])
                        )
            if progress:
                print(f"  step {last}/{i_end} t={i * dt:.4e}", flush=True)

    if write_outputs:
        for eidx, (ev, rec) in enumerate(zip(csv_events, recorders)):
            path = os.path.join(
                setup.out_dir, ev["dir"], f"{ev['kind']}_path_{eidx}.csv"
            )
            rec.write(path, dim=d)

    wall = time.time() - t0
    history["rebin_every"] = int(getattr(cfg, "rebin_every", 1))
    history["stage_timings"] = stages.summary()
    history["wall_s"] = wall
    history["steps_per_s"] = n / max(wall, 1e-12)
    if progress:
        print(f"done: {n} steps in {wall:.1f}s")
        print(stages.report())
    return p, history
