"""Explicit Newmark predictor-corrector MPM step (single-phase -u).

Completes the reference's intended explicit path
(/root/reference/nl-partsol/src/Formulations/Displacements/U-Verlet.c — note
the force/equilibrium stages are commented out in the reference's current
revision, U-Verlet.c:137-149; this implements the full scheme):

  per step:
    local search + shape functions            (:93)   — one fused evaluation
    lumped mass P2G                           (:166)
    particle predictor  Δu_p = Δt·v + Δt²/2·a;  v += (1−γ)Δt·a   (:229)
    P2G displacement increment (mass-weighted) + diagonal solve  (:301)
    Dirichlet on nodal increments             (:458)
    ΔF → F_{n+1} → J → stress                 (:530)
    internal + traction forces                (:703,805)
    lumped equilibrium  a_A = b + f_A/m_A, reactions on fixed dofs (:906)
    G2P accel/displacement + corrector  v += γΔt·a, x += Δu  (:1024)

Transfers run through ops/transfer.py: 'windowed' (scatter-free slot
layout) or 'scatter' (general fallback); 'pallas' runs the fused LME
transfers of ops/pallas_transfer.py.
One jitted pure function: Particles × nodal inputs → Particles.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..models import dispatch as con
from ..models import fracture
from ..models.materials import MaterialTable
from ..ops import transfer, windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, fem, lme
from ..types import Grid, Particles
from . import kinematics as kin


@struct.dataclass
class ExplicitConfig:
    dt: float = struct.field(pytree_node=False)
    gamma: float = struct.field(pytree_node=False, default=0.5)
    shapefun: str = struct.field(pytree_node=False, default="lme")
    lme_params: lme.LMEParams = struct.field(
        pytree_node=False, default_factory=lme.LMEParams
    )
    alme_params: "alme.ALMEParams" = struct.field(pytree_node=False, default=None)
    kinds: tuple = struct.field(pytree_node=False, default=(3,))  # NEO_HOOKEAN
    mass_tol: float = struct.field(pytree_node=False, default=1e-12)
    # transfer backend: 'windowed' (needs active_box) or 'scatter'
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    # nonlocal fracture driver: None | 'eigenerosion' | 'eigensoftening'
    # (requires windowed transfer — Beps sums run on the slot layout)
    damage: str = struct.field(pytree_node=False, default=None)
    beps_reach: int = struct.field(pytree_node=False, default=1)
    # F-bar volumetric-locking control (windowed only: the cell is the patch)
    fbar: bool = struct.field(pytree_node=False, default=False)
    # shard_map axis over which particles are sharded (grid replicated);
    # None = single device
    axis_name: str = struct.field(pytree_node=False, default=None)
    # pallas transfer: re-bin particles to cells every k-th step only.  The
    # kernel window widens by a 1-cell drift margin, so correctness needs
    # max drift ≤ 1 cell between re-binnings: rebin_every ≤ 1/CFL.  Kills
    # the per-step argsort+permute.
    rebin_every: int = struct.field(pytree_node=False, default=1)
    # pallas rebin mode:
    #   'local'  — end-of-step neighbour compaction (windowed.local_rebin,
    #       sort-free); with rebin_every = k > 1 the compaction fires every
    #       k-th step and margin-1 kernels tolerate the ≤ 1 cell of drift
    #       (requires particle speed ≤ c/(k·CFL); violations are counted
    #       loudly in the 'lost' diagnostic)
    #   'global' — argsort binning at step start (required with tractions)
    #   'none'   — no in-step rebin at all: an external owner restores the
    #       slot invariant (the halo-sharded drivers re-bin via
    #       parallel/domain.migrate_local after each step)
    rebin_mode: str = struct.field(pytree_node=False, default="local")
    # block-partitioned grid strip (parallel/domain.HaloSpec); grid and
    # active_box are then the LOCAL templates and transfers halo-exchange
    halo: object = struct.field(pytree_node=False, default=None)
    # particles already in slot layout (the sharded driver re-bins at the
    # end of each step after migration): skip the step's own binning
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # explicit scheme selector (reference driver-nl-partsol.c:349-379
    # dispatch): 'NPC-FS' (Newmark predictor-corrector, explicit_step),
    # 'FE' (momentum-form forward Euler, integrators.forward_euler_step),
    # 'Generalized-alpha' (integrators.generalized_alpha_step)
    scheme: str = struct.field(pytree_node=False, default="NPC-FS")
    # spectral radius r_b for Generalized-alpha
    # (rb-Generalized-alpha deck key, Read_GramsTime.c:152-155)
    ga_rb: float = struct.field(pytree_node=False, default=0.6)


from .common import found_lost, make_engine, shapefun_eval


def _damage_update(p, grid, cfg, mats, act, cs, J_n1, F_n1):
    """Nonlocal fracture update (Eigenerosion/Eigensoftening).  With
    cfg.halo set, the Beps neighbourhood sums run on slot arrays extended
    by a PARTICLE halo of ``beps_reach`` ghost cell planes per seam
    (parallel/domain.slot_plane_halo) so neighbourhoods crossing shard
    seams are complete (reference Beps.c:15-60 has no such seam — single
    process)."""
    halo = cfg.halo
    if halo is None:
        box = cfg.active_box
        if cfg.damage == "eigenerosion":
            return fracture.eigenerosion(
                grid, box, x=p.x, active=act, damage_n=p.damage, W=cs.W,
                J_n1=J_n1, vol0=p.vol0, stress=cs.tau, stress_zz=cs.tau_zz,
                Ceps=mats.Ceps[p.mat_id], Gf=mats.Gf[p.mat_id],
                reach=cfg.beps_reach,
            )
        if cfg.damage == "eigensoftening":
            return fracture.eigensoftening(
                grid, box, x=p.x, active=act, damage_n=p.damage,
                strain_f_n=p.strain_f, mass=p.mass, F_n1=F_n1, stress=cs.tau,
                stress_zz=cs.tau_zz, ft=mats.ft[p.mat_id],
                heps=mats.heps[p.mat_id], wcrit=mats.wcrit[p.mat_id],
                Ceps=mats.Ceps[p.mat_id], reach=cfg.beps_reach,
            )
        raise ValueError(f"unknown damage driver {cfg.damage}")

    from ..parallel import domain as _dom

    d = p.dim
    n = act.shape[0]
    mid = p.mat_id
    arrs = dict(
        x=p.x,
        active=act.astype(p.x.dtype),
        damage=p.damage,
        strain_f=p.strain_f,
        vol0=p.vol0,
        mass=p.mass,
        W=cs.W,
        J=J_n1,
        stress=cs.tau.reshape(n, d * d),
        stress_zz=cs.tau_zz,
        F=F_n1.reshape(n, d * d),
        Ceps=mats.Ceps[mid],
        Gf=mats.Gf[mid],
        ft=mats.ft[mid],
        heps=mats.heps[mid],
        wcrit=mats.wcrit[mid],
    )
    ext, ext_box = _dom.slot_plane_halo(
        arrs, halo, cfg.active_box, cfg.beps_reach, grid.spacing
    )
    ne = ext["x"].shape[0]
    eact = ext["active"] > 0.5
    if cfg.damage == "eigenerosion":
        dout = fracture.eigenerosion(
            grid, ext_box, x=ext["x"], active=eact, damage_n=ext["damage"],
            W=ext["W"], J_n1=ext["J"], vol0=ext["vol0"],
            stress=ext["stress"].reshape(ne, d, d), stress_zz=ext["stress_zz"],
            Ceps=ext["Ceps"], Gf=ext["Gf"], reach=cfg.beps_reach,
        )
    elif cfg.damage == "eigensoftening":
        dout = fracture.eigensoftening(
            grid, ext_box, x=ext["x"], active=eact, damage_n=ext["damage"],
            strain_f_n=ext["strain_f"], mass=ext["mass"],
            F_n1=ext["F"].reshape(ne, d, d),
            stress=ext["stress"].reshape(ne, d, d), stress_zz=ext["stress_zz"],
            ft=ext["ft"], heps=ext["heps"], wcrit=ext["wcrit"],
            Ceps=ext["Ceps"], reach=cfg.beps_reach,
        )
    else:
        raise ValueError(f"unknown damage driver {cfg.damage}")
    return fracture.DamageOut(
        damage=_dom.slot_plane_restrict(
            dout.damage, halo, cfg.active_box, cfg.beps_reach
        ),
        strain_f=_dom.slot_plane_restrict(
            dout.strain_f, halo, cfg.active_box, cfg.beps_reach
        ),
    )



def explicit_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: jax.Array,  # (d,) gravity/body acceleration this step
    traction: Optional[jax.Array] = None,  # (Np, d) nominal traction t̄
    traction_area: Optional[jax.Array] = None,  # (Np,) reference area A0_p
    rebin: Optional[jax.Array] = None,  # traced bool: re-bin this step
):
    """One explicit step.  Returns (particles_{n+1}, diagnostics)."""
    if cfg.transfer == "pallas":
        return _explicit_step_pallas(
            p, grid, mats, cfg, body_accel, traction, traction_area, rebin
        )
    dt = cfg.dt
    gamma = cfg.gamma
    n_nodes = grid.n_nodes

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer in ("windowed", "binned") and not cfg.prebinned:
        # binned: the same slot machinery over the node-bin pseudo-grid
        # (ops/binpair.py); particles re-bin by support-radius bin per step
        if cfg.transfer == "windowed":
            bgrid = grid
        else:
            from ..shapefun import femesh as femesh_mod

            bgrid = femesh_mod.bin_grid(grid)
        binning = windowed.bin_particles(bgrid, cfg.active_box, p.x, p.active)
        if traction is not None:
            idx = jnp.minimum(binning.slot_particle, traction.shape[0] - 1)
            traction = jnp.where(binning.valid[:, None], traction[idx], 0.0)
            traction_area = jnp.where(binning.valid, traction_area[idx], 0.0)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost

    act = p.active

    # --- shape functions (fused local search + N + ∇N) ---
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    # --- lumped mass ---
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]

    # --- particle predictor ---
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a

    # --- P2G displacement increment, mass-weighted recovery ---
    mom = (N * p.mass[:, None])[..., None] * d_dis_p[:, None, :]  # (Np,K,d)
    d_dis_nodes = eng.p2g(mom) / m_safe

    # --- Dirichlet on nodal increments ---
    if grid.dirichlet_mask is not None:
        d_dis_nodes = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, d_dis_nodes)

    # --- local compatibility: ΔF, F_{n+1}, J ---
    du_edges = eng.edge_gather(d_dis_nodes)
    DF = kin.incremental_deformation_gradient(du_edges, dN)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)  # negative-J clamp (U-Newmark-beta.c:1137)
    d = p.dim
    if cfg.fbar:
        # F-bar patches: on the slot layout the natural patch is the cell
        # (the reference uses quadratic-mesh element patches,
        # __local_compatibility_conditions, U-Newmark-beta.c:1146-1195)
        if cfg.transfer != "windowed":
            raise ValueError("fbar requires windowed transfer")
        J_patch = kin.cell_patch_jacobian(
            cfg.active_box, p.J, J_n1, p.vol0, act
        )
        alpha_fb = mats.alpha_fbar[p.mat_id]
        F_n1 = kin.fbar_deformation_gradient(F_n1, J_n1, J_patch * p.J, alpha_fb)
        J_n1 = tn.det(F_n1)
        J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)
        DF = tn.bmm(F_n1, tn.inv(jnp.where((p.J > 0)[:, None, None], p.F, jnp.eye(d, dtype=F_n1.dtype))))
    dt_DF = (DF - jnp.eye(d, dtype=DF.dtype)) / dt
    dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)

    # --- constitutive update ---
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=DF,
        dFdt_n1=dFdt_n1,
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=cfg.kinds,
    )
    # --- nonlocal damage (EigenErosion.c / EigenSoftening.c; scales the
    # stress entering the internal forces with (1 − d_{n+1}), reference
    # __nodal_internal_forces, U-Newmark-beta.c:1319-1333) ---
    damage_n1 = p.damage
    strain_f_n1 = p.strain_f
    if cfg.damage is not None:
        if cfg.transfer != "windowed":
            raise ValueError("fracture drivers require windowed transfer")
        dout = _damage_update(p, grid, cfg, mats, act, cs, J_n1, F_n1)
        damage_n1 = dout.damage
        strain_f_n1 = dout.strain_f
    tau_eff = cs.tau * (1.0 - damage_n1)[:, None, None]

    # --- internal forces: f_A = −Σ_p V0 τ ∇N^{n+1}  ---
    dN1 = kin.push_forward_dN(dN, DF)
    f_int_contrib = -jnp.einsum("pij,pkj->pki", tau_eff * p.vol0[:, None, None], dN1)
    forces = eng.p2g(f_int_contrib)

    # --- traction (Neumann) forces: f_A += Σ_p N A0 t̄ ---
    if traction is not None:
        tr = (N * traction_area[:, None])[..., None] * traction[:, None, :]
        forces = forces + eng.p2g(tr)

    # --- lumped equilibrium + reactions ---
    accel_nodes = body_accel[None, :] + forces / m_safe
    if grid.dirichlet_mask is not None:
        reactions = jnp.where(grid.dirichlet_mask, forces, 0.0)
        accel_nodes = jnp.where(grid.dirichlet_mask, 0.0, accel_nodes)
    else:
        reactions = jnp.zeros_like(forces)

    # --- G2P + corrector ---
    a_p = eng.g2p(N, accel_nodes)
    d_dis_p_smooth = eng.g2p(N, d_dis_nodes)
    v_new = v_pred + gamma * dt * a_p
    x_new = p.x + d_dis_p_smooth

    rho_new = p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12))

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, x_new, p.x),
        v=jnp.where(sel, v_new, p.v),
        a=jnp.where(sel, a_p, p.a),
        dis=p.dis + jnp.where(sel, d_dis_p_smooth, 0.0),
        rho=rho_new,
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        damage=damage_n1,
        strain_f=strain_f_n1,
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
        lme_beta=(
            alme.update_beta(p.lme_beta, DF) if cfg.shapefun == "alme" else p.lme_beta
        ),
    )
    nnz = count_nnz(mask)
    ke = 0.5 * jnp.sum(p.mass[:, None] * v_new * v_new, where=act[:, None])
    se = jnp.sum(cs.W * p.vol0, where=act)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        ke = jax.lax.psum(ke, cfg.axis_name)
        se = jax.lax.psum(se, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag = dict(
        nnz=nnz,
        reactions=reactions,
        kinetic_energy=ke,
        strain_energy=se,
        lost=lost,
    )
    return p_out, diag


def _explicit_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    body_accel: jax.Array,
    traction: Optional[jax.Array] = None,
    traction_area: Optional[jax.Array] = None,
    rebin: Optional[jax.Array] = None,
):
    """Fused-transfer variant of the explicit step (LME; the Triton
    kernels on a GPU in 2D, their XLA reference otherwise).  Physics identical to the windowed path; the particle↔grid
    transfers run through ops/pallas_transfer.py so no (Ns, K, ·) edge
    tensor ever hits HBM."""
    from ..ops import pallas_transfer as pt

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    box = cfg.active_box
    dt, gamma, d = cfg.dt, cfg.gamma, p.dim
    C, nc = box.capacity, box.n_cells
    halo = cfg.halo
    if halo is not None:
        # block-partitioned local strip (parallel/domain.py): kernels run on
        # the local box; scatters complete owned planes via ppermute halo
        # adds, gathers fill ghost planes first; phantom planes beyond the
        # global grid are masked per-device via grid.valid_lo/valid_hi
        from ..parallel import domain as _dom

        if cfg.rebin_mode != "none":
            raise ValueError(
                "halo-sharded pallas steps rebin via domain.migrate_local "
                "after the step: use rebin_mode='none'"
            )

        def _xadd(nodesv):
            return _dom.halo_exchange_add(nodesv, halo)

        def _fill(nodesv):
            return _dom.halo_fill(nodesv, halo)

    else:
        _xadd = _fill = lambda nodesv: nodesv
    vkw = dict(valid_lo=grid.valid_lo, valid_hi=grid.valid_hi)
    local_mode = cfg.rebin_mode == "local" and traction is None
    if cfg.rebin_mode == "none":
        # slot invariant restored externally (sharded migration); with
        # rebin_every = k > 1 the external migration fires every k-th step
        # only, so the kernels carry the same 1-cell drift margin as the
        # single-chip amortised path (the sharded halo is widened to match:
        # parallel/domain.decompose(margin=1))
        margin = 0 if cfg.rebin_every == 1 else 1
        lost = jnp.zeros((), jnp.int32)
        local_mode = False
    elif local_mode:
        # particles arrive on the slot invariant (binned to their cells by
        # to_slot_layout / the last end-of-step local_rebin).  With
        # rebin_every == 1 the kernel window needs no drift margin and the
        # neighbour compaction (windowed.local_rebin) runs every step; with
        # rebin_every = k > 1 a 1-cell margin widens the window and the
        # compaction fires only on rebin steps (k·CFL ≤ 1 keeps drift ≤ 1
        # cell between firings) — amortising the re-bin's permute/layout
        # cost.
        margin = 0 if cfg.rebin_every == 1 else 1
        lost = jnp.zeros((), jnp.int32)
    elif cfg.rebin_every > 1 and rebin is not None:
        margin = 1
        if traction is not None:
            raise ValueError("tractions require rebin_every=1")

        def _do_rebin(pp):
            b = windowed.bin_particles(grid, box, pp.x, pp.active)
            return windowed.permute_to_slots(pp, b), b.lost

        p, lost = jax.lax.cond(
            rebin, _do_rebin, lambda pp: (pp, jnp.zeros((), jnp.int32)), p
        )
    else:
        margin = 0 if cfg.rebin_every == 1 else 1
        binning = windowed.bin_particles(grid, box, p.x, p.active)
        if traction is not None:
            idx = jnp.minimum(binning.slot_particle, traction.shape[0] - 1)
            traction = jnp.where(binning.valid[:, None], traction[idx], 0.0)
            traction_area = jnp.where(binning.valid, traction_area[idx], 0.0)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost
    act = p.active

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    # --- scatter #1 (solves λ): lumped mass + momentum increment [+ traction]
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a
    chans = [p.mass] + [p.mass * d_dis_p[:, i] for i in range(d)]
    if traction is not None:
        chans += [traction_area * traction[:, i] for i in range(d)]
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0] for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        margin=margin, **vkw,
    )
    nodes1 = _xadd(nodes1)
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    d_dis_nodes = nodes1[:, 1 : 1 + d] / m_safe
    traction_forces = nodes1[:, 1 + d : 1 + 2 * d] if traction is not None else None

    if grid.dirichlet_mask is not None:
        d_dis_nodes = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, d_dis_nodes)

    # --- gather #1: smoothed Δu + displacement gradient (→ ΔF) ---
    d_dis_nodes_f = _fill(d_dis_nodes)
    d_dis_smooth, grad_du = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_new, act_t,
        gN=d_dis_nodes_f, g_grad=d_dis_nodes_f, margin=margin, **vkw,
    )
    DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)
    if cfg.fbar:
        J_patch = kin.cell_patch_jacobian(box, p.J, J_n1, p.vol0, act)
        alpha_fb = mats.alpha_fbar[p.mat_id]
        F_n1 = kin.fbar_deformation_gradient(F_n1, J_n1, J_patch * p.J, alpha_fb)
        J_n1 = tn.det(F_n1)
        J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)
        DF = tn.bmm(F_n1, tn.inv(
            jnp.where((p.J > 0)[:, None, None], p.F, jnp.eye(d, dtype=F_n1.dtype))
        ))
    dt_DF = (DF - jnp.eye(d, dtype=DF.dtype)) / dt
    dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)

    cs = con.stress_integration(
        F_n1=F_n1,
        DF=DF,
        dFdt_n1=dFdt_n1,
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=cfg.kinds,
    )
    damage_n1 = p.damage
    strain_f_n1 = p.strain_f
    if cfg.damage is not None:
        dout = _damage_update(p, grid, cfg, mats, act, cs, J_n1, F_n1)
        damage_n1 = dout.damage
        strain_f_n1 = dout.strain_f
    tau_eff = cs.tau * (1.0 - damage_n1)[:, None, None]

    # --- scatter #2: internal forces f_A = −Σ V0·τ·∇N¹ = Σ G·∇N with
    # G = −V0·τ_eff·DF⁻ᵀ (push-forward folded into the matrix) ---
    G = -tn.bmm(tau_eff * p.vol0[:, None, None], tn.inv_transpose(DF))
    G_t = pt.to_channel_leading(G.reshape(-1, d * d), C, nc)
    dummy = pt.to_channel_leading(jnp.zeros_like(p.mass), C, nc)
    nodes2, _, _ = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_new, act_t, dummy, G_t=G_t,
        solve=False, margin=margin, **vkw,
    )
    nodes2 = _xadd(nodes2)
    forces = nodes2[:, 1 : 1 + d]
    if traction_forces is not None:
        forces = forces + traction_forces

    accel_nodes = body_accel[None, :] + forces / m_safe
    if grid.dirichlet_mask is not None:
        reactions = jnp.where(grid.dirichlet_mask, forces, 0.0)
        accel_nodes = jnp.where(grid.dirichlet_mask, 0.0, accel_nodes)
    else:
        reactions = jnp.zeros_like(forces)

    # --- gather #2: accelerations ---
    a_p, _ = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_new, act_t, gN=_fill(accel_nodes),
        margin=margin, **vkw,
    )
    v_new = v_pred + gamma * dt * a_p
    x_new = p.x + d_dis_smooth
    rho_new = p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12))

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, x_new, p.x),
        v=jnp.where(sel, v_new, p.v),
        a=jnp.where(sel, a_p, p.a),
        dis=p.dis + jnp.where(sel, d_dis_smooth, 0.0),
        rho=rho_new,
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        damage=damage_n1,
        strain_f=strain_f_n1,
        lme_lambda=pt.from_channel_leading(lam_new),
    )
    ke = 0.5 * jnp.sum(p.mass[:, None] * v_new * v_new, where=act[:, None])
    se = jnp.sum(cs.W * p.vol0, where=act)
    if local_mode:
        # restore the slot invariant (no sort, no gather); with
        # rebin_every = k > 1 only every k-th step pays the re-bin (the
        # margin-widened kernels tolerate ≤ 1 cell of drift in between).
        # A static Python-bool ``rebin`` selects at trace time (the nested
        # k-periodic scan of run()/bench.py — no lax.cond, whose untaken
        # branch copies the whole carry); a traced flag falls back to cond.
        if isinstance(rebin, bool):
            if rebin:
                p_out, lost = windowed.local_rebin(p_out, grid, box)
        elif cfg.rebin_every > 1 and rebin is not None:
            p_out, lost = jax.lax.cond(
                rebin,
                lambda q: windowed.local_rebin(q, grid, box),
                lambda q: (q, jnp.zeros((), jnp.int32)),
                p_out,
            )
        else:
            p_out, lost = windowed.local_rebin(p_out, grid, box)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        ke = jax.lax.psum(ke, cfg.axis_name)
        se = jax.lax.psum(se, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag = dict(
        nnz=nnz,
        reactions=reactions,
        kinetic_energy=ke,
        strain_energy=se,
        lost=lost,
    )
    return p_out, diag


def to_slot_layout(
    p: Particles, grid: Grid, box: windowed.ActiveBox, allow_lost: bool = False
) -> Particles:
    """Convert an arbitrary particle set to windowed slot layout (do once
    before a windowed run so the scan carry shape is invariant).

    Raises when active particles do not fit the box (outside its cell range
    or overflowing ``capacity``) unless ``allow_lost=True`` — silent mass
    loss is never the default (a compacting granular run can exceed the
    seeded per-cell density; size capacity with ``windowed.required_capacity``
    or ``windowed.default_box``)."""
    binning = windowed.bin_particles(grid, box, p.x, p.active)
    if isinstance(binning.lost, jax.core.Tracer):
        return windowed.permute_to_slots(p, binning)  # under jit: no host check
    lost = int(jax.device_get(binning.lost))
    if lost > 0 and not allow_lost:
        need = windowed.required_capacity(grid, box, p.x, p.active)
        raise ValueError(
            f"to_slot_layout: {lost} active particles dropped by the ActiveBox "
            f"(cdims={box.cdims}, offset={box.offset}, capacity={box.capacity}; "
            f"this configuration needs capacity >= {need} or a larger box). "
            f"Pass allow_lost=True only if dropping is intended."
        )
    return windowed.permute_to_slots(p, binning)


def run(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ExplicitConfig,
    n_steps: int,
    body_accel=None,
):
    """Time loop under lax.scan (whole trajectory jitted)."""
    d = p.dim
    if body_accel is None:
        body_accel = jnp.zeros((d,), p.x.dtype)
    if cfg.transfer in ("windowed", "pallas"):
        p = to_slot_layout(p, grid, cfg.active_box)
    elif cfg.transfer == "binned":
        from ..shapefun import femesh as femesh_mod

        p = to_slot_layout(p, femesh_mod.bin_grid(grid), cfg.active_box)

    def body(carry, i):
        pp = carry
        rebin = (i % cfg.rebin_every) == 0 if cfg.rebin_every > 1 else None
        pp, diag = explicit_step(pp, grid, mats, cfg, body_accel, rebin=rebin)
        return pp, (diag["kinetic_energy"], diag["strain_energy"], diag["nnz"])

    k = cfg.rebin_every
    if (
        cfg.transfer == "pallas"
        and cfg.rebin_mode == "local"
        and k > 1
        and n_steps % k == 0
    ):
        # k-periodic nested scan with STATIC rebin flags: k−1 plain steps +
        # one rebin step per outer iteration — no lax.cond (whose untaken
        # branch copies the full carry every step)
        def inner(pp, _):
            pp, diag = explicit_step(
                pp, grid, mats, cfg, body_accel, rebin=False
            )
            return pp, (diag["kinetic_energy"], diag["strain_energy"], diag["nnz"])

        def outer(pp, _):
            pp, d1 = jax.lax.scan(inner, pp, None, length=k - 1)
            pp, diag = explicit_step(
                pp, grid, mats, cfg, body_accel, rebin=True
            )
            d2 = (diag["kinetic_energy"], diag["strain_energy"], diag["nnz"])
            out = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b[None]]), d1, d2
            )
            return pp, out

        p_final, (ke, se, nnz) = jax.lax.scan(
            outer, p, None, length=n_steps // k
        )
        return p_final, dict(
            kinetic_energy=ke.reshape(-1),
            strain_energy=se.reshape(-1),
            nnz=nnz.reshape(-1),
        )

    p_final, (ke, se, nnz) = jax.lax.scan(
        body, p, jnp.arange(n_steps), length=n_steps
    )
    return p_final, dict(kinetic_energy=ke, strain_energy=se, nnz=nnz)
