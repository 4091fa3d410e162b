"""Soil-water mixture formulation (-upw): explicit two-phase driver.

Re-designs /root/reference/nl-partsol/src/Formulations/
Displacements-WaterPressure/U-pw-Verlet.c as one jitted step:

  Δt (Coussy mixture celerity)                 (Courant.c:60)
  lumped mixture mass  m_A = Σ m_p N           (:160-252)
  lumped fluid compressibility C_A = Σ (J·φ_f·ρ_f/K_f)·V0·N   (:253-370)
  predictor: Δu_p, v_p, and p_w += (1−γ)Δt·ṗ_w (:371-407)
  P2G of Δu, v, p_w (÷ lumped matrices)        (:408-700)
  Dirichlet on v and p_w                       (:710-780)
  local state: ΔF → F → J, Cauchy p_w = θ/J, fluid density
    ρ_f = ρ_f0·exp((p_w − p_w0)/K_f), volume fractions φ_s = φ_s0/J,
    φ_f = 1 − (1−φ_f0)/J, mixture density; effective stress from the soil
    constitutive law                            (:782-960)
  mixture equilibrium: total Kirchhoff stress τ_tot = τ' − θ·I (Terzaghi;
    the reference phrases it as P = P' − θF^{-T}, :1108-1130 — identical in
    updated-Lagrangian form), a_A = b + f_A/m_A (:1240-1330)
  mass balance: C·ṗ_w = −Σ N ρ_f (dJ/dt) V0    (jacobian rate, :1386-1467)
      + (1/g) Σ ∇N·(F⁻¹k)·∇p_w V0              (Darcy, :1469-1607)
      + (Jρ_f/g) Σ ∇N·(F⁻¹k)·(a−b) V0          (fluid inertia, :1646-1788)
    ṗ_w solved on the lumped diagonal, G2P     (:1790-1880)
  corrector: v += γΔt·a, x += Δu, p_w += γΔt·ṗ_w  (:1882-1960)

The permeability is the isotropic Darcy conductivity k [m/s] with the
reference's hard-coded g = −9.81 convention (:1504, :1681).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from ..models import dispatch as con
from ..models.materials import MaterialTable
from ..ops import windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import found_lost, make_engine, shapefun_eval


@struct.dataclass
class MixtureTable:
    """Soil-water mixture parameters (reference ``Mixture`` struct,
    Types.h:462-530; read by NLPS-Read-Material-Mixtures.c).  Arrays indexed
    by the particle's mixture id (carried in ``Particles.mat_id``)."""

    soil_id: jnp.ndarray  # (Nmix,) index into the MaterialTable (solid)
    water_id: jnp.ndarray  # (Nmix,) index into the MaterialTable (fluid)
    phi_s0: jnp.ndarray  # reference solid volume fraction
    phi_f0: jnp.ndarray  # reference fluid volume fraction
    permeability: jnp.ndarray  # isotropic Darcy conductivity k


def make_mixture_table(rows) -> MixtureTable:
    cols = {k: [] for k in ("soil_id", "water_id", "phi_s0", "phi_f0", "permeability")}
    for r in rows:
        for k in cols:
            cols[k].append(r[k])
    return MixtureTable(
        soil_id=jnp.asarray(cols["soil_id"], jnp.int32),
        water_id=jnp.asarray(cols["water_id"], jnp.int32),
        phi_s0=jnp.asarray(cols["phi_s0"], jnp.float32),
        phi_f0=jnp.asarray(cols["phi_f0"], jnp.float32),
        permeability=jnp.asarray(cols["permeability"], jnp.float32),
    )


@struct.dataclass
class UpwConfig:
    dt: float = struct.field(pytree_node=False)
    gamma: float = struct.field(pytree_node=False, default=0.5)
    shapefun: str = struct.field(pytree_node=False, default="lme")
    lme_params: lme.LMEParams = struct.field(
        pytree_node=False, default_factory=lme.LMEParams
    )
    alme_params: object = struct.field(pytree_node=False, default=None)
    kinds: tuple = struct.field(pytree_node=False, default=(3,))
    mass_tol: float = struct.field(pytree_node=False, default=1e-12)
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    axis_name: str = struct.field(pytree_node=False, default=None)
    gravity_g: float = struct.field(pytree_node=False, default=-9.81)
    # block-partitioned grid strip (parallel/domain.HaloSpec); grid and
    # active_box are then LOCAL templates and the engine halo-exchanges
    halo: object = struct.field(pytree_node=False, default=None)
    # particles already in slot layout (sharded drivers re-bin per step)
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # pallas rebin mode (see ExplicitConfig.rebin_mode): 'local' restores
    # the slot invariant at step end; 'none' defers to an external owner
    # (the halo-sharded driver's migrate_local)
    rebin_mode: str = struct.field(pytree_node=False, default="local")


def init_mixture_state(p: Particles, mats: MaterialTable, mix: MixtureTable) -> Particles:
    """Initialise the two-phase particle fields (the analog of
    Generate_Soil_Water_Coupling_Analysis__InOutFun__ field setup)."""
    mid = p.mat_id
    rho_s0 = mats.rho0[mix.soil_id[mid]]
    rho_f0 = mats.rho0[mix.water_id[mid]]
    phi_s = mix.phi_s0[mid]
    phi_f = mix.phi_f0[mid]
    rho_mix = rho_s0 * phi_s + rho_f0 * phi_f
    return p.replace(
        rho_s=rho_s0,
        rho_f=rho_f0,
        phi_s=phi_s,
        phi_f=phi_f,
        rho=rho_mix,
        mass=rho_mix * p.vol0,
    )


def upw_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwConfig,
    body_accel: jax.Array,  # (d,)
    pw_dirichlet_mask: Optional[jax.Array] = None,  # (n_nodes,) bool
    pw_dirichlet_value: Optional[jax.Array] = None,  # (n_nodes,)
):
    """One explicit two-phase step.  Returns (particles, diagnostics).

    ``grid.dirichlet_mask`` constrains the solid velocity dofs;
    ``pw_dirichlet_*`` constrains nodal pore pressure.
    """
    if cfg.transfer == "pallas":
        return _upw_step_pallas(
            p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask,
            pw_dirichlet_value,
        )
    dt, gamma = cfg.dt, cfg.gamma
    d = p.dim
    n_nodes = grid.n_nodes

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer == "windowed" and not cfg.prebinned:
        binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost

    act = p.active
    mid = p.mat_id
    K_f = mats.compressibility[mix.water_id[mid]]
    rho_f0 = mats.rho0[mix.water_id[mid]]
    phi_s0 = mix.phi_s0[mid]
    phi_f0 = mix.phi_f0[mid]
    k_perm = mix.permeability[mid]
    g = cfg.gravity_g

    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    # --- lumped mixture mass + fluid compressibility ---
    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)
    comp_density = (p.J * p.phi_f * p.rho_f / jnp.maximum(K_f, 1e-30)) * p.vol0
    C_nodes = eng.p2g(N * comp_density[:, None])
    C_safe = jnp.maximum(C_nodes, cfg.mass_tol)

    # --- predictor (:371-407) ---
    pw_pred = p.pw + (1.0 - gamma) * dt * p.dpw_dt
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a

    # --- P2G: Δu, v, p_w ---
    mN = N * p.mass[:, None]
    d_dis_nodes = eng.p2g(mN[..., None] * d_dis_p[:, None, :]) / m_safe[:, None]
    v_nodes = eng.p2g(mN[..., None] * v_pred[:, None, :]) / m_safe[:, None]
    pw_nodes = eng.p2g(N * comp_density[:, None] * pw_pred[:, None]) / C_safe

    # --- Dirichlet (:710-780) ---
    if grid.dirichlet_mask is not None:
        v_nodes = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, v_nodes)
        d_dis_nodes = jnp.where(grid.dirichlet_mask, grid.dirichlet_value * dt, d_dis_nodes)
    if pw_dirichlet_mask is not None:
        pw_nodes = jnp.where(pw_dirichlet_mask, pw_dirichlet_value, pw_nodes)

    # --- local state (:782-960) ---
    du_edges = eng.edge_gather(d_dis_nodes)
    DF = kin.incremental_deformation_gradient(du_edges, dN)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.maximum(J_n1, 1e-8)
    v_edges = eng.edge_gather(v_nodes)
    grad_v = kin.disp_gradient(v_edges, dN)  # Σ v_A ⊗ ∇N_A at config n
    dFdt_n1 = kin.rate_deformation_gradient_n1(grad_v, p.F, DF, p.dFdt)
    # dJ/dt = J·tr(L) with L the spatial velocity gradient at n+1
    dN1_v = jnp.einsum("pij,pkj->pki", tn.inv_transpose(DF), dN)
    L_sp = kin.disp_gradient(v_edges, dN1_v)
    dJdt_n1 = J_n1 * tn.trace(L_sp)

    pw_cauchy = jnp.where(act, (eng.g2p(N, pw_nodes)) / J_n1, p.pw)
    # NOTE pw carried on particles is the Kirchhoff pressure θ = J·p_cauchy
    theta_p = pw_cauchy * J_n1
    rho_f_n1 = rho_f0 * jnp.exp((pw_cauchy - p.pw0) / jnp.maximum(K_f, 1e-30))
    phi_s_n1 = phi_s0 / J_n1
    phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
    rho_mix = p.rho_s * phi_s_n1 + rho_f_n1 * phi_f_n1

    # effective stress from the soil constitutive law
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=DF,
        dFdt_n1=dFdt_n1,
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=mix.soil_id[mid],
        mats=mats,
        kinds=cfg.kinds,
    )

    # --- mixture equilibrium: τ_tot = τ' − θ·I (Terzaghi) ---
    tau_tot = cs.tau - theta_p[:, None, None] * jnp.eye(d)
    dN1 = kin.push_forward_dN(dN, DF)
    fi = -jnp.einsum("pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1)
    forces = eng.p2g(fi)
    accel_nodes = body_accel[None, :] + forces / m_safe[:, None]
    if grid.dirichlet_mask is not None:
        accel_nodes = jnp.where(grid.dirichlet_mask, 0.0, accel_nodes)
    a_p = eng.g2p(N, accel_nodes)

    # --- mass balance RHS (:1369-1380) ---
    # jacobian-rate term
    src = -eng.p2g(N * (rho_f_n1 * dJdt_n1 * p.vol0)[:, None])
    # Darcy term: (1/g)·∇N_A·(F⁻¹k ∇θ)·V0
    pw_edges = eng.edge_gather(pw_nodes[:, None])[..., 0]  # (Np,K)
    grad_pw = jnp.einsum("pk,pki->pi", pw_edges, dN)  # spatial grad at n
    Finv = tn.inv(F_n1)
    Fk_gradpw = k_perm[:, None] * jnp.einsum("pij,pj->pi", Finv, grad_pw)
    # reference-config gradient GRAD_A = F_nᵀ∇N_A
    GRAD = jnp.einsum("pji,pkj->pki", p.F, dN)
    src = src + (1.0 / g) * eng.p2g(
        jnp.einsum("pki,pi->pk", GRAD, Fk_gradpw) * p.vol0[:, None]
    )
    # fluid-inertia term: (J ρ_f/g)·∇N_A·(F⁻¹k (a−b))·V0
    dyn = a_p - body_accel[None, :]
    Fk_dyn = k_perm[:, None] * jnp.einsum("pij,pj->pi", Finv, dyn)
    src = src + eng.p2g(
        jnp.einsum("pki,pi->pk", GRAD, Fk_dyn)
        * ((J_n1 * rho_f_n1 / g) * p.vol0)[:, None]
    )

    dpw_dt_nodes = src / C_safe
    if pw_dirichlet_mask is not None:
        dpw_dt_nodes = jnp.where(pw_dirichlet_mask, 0.0, dpw_dt_nodes)
    dpw_dt_p = eng.g2p(N, dpw_dt_nodes)

    # --- corrector (:1882-1960) ---
    d_dis_smooth = eng.g2p(N, d_dis_nodes)
    v_new = v_pred + gamma * dt * a_p
    pw_new = pw_pred + gamma * dt * dpw_dt_p

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + d_dis_smooth, p.x),
        dis=p.dis + jnp.where(sel, d_dis_smooth, 0.0),
        v=jnp.where(sel, v_new, p.v),
        a=jnp.where(sel, a_p, p.a),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        dJdt=dJdt_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        pw=jnp.where(act, pw_new, p.pw),
        dpw_dt=jnp.where(act, dpw_dt_p, p.dpw_dt),
        rho_f=jnp.where(act, rho_f_n1, p.rho_f),
        phi_s=jnp.where(act, phi_s_n1, p.phi_s),
        phi_f=jnp.where(act, phi_f_n1, p.phi_f),
        rho=jnp.where(act, rho_mix, p.rho),
        mass=p.mass,
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
    )
    nnz = count_nnz(mask)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag = dict(nnz=nnz, lost=lost)
    return p_out, diag


def _upw_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwConfig,
    body_accel: jax.Array,
    pw_dirichlet_mask=None,
    pw_dirichlet_value=None,
):
    """Fused-Pallas two-phase explicit step: physics
    identical to the windowed upw_step, transfers through the fused LME
    kernels of ops/pallas_transfer.py — 3 scatters + 5 gathers, no
    (Ns, K, ·) edge tensor ever reaches HBM.  All the reference's per-edge
    sums map onto the two kernel primitives: N-weighted channels
    (mass/compressibility/momenta/pressure P2G) and G·∇N contractions
    (mixture internal forces; the Darcy and fluid-inertia mass-balance
    terms become single G rows u = F_n·k·F⁻¹·(...), since
    GRAD_A·w = ∇N_A·(F_n w)).  Reference: U-pw-Verlet.c:60-1960."""
    from ..ops import pallas_transfer as pt

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    box = cfg.active_box
    dt, gamma, d = cfg.dt, cfg.gamma, p.dim
    C, nc = box.capacity, box.n_cells
    halo = cfg.halo
    if halo is not None:
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
    local_mode = cfg.rebin_mode == "local"
    lost = jnp.zeros((), jnp.int32)

    act = p.active
    mid = p.mat_id
    K_f = mats.compressibility[mix.water_id[mid]]
    rho_f0 = mats.rho0[mix.water_id[mid]]
    phi_s0 = mix.phi_s0[mid]
    phi_f0 = mix.phi_f0[mid]
    k_perm = mix.permeability[mid]
    g = cfg.gravity_g

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    def tcl(a):
        return pt.to_channel_leading(a, C, nc)[0]

    # --- scatter #1 (solves λ): mass, compressibility, Δu/v momenta, pw ---
    comp_density = (p.J * p.phi_f * p.rho_f / jnp.maximum(K_f, 1e-30)) * p.vol0
    pw_pred = p.pw + (1.0 - gamma) * dt * p.dpw_dt
    d_dis_p = dt * p.v + 0.5 * dt * dt * p.a
    v_pred = p.v + (1.0 - gamma) * dt * p.a
    chans = (
        [p.mass, comp_density]
        + [p.mass * d_dis_p[:, i] for i in range(d)]
        + [p.mass * v_pred[:, i] for i in range(d)]
        + [comp_density * pw_pred]
    )
    fN = jnp.stack([tcl(c) for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        **vkw,
    )
    nodes1 = _xadd(nodes1)
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)
    C_nodes = nodes1[:, 1]
    C_safe = jnp.maximum(C_nodes, cfg.mass_tol)
    d_dis_nodes = nodes1[:, 2 : 2 + d] / m_safe[:, None]
    v_nodes = nodes1[:, 2 + d : 2 + 2 * d] / m_safe[:, None]
    pw_nodes = nodes1[:, 2 + 2 * d] / C_safe

    if grid.dirichlet_mask is not None:
        v_nodes = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, v_nodes)
        d_dis_nodes = jnp.where(
            grid.dirichlet_mask, grid.dirichlet_value * dt, d_dis_nodes
        )
    if pw_dirichlet_mask is not None:
        pw_nodes = jnp.where(pw_dirichlet_mask, pw_dirichlet_value, pw_nodes)

    def gather(gN=None, g_grad=None):
        return pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_new, act_t,
            gN=None if gN is None else _fill(gN),
            g_grad=None if g_grad is None else _fill(g_grad),
            **vkw,
        )

    # --- gather A: smoothed Δu + pw at particles, ∇(Δu) ---
    gA, grad_du = gather(
        gN=jnp.concatenate([d_dis_nodes, pw_nodes[:, None]], axis=1),
        g_grad=d_dis_nodes,
    )
    d_dis_smooth = gA[:, :d]
    pw_gathered = gA[:, d]
    # --- gather B: ∇v (for dF/dt) ---
    _, grad_v = gather(g_grad=v_nodes)
    # --- gather C: ∇pw (packed into row 0 of a d-vector field) ---
    pw_packed = jnp.concatenate(
        [pw_nodes[:, None], jnp.zeros((grid.n_nodes, d - 1), pw_nodes.dtype)],
        axis=1,
    )
    _, grad_pw_full = gather(g_grad=pw_packed)
    grad_pw = grad_pw_full[:, 0, :]

    DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = jnp.maximum(tn.det(F_n1), 1e-8)
    dFdt_n1 = kin.rate_deformation_gradient_n1(grad_v, p.F, DF, p.dFdt)
    L_sp = tn.bmm(grad_v, tn.inv(DF))
    dJdt_n1 = J_n1 * tn.trace(L_sp)

    pw_cauchy = jnp.where(act, pw_gathered / J_n1, p.pw)
    theta_p = pw_cauchy * J_n1
    rho_f_n1 = rho_f0 * jnp.exp((pw_cauchy - p.pw0) / jnp.maximum(K_f, 1e-30))
    phi_s_n1 = phi_s0 / J_n1
    phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
    rho_mix = p.rho_s * phi_s_n1 + rho_f_n1 * phi_f_n1

    cs = con.stress_integration(
        F_n1=F_n1, DF=DF, dFdt_n1=dFdt_n1, bemi=p.bemi, bemi_zz=p.bemi_zz,
        eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
        mat_id=mix.soil_id[mid], mats=mats, kinds=cfg.kinds,
    )

    # --- scatter #2: mixture internal forces (G·∇N) + jacobian-rate src ---
    # NaN hygiene: inactive slots are fully zeroed (local_rebin), so
    # F_n1 = 0 there and its inverse is NaN; the fused kernels mask
    # multiplicatively (0·NaN = NaN propagates into the bank sums) unlike
    # the windowed engine's `where` masking — guard every per-slot kernel
    # input derived through a matrix inverse
    sel3 = act[:, None, None]
    tau_tot = cs.tau - theta_p[:, None, None] * jnp.eye(d)
    G_f = -tn.bmm(tau_tot * p.vol0[:, None, None], tn.inv_transpose(DF))
    G_f = jnp.where(sel3, G_f, 0.0)
    fN2 = jnp.stack([tcl(jnp.where(act, -(rho_f_n1 * dJdt_n1 * p.vol0), 0.0))])
    nodes2, _, _ = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_new, act_t, fN2,
        G_t=pt.to_channel_leading(G_f.reshape(-1, d * d), C, nc),
        solve=False, **vkw,
    )
    nodes2 = _xadd(nodes2)
    src = nodes2[:, 0]
    forces = nodes2[:, 1 : 1 + d]
    accel_nodes = body_accel[None, :] + forces / m_safe[:, None]
    if grid.dirichlet_mask is not None:
        accel_nodes = jnp.where(grid.dirichlet_mask, 0.0, accel_nodes)

    # --- gather D: accelerations ---
    a_p, _ = gather(gN=accel_nodes)

    # --- scatter #3: Darcy + fluid-inertia mass-balance terms as ONE G row:
    # GRAD_A·w = ∇N_A·(F_n·w) with w = k·F⁻¹·(∇θ/g + (J ρ_f/g)(a−b)) ---
    Finv = tn.inv(jnp.where(sel3, F_n1, jnp.eye(d, dtype=F_n1.dtype)))
    dyn = a_p - body_accel[None, :]
    w_vec = k_perm[:, None] * (
        jnp.einsum("pij,pj->pi", Finv, grad_pw) / g
        + jnp.einsum("pij,pj->pi", Finv, dyn)
        * ((J_n1 * rho_f_n1 / g))[:, None]
    )
    u_vec = jnp.where(
        act[:, None],
        jnp.einsum("pij,pj->pi", p.F, w_vec) * p.vol0[:, None],
        0.0,
    )
    G_src = jnp.zeros((p.count, d, d), u_vec.dtype).at[:, 0, :].set(u_vec)
    dummy = tcl(jnp.zeros_like(p.mass))[None]
    nodes3, _, _ = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_new, act_t, dummy,
        G_t=pt.to_channel_leading(G_src.reshape(-1, d * d), C, nc),
        solve=False, **vkw,
    )
    nodes3 = _xadd(nodes3)
    src = src + nodes3[:, 1]

    dpw_dt_nodes = src / C_safe
    if pw_dirichlet_mask is not None:
        dpw_dt_nodes = jnp.where(pw_dirichlet_mask, 0.0, dpw_dt_nodes)

    # --- gather E: ṗw ---
    gE, _ = gather(gN=dpw_dt_nodes[:, None])
    dpw_dt_p = gE[:, 0]

    v_new = v_pred + gamma * dt * a_p
    pw_new = pw_pred + gamma * dt * dpw_dt_p

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + d_dis_smooth, p.x),
        dis=p.dis + jnp.where(sel, d_dis_smooth, 0.0),
        v=jnp.where(sel, v_new, p.v),
        a=jnp.where(sel, a_p, p.a),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        dJdt=dJdt_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        pw=jnp.where(act, pw_new, p.pw),
        dpw_dt=jnp.where(act, dpw_dt_p, p.dpw_dt),
        rho_f=jnp.where(act, rho_f_n1, p.rho_f),
        phi_s=jnp.where(act, phi_s_n1, p.phi_s),
        phi_f=jnp.where(act, phi_f_n1, p.phi_f),
        rho=jnp.where(act, rho_mix, p.rho),
        mass=p.mass,
        lme_lambda=pt.from_channel_leading(lam_new),
    )
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    return p_out, dict(nnz=nnz, lost=lost)


@struct.dataclass
class UpwImplicitConfig:
    """Monolithic implicit u-pw Newmark-β (upw_Newmark_beta_Finite_Strains,
    /root/reference/nl-partsol/src/Formulations/Displacements-WaterPressure/
    U-pw-Newmark-beta.c:85)."""

    dt: float = struct.field(pytree_node=False)
    beta: float = struct.field(pytree_node=False, default=0.25)
    gamma: float = struct.field(pytree_node=False, default=0.5)
    shapefun: str = struct.field(pytree_node=False, default="lme")
    lme_params: lme.LMEParams = struct.field(
        pytree_node=False, default_factory=lme.LMEParams
    )
    alme_params: object = struct.field(pytree_node=False, default=None)
    kinds: tuple = struct.field(pytree_node=False, default=(3,))
    mass_tol: float = struct.field(pytree_node=False, default=1e-12)
    newton_tol: float = struct.field(pytree_node=False, default=1e-5)
    newton_maxiter: int = struct.field(pytree_node=False, default=20)
    krylov_tol: float = struct.field(pytree_node=False, default=1e-7)
    krylov_maxiter: int = struct.field(pytree_node=False, default=200)
    alpha_blend: float = struct.field(pytree_node=False, default=1.0)  # FLIP
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    axis_name: str = struct.field(pytree_node=False, default=None)
    gravity_g: float = struct.field(pytree_node=False, default=-9.81)
    # block-partitioned grid strip (parallel/domain.HaloSpec); grid and
    # active_box are then LOCAL templates and the engine halo-exchanges
    halo: object = struct.field(pytree_node=False, default=None)
    # particles already in slot layout (sharded drivers re-bin per step)
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # pallas rebin mode (see ExplicitConfig.rebin_mode): 'local' restores
    # the slot invariant at step end; 'none' defers to an external owner
    rebin_mode: str = struct.field(pytree_node=False, default="local")


def upw_newmark_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwImplicitConfig,
    body_accel: jax.Array,  # (d,)
    pw_dirichlet_mask: Optional[jax.Array] = None,  # (n_nodes,) bool
    pw_dirichlet_value: Optional[jax.Array] = None,  # (n_nodes,) increments
):
    """One monolithic implicit Newmark-β step of the u-pw mixture.

    Stacked nodal unknown z = (dU, dθ), Ndof = Ndim+1 (the reference's
    Nodal_Field ``value``; U-pw-Newmark-beta.c:30-36).  Residual rows:

      u rows:  Σ_p V0·(τ' − θ_{n+1}·I)·∇N¹  (compute_Internal_Forces_Mixture
               :908-1016 with P_total = P' − θF^{-T}, :1018-1042)
               + m_mix·(α₁dU − α₂u̇ₙ − α₃üₙ − b)   (:867-905)
      θ rows:  Σ_p N·[(φ_f·ρ_f/K_f)·θ̇_{n+1} + ρ_f·dJ/dt]·V0
               (compute_Rate_Mass_Fluid :1044-1158)
               − (1/g)·Σ_p GRAD_A·[F⁻¹kF^{-T}·GRADθ_{n+1}
                  + J·ρ_f·F⁻¹k·(a_{n+1}−b)]·V0
               (compute_Flow_contribution_Fluid :1160-1410)

    First-order dof θ uses the generalized-trapezoidal rate
    θ̇_{n+1} = (dθ − (1−γ)Δt·θ̇ₙ)/(γΔt), consistent with the explicit
    two-phase corrector above; u uses the standard Newmark α relations.
    The reference LU-factorises a dense monolithic tangent each iteration
    (:2238-2285); here the coupled nonsymmetric system is solved matrix-free
    with Newton-GMRES (ops/solvers.py).
    """
    from ..ops import solvers
    from .implicit import newmark_parameters

    if cfg.transfer == "pallas":
        return _upw_newmark_step_pallas(
            p, grid, mats, mix, cfg, body_accel, pw_dirichlet_mask,
            pw_dirichlet_value,
        )
    d = p.dim
    n_nodes = grid.n_nodes
    dt, gamma = cfg.dt, cfg.gamma
    nm = newmark_parameters(cfg.beta, cfg.gamma, dt)
    g = cfg.gravity_g

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer == "windowed" and not cfg.prebinned:
        binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost

    act = p.active
    mid = p.mat_id
    K_f = mats.compressibility[mix.water_id[mid]]
    rho_f0 = mats.rho0[mix.water_id[mid]]
    phi_s0 = mix.phi_s0[mid]
    phi_f0 = mix.phi_f0[mid]
    k_perm = mix.permeability[mid]

    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    comp_density = (p.phi_f * p.rho_f / jnp.maximum(K_f, 1e-30)) * p.vol0
    C_nodes = eng.p2g(N * comp_density[:, None])

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe[:, None]

    Un_dt = project(p.v)
    Un_dt2 = project(p.a)
    # nodal Kirchhoff pore pressure at t=n (compressibility-weighted
    # recovery, same lumping as the explicit two-phase path)
    C_safe = jnp.maximum(C_nodes, cfg.mass_tol)
    theta_n_nodes = eng.p2g(N * comp_density[:, None] * p.pw[:, None]) / C_safe
    dtheta_dt_n = eng.p2g(N * comp_density[:, None] * p.dpw_dt[:, None]) / C_safe

    if grid.dirichlet_mask is not None:
        free_u = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free_u = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)
    if pw_dirichlet_mask is not None:
        free_t = has_mass[:, 0] & ~pw_dirichlet_mask
        # pw_dirichlet_value prescribes the TOTAL nodal θ (as the explicit
        # path does); the unknown here is the increment dθ = θ̄ − θ_n
        dth_dirichlet = jnp.where(
            pw_dirichlet_mask, pw_dirichlet_value - theta_n_nodes, 0.0
        )
    else:
        free_t = has_mass[:, 0]
        dth_dirichlet = jnp.zeros((n_nodes,), p.x.dtype)

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)
    eye = jnp.eye(d, dtype=p.x.dtype)

    # --- Nondimensionalisation (computed BEFORE the residual so it can
    # scale the rows inside it).  The raw θ rows are storativity-sized —
    # up to ~1e5× smaller than the O(E·V0/h²)·dU u rows — so the raw
    # monolithic residual norm (what GMRES minimises and Newton tests:
    # right preconditioning does NOT change the norm) never sees them and
    # the f32 θ solution is pure Krylov noise.  Scale each row block by
    # its Jacobi diagonal TIMES a characteristic unknown magnitude
    # (h for dU, the P-wave modulus for dθ): both blocks then enter the
    # norm as dimensionless strain-like quantities, and the matching
    # column scaling in M_inv keeps the preconditioned operator O(1).
    # The root is unchanged.  (The reference dodges all this with dense
    # f64 LU each iteration, U-pw-Newmark-beta.c:2238.) ---
    from ..models.materials import lame_parameters

    lam_p, G_p = lame_parameters(
        mats.E[mix.soil_id[mid]], mats.nu[mix.soil_id[mid]]
    )
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    diag_K = eng.p2g(stiff_scale[:, None] * jnp.sum(dN * dN, axis=-1))
    diag_u = diag_K[:, None] + nm.alpha_1 * m_nodes[:, None]
    diag_u = jnp.where(free_u, jnp.maximum(diag_u, 1e-30), 1.0)
    # θ diag: storage/(γΔt) + Darcy stencil
    darcy_diag = eng.p2g(
        (k_perm * p.vol0 / jnp.abs(g))[:, None] * jnp.sum(dN * dN, axis=-1)
    )
    diag_t = C_nodes / (gamma * dt) + darcy_diag
    diag_t = jnp.where(free_t, jnp.maximum(diag_t, 1e-30), 1.0)
    h_ref = jnp.asarray(grid.spacing, p.x.dtype)
    # characteristic stress from the GLOBAL mixture table (shard-consistent
    # under halo sharding, unlike a mean over local particle rows)
    _lam_m, _G_m = lame_parameters(
        mats.E[mix.soil_id], mats.nu[mix.soil_id]
    )
    theta_ref = jnp.mean(_lam_m + 2.0 * _G_m)

    def local_state(dU, dth):
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        DF = grad_du + eye
        F_n1 = tn.bmm(DF, p.F)
        J_n1 = jnp.maximum(tn.det(F_n1), 1e-8)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
        dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
        # dJ/dt = J·tr(Ḟ F⁻¹)
        dJdt_n1 = J_n1 * tn.trace(tn.bmm(dFdt_n1, tn.inv(F_n1)))
        theta_n1_p = eng.g2p(N, theta_n_nodes + dth)
        dth_dt_p = (eng.g2p(N, dth) - (1.0 - gamma) * dt * p.dpw_dt) / (gamma * dt)
        cs = con.stress_integration(
            F_n1=F_n1,
            DF=DF,
            dFdt_n1=dFdt_n1,
            bemi=p.bemi,
            bemi_zz=p.bemi_zz,
            eps=p.eps,
            kappa=p.kappa,
            back_stress=p.back_stress,
            mat_id=mix.soil_id[mid],
            mats=mats,
            kinds=cfg.kinds,
        )
        return DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs

    def residual(z):
        dU = jnp.where(free_u, z[:, :d], dU_dirichlet)
        dth = jnp.where(free_t, z[:, d], dth_dirichlet)
        DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs = local_state(
            dU, dth
        )
        # --- u rows: mixture equilibrium ---
        tau_tot = cs.tau - theta_n1_p[:, None, None] * eye
        dN1 = kin.push_forward_dN(dN, DF)
        fi = jnp.einsum("pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1)
        R_u = eng.p2g(fi) + m_nodes[:, None] * (
            nm.alpha_1 * dU
            - nm.alpha_2 * Un_dt
            - nm.alpha_3 * Un_dt2
            - body_accel[None, :]
        )
        # --- θ rows: mass balance ---
        rho_f_n1 = rho_f0 * jnp.exp(
            (theta_n1_p / J_n1 - p.pw0) / jnp.maximum(K_f, 1e-30)
        )
        phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
        rate = (phi_f_n1 * rho_f_n1 / jnp.maximum(K_f, 1e-30)) * dth_dt_p + (
            rho_f_n1 * dJdt_n1
        )
        R_t = eng.p2g(N * (rate * p.vol0)[:, None])
        # Darcy + fluid-inertia flow terms (−(1/g)·GRAD_A·[...]·V0)
        th_n1_nodes = theta_n_nodes + dth
        th_edges = eng.edge_gather(th_n1_nodes[:, None])[..., 0]
        grad_th = jnp.einsum("pk,pki->pi", th_edges, dN)
        GRAD_th = jnp.einsum("pji,pj->pi", p.F, grad_th)
        Finv = tn.inv(F_n1)
        FkFt = k_perm[:, None, None] * jnp.einsum("pij,pkj->pik", Finv, Finv)
        flow_vec = jnp.einsum("pij,pj->pi", FkFt, GRAD_th)
        # acceleration at n+1 gathered from the Newmark relation
        a_n1_nodes = (
            nm.alpha_1 * dU - nm.alpha_2 * Un_dt - nm.alpha_3 * Un_dt2
        )
        a_n1_p = eng.g2p(N, a_n1_nodes)
        dyn = a_n1_p - body_accel[None, :]
        Fk_dyn = k_perm[:, None] * jnp.einsum("pij,pj->pi", Finv, dyn)
        flow_vec = flow_vec + (J_n1 * rho_f_n1)[:, None] * Fk_dyn
        GRAD = jnp.einsum("pji,pkj->pki", p.F, dN)
        R_t = R_t - (1.0 / g) * eng.p2g(
            jnp.einsum("pki,pi->pk", GRAD, flow_vec) * p.vol0[:, None]
        )
        # nondimensionalised rows (see the diag_u/diag_t comment above)
        R_u = jnp.where(free_u, R_u / (diag_u * h_ref), 0.0)
        R_t = jnp.where(free_t, R_t / (diag_t * theta_ref), 0.0)
        return jnp.concatenate([R_u, R_t[:, None]], axis=-1)

    def M_inv(r):
        # column scaling: undo the nondimensionalisation on the unknown side
        return jnp.concatenate(
            [r[:, :d] * h_ref, (r[:, d] * theta_ref)[:, None]], axis=-1
        )

    res = solvers.newton_krylov(
        residual,
        jnp.zeros((n_nodes, d + 1), p.x.dtype),
        M_inv=M_inv,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.krylov_tol,
        cg_maxiter=cfg.krylov_maxiter,
        linear="gmres",
        threshold_mode="rel",
        axis_name=cfg.halo.axis_name if cfg.halo is not None else None,
    )
    dU = jnp.where(free_u, res.x[:, :d], dU_dirichlet)
    dth = jnp.where(free_t, res.x[:, d], dth_dirichlet)

    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs = local_state(
        dU, dth
    )
    rho_f_n1 = rho_f0 * jnp.exp(
        (theta_n1_p / J_n1 - p.pw0) / jnp.maximum(K_f, 1e-30)
    )
    phi_s_n1 = phi_s0 / J_n1
    phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
    rho_mix = p.rho_s * phi_s_n1 + rho_f_n1 * phi_f_n1

    a_blend = cfg.alpha_blend
    dis_inc = eng.g2p(N, dU)
    dv = eng.g2p(N, dU_dt + (1.0 - a_blend) * Un_dt)
    da = eng.g2p(N, dU_dt2)

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + dis_inc, p.x),
        dis=jnp.where(sel, p.dis + dis_inc, p.dis),
        v=jnp.where(sel, a_blend * p.v + dv, p.v),
        a=jnp.where(sel, p.a + da, p.a),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        dJdt=dJdt_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        pw=jnp.where(act, theta_n1_p, p.pw),
        dpw_dt=jnp.where(act, dth_dt_p, p.dpw_dt),
        rho_f=jnp.where(act, rho_f_n1, p.rho_f),
        phi_s=jnp.where(act, phi_s_n1, p.phi_s),
        phi_f=jnp.where(act, phi_f_n1, p.phi_f),
        rho=jnp.where(act, rho_mix, p.rho),
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
    )
    nnz = count_nnz(mask)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag = dict(
        nnz=nnz,
        lost=lost,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
    )
    return p_out, diag


def _upw_newmark_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    mix: MixtureTable,
    cfg: UpwImplicitConfig,
    body_accel: jax.Array,
    pw_dirichlet_mask=None,
    pw_dirichlet_value=None,
):
    """Fused-Pallas monolithic implicit u-pw Newmark-β step.

    Physics identical to the windowed ``upw_newmark_step``; every transfer
    inside the Newton-GMRES loop runs through the fused LME kernels of
    ops/pallas_transfer.py wrapped in linearity-exploiting custom JVPs (the
    same trick as the single-phase ``_implicit_step_pallas``), so each
    residual/J·v evaluation costs two fused gathers (∇(dU)+N-samples of
    (dU, dθ); ∇(dθ)) and two fused scatters (mixture G + storage-rate
    channel; Darcy/inertia flow row) — no (Ns, K, ·) edge tensor is ever
    materialised.  λ is solved once (first scatter) and frozen through the
    Newton loop.  Reference being replaced: the dense monolithic NR of
    U-pw-Newmark-beta.c:85 (LU at :2238 each iteration)."""
    from ..ops import pallas_transfer as pt
    from ..ops import solvers
    from ..models.materials import lame_parameters
    from .implicit import newmark_parameters, _linear_op

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    box = cfg.active_box
    d = p.dim
    n_nodes = grid.n_nodes
    dt, gamma = cfg.dt, cfg.gamma
    nm = newmark_parameters(cfg.beta, cfg.gamma, dt)
    g = cfg.gravity_g
    C, nc = box.capacity, box.n_cells
    halo = cfg.halo
    if halo is not None:
        from ..parallel import domain as _dom

        def _xadd(nodesv):
            return _dom.halo_exchange_add(nodesv, halo)

        def _fill(nodesv):
            return _dom.halo_fill(nodesv, halo)

    else:
        _xadd = _fill = lambda nodesv: nodesv
    vkw = dict(valid_lo=grid.valid_lo, valid_hi=grid.valid_hi)

    local_mode = cfg.rebin_mode == "local" and not cfg.prebinned
    lost = jnp.zeros((), jnp.int32)
    if not local_mode and not cfg.prebinned:
        binning = windowed.bin_particles(grid, box, p.x, p.active)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost
    act = p.active
    sel3 = act[:, None, None]
    eye = jnp.eye(d, dtype=p.x.dtype)

    mid = p.mat_id
    K_f = mats.compressibility[mix.water_id[mid]]
    rho_f0 = mats.rho0[mix.water_id[mid]]
    phi_s0 = mix.phi_s0[mid]
    phi_f0 = mix.phi_f0[mid]
    k_perm = mix.permeability[mid]

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    def tcl(a):
        return pt.to_channel_leading(a, C, nc)

    # --- scatter #1 (solves λ): mass, storativity, θ/θ̇ momenta, v/a
    # momenta, Jacobi stiffness diag (gnorm channel) ---
    lam_p, G_p = lame_parameters(
        mats.E[mix.soil_id[mid]], mats.nu[mix.soil_id[mid]]
    )
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    comp_density = (p.phi_f * p.rho_f / jnp.maximum(K_f, 1e-30)) * p.vol0
    chans = (
        [p.mass, comp_density, comp_density * p.pw]
        + [p.mass * p.v[:, i] for i in range(d)]
        + [p.mass * p.a[:, i] for i in range(d)]
        + [stiff_scale]  # LAST channel doubles as the gnorm weight
    )
    fN = jnp.concatenate([tcl(c) for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        gnorm=True, **vkw,
    )
    nodes1 = _xadd(nodes1)
    lam_f = lam_new  # frozen through the Newton loop
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    C_nodes = nodes1[:, 1]
    C_safe = jnp.maximum(C_nodes, cfg.mass_tol)
    theta_n_nodes = nodes1[:, 2] / C_safe
    Un_dt = nodes1[:, 3 : 3 + d] / m_safe[:, None]
    Un_dt2 = nodes1[:, 3 + d : 3 + 2 * d] / m_safe[:, None]
    diag_K = nodes1[:, -1]

    # --- scatter #2: Darcy stencil diagonal (θ-row preconditioner) ---
    darcy_w = jnp.where(act, k_perm * p.vol0 / jnp.abs(g), 0.0)
    nodes2, _, _ = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_f, act_t, tcl(darcy_w),
        solve=False, gnorm=True, **vkw,
    )
    darcy_diag = _xadd(nodes2)[:, 1]

    if grid.dirichlet_mask is not None:
        free_u = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free_u = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)
    if pw_dirichlet_mask is not None:
        free_t = has_mass[:, 0] & ~pw_dirichlet_mask
        dth_dirichlet = jnp.where(
            pw_dirichlet_mask, pw_dirichlet_value - theta_n_nodes, 0.0
        )
    else:
        free_t = has_mass[:, 0]
        dth_dirichlet = jnp.zeros((n_nodes,), p.x.dtype)

    # Nondimensionalisation scales (see the windowed path's comment)
    diag_u = diag_K[:, None] + nm.alpha_1 * m_nodes[:, None]
    diag_u = jnp.where(free_u, jnp.maximum(diag_u, 1e-30), 1.0)
    diag_t = C_nodes / (gamma * dt) + darcy_diag
    diag_t = jnp.where(free_t, jnp.maximum(diag_t, 1e-30), 1.0)
    h_ref = jnp.asarray(grid.spacing, p.x.dtype)
    # characteristic stress from the GLOBAL mixture table (shard-consistent
    # under halo sharding, unlike a mean over local particle rows)
    _lam_m, _G_m = lame_parameters(
        mats.E[mix.soil_id], mats.nu[mix.soil_id]
    )
    theta_ref = jnp.mean(_lam_m + 2.0 * _G_m)

    def _pack_scalar(col):
        # scalar nodal field in row 0 of a d-vector for the grad kernel
        return jnp.concatenate(
            [col[:, None], jnp.zeros((col.shape[0], d - 1), col.dtype)], axis=1
        )

    # --- per-step constant gathers: ∇(velocity constant), N-samples of
    # (α₂u̇+α₃ü, θₙ), ∇θₙ ---
    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    gc0, grad_vel_const = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t,
        gN=_fill(jnp.concatenate(
            [nm.alpha_2 * Un_dt + nm.alpha_3 * Un_dt2, theta_n_nodes[:, None]],
            axis=1,
        )),
        g_grad=_fill(vel_const_nodes), **vkw,
    )
    const_a_p = gc0[:, :d]  # g2p(α₂u̇ₙ + α₃üₙ)
    th_n_p = gc0[:, d]      # g2p(θₙ)
    _, grad_th_const4 = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t,
        g_grad=_fill(_pack_scalar(theta_n_nodes)), **vkw,
    )
    grad_th_const = grad_th_const4[:, 0, :]

    # --- per-iteration linear transfer primitives (custom-JVP wrapped) ---
    def _g_all_raw(z):
        # z: (n_nodes, d+1) = [dU | dθ]
        outN, grad_du = pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_f, act_t,
            gN=_fill(z), g_grad=_fill(z[:, :d]), **vkw,
        )
        _, grad_dth4 = pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_f, act_t,
            g_grad=_fill(_pack_scalar(z[:, d])), **vkw,
        )
        return outN, grad_du, grad_dth4[:, 0, :]

    g_all = _linear_op(_g_all_raw)

    dummy1 = tcl(jnp.zeros_like(p.mass))

    def _s_all_raw(c):
        # c: (Ns, 1 + d² + d) = [rate·V0 | G_mix flat | flow u-vector]
        n1, _, _ = pt.fused_scatter(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, tcl(c[:, 0]),
            G_t=tcl(c[:, 1 : 1 + d * d]), solve=False, **vkw,
        )
        n1 = _xadd(n1)
        G_flow = jnp.zeros((c.shape[0], d, d), c.dtype).at[:, 0, :].set(
            c[:, 1 + d * d :]
        )
        n2, _, _ = pt.fused_scatter(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, dummy1,
            G_t=tcl(G_flow.reshape(-1, d * d)), solve=False, **vkw,
        )
        n2 = _xadd(n2)
        return n1[:, 0], n1[:, 1 : 1 + d], n2[:, 1]

    s_all = _linear_op(_s_all_raw)

    def local_state(zm):
        """Nonlinear per-particle state from the masked nodal unknown."""
        outN, grad_du, grad_dth = g_all(zm)
        g_dU = outN[:, :d]
        g_dth = outN[:, d]
        DF = grad_du + eye
        F_n1 = tn.bmm(DF, p.F)
        J_n1 = jnp.maximum(tn.det(F_n1), 1e-8)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
        dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
        Finv = tn.inv(jnp.where(sel3, F_n1, eye))
        dJdt_n1 = J_n1 * tn.trace(tn.bmm(dFdt_n1, Finv))
        theta_n1_p = th_n_p + g_dth
        dth_dt_p = (g_dth - (1.0 - gamma) * dt * p.dpw_dt) / (gamma * dt)
        cs = con.stress_integration(
            F_n1=F_n1, DF=DF, dFdt_n1=dFdt_n1, bemi=p.bemi, bemi_zz=p.bemi_zz,
            eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
            mat_id=mix.soil_id[mid], mats=mats, kinds=cfg.kinds,
        )
        return (DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs,
                g_dU, grad_dth, Finv)

    def residual(z):
        dU = jnp.where(free_u, z[:, :d], dU_dirichlet)
        dth = jnp.where(free_t, z[:, d], dth_dirichlet)
        zm = jnp.concatenate([dU, dth[:, None]], axis=1)
        (DF, F_n1, J_n1, _dFdt, dJdt_n1, theta_n1_p, dth_dt_p, cs,
         g_dU, grad_dth, Finv) = local_state(zm)
        # --- u rows: mixture internal forces G = V0·(τ' − θ·I)·DF⁻ᵀ ---
        tau_tot = cs.tau - theta_n1_p[:, None, None] * eye
        G_mix = tn.bmm(
            tau_tot * p.vol0[:, None, None],
            tn.inv_transpose(jnp.where(sel3, DF, eye)),
        )
        G_mix = jnp.where(sel3, G_mix, 0.0)
        # --- θ rows: storage rate + jacobian rate ---
        rho_f_n1 = rho_f0 * jnp.exp(
            (theta_n1_p / J_n1 - p.pw0) / jnp.maximum(K_f, 1e-30)
        )
        phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
        rate = (phi_f_n1 * rho_f_n1 / jnp.maximum(K_f, 1e-30)) * dth_dt_p + (
            rho_f_n1 * dJdt_n1
        )
        rate_ch = jnp.where(act, rate * p.vol0, 0.0)
        # --- θ rows: Darcy + fluid-inertia flow, one ∇N contraction:
        # GRAD_A·w = ∇N_A·(F_n·w)  with  w = k·F⁻¹·(F⁻ᵀ·GRADθ + Jρ_f(a−b))
        grad_th = grad_th_const + grad_dth  # spatial ∇θ_{n+1} at config n
        GRAD_th = jnp.einsum("pji,pj->pi", p.F, grad_th)
        a_n1_p = nm.alpha_1 * g_dU - const_a_p
        dyn = a_n1_p - body_accel[None, :]
        w_vec = k_perm[:, None] * (
            jnp.einsum("pij,pj->pi", Finv,
                       jnp.einsum("pji,pj->pi", Finv, GRAD_th))
            + jnp.einsum("pij,pj->pi", Finv, dyn)
            * (J_n1 * rho_f_n1)[:, None]
        )
        u_vec = jnp.where(
            act[:, None],
            jnp.einsum("pij,pj->pi", p.F, w_vec) * p.vol0[:, None],
            0.0,
        )
        R_rate, R_u_int, flow_sum = s_all(
            jnp.concatenate(
                [rate_ch[:, None], G_mix.reshape(-1, d * d), u_vec], axis=1
            )
        )
        R_u = R_u_int + m_nodes[:, None] * (
            nm.alpha_1 * dU
            - nm.alpha_2 * Un_dt
            - nm.alpha_3 * Un_dt2
            - body_accel[None, :]
        )
        R_t = R_rate - (1.0 / g) * flow_sum
        # nondimensionalised rows (same scheme as the windowed path)
        R_u = jnp.where(free_u, R_u / (diag_u * h_ref), 0.0)
        R_t = jnp.where(free_t, R_t / (diag_t * theta_ref), 0.0)
        return jnp.concatenate([R_u, R_t[:, None]], axis=-1)

    def M_inv(r):
        # column scaling: undo the nondimensionalisation on the unknown side
        return jnp.concatenate(
            [r[:, :d] * h_ref, (r[:, d] * theta_ref)[:, None]], axis=-1
        )

    res = solvers.newton_krylov(
        residual,
        jnp.zeros((n_nodes, d + 1), p.x.dtype),
        M_inv=M_inv,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.krylov_tol,
        cg_maxiter=cfg.krylov_maxiter,
        linear="gmres",
        threshold_mode="rel",
        axis_name=halo.axis_name if halo is not None else None,
    )
    dU = jnp.where(free_u, res.x[:, :d], dU_dirichlet)
    dth = jnp.where(free_t, res.x[:, d], dth_dirichlet)

    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    zm = jnp.concatenate([dU, dth[:, None]], axis=1)
    (DF, F_n1, J_n1, dFdt_n1, dJdt_n1, theta_n1_p, dth_dt_p, cs,
     _g_dU, _grad_dth, _Finv) = local_state(zm)
    rho_f_n1 = rho_f0 * jnp.exp(
        (theta_n1_p / J_n1 - p.pw0) / jnp.maximum(K_f, 1e-30)
    )
    phi_s_n1 = phi_s0 / J_n1
    phi_f_n1 = 1.0 - (1.0 - phi_f0) / J_n1
    rho_mix = p.rho_s * phi_s_n1 + rho_f_n1 * phi_f_n1

    a_blend = cfg.alpha_blend
    gfields = jnp.concatenate(
        [dU, dU_dt + (1.0 - a_blend) * Un_dt, dU_dt2], axis=1
    )
    gout, _ = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t, gN=_fill(gfields), **vkw,
    )
    dis_inc, dv, da = gout[:, 0:d], gout[:, d : 2 * d], gout[:, 2 * d : 3 * d]

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + dis_inc, p.x),
        dis=jnp.where(sel, p.dis + dis_inc, p.dis),
        v=jnp.where(sel, a_blend * p.v + dv, p.v),
        a=jnp.where(sel, p.a + da, p.a),
        F=F_n1,
        dFdt=dFdt_n1,
        J=J_n1,
        dJdt=dJdt_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        eps=cs.eps,
        kappa=cs.kappa,
        back_stress=cs.back_stress,
        W=cs.W,
        pw=jnp.where(act, theta_n1_p, p.pw),
        dpw_dt=jnp.where(act, dth_dt_p, p.dpw_dt),
        rho_f=jnp.where(act, rho_f_n1, p.rho_f),
        phi_s=jnp.where(act, phi_s_n1, p.phi_s),
        phi_f=jnp.where(act, phi_f_n1, p.phi_f),
        rho=jnp.where(act, rho_mix, p.rho),
        lme_lambda=pt.from_channel_leading(lam_f),
    )
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag = dict(
        nnz=nnz,
        lost=lost,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
    )
    return p_out, diag


def run(p, grid, mats, mix, cfg, n_steps, body_accel=None,
        pw_dirichlet_mask=None, pw_dirichlet_value=None):
    if body_accel is None:
        body_accel = jnp.zeros((p.dim,), p.x.dtype)
    if cfg.transfer in ("windowed", "pallas"):
        from .explicit import to_slot_layout

        p = to_slot_layout(p, grid, cfg.active_box)

    def body(carry, _):
        pp, _diag = upw_step(
            carry, grid, mats, mix, cfg, body_accel,
            pw_dirichlet_mask, pw_dirichlet_value,
        )
        return pp, None

    p_final, _ = jax.lax.scan(body, p, None, length=n_steps)
    return p_final
