"""Discrete Energy-Momentum (EDMC) implicit driver.

Re-designs /root/reference/nl-partsol/src/Formulations/Displacements/
U-Discrete-Energy-Momentum.c (``U_Discrete_Energy_Momentum``, :116): a
Simo-Tarnow/Gonzalez energy-momentum-conserving midpoint scheme solved by
Newton iteration on the **nodal velocity at t = n+1** (the reference
assembles a dense tangent and LU-solves, :1522,1633; here the coupled system
is solved matrix-free with Newton-CG and the algorithmically-consistent
tangent comes from AD through the discrete-gradient stress).

Scheme (per step, unknown nodal velocity V ≡ v_{n+1}):

  v_mid   = (v_n + V)/2
  dU      = Δt · v_mid                      (nodal)
  F_{n+1} = (I + Σ_A dU_A ⊗ ∇N_A) · F_n
  C_n, C_{n+1}, ΔC = C_{n+1} − C_n, C_mid = (C_n + C_{n+1})/2

  S*      = S(C_mid) + 2·(ΔW − ½·S(C_mid):ΔC)/(ΔC:ΔC)·ΔC
            — the Gonzalez (2000) discrete gradient: the correction makes
            S*:ΔC/2 = W_{n+1} − W_n EXACTLY, hence total (kinetic + strain)
            energy is conserved to solver tolerance for any hyperelastic
            potential; S(C_mid) is obtained by AD: P = ∂W/∂F at
            F_mid = (F_n + F_{n+1})/2, S = F_mid⁻¹·P.

  R_A = m_A·(V − v_n)/Δt + Σ_p V0·P*·GRAD_A − f_ext,  P* = F_mid·S*,
        GRAD_A = F_nᵀ·∇N_A (reference-configuration gradient)

Restricted to hyperelastic materials (path-independent W), matching the
reference's usage.  The momentum-conservation property is structural (the
residual is a pure P2G scatter of equal-and-opposite internal forces);
energy conservation is asserted in tests/test_dem.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..models import dispatch as con
from ..models.materials import MaterialTable, lame_parameters
from ..ops import solvers, windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import found_lost, make_engine, shapefun_eval


@struct.dataclass
class DEMConfig:
    dt: float = struct.field(pytree_node=False)
    shapefun: str = struct.field(pytree_node=False, default="lme")
    lme_params: lme.LMEParams = struct.field(
        pytree_node=False, default_factory=lme.LMEParams
    )
    alme_params: object = struct.field(pytree_node=False, default=None)
    kinds: tuple = struct.field(pytree_node=False, default=(3,))
    mass_tol: float = struct.field(pytree_node=False, default=1e-12)
    newton_tol: float = struct.field(pytree_node=False, default=1e-6)
    newton_maxiter: int = struct.field(pytree_node=False, default=30)
    cg_tol: float = struct.field(pytree_node=False, default=1e-8)
    cg_maxiter: int = struct.field(pytree_node=False, default=200)
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    axis_name: str = struct.field(pytree_node=False, default=None)
    # pallas rebin mode (see ImplicitConfig.rebin_mode): 'local' restores
    # the slot invariant at step end (implicit steps may exceed 1 cell of
    # drift — losses are counted loudly)
    rebin_mode: str = struct.field(pytree_node=False, default="local")
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # midpoint stress integrator:
    #   'discrete-gradient' — Gonzalez discrete gradient (energy-exact; the
    #       default, conserves W to machine precision)
    #   'average-strain'    — the reference's S(C_mid, J_mid) rule
    #       (average_strain_integration_Stress__Particles__,
    #       U-Discrete-Energy-Momentum.c:50-80; used for the end-to-end
    #       head-to-head golden gate, tests/test_reference_e2e.py)
    stress_mode: str = struct.field(
        pytree_node=False, default="discrete-gradient"
    )


def _strain_energy(F_n1, p, mats, kinds):
    """Batched W(F) for hyperelastic kinds (models return the potential)."""
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=jnp.broadcast_to(jnp.eye(F_n1.shape[-1], dtype=F_n1.dtype), F_n1.shape),
        dFdt_n1=jnp.zeros_like(F_n1),
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=kinds,
    )
    return cs.W


def dem_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: DEMConfig,
    body_accel: jax.Array,
):
    """One energy-momentum-conserving implicit step."""
    if cfg.transfer == "pallas":
        return _dem_step_pallas(p, grid, mats, cfg, body_accel)
    d = p.dim
    n_nodes = grid.n_nodes
    dt = cfg.dt

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer == "windowed":
        binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost

    act = p.active
    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    lost = lost + found_lost(sf, act)
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Vn = project(p.v)
    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
        V_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
        # the reference imposes the BC on the PROJECTED velocity before the
        # solve (imposse_Nodal_Velocity, U-Discrete-Energy-Momentum.c:228):
        # constrained nodes carry the BC history, so the FLIP increment at
        # the wall is the BC's, not minus the raw projection
        Vn = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, Vn)
    else:
        free = has_mass
        V_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)

    eye = jnp.eye(d, dtype=p.x.dtype)
    C_n = jnp.einsum("pki,pkj->pij", p.F, p.F)
    W_n = _strain_energy(p.F, p, mats, cfg.kinds)
    # P(F) = ∂W/∂F by AD (exact for every hyperelastic model; replaces the
    # per-model midpoint stress of the reference, :103-108)
    grad_W = jax.grad(lambda F: jnp.sum(_strain_energy(F, p, mats, cfg.kinds)))

    def discrete_gradient_PK1(F_n1):
        """P* = F_mid·S* with the Gonzalez discrete-gradient S*."""
        F_mid = 0.5 * (p.F + F_n1)
        C_n1 = jnp.einsum("pki,pkj->pij", F_n1, F_n1)
        dC = C_n1 - C_n
        C_colon = jnp.einsum("pij,pij->p", dC, dC)
        P_mid = grad_W(F_mid)
        S_mid = jnp.einsum("pij,pjk->pik", tn.inv(F_mid), P_mid)
        # symmetrise (S from AD through F may carry a skew part that does no
        # work against the symmetric ΔC but pollutes the correction)
        S_mid = 0.5 * (S_mid + jnp.swapaxes(S_mid, -1, -2))
        W_n1 = _strain_energy(F_n1, p, mats, cfg.kinds)
        dW = W_n1 - W_n
        S_dC = 0.5 * jnp.einsum("pij,pij->p", S_mid, dC)
        coef = jnp.where(
            C_colon > 1e-16, (dW - S_dC) / jnp.maximum(C_colon, 1e-30), 0.0
        )
        S_star = S_mid + 2.0 * coef[:, None, None] * dC
        return jnp.einsum("pij,pjk->pik", F_mid, S_star)

    def average_strain_PK1(F_n1):
        """The reference's midpoint rule: S evaluated at the AVERAGED
        C and J (not at F_mid), P = F_mid·S (U-Discrete-Energy-Momentum.c:
        50-80).  Materials as the reference's DEM dispatch (:62-66):
        Neo-Hookean-Wriggers (compute_2PK_Stress_Tensor_...,
        Neo-Hookean.c:145-178) and Saint-Venant-Kirchhoff
        (grad_energy_Saint_Venant_Kirchhoff, Saint-Venant-Kirchhoff.c:84-120
        with the trE initialiser restored — note the reference's formula is
        S = λ·trE·I + G·E, i.e. HALF the textbook 2G·E shear term; we
        replicate it verbatim here because this mode exists for binary
        parity, while models/ keeps the textbook SVK)."""
        from ..models.materials import (
            NEO_HOOKEAN, SAINT_VENANT_KIRCHHOFF, lame_parameters,
        )

        F_mid = 0.5 * (p.F + F_n1)
        C_n1 = jnp.einsum("pki,pkj->pij", F_n1, F_n1)
        C_mid = 0.5 * (C_n + C_n1)
        lam, G = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
        if tuple(cfg.kinds) == (NEO_HOOKEAN,):
            J_mid = 0.5 * (tn.det(p.F) + tn.det(F_n1))
            C_inv = tn.inv(C_mid)
            S = (
                (0.5 * lam * (J_mid * J_mid - 1.0))[:, None, None] * C_inv
                + G[:, None, None] * (eye[None] - C_inv)
            )
        elif tuple(cfg.kinds) == (SAINT_VENANT_KIRCHHOFF,):
            E_mid = 0.5 * (C_mid - eye[None])
            trE = jnp.trace(E_mid, axis1=-2, axis2=-1)
            S = (lam * trE)[:, None, None] * eye[None] + G[:, None, None] * E_mid
        else:
            raise ValueError(
                "stress_mode='average-strain' implements the reference's "
                "DEM dispatch (Neo-Hookean-Wriggers, Saint-Venant-Kirchhoff "
                "— U-Discrete-Energy-Momentum.c:62-66) only"
            )
        return jnp.einsum("pij,pjk->pik", F_mid, S)

    pk1_of = (
        average_strain_PK1
        if cfg.stress_mode == "average-strain"
        else discrete_gradient_PK1
    )

    GRAD = jnp.einsum("pji,pkj->pki", p.F, dN)  # F_nᵀ·∇N_A per edge

    def residual(V_free):
        V = jnp.where(free, V_free, V_dirichlet)
        v_mid = 0.5 * (Vn + V)
        dU = dt * v_mid
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        F_n1 = tn.bmm(grad_du + eye, p.F)
        P_star = pk1_of(F_n1)
        fi = jnp.einsum(
            "pij,pkj->pki", P_star * p.vol0[:, None, None], GRAD
        )
        R = (
            m_nodes[:, None] * (V - Vn) / dt
            + eng.p2g(fi)
            - m_nodes[:, None] * body_accel[None, :]
        )
        return jnp.where(free, R, 0.0)

    # Jacobi preconditioner: m/dt + spectrally-scaled stiffness diagonal
    lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0 * (0.5 * dt)
    diag_K = eng.p2g(stiff_scale[:, None] * jnp.sum(dN * dN, axis=-1))
    diag = diag_K[:, None] + m_nodes[:, None] / dt
    diag = jnp.where(free, jnp.maximum(diag, 1e-30), 1.0)

    res = solvers.newton_krylov(
        residual,
        Vn,
        M_inv=lambda r: r / diag,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter,
    )
    V = jnp.where(free, res.x, V_dirichlet)
    v_mid_nodes = 0.5 * (Vn + V)
    dU = dt * v_mid_nodes

    grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
    DF = grad_du + eye
    F_n1 = tn.bmm(DF, p.F)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)
    # end-of-step stress/state from the standard constitutive update (the
    # discrete gradient is internal to the solve; particle state carries the
    # true τ(F_{n+1}), as the reference does on convergence)
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=DF,
        dFdt_n1=kin.rate_deformation_gradient_n1(
            kin.disp_gradient(eng.edge_gather(V - Vn), dN) / dt * dt, p.F, DF, p.dFdt
        ),
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=cfg.kinds,
    )

    dis_inc = eng.g2p(N, dU)
    dv = eng.g2p(N, V - Vn)  # FLIP velocity increment
    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + dis_inc, p.x),
        dis=jnp.where(sel, p.dis + dis_inc, p.dis),
        v=jnp.where(sel, p.v + dv, p.v),
        a=jnp.where(sel, eng.g2p(N, (V - Vn) / dt), p.a),
        rho=p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12)),
        F=F_n1,
        J=J_n1,
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        W=cs.W,
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
    )
    # Grid-level energy audit: the discrete-gradient property guarantees
    # ½Σ_A m_A(V² − Vn²) + Σ_p (W_{n+1} − W_n)·V0 = 0 to solver tolerance
    # (particle-level energies additionally see the FLIP transfer error).
    W_n1 = _strain_energy(F_n1, p, mats, cfg.kinds)
    nodal_dke = 0.5 * jnp.sum(m_nodes[:, None] * (V**2 - Vn**2))
    dW_tot = jnp.sum(jnp.where(act, (W_n1 - W_n) * p.vol0, 0.0))
    diag_out = dict(
        nnz=count_nnz(mask),
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        converged=res.converged,
        lost=lost,
        kinetic_energy=0.5 * jnp.sum(
            jnp.where(act, p_out.mass * jnp.sum(p_out.v**2, -1), 0.0)
        ),
        strain_energy=jnp.sum(jnp.where(act, cs.W * p.vol0, 0.0)),
        grid_energy_increment=nodal_dke + dW_tot,
        grid_kinetic_energy=0.5 * jnp.sum(m_nodes[:, None] * V**2),
    )
    return p_out, diag_out


def _dem_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: DEMConfig,
    body_accel: jax.Array,
):
    """Fused-Pallas Discrete Energy-Momentum step:
    physics identical to the windowed path; every Newton-CG residual costs
    one fused gradient-gather + one fused G-scatter (the internal forces
    collapse to G·∇N rows with G = P*·V0·F_nᵀ, since
    P*·GRAD_A = P*·F_nᵀ·∇N_A), wrapped in linearity-exploiting custom JVPs
    exactly like the implicit Newmark path."""
    from ..ops import pallas_transfer as pt
    from .implicit import _linear_op

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    box = cfg.active_box
    d = p.dim
    dt = cfg.dt
    n_nodes = grid.n_nodes
    C, nc = box.capacity, box.n_cells
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
    # NaN hygiene (see upw): zeroed inactive slots carry F = 0, which the
    # energy/inverse paths cannot digest — substitute identity there
    Fb = jnp.where(sel3, p.F, eye)
    pb = p.replace(F=Fb)

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    # --- scatter #1 (solves λ): mass, momentum, Jacobi gnorm weight ---
    lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0 * (0.5 * dt)
    chans = [p.mass] + [p.mass * p.v[:, i] for i in range(d)] + [stiff_scale]
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0] for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        gnorm=True, **vkw,
    )
    lam_f = lam_new
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    Vn = nodes1[:, 1 : 1 + d] / m_safe
    diag_K = nodes1[:, -1]

    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
        V_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
        Vn = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, Vn)
    else:
        free = has_mass
        V_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)

    grad_gather = _linear_op(
        lambda nodes: pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, g_grad=nodes, **vkw,
        )[1]
    )
    dummy1 = pt.to_channel_leading(jnp.zeros_like(p.mass), C, nc)
    g_scatter = _linear_op(
        lambda G: pt.fused_scatter(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, dummy1,
            G_t=pt.to_channel_leading(G.reshape(-1, d * d), C, nc),
            solve=False, **vkw,
        )[0][:, 1 : 1 + d]
    )

    C_n = jnp.einsum("pki,pkj->pij", Fb, Fb)
    W_n = _strain_energy(Fb, pb, mats, cfg.kinds)
    grad_W = jax.grad(lambda F: jnp.sum(_strain_energy(F, pb, mats, cfg.kinds)))

    def discrete_gradient_PK1(F_n1):
        F_mid = 0.5 * (Fb + F_n1)
        C_n1 = jnp.einsum("pki,pkj->pij", F_n1, F_n1)
        dC = C_n1 - C_n
        C_colon = jnp.einsum("pij,pij->p", dC, dC)
        P_mid = grad_W(F_mid)
        S_mid = jnp.einsum("pij,pjk->pik", tn.inv(F_mid), P_mid)
        S_mid = 0.5 * (S_mid + jnp.swapaxes(S_mid, -1, -2))
        W_n1 = _strain_energy(F_n1, pb, mats, cfg.kinds)
        dW = W_n1 - W_n
        S_dC = 0.5 * jnp.einsum("pij,pij->p", S_mid, dC)
        coef = jnp.where(
            C_colon > 1e-16, (dW - S_dC) / jnp.maximum(C_colon, 1e-30), 0.0
        )
        S_star = S_mid + 2.0 * coef[:, None, None] * dC
        return jnp.einsum("pij,pjk->pik", F_mid, S_star)

    if cfg.stress_mode != "discrete-gradient":
        raise ValueError(
            "the pallas DEM path implements stress_mode='discrete-gradient' "
            "(the parity-gate 'average-strain' rule runs on the "
            "windowed/scatter engines)"
        )

    def residual(V_free):
        V = jnp.where(free, V_free, V_dirichlet)
        dU = dt * 0.5 * (Vn + V)
        grad_du = grad_gather(dU)
        F_n1 = tn.bmm(grad_du + eye, Fb)
        P_star = discrete_gradient_PK1(F_n1)
        G = jnp.where(
            sel3,
            jnp.einsum(
                "pij,pkj->pik", P_star * p.vol0[:, None, None], Fb
            ),
            0.0,
        )
        R = (
            m_nodes[:, None] * (V - Vn) / dt
            + g_scatter(G)
            - m_nodes[:, None] * body_accel[None, :]
        )
        return jnp.where(free, R, 0.0)

    diag = diag_K[:, None] + m_nodes[:, None] / dt
    diag = jnp.where(free, jnp.maximum(diag, 1e-30), 1.0)

    res = solvers.newton_krylov(
        residual,
        Vn,
        M_inv=lambda r: r / diag,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter,
    )
    V = jnp.where(free, res.x, V_dirichlet)
    dU = dt * 0.5 * (Vn + V)

    grad_du = grad_gather(dU)
    DF = grad_du + eye
    F_n1 = tn.bmm(DF, Fb)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)
    grad_dv = grad_gather(V - Vn)
    cs = con.stress_integration(
        F_n1=F_n1,
        DF=DF,
        dFdt_n1=kin.rate_deformation_gradient_n1(grad_dv, Fb, DF, p.dFdt),
        bemi=p.bemi,
        bemi_zz=p.bemi_zz,
        eps=p.eps,
        kappa=p.kappa,
        back_stress=p.back_stress,
        mat_id=p.mat_id,
        mats=mats,
        kinds=cfg.kinds,
    )

    gout, _ = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t,
        gN=jnp.concatenate([dU, V - Vn], axis=1), **vkw,
    )
    dis_inc, dv = gout[:, :d], gout[:, d : 2 * d]
    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + dis_inc, p.x),
        dis=jnp.where(sel, p.dis + dis_inc, p.dis),
        v=jnp.where(sel, p.v + dv, p.v),
        a=jnp.where(sel, dv / dt, p.a),
        rho=p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12)),
        F=jnp.where(sel3, F_n1, p.F),
        J=jnp.where(act, J_n1, p.J),
        bemi=cs.bemi,
        bemi_zz=cs.bemi_zz,
        stress=cs.tau,
        stress_zz=cs.tau_zz,
        W=cs.W,
        lme_lambda=pt.from_channel_leading(lam_f),
    )
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    W_n1 = _strain_energy(F_n1, pb, mats, cfg.kinds)
    nodal_dke = 0.5 * jnp.sum(m_nodes[:, None] * (V**2 - Vn**2))
    dW_tot = jnp.sum(jnp.where(act, (W_n1 - W_n) * p.vol0, 0.0))
    diag_out = dict(
        nnz=nnz,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
        lost=lost,
        kinetic_energy=0.5 * jnp.sum(
            jnp.where(act, p_out.mass * jnp.sum(p_out.v**2, -1), 0.0)
        ),
        strain_energy=jnp.sum(jnp.where(act, cs.W * p.vol0, 0.0)),
        grid_energy_increment=nodal_dke + dW_tot,
        grid_kinetic_energy=0.5 * jnp.sum(m_nodes[:, None] * V**2),
    )
    return p_out, diag_out


def run(p, grid, mats, cfg, n_steps, body_accel=None):
    if body_accel is None:
        body_accel = jnp.zeros((p.dim,), p.x.dtype)
    if cfg.transfer in ("windowed", "pallas"):
        from .explicit import to_slot_layout

        p = to_slot_layout(p, grid, cfg.active_box)

    def body(carry, _):
        pp, dg = dem_step(carry, grid, mats, cfg, body_accel)
        return pp, (dg["kinetic_energy"], dg["strain_energy"], dg["newton_iters"])

    p_final, (ke, se, iters) = jax.lax.scan(body, p, None, length=n_steps)
    return p_final, dict(kinetic_energy=ke, strain_energy=se, newton_iters=iters)
