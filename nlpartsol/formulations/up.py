"""Mixed displacement–pressure (-up) implicit Newmark-β driver.

Re-designs /root/reference/nl-partsol/src/Formulations/Displacements-Pressure/
U-p-Newmark-beta.c (``Up_Newmark_beta_Finite_Strains``) as a monolithic
matrix-free Newton-Krylov on the stacked nodal unknown (dU, dλ):

  nodal dofs: Ndim displacement increments + 1 pressure multiplier
              (Ndof = Ndim+1, U-p-Newmark-beta.c:75)
  particle multiplier update λ_{n+1} = λ_n + Σ_A N_A·dλ_A   (:700-704)
  momentum rows: internal forces from the *constrained* stress — deviatoric
    constitutive response + the nodal pressure field — plus Newmark inertia
    (compute_Internal_Forces :860-965, compute_Inertial_Forces)
  pressure rows: the weak volumetric statement Σ_p N_A·(·)·V0
    (compute_Volumetric_Constrain_Forces :970-1045)
  monolithic NR with dense-LAPACK solve in the reference (:1580) — here a
  matrix-free Newton-GMRES (ops/solvers.py) on the coupled nonsymmetric
  system.

Formulation note: the reference's U-p path is itself work-in-progress (its
kinematic updates are commented out, :686-697, and the multiplier is never
fed into the stress, Constitutive.c:97).  This implementation completes the
scheme as the standard mean-stress-projection mixed method: the nodal
pressure λ is the L2 projection of the Kirchhoff mean stress,

    R_λ,A = Σ_p N_A · ( p̄(F_p) − λ_{n+1,p} ) · V0_p ,
    τ_total = dev τ(F) + λ_{n+1} · I ,

which (a) reproduces the pure-displacement solution for compressible
materials (projection consistency) and (b) relieves volumetric locking as
ν → 1/2 because the pressure entering equilibrium is the smoothed nodal
field, not the raw per-particle volumetric response.
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
from ..shapefun import alme, lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import found_lost, make_engine, shapefun_eval
from .implicit import newmark_parameters


@struct.dataclass
class UpConfig:
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
    quasi_static: bool = struct.field(pytree_node=False, default=False)
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    axis_name: str = struct.field(pytree_node=False, default=None)
    # particles already in slot layout (sharded drivers re-bin per step)
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # pallas rebin mode (see ExplicitConfig.rebin_mode)
    rebin_mode: str = struct.field(pytree_node=False, default="local")


def _mean_and_dev(tau, tau_zz, dim):
    """Kirchhoff mean stress and deviator with the plane-strain zz channel
    (2D tensors carry the out-of-plane component separately, Types.h /
    U-Analisys.c:24-44)."""
    tr = jnp.trace(tau, axis1=-2, axis2=-1)
    if dim == 2:
        tr = tr + tau_zz
    mean = tr / 3.0
    eye = jnp.eye(dim, dtype=tau.dtype)
    dev = tau - mean[:, None, None] * eye
    dev_zz = tau_zz - mean
    return mean, dev, dev_zz


def up_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: UpConfig,
    body_accel: jax.Array,
    traction: Optional[jax.Array] = None,
    traction_area: Optional[jax.Array] = None,
):
    """One implicit Newmark-β step of the mixed u-p formulation.

    The particle pressure multiplier λ_n is carried in ``Particles.pw``
    (the reference stores it in ``Phi.lambda_pressure_n``, Types.h:221)."""
    if cfg.transfer == "pallas":
        return _up_step_pallas(p, grid, mats, cfg, body_accel, traction,
                               traction_area)
    d = p.dim
    n_nodes = grid.n_nodes
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer == "windowed":
        binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
        if traction is not None:
            idx = jnp.minimum(binning.slot_particle, traction.shape[0] - 1)
            traction = jnp.where(binning.valid[:, None], traction[idx], 0.0)
            traction_area = jnp.where(binning.valid, traction_area[idx], 0.0)
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
    # lumped volume (the pressure-projection "mass"): Σ_p N·V0
    v_nodes = eng.p2g(N * p.vol0[:, None])

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Un_dt = project(p.v)
    Un_dt2 = project(p.a)

    if grid.dirichlet_mask is not None:
        free_u = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free_u = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)
    free_l = has_mass[:, 0]

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)

    # --- nondimensionalisation (same scheme as upw_newmark_step: scale
    # each row block by its Jacobi diagonal times a characteristic unknown
    # magnitude so both blocks enter the GMRES/Newton norms as
    # dimensionless strain-like quantities; M_inv below applies the
    # matching column scaling) ---
    lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    diag_K = eng.p2g(stiff_scale[:, None] * jnp.sum(dN * dN, axis=-1))
    diag_u = diag_K[:, None] + (
        0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None]
    )
    diag_u = jnp.where(free_u, jnp.maximum(diag_u, 1e-30), 1.0)
    diag_l = jnp.where(free_l, jnp.maximum(v_nodes, 1e-30), 1.0)
    h_ref = jnp.asarray(grid.spacing, p.x.dtype)
    _lam_m, _G_m = lame_parameters(mats.E, mats.nu)
    theta_ref = jnp.mean(_lam_m + 2.0 * _G_m)

    def local_state(dU, dlam):
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
        F_n1 = tn.bmm(DF, p.F)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
        dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
        lam_n1 = p.pw + eng.g2p(N, dlam)  # λ_{n+1} per particle (:700-704)
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
        return DF, F_n1, dFdt_n1, lam_n1, cs

    def residual(z):
        dU = jnp.where(free_u, z[:, :d], dU_dirichlet)
        dlam = jnp.where(free_l, z[:, d], 0.0)
        DF, F_n1, _, lam_n1, cs = local_state(dU, dlam)
        dmg = (1.0 - p.damage)[:, None, None]
        mean, dev, dev_zz = _mean_and_dev(cs.tau * dmg, cs.tau_zz * (1.0 - p.damage), d)
        # constrained stress: deviatoric response + nodal pressure field
        tau_tot = dev + lam_n1[:, None, None] * jnp.eye(d, dtype=dev.dtype)
        dN1 = kin.push_forward_dN(dN, DF)
        fi = jnp.einsum(
            "pij,pkj->pki", tau_tot * p.vol0[:, None, None], dN1
        )
        R_u = eng.p2g(fi)
        if traction is not None:
            tr = (N * traction_area[:, None])[..., None] * traction[:, None, :]
            R_u = R_u - eng.p2g(tr)
        if cfg.quasi_static:
            R_u = R_u - m_nodes[:, None] * body_accel[None, :]
        else:
            R_u = R_u + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        # pressure projection rows (compute_Volumetric_Constrain_Forces):
        # λ is the L2 projection of the constitutive mean Kirchhoff stress
        R_l = eng.p2g(N * ((mean - lam_n1) * p.vol0)[:, None])
        # nondimensionalised rows (see the diag_u/diag_l comment above)
        R_u = jnp.where(free_u, R_u / (diag_u * h_ref), 0.0)
        R_l = jnp.where(free_l, R_l / (diag_l * theta_ref), 0.0)
        return jnp.concatenate([R_u, R_l[:, None]], axis=-1)

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
    )
    dU = jnp.where(free_u, res.x[:, :d], dU_dirichlet)
    dlam = jnp.where(free_l, res.x[:, d], 0.0)

    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    DF, F_n1, dFdt_n1, lam_n1, cs = local_state(dU, dlam)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)

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
        rho=p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12)),
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
        pw=jnp.where(act, lam_n1, p.pw),  # λ_n ← λ_{n+1} (:1722)
        lme_lambda=sf["lam"] if sf["lam"] is not None else p.lme_lambda,
        lme_beta=(
            alme.update_beta(p.lme_beta, DF) if cfg.shapefun == "alme" else p.lme_beta
        ),
    )
    nnz = count_nnz(mask)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag_out = dict(
        nnz=nnz,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
        lost=lost,
    )
    return p_out, diag_out


def _up_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: UpConfig,
    body_accel: jax.Array,
    traction: Optional[jax.Array] = None,
    traction_area: Optional[jax.Array] = None,
):
    """Fused-Pallas mixed u-p implicit Newmark-β step.

    Physics identical to the windowed ``up_step``; each Newton-GMRES
    residual/J·v evaluation costs ONE fused gather (N-samples of dλ +
    ∇(dU)) and ONE fused scatter (constrained-stress G block + the
    pressure-projection N channel), wrapped in linearity-exploiting custom
    JVPs like the single-phase ``_implicit_step_pallas``.  Reference being
    replaced: the dense monolithic NR of U-p-Newmark-beta.c (LU at :1580)."""
    from ..ops import pallas_transfer as pt
    from .implicit import _linear_op

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    box = cfg.active_box
    d = p.dim
    n_nodes = grid.n_nodes
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    C, nc = box.capacity, box.n_cells
    vkw = dict(valid_lo=grid.valid_lo, valid_hi=grid.valid_hi)

    local_mode = (
        cfg.rebin_mode == "local" and traction is None and not cfg.prebinned
    )
    lost = jnp.zeros((), jnp.int32)
    if not local_mode and not cfg.prebinned:
        binning = windowed.bin_particles(grid, box, p.x, p.active)
        if traction is not None:
            idx = jnp.minimum(binning.slot_particle, traction.shape[0] - 1)
            traction = jnp.where(binning.valid[:, None], traction[idx], 0.0)
            traction_area = jnp.where(binning.valid, traction_area[idx], 0.0)
        p = windowed.permute_to_slots(p, binning)
        lost = binning.lost
    act = p.active
    sel3 = act[:, None, None]
    eye = jnp.eye(d, dtype=p.x.dtype)

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    def tcl(a):
        return pt.to_channel_leading(a, C, nc)

    # --- scatter #1 (solves λ): mass, lumped volume, v/a momenta,
    # traction, Jacobi stiffness diag (gnorm channel) ---
    lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    chans = (
        [p.mass, p.vol0]
        + [p.mass * p.v[:, i] for i in range(d)]
        + [p.mass * p.a[:, i] for i in range(d)]
    )
    if traction is not None:
        chans += [traction_area * traction[:, i] for i in range(d)]
    chans += [stiff_scale]  # LAST channel doubles as the gnorm weight
    fN = jnp.concatenate([tcl(c) for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        gnorm=True, **vkw,
    )
    lam_f = lam_new  # frozen through the Newton loop
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    v_nodes = nodes1[:, 1]
    Un_dt = nodes1[:, 2 : 2 + d] / m_safe
    Un_dt2 = nodes1[:, 2 + d : 2 + 2 * d] / m_safe
    f_tra = nodes1[:, 2 + 2 * d : 2 + 3 * d] if traction is not None else None
    diag_K = nodes1[:, -1]

    if grid.dirichlet_mask is not None:
        free_u = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free_u = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)
    free_l = has_mass[:, 0]

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    _, grad_vel_const = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t,
        g_grad=vel_const_nodes, **vkw,
    )

    # nondimensionalisation scales (see the windowed path's comment)
    diag_u = diag_K[:, None] + (
        0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None]
    )
    diag_u = jnp.where(free_u, jnp.maximum(diag_u, 1e-30), 1.0)
    diag_l = jnp.where(free_l, jnp.maximum(v_nodes, 1e-30), 1.0)
    h_ref = jnp.asarray(grid.spacing, p.x.dtype)
    _lam_m, _G_m = lame_parameters(mats.E, mats.nu)
    theta_ref = jnp.mean(_lam_m + 2.0 * _G_m)

    # --- per-iteration linear transfer primitives (custom-JVP wrapped) ---
    def _g_all_raw(z):
        # z: (n_nodes, d+1) = [dU | dλ]
        outN, grad_du = pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_f, act_t,
            gN=z[:, d:], g_grad=z[:, :d], **vkw,
        )
        return outN[:, 0], grad_du

    g_all = _linear_op(_g_all_raw)

    def _s_all_raw(c):
        # c: (Ns, 1 + d²) = [(p̄−λ)·V0 | G flat]
        n1, _, _ = pt.fused_scatter(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, tcl(c[:, 0]),
            G_t=tcl(c[:, 1:]), solve=False, **vkw,
        )
        return n1[:, 0], n1[:, 1 : 1 + d]

    s_all = _linear_op(_s_all_raw)

    def local_state(zm):
        g_dlam, grad_du = g_all(zm)
        DF = grad_du + eye
        F_n1 = tn.bmm(DF, p.F)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
        dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
        lam_n1 = p.pw + g_dlam  # λ_{n+1} per particle (:700-704)
        cs = con.stress_integration(
            F_n1=F_n1, DF=DF, dFdt_n1=dFdt_n1, bemi=p.bemi, bemi_zz=p.bemi_zz,
            eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
            mat_id=p.mat_id, mats=mats, kinds=cfg.kinds,
        )
        return DF, F_n1, dFdt_n1, lam_n1, cs

    def residual(z):
        dU = jnp.where(free_u, z[:, :d], dU_dirichlet)
        dlam = jnp.where(free_l, z[:, d], 0.0)
        zm = jnp.concatenate([dU, dlam[:, None]], axis=1)
        DF, F_n1, _, lam_n1, cs = local_state(zm)
        dmg = (1.0 - p.damage)[:, None, None]
        mean, dev, dev_zz = _mean_and_dev(
            cs.tau * dmg, cs.tau_zz * (1.0 - p.damage), d
        )
        tau_tot = dev + lam_n1[:, None, None] * eye
        G = tn.bmm(
            tau_tot * p.vol0[:, None, None],
            tn.inv_transpose(jnp.where(sel3, DF, eye)),
        )
        G = jnp.where(sel3, G, 0.0)
        rlam = jnp.where(act, (mean - lam_n1) * p.vol0, 0.0)
        R_l, R_u = s_all(
            jnp.concatenate([rlam[:, None], G.reshape(-1, d * d)], axis=1)
        )
        if f_tra is not None:
            R_u = R_u - f_tra
        if cfg.quasi_static:
            R_u = R_u - m_nodes[:, None] * body_accel[None, :]
        else:
            R_u = R_u + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        # nondimensionalised rows (see the windowed path's comment)
        R_u = jnp.where(free_u, R_u / (diag_u * h_ref), 0.0)
        R_l = jnp.where(free_l, R_l / (diag_l * theta_ref), 0.0)
        return jnp.concatenate([R_u, R_l[:, None]], axis=-1)

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
    )
    dU = jnp.where(free_u, res.x[:, :d], dU_dirichlet)
    dlam = jnp.where(free_l, res.x[:, d], 0.0)

    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    zm = jnp.concatenate([dU, dlam[:, None]], axis=1)
    DF, F_n1, dFdt_n1, lam_n1, cs = local_state(zm)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)

    a_blend = cfg.alpha_blend
    gfields = jnp.concatenate(
        [dU, dU_dt + (1.0 - a_blend) * Un_dt, dU_dt2], axis=1
    )
    gout, _ = pt.fused_gather(
        grid, box, cfg.lme_params, x_t, lam_f, act_t, gN=gfields, **vkw,
    )
    dis_inc, dv, da = gout[:, 0:d], gout[:, d : 2 * d], gout[:, 2 * d : 3 * d]

    sel = act[:, None]
    p_out = p.replace(
        x=jnp.where(sel, p.x + dis_inc, p.x),
        dis=jnp.where(sel, p.dis + dis_inc, p.dis),
        v=jnp.where(sel, a_blend * p.v + dv, p.v),
        a=jnp.where(sel, p.a + da, p.a),
        rho=p.mass / (p.vol0 * jnp.maximum(J_n1, 1e-12)),
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
        pw=jnp.where(act, lam_n1, p.pw),  # λ_n ← λ_{n+1} (:1722)
        lme_lambda=pt.from_channel_leading(lam_f),
    )
    if local_mode:
        p_out, lost = windowed.local_rebin(p_out, grid, box)
    if cfg.axis_name is not None:
        nnz = jax.lax.psum(nnz, cfg.axis_name)
        lost = jax.lax.psum(lost, cfg.axis_name)
    diag_out = dict(
        nnz=nnz,
        newton_iters=res.iters,
        newton_residual=res.residual_norm,
        cg_iters=res.linear_iters,
        converged=res.converged,
        lost=lost,
    )
    return p_out, diag_out


def run(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: UpConfig,
    n_steps: int,
    body_accel=None,
):
    if body_accel is None:
        body_accel = jnp.zeros((p.dim,), p.x.dtype)
    if cfg.transfer in ("windowed", "pallas"):
        from .explicit import to_slot_layout

        p = to_slot_layout(p, grid, cfg.active_box)

    def body(carry, _):
        pp = carry
        pp, dg = up_step(pp, grid, mats, cfg, body_accel)
        return pp, (dg["newton_iters"], dg["newton_residual"])

    p_final, (iters, rnorm) = jax.lax.scan(body, p, None, length=n_steps)
    return p_final, dict(newton_iters=iters, newton_residual=rnorm)
