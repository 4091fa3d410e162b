"""Implicit Newmark-β and quasi-static drivers (the flagship implicit path).

Re-designs /root/reference/nl-partsol/src/Formulations/Displacements/
U-Newmark-beta.c (PETSc SNES + AIJ + PCJACOBI) and U-Static.c as a
matrix-free Newton-Krylov on the masked structured grid:

  Newmark parameters α₁..α₆               (:497-514)
  lumped mass                              (:528)
  nodal v/a projection (P2G ÷ mass)        (:615)
  residual R(dU) = F_int(dU) + F_tra + M⊙(α₁dU − α₂u̇ₙ − α₃üₙ − b)
                                           (:970-1050, 1257-1556)
  Jacobian = Σ_p V0·stiffness_density + α₁·M   (:1646-1830)
       → here: exact J·v by jax.jvp through R (no BSR assembly on the
         Newton path; the assembled-BSR module serves the preconditioner
         and standalone SpMV needs)
  Dirichlet via dof masking (the MatZeroRowsColumnsIS equivalent, :1827)
  FLIP/PIC particle update                 (:1993-2064)

The quasi-static mode is the same machinery without inertial terms
(U-Static.c:83), used for gravity pre-load stages (-ff flow,
driver-nl-partsol.c:206-292).

Transfers run through ops/transfer.py ('windowed' scatter-free slot layout
or 'scatter' fallback); each Newton/CG residual evaluation costs one
edge-gather + one P2G, both dense in windowed mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..models import dispatch as con
from ..models.materials import MaterialTable, lame_parameters
from ..ops import bsr, solvers, windowed
from ..ops import tensor as tn
from ..ops.sparse import nnz as count_nnz
from ..shapefun import alme, lme
from ..types import Grid, Particles
from . import kinematics as kin
from .common import found_lost, make_engine, shapefun_eval


class NewmarkParams(NamedTuple):
    """α₁..α₆ (__compute_Newmark_parameters, U-Newmark-beta.c:497-514)."""

    alpha_1: float
    alpha_2: float
    alpha_3: float
    alpha_4: float
    alpha_5: float
    alpha_6: float
    dt: float


def newmark_parameters(beta: float, gamma: float, dt: float) -> NewmarkParams:
    return NewmarkParams(
        alpha_1=1.0 / (beta * dt * dt),
        alpha_2=1.0 / (beta * dt),
        alpha_3=(1.0 - 2.0 * beta) / (2.0 * beta),
        alpha_4=gamma / (beta * dt),
        alpha_5=1.0 - gamma / beta,
        alpha_6=(1.0 - gamma / (2.0 * beta)) * dt,
        dt=dt,
    )


@struct.dataclass
class ImplicitConfig:
    dt: float = struct.field(pytree_node=False)
    beta: float = struct.field(pytree_node=False, default=0.25)
    gamma: float = struct.field(pytree_node=False, default=0.5)
    shapefun: str = struct.field(pytree_node=False, default="lme")
    lme_params: lme.LMEParams = struct.field(
        pytree_node=False, default_factory=lme.LMEParams
    )
    alme_params: "alme.ALMEParams" = struct.field(pytree_node=False, default=None)
    kinds: tuple = struct.field(pytree_node=False, default=(3,))
    mass_tol: float = struct.field(pytree_node=False, default=1e-12)
    # Solver tolerances (reference: TOL_NR 1e-5 Macros.h:40; KSP defaults)
    newton_tol: float = struct.field(pytree_node=False, default=1e-5)
    newton_maxiter: int = struct.field(pytree_node=False, default=20)
    cg_tol: float = struct.field(pytree_node=False, default=1e-7)
    cg_maxiter: int = struct.field(pytree_node=False, default=200)
    alpha_blend: float = struct.field(pytree_node=False, default=1.0)  # 1 ⇒ FLIP
    quasi_static: bool = struct.field(pytree_node=False, default=False)
    # preconditioner: 'jacobi' (spectral-scalar) or 'block-jacobi'
    # (exact AD-assembled d×d diagonal blocks, ops/bsr.py)
    precond: str = struct.field(pytree_node=False, default="jacobi")
    # inner linear solver: 'cg' | 'bicgstab' | 'gmres' | 'dense' (direct LU
    # fallback, ops/solvers.dense_lu — the reference's dgetrs path)
    linear: str = struct.field(pytree_node=False, default="cg")
    # inner-tolerance forcing: 'ew' (Eisenstat-Walker, default) | 'fixed'
    # (every solve to cg_tol — the reference's fixed-tol KSP behaviour)
    forcing: str = struct.field(pytree_node=False, default="ew")
    # transfer backend: 'windowed' (needs active_box) or 'scatter'
    transfer: str = struct.field(pytree_node=False, default="scatter")
    active_box: windowed.ActiveBox = struct.field(pytree_node=False, default=None)
    # nonlocal fracture driver: None | 'eigenerosion' | 'eigensoftening'.
    # The reference's flagship implicit path recomputes damage inside every
    # residual evaluation (compute_damage__Constitutive__ from
    # __constitutive_update, U-Newmark-beta.c:1313-1318); here the scheme is
    # STAGGERED: the Newton solve runs with damage frozen at d_n (so the
    # tangent stays consistent and AD never differentiates the binary
    # erosion switch), then ONE nonlocal Beps update fires at the converged
    # state — the standard staggered treatment for nonlocal damage, one
    # solve behind the reference's monolithic coupling.
    damage: str = struct.field(pytree_node=False, default=None)
    beps_reach: int = struct.field(pytree_node=False, default=1)
    # shard_map axis over which particles are sharded (grid replicated)
    axis_name: str = struct.field(pytree_node=False, default=None)
    # block-partitioned grid strip (parallel/domain.HaloSpec): grid and
    # active_box become LOCAL templates; transfers halo-exchange and the
    # Newton-CG dot products psum over halo.axis_name
    halo: object = struct.field(pytree_node=False, default=None)
    # particles already in slot layout: skip the step's own binning
    prebinned: bool = struct.field(pytree_node=False, default=False)
    # pallas rebin mode (see ExplicitConfig.rebin_mode): 'local' requires
    # the slot invariant at step entry AND per-step particle displacement
    # ≤ 1 cell (implicit steps can exceed CFL — losses are counted loudly);
    # 'global' argsort-bins at step start
    rebin_mode: str = struct.field(pytree_node=False, default="local")


def edge_force_jacobian(fi_fn, grad0: jax.Array) -> jax.Array:
    """H[p, A, i, l, m] = ∂f_{pA,i}/∂(∇du_p)_{lm} by d² forward-mode JVPs
    of the batched integrand (each particle's f depends only on its own
    gradient, so a broadcast basis direction extracts the exact per-particle
    derivative for the whole batch at once).  AD through the return mapping
    yields the algorithmically consistent tangent for every material —
    replacing the reference's hand-derived `stiffness_density` per model
    (src/Constitutive/Constitutive.c:262-381)."""
    d = grad0.shape[-1]
    cols = []
    for l in range(d):
        for m in range(d):
            E = jnp.zeros((d, d), grad0.dtype).at[l, m].set(1.0)
            tang = jax.jvp(
                fi_fn, (grad0,), (jnp.broadcast_to(E, grad0.shape),)
            )[1]
            cols.append(tang)  # (Ns, K, d)
    H = jnp.stack(cols, axis=-1)  # (Ns, K, d, d*d)
    return H.reshape(H.shape[:-1] + (d, d))


def implicit_step(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    body_accel: jax.Array,
    traction: Optional[jax.Array] = None,
    traction_area: Optional[jax.Array] = None,
):
    """One implicit Newmark-β (or quasi-static) step."""
    if cfg.transfer == "pallas":
        return _implicit_step_pallas(
            p, grid, mats, cfg, body_accel, traction, traction_area
        )
    d = p.dim
    n_nodes = grid.n_nodes
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)

    lost = jnp.zeros((), jnp.int32)
    if cfg.transfer == "windowed" and not cfg.prebinned:
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

    # nodal fields at t=n: variational recovery (P2G ÷ lumped mass, :615)
    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Un_dt = project(p.v)
    Un_dt2 = project(p.a)

    # free-dof mask: active (mass-carrying) nodes minus Dirichlet
    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)

    # dU̇ = α₄·dU + const; the constant part's displacement gradient is fixed
    # per step — precompute its edge contribution once.
    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)

    def local_state_of_grad(grad_du):
        """ΔF, F_{n+1}, stress from the particle displacement gradient at
        the current Newton iterate (does NOT mutate particle state — the
        reference recomputes per residual call the same way, :1064-1256)."""
        DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
        F_n1 = tn.bmm(DF, p.F)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
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
        return DF, F_n1, dFdt_n1, cs

    def fi_of_grad(grad_du):
        """Per-edge internal-force integrand f_{pA} = V0·τ_eff·∇N¹_A —
        the function whose forward-mode derivative is the exact consistent
        tangent (replaces hand-derived stiffness densities,
        Constitutive.c:262)."""
        DF, _, _, cs = local_state_of_grad(grad_du)
        tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
        dN1 = kin.push_forward_dN(dN, DF)
        return jnp.einsum("pij,pkj->pki", tau_eff * p.vol0[:, None, None], dN1)

    def local_state(dU):
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        return local_state_of_grad(grad_du)

    def residual(dU_free):
        # Prescribed increments live on Dirichlet dofs; unknowns on free dofs
        dU = jnp.where(free, dU_free, dU_dirichlet)
        grad_du = kin.disp_gradient(eng.edge_gather(dU), dN)
        fi = fi_of_grad(grad_du)
        R = eng.p2g(fi)  # internal forces (+ sign, :1257)
        if traction is not None:
            tr = (N * traction_area[:, None])[..., None] * traction[:, None, :]
            R = R - eng.p2g(tr)  # −N·t̄·A0 (:1388-1500)
        if cfg.quasi_static:
            R = R - m_nodes[:, None] * body_accel[None, :]
        else:
            R = R + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        return jnp.where(free, R, 0.0)

    if cfg.precond == "block-jacobi":
        # exact AD-assembled d×d diagonal blocks K_AA (+ α₁·m·I), inverted
        # in closed form per node (ops/bsr.py) — upgrades the reference's
        # scalar PCJACOBI (:326-335)
        H = edge_force_jacobian(fi_of_grad, jnp.zeros_like(p.F))
        Bi = jnp.einsum("skilm,skm->skil", H, dN)  # pair (i,i) blocks
        ns_, K_ = dN.shape[0], dN.shape[1]
        diag_blocks = eng.p2g(Bi.reshape(ns_, K_, d * d)).reshape(
            n_nodes, d, d
        )
        shift = None if cfg.quasi_static else nm.alpha_1 * m_nodes
        Dinv = bsr.block_jacobi_inverse(diag_blocks, free=free, shift=shift)

        def M_inv(r):
            return jnp.einsum("nij,nj->ni", Dinv, r)

    else:
        # Jacobi preconditioner: α₁·m + a spectrally-scaled stiffness
        # diagonal Σ_p V0 (λ+2G) |∇N_pA|² (PCJACOBI equivalent, :326-335)
        lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
        stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
        diag_K = eng.p2g(stiff_scale[:, None] * jnp.sum(dN * dN, axis=-1))
        diag = diag_K[:, None] + (
            0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None]
        )
        diag = jnp.where(free, jnp.maximum(diag, 1e-30), 1.0)

        def M_inv(r):
            return r / diag

    res = solvers.newton_krylov(
        residual,
        jnp.zeros((n_nodes, d), p.x.dtype),
        M_inv=M_inv,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter,
        linear=cfg.linear,
        forcing=cfg.forcing,
        # grid-partitioned vectors (halo sharding): psum all dots/norms
        axis_name=cfg.halo.axis_name if cfg.halo is not None else None,
    )
    dU = jnp.where(free, res.x, dU_dirichlet)

    # kinetic increments (:1834-1906)
    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    # final state at converged dU
    DF, F_n1, dFdt_n1, cs = local_state(dU)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)

    # staggered nonlocal damage update at the converged state (see
    # ImplicitConfig.damage; reference hook U-Newmark-beta.c:1313-1318)
    damage_n1 = p.damage
    strain_f_n1 = p.strain_f
    if cfg.damage is not None:
        if cfg.transfer != "windowed":
            raise ValueError("fracture drivers require windowed transfer")
        from .explicit import _damage_update

        dout = _damage_update(p, grid, cfg, mats, act, cs, J_n1, F_n1)
        damage_n1 = dout.damage
        strain_f_n1 = dout.strain_f

    # reactions: minus the unmasked residual at Dirichlet rows (the free-dof
    # residual is ~0 at convergence; Dirichlet rows carry the support force
    # — the reference reports these via the nodal VTK/CSV writers).  Sign
    # matches the explicit path's `forces` (−internal + traction − inertia).
    if grid.dirichlet_mask is not None:
        tau_eff_f = cs.tau * (1.0 - p.damage)[:, None, None]
        dN1_f = kin.push_forward_dN(dN, DF)
        fi_f = jnp.einsum("pij,pkj->pki", tau_eff_f * p.vol0[:, None, None], dN1_f)
        R_full = eng.p2g(fi_f)
        if traction is not None:
            tr_f = (N * traction_area[:, None])[..., None] * traction[:, None, :]
            R_full = R_full - eng.p2g(tr_f)
        if cfg.quasi_static:
            R_full = R_full - m_nodes[:, None] * body_accel[None, :]
        else:
            R_full = R_full + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        reactions = jnp.where(grid.dirichlet_mask, -R_full, 0.0)
    else:
        reactions = jnp.zeros((n_nodes, d), p.x.dtype)

    # FLIP/PIC particle update (:1993-2064); alpha_blend=1 ⇒ pure FLIP
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
        damage=damage_n1,
        strain_f=strain_f_n1,
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
        reactions=reactions,
    )
    return p_out, diag_out


def _linear_op(fn):
    """Wrap a LINEAR function of one array with a custom JVP equal to
    itself — lets forward-mode AD (the matrix-free Newton-CG J·v) flow
    through Pallas kernels, which are not natively differentiable."""
    f = jax.custom_jvp(fn)

    @f.defjvp
    def _jvp(primals, tangents):
        (x,) = primals
        (t,) = tangents
        return fn(x), fn(t)

    return f


def _implicit_step_pallas(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    body_accel: jax.Array,
    traction: Optional[jax.Array] = None,
    traction_area: Optional[jax.Array] = None,
):
    """Fused-Pallas implicit Newmark-β step (2D/3D LME).

    Physics identical to the windowed path; no (Ns, K, ·) edge tensor is
    ever materialised.  Each Newton-CG matvec costs exactly one fused
    gradient-gather + one fused G-scatter (the kernels of
    ops/pallas_transfer.py), wrapped in linearity-exploiting custom JVPs so
    jax.jvp differentiates through them.  λ is solved once per step (first
    scatter) and frozen through the Newton loop, exactly like the windowed
    path's one-shot shape-function evaluation.
    Reference being replaced: U-Newmark-beta.c:130-432 (SNES + AIJ +
    PCJACOBI)."""
    from ..ops import pallas_transfer as pt

    if cfg.shapefun != "lme":
        raise ValueError("pallas transfer currently implements LME only")
    if cfg.precond == "block-jacobi":
        raise ValueError("pallas implicit supports precond='jacobi' only")
    box = cfg.active_box
    d = p.dim
    n_nodes = grid.n_nodes
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    C, nc = box.capacity, box.n_cells
    halo = cfg.halo
    if halo is not None:
        # halo-sharded local strip: owned-complete scatters, ghost-filled
        # gathers, psum'd Newton-CG dots (parallel/domain.py)
        from ..parallel import domain as _dom

        def _xadd(nodesv):
            return _dom.halo_exchange_add(nodesv, halo)

        def _fill(nodesv):
            return _dom.halo_fill(nodesv, halo)

    else:
        _xadd = _fill = lambda nodesv: nodesv
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

    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(act.astype(p.x.dtype), C, nc)

    # --- scatter #1 (solves λ): mass, v/a momenta, traction, Jacobi diag
    lam_p, G_p = lame_parameters(mats.E[p.mat_id], mats.nu[p.mat_id])
    stiff_scale = (lam_p + 2.0 * G_p) * p.vol0
    chans = (
        [p.mass]
        + [p.mass * p.v[:, i] for i in range(d)]
        + [p.mass * p.a[:, i] for i in range(d)]
    )
    if traction is not None:
        chans += [traction_area * traction[:, i] for i in range(d)]
    chans += [stiff_scale]  # LAST channel doubles as the gnorm weight
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0] for c in chans])
    nodes1, lam_new, nnz = pt.fused_scatter(
        grid, box, cfg.lme_params, x_t, lam_t, act_t, fN, solve=True,
        gnorm=True, **vkw,
    )
    nodes1 = _xadd(nodes1)
    lam_f = lam_new  # frozen through the Newton loop
    m_nodes = nodes1[:, 0]
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]
    Un_dt = nodes1[:, 1 : 1 + d] / m_safe
    Un_dt2 = nodes1[:, 1 + d : 1 + 2 * d] / m_safe
    f_tra = nodes1[:, 1 + 2 * d : 1 + 3 * d] if traction is not None else None
    diag_K = nodes1[:, -1]

    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
        dU_dirichlet = jnp.where(grid.dirichlet_mask, grid.dirichlet_value, 0.0)
    else:
        free = has_mass
        dU_dirichlet = jnp.zeros((n_nodes, d), p.x.dtype)

    grad_gather = _linear_op(
        lambda nodes: pt.fused_gather(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, g_grad=_fill(nodes),
            **vkw,
        )[1]
    )
    dummy1 = pt.to_channel_leading(jnp.zeros_like(p.mass), C, nc)
    g_scatter = _linear_op(
        lambda G: _xadd(pt.fused_scatter(
            grid, box, cfg.lme_params, x_t, lam_f, act_t, dummy1,
            G_t=pt.to_channel_leading(G.reshape(-1, d * d), C, nc), solve=False,
            **vkw,
        )[0])[:, 1 : 1 + d]
    )

    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = grad_gather(vel_const_nodes)

    def local_state_of_grad(grad_du):
        DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
        F_n1 = tn.bmm(DF, p.F)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
        dFdt_n1 = kin.rate_deformation_gradient_n1(dt_DF, p.F, DF, p.dFdt)
        cs = con.stress_integration(
            F_n1=F_n1, DF=DF, dFdt_n1=dFdt_n1, bemi=p.bemi, bemi_zz=p.bemi_zz,
            eps=p.eps, kappa=p.kappa, back_stress=p.back_stress,
            mat_id=p.mat_id, mats=mats, kinds=cfg.kinds,
        )
        return DF, F_n1, dFdt_n1, cs

    def residual(dU_free):
        dU = jnp.where(free, dU_free, dU_dirichlet)
        grad_du = grad_gather(dU)
        DF, _, _, cs = local_state_of_grad(grad_du)
        tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
        # internal forces: R_A = Σ_p G·∇N_A with G = V0·τ_eff·DF⁻ᵀ
        G = tn.bmm(tau_eff * p.vol0[:, None, None], tn.inv_transpose(DF))
        R = g_scatter(G)
        if f_tra is not None:
            R = R - f_tra
        if cfg.quasi_static:
            R = R - m_nodes[:, None] * body_accel[None, :]
        else:
            R = R + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        return jnp.where(free, R, 0.0)

    diag = diag_K[:, None] + (
        0.0 if cfg.quasi_static else nm.alpha_1 * m_nodes[:, None]
    )
    diag = jnp.where(free, jnp.maximum(diag, 1e-30), 1.0)

    def M_inv(r):
        return r / diag

    res = solvers.newton_krylov(
        residual,
        jnp.zeros((n_nodes, d), p.x.dtype),
        M_inv=M_inv,
        tol=cfg.newton_tol,
        maxiter=cfg.newton_maxiter,
        cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter,
        linear=cfg.linear,
        forcing=cfg.forcing,
        axis_name=halo.axis_name if halo is not None else None,
    )
    dU = jnp.where(free, res.x, dU_dirichlet)

    dU_dt = nm.alpha_4 * dU + (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    dU_dt2 = nm.alpha_1 * dU - nm.alpha_2 * Un_dt - (nm.alpha_3 + 1.0) * Un_dt2

    grad_final = grad_gather(dU)
    DF, F_n1, dFdt_n1, cs = local_state_of_grad(grad_final)
    J_n1 = tn.det(F_n1)
    J_n1 = jnp.where(J_n1 > 0.0, J_n1, 0.0)

    # staggered nonlocal damage update at the converged state (see
    # ImplicitConfig.damage); the Beps slot-sums run on the same slot
    # layout (+ seam particle halos when cfg.halo is set)
    damage_n1 = p.damage
    strain_f_n1 = p.strain_f
    if cfg.damage is not None:
        from .explicit import _damage_update

        dout = _damage_update(p, grid, cfg, mats, act, cs, J_n1, F_n1)
        damage_n1 = dout.damage
        strain_f_n1 = dout.strain_f

    # reactions on Dirichlet rows = −(unmasked residual) at the converged
    # state; one extra fused G-scatter (same convention as the windowed path)
    if grid.dirichlet_mask is not None:
        tau_eff_f = cs.tau * (1.0 - p.damage)[:, None, None]
        G_f = tn.bmm(tau_eff_f * p.vol0[:, None, None], tn.inv_transpose(DF))
        R_full = g_scatter(G_f)
        if f_tra is not None:
            R_full = R_full - f_tra
        if cfg.quasi_static:
            R_full = R_full - m_nodes[:, None] * body_accel[None, :]
        else:
            R_full = R_full + m_nodes[:, None] * (
                nm.alpha_1 * dU
                - nm.alpha_2 * Un_dt
                - nm.alpha_3 * Un_dt2
                - body_accel[None, :]
            )
        reactions = jnp.where(grid.dirichlet_mask, -R_full, 0.0)
    else:
        reactions = jnp.zeros((n_nodes, d), p.x.dtype)

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
        damage=damage_n1,
        strain_f=strain_f_n1,
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
        reactions=reactions,
    )
    return p_out, diag_out


def assemble_tangent(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
    dU: Optional[jax.Array] = None,
):
    """Assembled banded-BSR Newmark tangent J = Σ_p H·∇N + α₁·M at the
    iterate dU (default 0), Dirichlet rows/cols zeroed — the standalone
    equivalent of the reference's `__jacobian_evaluation`
    (U-Newmark-beta.c:1646-1830) for modified-Newton / preconditioner /
    SpMV-benchmark use.  Requires the windowed transfer backend."""
    if cfg.transfer != "windowed":
        raise ValueError("assemble_tangent requires cfg.transfer='windowed'")
    d = p.dim
    nm = newmark_parameters(cfg.beta, cfg.gamma, cfg.dt)
    binning = windowed.bin_particles(grid, cfg.active_box, p.x, p.active)
    p = windowed.permute_to_slots(p, binning)
    act = p.active

    sf, offsets = shapefun_eval(cfg, grid, p)
    N, dN, mask = sf["N"], sf["dN"], sf["mask"] & act[:, None]
    eng = make_engine(cfg, grid, sf, offsets, mask)

    m_nodes = eng.p2g(N * p.mass[:, None])
    m_safe = jnp.maximum(m_nodes, cfg.mass_tol)[:, None]
    has_mass = (m_nodes > cfg.mass_tol)[:, None]

    def project(field_p):
        mom = (N * p.mass[:, None])[..., None] * field_p[:, None, :]
        return eng.p2g(mom) / m_safe

    Un_dt = project(p.v)
    Un_dt2 = project(p.a)
    if grid.dirichlet_mask is not None:
        free = has_mass & ~grid.dirichlet_mask
    else:
        free = has_mass
    vel_const_nodes = (nm.alpha_5 - 1.0) * Un_dt + nm.alpha_6 * Un_dt2
    grad_vel_const = kin.disp_gradient(eng.edge_gather(vel_const_nodes), dN)

    def fi_of_grad(grad_du):
        DF = grad_du + jnp.eye(d, dtype=grad_du.dtype)
        F_n1 = tn.bmm(DF, p.F)
        dt_DF = nm.alpha_4 * grad_du + grad_vel_const
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
        tau_eff = cs.tau * (1.0 - p.damage)[:, None, None]
        dN1 = kin.push_forward_dN(dN, DF)
        return jnp.einsum("pij,pkj->pki", tau_eff * p.vol0[:, None, None], dN1)

    if dU is None:
        grad0 = jnp.zeros_like(p.F)
    else:
        grad0 = kin.disp_gradient(eng.edge_gather(dU), dN)
    H = edge_force_jacobian(fi_of_grad, grad0)
    A = bsr.assemble(H, dN, mask, cfg.active_box, grid, offsets)
    if not cfg.quasi_static:
        A = bsr.add_diagonal(A, nm.alpha_1 * m_nodes)
    A = bsr.apply_dof_masks(A, free)
    return A, dict(free=free, m_nodes=m_nodes, binning=binning)


def run(
    p: Particles,
    grid: Grid,
    mats: MaterialTable,
    cfg: ImplicitConfig,
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
        pp, dg = implicit_step(pp, grid, mats, cfg, body_accel)
        return pp, (dg["newton_iters"], dg["newton_residual"])

    p_final, (iters, rnorm) = jax.lax.scan(body, p, None, length=n_steps)
    return p_final, dict(newton_iters=iters, newton_residual=rnorm)
