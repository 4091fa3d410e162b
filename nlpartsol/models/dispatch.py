"""Constitutive dispatch.

Replaces the per-particle string dispatch of
``Stress_integration__Constitutive__``
(/root/reference/nl-partsol/src/Constitutive/Constitutive.c:18-255) with a
static loop over the *model kinds present in the material table*: each model
runs batched over all particles and the results are blended with masks.  For
the usual 1–2 material case this is cheaper than per-particle branching
(no divergence between particles, one fused elementwise pass per model).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import hyperelastic, materials as M
from .fluid import bingham_fluid, newtonian_fluid
from .vonmises import von_mises
from .druckerprager import drucker_prager
from .borja import borja_frictional


class StressState(NamedTuple):
    """Per-particle constitutive state (in/out).  The reference's
    ``State_Parameters`` view (Types.h:462-560)."""

    tau: jax.Array
    tau_zz: jax.Array
    bemi: jax.Array
    bemi_zz: jax.Array
    eps: jax.Array
    kappa: jax.Array
    back_stress: jax.Array
    W: jax.Array
    failed: jax.Array  # Drucker-Prager particle failure flag


def stress_integration(
    *,
    F_n1: jax.Array,  # (Np, d, d) total deformation gradient at n+1
    DF: jax.Array,  # (Np, d, d) incremental deformation gradient
    dFdt_n1: jax.Array,  # (Np, d, d) rate of F at n+1
    bemi: jax.Array,
    bemi_zz: jax.Array,
    eps: jax.Array,
    kappa: jax.Array,
    back_stress: jax.Array,
    mat_id: jax.Array,  # (Np,) int32
    mats: M.MaterialTable,
    kinds: tuple,  # static tuple of model codes present
) -> StressState:
    """Batched stress update for every particle."""

    def g(name):
        return getattr(mats, name)[mat_id]

    npart = F_n1.shape[0]
    dt = F_n1.dtype
    out = StressState(
        tau=jnp.zeros_like(F_n1),
        tau_zz=jnp.zeros_like(eps),
        bemi=bemi,
        bemi_zz=bemi_zz,
        eps=eps,
        kappa=kappa,
        back_stress=back_stress,
        W=jnp.zeros_like(eps),
        failed=jnp.zeros((npart,), bool),
    )

    kind_p = mats.kind[mat_id]

    def blend(out, sel, tau, tau_zz, W, **extra):
        sel1 = sel[:, None]
        sel2 = sel[:, None, None]
        upd = dict(
            tau=jnp.where(sel2, tau, out.tau),
            tau_zz=jnp.where(sel, tau_zz, out.tau_zz),
            W=jnp.where(sel, W, out.W),
        )
        for k, v in extra.items():
            cur = getattr(out, k)
            m = sel if v.ndim == 1 else (sel1 if v.ndim == 2 else sel2)
            upd[k] = jnp.where(m, v, cur)
        return out._replace(**upd)

    for kind in kinds:
        sel = kind_p == kind
        if kind == M.NEO_HOOKEAN:
            tau, tzz, W = hyperelastic.neo_hookean(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.SAINT_VENANT_KIRCHHOFF:
            tau, tzz, W = hyperelastic.saint_venant_kirchhoff(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.HENCKY:
            tau, tzz, W = hyperelastic.hencky(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.LINEAR_ELASTIC:
            tau, tzz, W = hyperelastic.linear_elastic(F_n1, g("E"), g("nu"))
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.MOONEY_RIVLIN:
            tau, tzz, W = hyperelastic.mooney_rivlin(
                F_n1, g("E"), g("nu"), g("mu1_mr"), g("mu2_mr")
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.BINGHAM_FLUID:
            tau, tzz, W = bingham_fluid(
                F_n1,
                dFdt_n1,
                p0=g("reference_pressure"),
                mu0=g("viscosity"),
                tau_y=g("kappa0"),
                m_pap=g("fluidity_param"),
                n=g("n_macdonald"),
                K=g("compressibility"),
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.NEWTONIAN_FLUID:
            tau, tzz, W = newtonian_fluid(
                F_n1,
                dFdt_n1,
                p0=g("reference_pressure"),
                mu=g("viscosity"),
                n=g("n_macdonald"),
                K=g("compressibility"),
            )
            out = blend(out, sel, tau, tzz, W)
        elif kind == M.VON_MISES:
            r = von_mises(
                bemi,
                bemi_zz,
                DF,
                eps,
                back_stress,
                E=g("E"),
                nu=g("nu"),
                sigma_y=g("kappa0"),
                H=g("hardening_modulus"),
                theta=g("theta_voce"),
                K0=g("K0_voce"),
                Kinf=g("Kinf_voce"),
                delta=g("delta_voce"),
            )
            out = blend(
                out,
                sel,
                r.tau,
                r.tau_zz,
                r.W,
                bemi=r.bemi,
                bemi_zz=r.bemi_zz,
                eps=r.eps,
                back_stress=r.back_stress,
            )
        elif kind == M.DRUCKER_PRAGER:
            r = drucker_prager(
                bemi,
                bemi_zz,
                DF,
                eps,
                kappa,
                E=g("E"),
                nu=g("nu"),
                kappa0=g("kappa0"),
                friction_angle=g("friction_angle"),
                dilatancy_angle=g("dilatancy_angle"),
                exponent_ortiz=g("exponent_ortiz"),
                plastic_strain_0=g("plastic_strain_0"),
                cohesion=g("cohesion"),
                J2_degradated=g("J2_degradated"),
            )
            out = blend(
                out,
                sel,
                r.tau,
                r.tau_zz,
                r.W,
                bemi=r.bemi,
                bemi_zz=r.bemi_zz,
                eps=r.eps,
                kappa=r.kappa,
                failed=r.failed,
            )
        elif kind in (M.MATSUOKA_NAKAI, M.LADE_DUNCAN, M.MODIFIED_LADE_DUNCAN):
            r = borja_frictional(
                bemi,
                bemi_zz,
                DF,
                eps,
                kappa,
                yield_kind={
                    M.MATSUOKA_NAKAI: "matsuoka-nakai",
                    M.LADE_DUNCAN: "lade-duncan",
                    M.MODIFIED_LADE_DUNCAN: "modified-lade-duncan",
                }[kind],
                pa=g("atmospheric_pressure"),
                E=g("E"),
                nu=g("nu"),
                m=g("m_frictional"),
                c0=g("c0_frictional"),
                phi=g("phi_frictional"),
                psi=g("psi_frictional"),
                a1=g("a1_borja"),
                a2=g("a2_borja"),
                a3=g("a3_borja"),
                alpha=g("alpha_borja"),
            )
            out = blend(
                out,
                sel,
                r.tau,
                r.tau_zz,
                r.W,
                bemi=r.bemi,
                bemi_zz=r.bemi_zz,
                eps=r.eps,
                kappa=r.kappa,
            )
        elif kind == M.SOLID_RIGID:
            # Rigid: zero stress, no state evolution.
            pass
        else:
            raise ValueError(f"unknown material kind: {kind}")

    return out
