"""Particle kinematics kernels (reference src/Particles/compute-Strains.c).

All batched over particles; nodal values arrive as per-edge arrays from the
transfer engine (ops/transfer.py), so these are pure per-particle tensor
algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import tensor as tn


def disp_gradient(edge_vals: jax.Array, dN: jax.Array) -> jax.Array:
    """Σ_A u_A ⊗ ∇N_A from per-edge nodal values (Np, K, d) and gradients
    (Np, K, d) → (Np, d, d)."""
    return jnp.einsum("pki,pkj->pij", edge_vals, dN)


def incremental_deformation_gradient(du_edges, dN) -> jax.Array:
    """ΔF = I + Σ_A Δu_A ⊗ ∇N_A (update_increment_Deformation_Gradient__
    Particles__, compute-Strains.c:20-43)."""
    g = disp_gradient(du_edges, dN)
    d = dN.shape[-1]
    return g + jnp.eye(d, dtype=g.dtype)


def rate_deformation_gradient_n1(dt_DF, F_n, DF, dFdt_n):
    """Ḟ_{n+1} = (dΔF/dt)·F_n + ΔF·Ḟ_n (compute-Strains.c:176-209)."""
    return tn.bmm(dt_DF, F_n) + tn.bmm(DF, dFdt_n)


def push_forward_dN(dN, DF):
    """∇N^{n+1} = ΔF^{-T} ∇N^n per particle
    (push_forward_dN__MeshTools__, Shape-Functions.c:405-449).

    dN: (Np, K, d); DF: (Np, d, d) → (Np, K, d).
    """
    DF_invT = tn.inv_transpose(DF)
    return jnp.einsum("pij,pkj->pki", DF_invT, dN)


def cell_patch_jacobian(box, J_n, J_n1, vol0, active):
    """Patch ΔJ = Σ_cell(J_{n+1}·V0)/Σ_cell(J_n·V0) broadcast back to slots
    (reference patch volumes, U-Newmark-beta.c:1146-1195; here the windowed
    slot layout makes the cell the natural patch)."""
    nc = box.n_cells
    vn = (jnp.where(active, J_n * vol0, 0.0)).reshape(box.capacity, nc).sum(0)
    vn1 = (jnp.where(active, J_n1 * vol0, 0.0)).reshape(box.capacity, nc).sum(0)
    ratio = vn1 / jnp.maximum(vn, 1e-30)
    ratio = jnp.where(vn > 0, ratio, 1.0)
    return jnp.tile(ratio, box.capacity)


def fbar_deformation_gradient(F_n1, J_n1, DJ_patch, alpha_fbar):
    """Locking-free F-bar blend
    (get_locking_free_Deformation_Gradient_n1__Particles__,
    compute-Strains.c:109-174): scale F by (J_patch/J)^{1/d} blended by α."""
    d = F_n1.shape[-1]
    ratio = jnp.maximum(DJ_patch / jnp.maximum(J_n1, 1e-12), 1e-12)
    scale = ratio ** (1.0 / d)
    Fbar = scale[..., None, None] * F_n1
    return alpha_fbar[..., None, None] * Fbar + (1.0 - alpha_fbar)[..., None, None] * F_n1
