"""Anisotropic LME (aLME) shape functions.

Reference: /root/reference/nl-partsol/src/Nodes/aLME.c — the LME basis with a
tensor-valued thermalisation parameter per particle:
  f_a = −l_aᵀ β l_a + λ·l_a                        (fa__aLME__, :382-405)
  β₀ = γ/h² · I                                    (initialize_beta__aLME__)
  β ← ΔF⁻ᵀ β ΔF⁻¹ per step (pull-back)             (update_beta__aLME__, :~430;
                                                    2D-only in the reference —
                                                    dim-generic here)
  support: elliptical cutoff l.C.l ≤ 1 with C₀ = γ/(−ln tol · h²) I,
  updated by the same pull-back (initialize_Cut_off_Ellipsoid__aLME__).

Because C₀ = β₀/(−ln tol) and the pull-back commutes with scalar scaling,
C ≡ β/(−ln tol) for all time — so the cutoff tensor is *derived*, not stored;
the particle state carries only β (``Particles.lme_beta``).

The λ-Newton, gradient formula and masked-softmax machinery are shared with
the isotropic LME module.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops import tensor as tn
from ..types import Grid
from .lme import LMEParams, _masked_softmax, _r_and_J, _safe_solve
from .window import window_nodes, window_offsets


@struct.dataclass
class ALMEParams:
    gamma: float = struct.field(pytree_node=False, default=3.0)
    tol_zero: float = struct.field(pytree_node=False, default=1e-10)
    max_iter: int = struct.field(pytree_node=False, default=10)
    tol_lambda: float = struct.field(pytree_node=False, default=1e-10)
    # static bound on support stretch (window halfwidth multiplier): the
    # elliptical support can grow as β is pulled back by deformation
    max_stretch: float = struct.field(pytree_node=False, default=1.5)


def beta0(params: ALMEParams, h: float, dim: int) -> np.ndarray:
    """Initial isotropic β = γ/h² · I (the LME value)."""
    return (params.gamma / (h * h)) * np.eye(dim, dtype=np.float32)


def init_lme_beta(n: int, params: ALMEParams, h: float, dim: int) -> jax.Array:
    return jnp.broadcast_to(jnp.asarray(beta0(params, h, dim)), (n, dim, dim))


def update_beta(beta_t: jax.Array, DF: jax.Array) -> jax.Array:
    """β ← ΔF⁻ᵀ β ΔF⁻¹ (update_beta__aLME__; dim-generic)."""
    DFinv = tn.inv(DF)
    return jnp.swapaxes(DFinv, -1, -2) @ beta_t @ DFinv


def window_halfwidth(params: ALMEParams) -> int:
    r_over_h = math.sqrt(-math.log(params.tol_zero) / params.gamma)
    return int(math.ceil(r_over_h * params.max_stretch))


def offsets_for(dim: int, params: ALMEParams) -> np.ndarray:
    w = window_halfwidth(params)
    return window_offsets(dim, -w, w)


def evaluate(grid: Grid, x: jax.Array, lam0: jax.Array, beta_t: jax.Array, params: ALMEParams):
    """Fused aLME local search + λ solve + N + ∇N.

    Args:
      beta_t: (Np, d, d) per-particle anisotropic β tensor.
    Same return contract as lme.evaluate.
    """
    offs = offsets_for(grid.dim, params)
    node_ids, rel, inb = window_nodes(grid, x, offs)
    # elliptical cutoff: l.C.l ≤ 1 with C = β / (−ln tol)
    lbl = jnp.einsum("pki,pij,pkj->pk", rel, beta_t, rel)
    cutoff = -math.log(params.tol_zero)
    mask = inb & (lbl <= cutoff)

    lam_params = LMEParams(
        gamma=params.gamma,
        tol_zero=params.tol_zero,
        max_iter=params.max_iter,
        tol_lambda=params.tol_lambda,
    )

    def f_of(lam):
        return -lbl + jnp.einsum("pi,pki->pk", lam, rel)

    def body(_, lam):
        p = _masked_softmax(f_of(lam), mask)
        r, J = _r_and_J(p, rel)
        dlam = _safe_solve(J, r)
        conv = jnp.linalg.norm(r, axis=-1) <= lam_params.tol_lambda
        return jnp.where(conv[..., None], lam, lam - dlam)

    lam = jax.lax.fori_loop(0, lam_params.max_iter, body, lam0)

    N = _masked_softmax(f_of(lam), mask)
    r, J = _r_and_J(N, rel)
    Jinv = tn.inv(
        J + 1e-10 * tn.trace(J)[..., None, None] * jnp.eye(grid.dim, dtype=J.dtype)
    )
    dN = -N[..., None] * jnp.einsum("pij,pkj->pki", Jinv, rel - r[:, None, :])
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=lam)
