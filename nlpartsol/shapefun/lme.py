"""Local Maximum-Entropy (LME) shape functions — batched, branch-free.

Re-design of /root/reference/nl-partsol/src/Nodes/LME.c:

* basis        p_a ∝ exp(−β‖l_a‖² + λ·l_a), Z-normalised       (LME.c:700-737)
* λ solved per particle by Newton on r = ∇_λ log Z with Hessian
  J = Σ p l⊗l − r⊗r                                            (LME.c:272-353,766,795)
* gradient     ∇p_a = −p_a J⁻¹ l_a                              (LME.c:836-891)
* β = γ/h²                                                      (LME.c:177-185)
* support radius R = sqrt(−ln(tol_zero)/β)                      (LME.c:1019-1099)

Differences from the reference, by design:
* One fused batched evaluation per step producing N, ∇N, and the padded
  CSR pattern at once (the reference recomputes N/∇N with fresh mallocs at
  every one of ~6 call sites per step, SURVEY.md §3.4).
* λ-Newton is a fixed-bound masked iteration (vmappable; no data-dependent
  aborts).  Near-singular Hessians are Tikhonov-damped instead of calling
  exit() (LME.c:308-313) — the damping vanishes for well-posed supports.
* λ is warm-started from the previous step via ``Particles.lme_lambda``
  (the reference persists ``MPM_Mesh.lambda`` the same way).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from .. import config
from ..ops import tensor as tn
from ..types import Grid
from .window import window_nodes, window_offsets


@struct.dataclass
class LMEParams:
    gamma: float = struct.field(pytree_node=False, default=3.0)
    tol_zero: float = struct.field(pytree_node=False, default=1e-10)
    max_iter: int = struct.field(pytree_node=False, default=10)
    # λ-Newton tolerance on ‖r‖ relative to the support radius.  The
    # reference's TOL_wrapper_LME is absolute in f64; 1e-6 relative is the
    # practical float32 floor (r = Σp·l is O(radius)·O(eps_f32) at best).
    tol_lambda: float = struct.field(pytree_node=False, default=1e-6)
    # λ-solver wrapper (GramsShapeFun wrapper=, Read_GramsShapeFun.c:84-190):
    # 'Newton-Raphson' — plain damped Newton (LME.c:272-353);
    # 'Nelder-Mead'    — the reference's derivative-free fallback
    #   (LME.c:357-672) re-expressed as a vmappable guarded mode: the Newton
    #   step is clamped to a trust region of the support radius and the
    #   iteration cap doubles, which recovers the robustness the reference
    #   gets from the simplex search without data-dependent host control.
    wrapper: str = struct.field(pytree_node=False, default="Newton-Raphson")


def beta_of(params: LMEParams, h: float) -> float:
    """β = γ/h² (beta__LME__, LME.c:177-185)."""
    return params.gamma / (h * h)


def support_radius(params: LMEParams, h: float) -> float:
    """R = sqrt(−ln(tol_zero)/β) (tributary__LME__, LME.c:1019)."""
    return math.sqrt(-math.log(params.tol_zero) / beta_of(params, h))


def window_halfwidth(params: LMEParams, h: float) -> int:
    return int(math.ceil(support_radius(params, h) / h))


def offsets_for(dim: int, params: LMEParams) -> np.ndarray:
    w = window_halfwidth(params, 1.0)  # R/h is h-independent
    return window_offsets(dim, -w, w)


def _masked_softmax(f: jax.Array, mask: jax.Array):
    """Softmax over the K axis restricted to valid entries."""
    neg = jnp.asarray(-1e30, f.dtype)
    f = jnp.where(mask, f, neg)
    fmax = jnp.max(f, axis=-1, keepdims=True)
    e = jnp.where(mask, jnp.exp(f - fmax), 0.0)
    z = jnp.sum(e, axis=-1, keepdims=True)
    return e / z


def _r_and_J(p: jax.Array, rel: jax.Array):
    """Gradient r = Σ p l and Hessian J = Σ p l⊗l − r⊗r of log Z
    (r__LME__/J__LME__, LME.c:766,795)."""
    r = jnp.einsum("...k,...ki->...i", p, rel)
    J = jnp.einsum("...k,...ki,...kj->...ij", p, rel, rel) - r[..., :, None] * r[
        ..., None, :
    ]
    return r, J


def _safe_solve(J: jax.Array, r: jax.Array):
    """Solve J x = r with Tikhonov damping when J is near-singular
    (replaces the rcond<1e-8 abort at LME.c:308-313)."""
    d = J.shape[-1]
    trJ = tn.trace(J)
    eps = (1e-10 * jnp.maximum(trJ, 1e-30))[..., None, None] * jnp.eye(d, dtype=J.dtype)
    Jd = J + eps
    return jnp.einsum("...ij,...j->...i", tn.inv(Jd), r)


def solve_lambda(
    rel: jax.Array, mask: jax.Array, lam0: jax.Array, beta: float, params: LMEParams
):
    """Newton iteration on λ (``__lambda_Newton_Rapson``, LME.c:272-353),
    batched over particles with per-particle convergence masking.

    Args:
      rel:  (Np, K, d) l = x_p − x_a.
      mask: (Np, K) valid-support mask.
      lam0: (Np, d) warm start.
    Returns:
      lam:  (Np, d) converged multipliers.
    """
    sq = jnp.sum(rel * rel, axis=-1)  # (Np, K)
    # convergence scale: r is O(h)-sized; tol relative to support radius
    scale = jnp.sqrt(jnp.maximum(jnp.max(sq, axis=-1, where=mask, initial=0.0), 1e-30))
    live = jnp.any(mask, axis=-1)

    wrapper = params.wrapper.lower().replace("_", "-")
    if wrapper not in ("newton-raphson", "nelder-mead"):
        raise ValueError(
            f"unknown LME wrapper '{params.wrapper}' "
            "(expected 'Newton-Raphson' or 'Nelder-Mead')"
        )
    guarded = wrapper == "nelder-mead"
    max_iter = params.max_iter * (2 if guarded else 1)

    def f_of(lam):
        return -beta * sq + jnp.einsum("...i,...ki->...k", lam, rel)

    def step(lam):
        p = _masked_softmax(f_of(lam), mask)
        r, J = _r_and_J(p, rel)
        dlam = _safe_solve(J, r)
        if guarded:
            # trust-region clamp ‖Δλ‖ ≤ 4β·scale — the vmappable analog of
            # the reference's Nelder-Mead fallback (LME.c:357-672): never
            # take a step larger than the kernel's own curvature scale
            cap = 4.0 * beta * scale
            nrm = jnp.linalg.norm(dlam, axis=-1)
            fac = jnp.minimum(1.0, cap / jnp.maximum(nrm, 1e-30))
            dlam = dlam * fac[..., None]
        # a row with no node in its support (an empty slot) has nothing to
        # solve: it counts as converged and keeps its λ, so it neither turns
        # to NaN nor holds off the all-converged early exit
        conv = (jnp.linalg.norm(r, axis=-1) <= params.tol_lambda * scale) | ~live
        return jnp.where(conv[..., None], lam, lam - dlam), jnp.all(conv)

    # while_loop with a global all-converged early exit: the warm-started λ
    # (persisted across steps, as the reference persists MPM_Mesh.lambda)
    # makes 1-2 iterations the steady-state cost instead of max_iter
    def cond(state):
        lam, done, it = state
        return (~done) & (it < max_iter)

    def body(state):
        lam, _, it = state
        lam, all_conv = step(lam)
        return (lam, all_conv, it + 1)

    from ..ops.vma import vary_like

    # done/it enter with lam0's shard_map varying type: the body derives
    # them from device-local λ, and VMA-checked lowering requires carry
    # types to be loop-invariant (ops/vma.py; no collectives inside, so a
    # device-varying trip count is legal SPMD)
    init = (lam0, vary_like(jnp.asarray(False), lam0),
            vary_like(jnp.asarray(0), lam0))
    lam, _, _ = jax.lax.while_loop(cond, body, init)
    return lam


def evaluate(grid: Grid, x: jax.Array, lam0: jax.Array, params: LMEParams):
    """Fused local search + λ solve + N + ∇N (one call per step).

    Returns dict with:
      node_ids: (Np, K) int32 flat node ids
      N:        (Np, K) shape-function values (0 on masked entries)
      dN:       (Np, K, d) spatial gradients
      mask:     (Np, K) support mask
      lam:      (Np, d) converged λ (persist as warm start)
    """
    h = grid.spacing
    beta = beta_of(params, h)
    r_sup = support_radius(params, h)
    offs = offsets_for(grid.dim, params)
    node_ids, rel, inb = window_nodes(grid, x, offs)
    sq = jnp.sum(rel * rel, axis=-1)
    mask = inb & (sq <= r_sup * r_sup)

    lam = solve_lambda(rel, mask, lam0, beta, params)

    f = -beta * sq + jnp.einsum("pi,pki->pk", lam, rel)
    N = _masked_softmax(f, mask)
    r, J = _r_and_J(N, rel)
    Jinv = tn.inv(J + 1e-10 * tn.trace(J)[..., None, None] * jnp.eye(grid.dim, dtype=J.dtype))
    # ∇p_a = −p_a J⁻¹ (l_a − r).  The reference uses −p_a J⁻¹ l_a
    # (dp__LME__, LME.c:836-891), identical at exact convergence (r = 0); the
    # −r correction makes Σ_a ∇p_a = 0 and Σ_a ∇p_a ⊗ x_a = I hold *exactly*
    # at any finite λ tolerance — essential in float32.
    dN = -N[..., None] * jnp.einsum("pij,pkj->pki", Jinv, rel - r[:, None, :])
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=lam)
