"""From-scratch Krylov / Newton solvers (the PETSc-KSP/SNES replacement).

Replaces the reference's linear-solver surface (SURVEY.md §2.3):
``Conjugate_Gradient_Method`` (dense, MaxIter=25, src/Linear-Solvers/
Conjugate-Gradient.c:6), ``Jacobi_Conjugate_Gradient_Method``
(Jacobi-Conjugate-Gradient.c:3), the LAPACK LU fallback, and the PETSc
SNES+KSP+PCJACOBI stack embedded in U-Newmark-beta.c:270-356.

Design:
* operators are *functions* (matrix-free SpMV or assembled BSR apply) — CG
  never sees a matrix layout;
* fixed-shape ``lax.while_loop`` iterations, convergence by masked residual
  norms — jit/vmap/shard_map friendly;
* all reductions are plain ``jnp.sum``/``vdot`` so they lower to ``psum``
  under shard_map on a device mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    residual: jax.Array  # final ||r||


def _vdot(a, b):
    return jnp.sum(a * b)


def _make_vdot(axis_name):
    """Dot product, globally reduced over a shard_map axis when the vectors
    are grid-partitioned (halo sharding: each owned dof lives on exactly one
    device, ghost entries are zero — a psum of local dots is the global
    dot).  ``None`` = single-device / replicated semantics."""
    if axis_name is None:
        return _vdot

    def vd(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis_name)

    return vd


def dense_lu(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    free_mask: Optional[jax.Array] = None,
) -> CGResult:
    """Direct dense solve of the matrix-free operator (the reference's
    LAPACK ``dgetrs`` fallback, src/Linear-Solvers/dgetrs-LAPACK.c:14 and
    the dense NR paths of U-p/U-pw/DEM).

    Materialises the operator column-by-column (one vmapped application
    per basis vector) and LU-solves — O(n²) memory / O(n³) flops, for
    pathological tangents where Krylov stalls, or small strongly-coupled
    systems.  ``free_mask`` (same shape as b): rows/cols outside the mask
    get an identity diagonal (Dirichlet handling, the
    ``MatZeroRowsColumnsIS`` equivalent).
    """
    shape = b.shape
    n = b.size
    eye = jnp.eye(n, dtype=b.dtype)
    cols = jax.vmap(lambda e: A(e.reshape(shape)).reshape(-1), out_axes=1)(eye)
    if free_mask is not None:
        fm = free_mask.reshape(-1).astype(b.dtype)
        cols = cols * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
        b = b * free_mask.reshape(shape).astype(b.dtype)
    else:
        # operators restricted to a masked subspace (Dirichlet/inactive
        # dofs zeroed by the residual) produce structurally zero rows —
        # give those an identity diagonal so LU stays regular
        live = jnp.sum(jnp.abs(cols), axis=1) > 0.0
        cols = cols + jnp.diag((~live).astype(b.dtype))
    x = jnp.linalg.solve(cols, b.reshape(-1))
    r = b.reshape(-1) - (cols @ x)
    return CGResult(
        x=x.reshape(shape),
        iters=jnp.asarray(1),
        residual=jnp.sqrt(jnp.sum(r * r)),
    )


def pcg(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-7,
    atol: float = 0.0,
    maxiter: int = 100,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Preconditioned conjugate gradients on an SPD operator.

    Matches the reference's Jacobi-CG semantics
    (Jacobi-Conjugate-Gradient.c: relative tolerance on ||r||) but with a
    functional operator and fixed-bound while_loop.  With ``axis_name`` the
    vectors are grid-partitioned over that shard_map axis and all dot
    products are psum-reduced (distributed CG).
    """
    _vdot = _make_vdot(axis_name)
    if M_inv is None:
        M_inv = lambda r: r
    from .vma import vary_like

    x = vary_like(jnp.zeros_like(b), b) if x0 is None else x0

    r = b - A(x)
    z = M_inv(r)
    p = z
    rz = _vdot(r, z)
    bnorm = jnp.sqrt(_vdot(b, b))
    threshold = jnp.maximum(tol * bnorm, atol)

    def cond(state):
        x, r, p, rz, it = state
        return (jnp.sqrt(_vdot(r, r)) > threshold) & (it < maxiter)

    def body(state):
        x, r, p, rz, it = state
        Ap = A(p)
        pAp = _vdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0.0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    x, r, p, rz, it = jax.lax.while_loop(cond, body, (x, r, p, rz, jnp.array(0)))
    return CGResult(x=x, iters=it, residual=jnp.sqrt(_vdot(r, r)))


def bicgstab(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-7,
    atol: float = 0.0,
    maxiter: int = 200,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Preconditioned BiCGStab for general (nonsymmetric) operators.

    The reference solves its nonsymmetric mixed-formulation tangents with a
    dense LAPACK LU each Newton iteration (U-pw-Newmark-beta.c:2238-2285,
    U-p-Newmark-beta.c:1580); this is the matrix-free iterative equivalent
    (and the stand-in for PETSc's default KSP on nonsymmetric systems).
    Fixed-shape ``lax.while_loop`` — jit/shard_map friendly.
    """
    _vdot = _make_vdot(axis_name)
    if M_inv is None:
        M_inv = lambda r: r
    from .vma import vary_like

    x = vary_like(jnp.zeros_like(b), b) if x0 is None else x0

    r = b - A(x)
    r_hat = r  # shadow residual
    bnorm = jnp.sqrt(_vdot(b, b))
    threshold = jnp.maximum(tol * bnorm, atol)
    one = jnp.ones((), b.dtype)
    rho = one
    alpha = one
    omega = one
    v = vary_like(jnp.zeros_like(b), b)
    p = vary_like(jnp.zeros_like(b), b)

    def _safe(x):
        return jnp.where(x == 0.0, jnp.finfo(b.dtype).tiny, x)

    def cond(state):
        x, r, p, v, rho, alpha, omega, it = state
        return (jnp.sqrt(_vdot(r, r)) > threshold) & (it < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, it = state
        rho_new = _vdot(r_hat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = r + beta * (p - omega * v)
        p_hat = M_inv(p)
        v = A(p_hat)
        alpha = rho_new / _safe(_vdot(r_hat, v))
        s = r - alpha * v
        s_hat = M_inv(s)
        t = A(s_hat)
        tt = _vdot(t, t)
        omega = _vdot(t, s) / _safe(tt)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    x, r, p, v, rho, alpha, omega, it = jax.lax.while_loop(
        cond, body, (x, r, p, v, rho, alpha, omega, jnp.array(0))
    )
    return CGResult(x=x, iters=it, residual=jnp.sqrt(_vdot(r, r)))


def gmres(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-7,
    atol: float = 0.0,
    restart: int = 20,
    max_cycles: int = 10,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Restarted GMRES(m) with right preconditioning and Givens rotations.

    Matrix-free stand-in for PETSc KSP (``krylov_PETSC``,
    src/Linear-Solvers/ksp-PETSC.c:5-97) on general operators.  The Arnoldi
    basis has static size ``restart`` (padded; converged columns are masked),
    so the whole solver jits with fixed shapes.
    """
    _vdot = _make_vdot(axis_name)
    if M_inv is None:
        M_inv = lambda r: r
    from .vma import vary_like

    x = vary_like(jnp.zeros_like(b), b) if x0 is None else x0
    shape = b.shape
    n = b.size
    m = restart
    dt = b.dtype
    bnorm = jnp.sqrt(_vdot(b, b))
    threshold = jnp.maximum(tol * bnorm, atol)

    def _safe(v):
        return jnp.where(v == 0.0, jnp.finfo(dt).tiny, v)

    def _gsum(v):
        return v if axis_name is None else jax.lax.psum(v, axis_name)

    def cycle(x):
        r = (b - A(x)).reshape(n)
        beta0 = jnp.sqrt(_gsum(jnp.sum(r * r)))
        V = jnp.zeros((m + 1, n), dt).at[0].set(r / _safe(beta0))
        H = jnp.zeros((m + 1, m), dt)
        cs = jnp.zeros((m,), dt)
        sn = jnp.zeros((m,), dt)
        g = jnp.zeros((m + 1,), dt).at[0].set(beta0)

        def arnoldi(j, carry):
            V, H, cs, sn, g = carry
            w = A(M_inv(V[j].reshape(shape))).reshape(n)
            # modified Gram-Schmidt against all m+1 rows (rows > j are zero)
            h = _gsum(V @ w)  # (m+1,)
            mask = jnp.arange(m + 1) <= j
            h = jnp.where(mask, h, 0.0)
            w = w - h @ V
            h_next = jnp.sqrt(_gsum(jnp.sum(w * w)))
            V = V.at[j + 1].set(w / _safe(h_next))
            col = h.at[j + 1].set(h_next)
            # apply previous Givens rotations to the new column
            def rot(i, col):
                ci, si = cs[i], sn[i]
                hi, hi1 = col[i], col[i + 1]
                col = col.at[i].set(ci * hi + si * hi1)
                col = col.at[i + 1].set(-si * hi + ci * hi1)
                return col

            col = jax.lax.fori_loop(0, j, rot, col)
            denom = _safe(jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2))
            cj = col[j] / denom
            sj = col[j + 1] / denom
            col = col.at[j].set(cj * col[j] + sj * col[j + 1]).at[j + 1].set(0.0)
            cs = cs.at[j].set(cj)
            sn = sn.at[j].set(sj)
            g = g.at[j + 1].set(-sj * g[j])
            g = g.at[j].set(cj * g[j])
            H = H.at[:, j].set(col)
            return (V, H, cs, sn, g)

        V, H, cs, sn, g = jax.lax.fori_loop(0, m, arnoldi, (V, H, cs, sn, g))
        # back-substitution on the (m, m) upper-triangular H (rows may be
        # zero for breakdown columns; guard the diagonal)
        R = H[:m, :]
        y = jnp.zeros((m,), dt)

        def back(i_rev, y):
            i = m - 1 - i_rev
            s = g[i] - jnp.sum(R[i] * y)
            return y.at[i].set(s / _safe(R[i, i]))

        y = jax.lax.fori_loop(0, m, back, y)
        dx = M_inv((y @ V[:m]).reshape(shape))
        return x + dx

    def cond(state):
        x, it = state
        r = b - A(x)
        return (jnp.sqrt(_vdot(r, r)) > threshold) & (it < max_cycles)

    def body(state):
        x, it = state
        return (cycle(x), it + 1)

    x, it = jax.lax.while_loop(cond, body, (x, jnp.array(0)))
    r = b - A(x)
    return CGResult(x=x, iters=it * m, residual=jnp.sqrt(_vdot(r, r)))


class NewtonResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    residual_norm: jax.Array
    converged: jax.Array
    linear_iters: jax.Array = None  # total inner (CG/Krylov) iterations


def newton_krylov(
    residual: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    tol: float = 1e-5,
    maxiter: int = 20,
    cg_tol: float = 1e-7,
    cg_maxiter: int = 100,
    linear: str = "cg",
    axis_name: Optional[str] = None,
    forcing: str = "ew",
    threshold_mode: str = "abs1",
) -> NewtonResult:
    """Newton's method with matrix-free Jacobian-vector products.

    The Jacobian action J·v is computed by forward-mode AD through the
    residual (jax.jvp) — the *exact consistent tangent* for every
    constitutive model, with no hand-assembled stiffness densities
    (replaces __jacobian_evaluation, U-Newmark-beta.c:1646-1830).

    Convergence: ||R|| <= tol * max(1, ||R_0||)  (the reference's SNES rtol
    semantics, U-Newmark-beta.c:336-343).  ``axis_name``: grid-partitioned
    vectors over that shard_map axis (all norms/dots psum-reduced).

    ``forcing``: inner-solve tolerance strategy.
      * ``'ew'`` (default) — Eisenstat–Walker choice 2: the k-th linear
        solve runs to η_k = 0.9·(‖R_k‖/‖R_{k-1}‖)², safeguarded by
        η ≥ 0.9·η_{k-1}² while that exceeds 0.1 and clipped to
        [cg_tol, 0.5].  Early Newton iterations stop the Krylov solve as
        soon as it can't improve the *nonlinear* residual — the classic
        inexact-Newton economy the reference's fixed-tol PCJACOBI KSP
        (U-Newmark-beta.c:326-335) leaves on the table.
      * ``'fixed'`` — every inner solve runs to ``cg_tol`` (the reference
        KSP behaviour).
    Diagnostics: ``linear_iters`` totals the inner iterations across the
    Newton loop (the per-step `KSP iterations` count of --Print-Convergence).
    """
    _vdot = _make_vdot(axis_name)

    r0 = residual(x0)
    # VMA typing (ops/vma.py): a literal x0 is unvarying but the Newton
    # update derives from the device-varying residual — promote so the
    # while_loop carry type is loop-invariant under shard_map
    from .vma import vary_like

    x0 = vary_like(x0, r0)
    r0_norm = jnp.sqrt(_vdot(r0, r0))
    # ``threshold_mode``: 'abs1' (default) = tol·max(1, ‖R₀‖), the
    # reference's SNES rtol semantics for raw (dimensional) residuals whose
    # magnitudes are ≫ 1.  'rel' = tol·‖R₀‖, for nondimensionalised
    # residuals (up/upw monolithic rows) where ‖R₀‖ ≤ 1 would otherwise
    # turn tol into a too-loose absolute test that accepts x₀ unsolved.
    if threshold_mode == "rel":
        threshold = tol * r0_norm
    else:
        threshold = tol * jnp.maximum(1.0, r0_norm)
    # Float32 noise floor: P2G reductions accumulate O(100s·eps) of relative
    # error, so ||R|| plateaus around ~1e3·eps·||R_0|| no matter how many
    # Newton iterations run (the reference's 1e-5 TOL assumes f64).  Detect
    # stagnation and accept if the residual dropped by >100x.
    eps = jnp.finfo(r0.dtype).eps
    eta0 = jnp.asarray(0.1 if forcing == "ew" else cg_tol, r0.dtype)

    def cond(state):
        x, r, rnorm, best, stall_count, it, lin, eta, rprev = state
        return (rnorm > threshold) & (it < maxiter) & (stall_count < 3)

    def body(state):
        x, r, rnorm, best, stall_count, it, lin, eta, rprev = state

        def Jv(v):
            return jax.jvp(residual, (x,), (v,))[1]

        if linear == "dense":
            res_lin = dense_lu(Jv, -r)
        elif linear == "bicgstab":
            res_lin = bicgstab(
                Jv, -r, M_inv=M_inv, tol=eta, maxiter=cg_maxiter,
                axis_name=axis_name,
            )
        elif linear == "gmres":
            res_lin = gmres(
                Jv, -r, M_inv=M_inv, tol=eta,
                max_cycles=max(1, cg_maxiter // 20), axis_name=axis_name,
            )
        else:
            res_lin = pcg(
                Jv, -r, M_inv=M_inv, tol=eta, maxiter=cg_maxiter,
                axis_name=axis_name,
            )
        dx = res_lin.x

        # Backtracking line search (the reference's SNESNEWTONLS,
        # U-Newmark-beta.c:281): evaluate a fixed candidate set and keep the
        # step with the smallest residual — branch-free, jit-stable.
        def eval_alpha(alpha):
            r_a = residual(x + alpha * dx)
            return jnp.sqrt(_vdot(r_a, r_a))

        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625], dx.dtype)
        norms = jnp.stack([eval_alpha(a) for a in [1.0, 0.5, 0.25, 0.0625]])
        k = jnp.argmin(norms)
        x_new = x + alphas[k] * dx
        r_new = residual(x_new)
        rnorm_new = norms[k]
        improved = rnorm_new < 0.5 * best
        stall_count = jnp.where(improved, 0, stall_count + 1)
        best = jnp.minimum(best, rnorm_new)
        if forcing == "ew":
            # Eisenstat–Walker choice 2 (γ=0.9, α=2) with the η_{k-1}²
            # oscillation safeguard, clipped to [cg_tol, 0.5]
            eta_cand = 0.9 * (rnorm_new / jnp.maximum(rnorm, 1e-30)) ** 2
            guard = 0.9 * eta * eta
            eta_cand = jnp.where(guard > 0.1, jnp.maximum(eta_cand, guard), eta_cand)
            eta_new = jnp.clip(eta_cand, cg_tol, 0.5)
        else:
            eta_new = eta
        return (x_new, r_new, rnorm_new, best, stall_count, it + 1,
                lin + res_lin.iters, eta_new, rnorm)

    x, r, rnorm, best, stall_count, it, lin, _, _ = jax.lax.while_loop(
        cond, body,
        (x0, r0, r0_norm, r0_norm, jnp.array(0), jnp.array(0), jnp.array(0),
         eta0, r0_norm),
    )
    converged = (rnorm <= threshold) | (
        (stall_count >= 3) & (rnorm <= 1e-2 * r0_norm)
    )
    return NewtonResult(
        x=x, iters=it, residual_norm=rnorm, converged=converged,
        linear_iters=lin,
    )
