"""Batched small-tensor algebra ("matcore").

Replacement for the reference's Matlib layer
(/root/reference/nl-partsol/src/Matlib/TensorLib.c: invariants at :113-170,
LAPACK ``dsyev`` eigen at :172, inverse/adjunct at :748/:829).  Instead of
per-particle malloc'd 2x2/3x3 ops with LAPACK calls, everything here is a
closed-form, branch-free function on arrays of shape ``(..., d, d)`` that
vmaps/fuses into the surrounding elementwise code.

All functions support d in {2, 3} with static dispatch on the trailing shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "identity_like",
    "trace",
    "det",
    "adj",
    "inv",
    "inv_transpose",
    "I1",
    "I2",
    "I3",
    "sym",
    "dev",
    "norm_fro",
    "sym_eig",
    "sym_from_eig",
    "sym_func",
]


def identity_like(a: jax.Array) -> jax.Array:
    d = a.shape[-1]
    return jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)


def trace(a: jax.Array) -> jax.Array:
    return jnp.trace(a, axis1=-2, axis2=-1)


def det(a: jax.Array) -> jax.Array:
    """Determinant of (..., d, d), closed form for d=2,3."""
    d = a.shape[-1]
    if d == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    if d == 3:
        return (
            a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
        )
    raise ValueError(f"det: unsupported dim {d}")


def adj(a: jax.Array) -> jax.Array:
    """Adjugate (transpose of cofactor matrix): inv(a) = adj(a)/det(a)."""
    d = a.shape[-1]
    if d == 2:
        row0 = jnp.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1)
        row1 = jnp.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    if d == 3:
        c = jnp.empty(a.shape, a.dtype)

        def cof(i1, i2, j1, j2):
            return a[..., i1, j1] * a[..., i2, j2] - a[..., i1, j2] * a[..., i2, j1]

        rows = [
            jnp.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], axis=-1),
            jnp.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], axis=-1),
            jnp.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], axis=-1),
        ]
        del c
        return jnp.stack(rows, axis=-2)
    raise ValueError(f"adj: unsupported dim {d}")


def inv(a: jax.Array) -> jax.Array:
    return adj(a) / det(a)[..., None, None]


def inv_transpose(a: jax.Array) -> jax.Array:
    """a^{-T}: the push-forward operator for shape-function gradients
    (reference: compute_adjunt + push_forward_dN, Shape-Functions.c:405)."""
    return jnp.swapaxes(inv(a), -1, -2)


def I1(a: jax.Array) -> jax.Array:
    return trace(a)


def I2(a: jax.Array) -> jax.Array:
    t = trace(a)
    return 0.5 * (t * t - trace(bmm(a, a)))


def I3(a: jax.Array) -> jax.Array:
    return det(a)


def sym(a: jax.Array) -> jax.Array:
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def dev(a: jax.Array) -> jax.Array:
    d = a.shape[-1]
    return a - (trace(a) / d)[..., None, None] * jnp.eye(d, dtype=a.dtype)


def norm_fro(a: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(a * a, axis=(-2, -1)))


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition, closed-form 2x2 / Jacobi 3x3
# (replaces LAPACK dsyev in sym_eigen_analysis__TensorLib__, TensorLib.c:172)
# ---------------------------------------------------------------------------


def _sym_eig2(a: jax.Array):
    a00, a01, a11 = a[..., 0, 0], 0.5 * (a[..., 0, 1] + a[..., 1, 0]), a[..., 1, 1]
    tr_half = 0.5 * (a00 + a11)
    diff_half = 0.5 * (a00 - a11)
    rad = jnp.sqrt(diff_half * diff_half + a01 * a01)
    w0 = tr_half - rad
    w1 = tr_half + rad
    # Eigenvector for w1: (a01, w1 - a00) or (w1 - a11, a01); pick stabler.
    use_first = jnp.abs(diff_half) <= 0.0  # tie-break handled by norm guard below
    v1x = jnp.where(a01 == 0.0, jnp.where(a00 >= a11, 1.0, 0.0), a01)
    v1y = jnp.where(a01 == 0.0, jnp.where(a00 >= a11, 0.0, 1.0), w1 - a00)
    del use_first
    n1 = jnp.sqrt(v1x * v1x + v1y * v1y)
    v1x, v1y = v1x / n1, v1y / n1
    # v0 orthogonal to v1
    v0x, v0y = -v1y, v1x
    w = jnp.stack([w0, w1], axis=-1)
    v = jnp.stack(
        [jnp.stack([v0x, v1x], axis=-1), jnp.stack([v0y, v1y], axis=-1)], axis=-2
    )
    return w, v


def _sym_eig3_jacobi(a: jax.Array, sweeps: int = 8):
    """Cyclic Jacobi for symmetric 3x3; branch-free, vmappable.

    Returns eigenvalues ascending and the matrix of column eigenvectors.
    """
    dt = a.dtype
    A = sym(a)
    V = identity_like(A)

    def rotate(AV, pq):
        A, V = AV
        p, q = pq
        apq = A[..., p, q]
        app = A[..., p, p]
        aqq = A[..., q, q]
        # Stable Jacobi rotation angle
        tau = (aqq - app) / (2.0 * jnp.where(apq == 0.0, 1.0, apq))
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        t = jnp.where(apq == 0.0, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        # Build rotation matrix G (identity with c,s in p,q slots)
        G = identity_like(A)
        G = G.at[..., p, p].set(c)
        G = G.at[..., q, q].set(c)
        G = G.at[..., p, q].set(s)
        G = G.at[..., q, p].set(-s)
        A = bmm(jnp.swapaxes(G, -1, -2), bmm(A, G))
        V = bmm(V, G)
        return (A, V)

    pairs = [(0, 1), (0, 2), (1, 2)]
    for _ in range(sweeps):
        for pq in pairs:
            A, V = rotate((A, V), pq)

    w = jnp.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], axis=-1)
    # sort ascending
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w.astype(dt), V.astype(dt)


def sym_eig(a: jax.Array):
    """Eigendecomposition of a symmetric (..., d, d) tensor.

    Returns ``(w, V)`` with eigenvalues ascending and eigenvectors as columns
    of V, i.e. ``a ≈ V @ diag(w) @ V.T``.
    """
    d = a.shape[-1]
    if d == 2:
        return _sym_eig2(a)
    if d == 3:
        return _sym_eig3_jacobi(a)
    raise ValueError(f"sym_eig: unsupported dim {d}")


def sym_from_eig(w: jax.Array, V: jax.Array) -> jax.Array:
    """Rebuild a symmetric tensor from eigenvalues/eigenvectors."""
    return bmm_t(V * w[..., None, :], V)


def sym_func(a: jax.Array, fn) -> jax.Array:
    """Apply a scalar function to a symmetric tensor through its spectrum
    (e.g. ``sym_func(b_e, jnp.log)`` for Hencky strain)."""
    w, V = sym_eig(a)
    return sym_from_eig(fn(w), V)


# ---------------------------------------------------------------------------
# Cancellation-free small-strain primitives.
#
# In float32 (the production dtype) quantities like det(F)−1, b−I and
# ln(J) lose all significance when F ≈ I: 500.025 − 499.975 in f32 keeps two
# digits.  Everything downstream therefore works with the displacement
# gradient A = F − I and these exact identities:
#   det(I+A) − 1 = I1(A) + I2(A) + I3(A)
#   (I+A)(I+A)ᵀ − I = A + Aᵀ + AAᵀ
#   x − log1p(x) = x²/2 − x³/3 + …   (series for small x)
# ---------------------------------------------------------------------------


def det_minus_one(a_disp: jax.Array) -> jax.Array:
    """det(I + A) − 1 computed without cancellation; A = F − I."""
    d = a_disp.shape[-1]
    if d == 2:
        return trace(a_disp) + det(a_disp)
    return I1(a_disp) + I2(a_disp) + I3(a_disp)


def bmi_from_disp_grad(a_disp: jax.Array) -> jax.Array:
    """b − I = A + Aᵀ + AAᵀ (left Cauchy-Green minus identity)."""
    return a_disp + jnp.swapaxes(a_disp, -1, -2) + bmm_t(a_disp, a_disp)


def cmi_from_disp_grad(a_disp: jax.Array) -> jax.Array:
    """C − I = A + Aᵀ + AᵀA (right Cauchy-Green minus identity)."""
    return a_disp + jnp.swapaxes(a_disp, -1, -2) + bmm(jnp.swapaxes(a_disp, -1, -2), a_disp)


def sub_log1p(x: jax.Array) -> jax.Array:
    """x − log1p(x), accurate for small x (≈ x²/2 − x³/3 + x⁴/4)."""
    small = jnp.abs(x) < 1e-2
    x_safe = jnp.where(small, 0.0, x)
    series = x * x * (0.5 + x * (-1.0 / 3.0 + x * (0.25 - 0.2 * x)))
    return jnp.where(small, series, x_safe - jnp.log1p(x_safe))


def bmm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched small-matrix product by unrolled channel arithmetic.

    ``a @ b`` over (..., d, d) would be a batch of 2×2/3×3 matrix
    products, far too small for a matrix unit.  Unrolling turns the
    product into d³ fused multiply-adds over the (...,) batch, which XLA
    fuses with its neighbours.
    """
    d = a.shape[-1]
    rows = []
    for i in range(d):
        row = []
        for j in range(d):
            s = a[..., i, 0] * b[..., 0, j]
            for k in range(1, d):
                s = s + a[..., i, k] * b[..., k, j]
            row.append(s)
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def bmm_t(a: jax.Array, b: jax.Array) -> jax.Array:
    """a @ bᵀ, unrolled (see bmm)."""
    d = a.shape[-1]
    rows = []
    for i in range(d):
        row = []
        for j in range(d):
            s = a[..., i, 0] * b[..., j, 0]
            for k in range(1, d):
                s = s + a[..., i, k] * b[..., j, k]
            row.append(s)
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def bmv(a: jax.Array, v: jax.Array) -> jax.Array:
    """Batched matrix·vector, unrolled (see bmm)."""
    d = a.shape[-1]
    return jnp.stack(
        [sum(a[..., i, k] * v[..., k] for k in range(d)) for i in range(d)],
        axis=-1,
    )
