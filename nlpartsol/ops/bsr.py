"""Banded block-sparse (BSR) tangent: assembly, SpMV, block-Jacobi.

The replacement for the reference's assembled PETSc AIJ tangent
(`MatCreateSeqAIJ` with a precomputed per-row-nnz sparsity pattern,
/root/reference/nl-partsol/src/Formulations/Displacements/
U-Newmark-beta.c:288-292 and the O(N²) dense occupancy builder
`__create_sparsity_pattern` :1568-1632, blocks scattered with
`MatSetValues ADD_VALUES` inside `omp critical` :1783-1789).

On the structured background grid the stencil "node pairs sharing ≥1
particle" is **banded by construction**: a particle in cell c touches nodes
c + off_i for the static window offsets off_i, so every nonzero block sits
at a column offset rel = off_j − off_i drawn from a *static* set of
R = |{off_j − off_i}| relative offsets.  The matrix is therefore stored as
a dense band

    band[node, r, :, :]   (n_nodes, R, d, d)

and both assembly and SpMV are pure static-slice dense ops — no sparsity
pattern build, no scatter, no `omp critical` equivalent.

Per-particle blocks come from the **exact consistent tangent by forward-mode
AD** of the internal-force integrand (see formulations/implicit.py:
`edge_force_jacobian`):

    H[p, A, i, l, m] = ∂ f_{A,i} / ∂ (∇du)_{l,m}      (per particle p)
    K_{AB}[i, l]     = Σ_m H[p, A, i, l, m] · ∇N_B[m]

replacing the reference's hand-derived per-model stiffness densities
(`stiffness_density__Constitutive__`, src/Constitutive/Constitutive.c:262)
— AD through the return mapping yields the algorithmically consistent
tangent for every material, including the plasticity branches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from ..types import Grid
from . import windowed
from .windowed import ActiveBox, _node_slices


def relative_offsets(offsets: np.ndarray):
    """Static set of pairwise offset differences off_j − off_i.

    Returns (rels (R, d) int array, pair_index (K, K) int array with
    pair_index[i, j] = r such that rels[r] = off_j − off_i).
    """
    offsets = np.asarray(offsets)
    K = offsets.shape[0]
    diffs = offsets[None, :, :] - offsets[:, None, :]  # (K, K, d) j − i
    flat = diffs.reshape(K * K, -1)
    rels, inverse = np.unique(flat, axis=0, return_inverse=True)
    return rels.astype(np.int64), inverse.reshape(K, K)


@struct.dataclass
class BandedBSR:
    """Banded block matrix over grid nodes: A[n, n + rel_r] = band[n, r]."""

    band: jax.Array  # (n_nodes, R, d, d)
    rels: tuple = struct.field(pytree_node=False)  # ((dr per axis), ...) len R
    grid_dims: tuple = struct.field(pytree_node=False)

    @property
    def dim(self) -> int:
        return len(self.grid_dims)

    @property
    def d(self) -> int:
        return self.band.shape[-1]


def _shift_slices(grid_dims, rel):
    """Row/column node slices such that row + rel = col, both in-grid."""
    rs, cs = [], []
    for ax, r in enumerate(rel):
        n = grid_dims[ax]
        a0 = max(0, -int(r))
        a1 = min(n, n - int(r))
        if a1 <= a0:
            return None
        rs.append(slice(a0, a1))
        cs.append(slice(a0 + int(r), a1 + int(r)))
    return tuple(rs), tuple(cs)


def assemble(
    H: jax.Array,  # (Ns, K, d, d, d)  ∂f_{A,i}/∂grad_{lm} per edge
    dN: jax.Array,  # (Ns, K, d) reference-config shape gradients
    mask: jax.Array,  # (Ns, K) valid edges
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> BandedBSR:
    """Assemble the banded tangent from per-particle edge jacobians.

    For every static window pair (i, j): the (d, d) block scattered to
    (A, B) = (cell + off_i, cell + off_j) is Σ_m H[:, i, :, :, m]·dN[:, j, m],
    accumulated densely (capacity-sum + static-slice add) into band slot
    r = index(off_j − off_i).  K² unrolled dense adds, zero scatters.
    """
    rels, pair_index = relative_offsets(offsets)
    K = offsets.shape[0]
    d = dN.shape[-1]
    R = rels.shape[0]
    n_nodes = grid.n_nodes
    band = jnp.zeros(tuple(grid.dims) + (R, d, d), H.dtype)
    m2 = mask[:, :, None, None]
    for i in range(K):
        # all pairs (i, j): blocks B_j = H_i · dN_j, masked
        Bi = jnp.einsum(
            "silm,sjm->sjil", H[:, i], jnp.where(m2[:, :, :, 0], dN, 0.0)
        )  # (Ns, K, d, d)
        Bi = jnp.where(m2[:, i : i + 1] & m2, Bi, 0.0)
        per_cell = Bi.reshape((box.capacity,) + box.cdims + (K, d, d)).sum(
            axis=0
        )  # (cells…, K, d, d)
        sl = _node_slices(box, grid.dims, offsets[i])
        if sl is None:
            continue
        cs, ns = sl
        for j in range(K):
            r = int(pair_index[i, j])
            band = band.at[ns + (r,)].add(per_cell[cs + (j,)])
    return BandedBSR(
        band=band.reshape(n_nodes, R, d, d),
        rels=tuple(tuple(int(v) for v in r) for r in rels),
        grid_dims=tuple(grid.dims),
    )


def matvec(A: BandedBSR, x: jax.Array) -> jax.Array:
    """y[A] = Σ_r band[A, r] · x[A + rel_r] — R static shifted dense
    contractions (the BSR SpMV of SURVEY.md §2.3, scatter/gather-free)."""
    d = A.d
    xg = x.reshape(tuple(A.grid_dims) + (d,))
    bg = A.band.reshape(tuple(A.grid_dims) + A.band.shape[1:])
    y = jnp.zeros_like(xg)
    for r, rel in enumerate(A.rels):
        sl = _shift_slices(A.grid_dims, rel)
        if sl is None:
            continue
        rs, cs = sl
        y = y.at[rs].add(
            jnp.einsum("...il,...l->...i", bg[rs + (r,)], xg[cs])
        )
    return y.reshape(x.shape)


def apply_dof_masks(A: BandedBSR, free: jax.Array) -> BandedBSR:
    """Zero rows+columns of constrained dofs and put a unit diagonal there —
    the `MatZeroRowsColumnsIS` equivalent (U-Newmark-beta.c:1827), done as
    R static masked dense updates."""
    d = A.d
    fg = free.reshape(tuple(A.grid_dims) + (d,)).astype(A.band.dtype)
    bg = A.band.reshape(tuple(A.grid_dims) + A.band.shape[1:])
    out = jnp.zeros_like(bg)
    for r, rel in enumerate(A.rels):
        sl = _shift_slices(A.grid_dims, rel)
        if sl is None:
            continue
        rs, cs = sl
        blk = bg[rs + (r,)] * fg[rs][..., :, None] * fg[cs][..., None, :]
        if all(v == 0 for v in rel):
            blk = blk + jnp.eye(d, dtype=A.band.dtype) * (1.0 - fg[rs])[
                ..., :, None
            ]
        out = out.at[rs + (r,)].set(blk)
    return A.replace(band=out.reshape(A.band.shape))


def add_diagonal(A: BandedBSR, shift: jax.Array) -> BandedBSR:
    """A + diag(shift ⊗ I_d) — e.g. the α₁·M inertial diagonal."""
    d = A.d
    r0 = A.rels.index((0,) * len(A.grid_dims))
    band = A.band.at[:, r0].add(
        shift[:, None, None] * jnp.eye(d, dtype=A.band.dtype)
    )
    return A.replace(band=band)


def to_dense(A: BandedBSR) -> jax.Array:
    """Dense (n·d, n·d) matrix — test/debug oracle only."""
    n = int(np.prod(A.grid_dims))
    d = A.d
    dense = jnp.zeros((n, d, n, d), A.band.dtype)
    node_idx = np.indices(A.grid_dims).reshape(len(A.grid_dims), -1).T
    strides = np.concatenate(
        [np.cumprod(np.asarray(A.grid_dims)[::-1])[-2::-1], [1]]
    ).astype(np.int64)
    flat = node_idx @ strides
    for r, rel in enumerate(A.rels):
        col_idx = node_idx + np.asarray(rel)
        ok = np.all((col_idx >= 0) & (col_idx < np.asarray(A.grid_dims)), axis=1)
        rows = flat[ok]
        cols = (col_idx[ok] @ strides)
        dense = dense.at[rows, :, cols, :].add(A.band[rows, r])
    return dense.reshape(n * d, n * d)


def block_jacobi_inverse(
    diag_blocks: jax.Array,  # (n_nodes, d, d)
    free: Optional[jax.Array] = None,  # (n_nodes, d) free-dof mask
    shift: Optional[jax.Array] = None,  # (n_nodes,) added to the diagonal
) -> jax.Array:
    """Per-node closed-form inverse of the (regularised, dof-masked)
    diagonal blocks — the PCJACOBI upgrade the reference never had
    (SNES uses scalar PCJACOBI, U-Newmark-beta.c:326-335)."""
    from . import tensor as tn

    d = diag_blocks.shape[-1]
    D = 0.5 * (diag_blocks + jnp.swapaxes(diag_blocks, -1, -2))
    if shift is not None:
        D = D + shift[:, None, None] * jnp.eye(d, dtype=D.dtype)
    if free is not None:
        # zero rows/cols of constrained dofs, unit diagonal there
        f = free.astype(D.dtype)
        D = D * f[:, :, None] * f[:, None, :]
        D = D + jnp.eye(d, dtype=D.dtype) * (1.0 - f)[:, :, None] * jnp.eye(
            d, dtype=D.dtype
        )
    # Levenberg-style floor so near-singular blocks stay invertible
    tr = jnp.trace(D, axis1=-2, axis2=-1) / d
    eps = 1e-12 * jnp.maximum(jnp.abs(tr), 1.0)[:, None, None]
    D = D + eps * jnp.eye(d, dtype=D.dtype)
    return tn.inv(D)
