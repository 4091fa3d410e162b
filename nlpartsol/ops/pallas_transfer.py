"""LME particle↔grid transfers fused with the basis evaluation.

The XLA 'windowed' engine (ops/windowed.py) materialises the per-edge
tensors N (Ns, K), ∇N (Ns, K, d) and every per-edge value array in device
memory; at K = 81 (2D LME, γ=3, 1-cell drift margin) one f32 (Ns, K, 2)
tensor is hundreds of MB.  The kernels here never materialise an edge
tensor: the LME basis (λ-Newton + N + ∇N; src/Nodes/LME.c:272-353,700-891)
is recomputed in registers from slot positions and the warm-start λ and
contracted at once.

* ``fused_scatter`` — P2G: per-slot channel values (N-weighted) and/or
  per-slot 2×2 matrices G (gradient-weighted: G·∇N_A to node A) summed into
  the nodes.  Optionally runs the λ Newton solve and returns the converged λ.
* ``fused_gather`` — G2P: node fields contracted against N (channel gather)
  and ∇N (displacement-gradient gather) per slot.

Two implementations share one contract:

* ``_scatter_xla``/``_gather_xla`` — plain XLA over the widened window
  (the reference semantics; the CPU path);
* Pallas kernels through Triton (the GPU path).  P2G is deterministic and
  runs in two passes: a per-slot pass (λ-Newton, log Z, r and J⁻¹ — nine
  floats per slot) and a per-node pass that sums over the window's cells ×
  C slots, so no atomics reorder the sums between runs.  G2P runs one
  program per tile of box cells.

Axis convention (2D): grid dims = (n0, n1), flat node = i0·n1 + i1.  Slot
arrays are capacity-major (ops/windowed.py) and passed channel-leading as
(ch, C, n_cells); coordinate channel c is the position along grid axis c.
3D runs the XLA form: it holds (Ns, K, 3) edge tensors at K = 343, and a
3D kernel for the GPU is an open item (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..shapefun import lme as lme_mod
from ..types import Grid
from .vma import out_struct
from . import tensor as tn
from . import windowed

#: slots (or nodes) per Triton program: two per thread at 4 warps of 32
TILE = 256
NUM_WARPS = 4
_NEG = -1e30


def transfer_impl(platform: str, interpret: bool = False) -> str:
    """Which implementation runs the 2D transfers on ``platform``.

    ``'triton'`` (the compiled kernels) on a GPU, ``'xla'`` (the plain
    reference) on the CPU, ``'interpret'`` (the kernels in Pallas interpret
    mode) only when a CPU caller asks for it.  Any other platform, or
    interpret mode on a GPU, is an error: no path silently stands in for
    another."""
    if platform == "gpu":
        if interpret:
            raise ValueError("Pallas interpret mode is a CPU test path; "
                             "on the GPU the kernels run compiled")
        return "triton"
    if platform == "cpu":
        return "interpret" if interpret else "xla"
    raise ValueError(f"no LME transfer for platform {platform!r} "
                     "(expected 'gpu' or 'cpu')")


class _Geom:
    """Static geometry of the 2D kernels."""

    def __init__(self, grid: Grid, box: windowed.ActiveBox, params: lme_mod.LMEParams,
                 margin: int = 0):
        assert grid.dim == 2, "the kernels are 2D; 3D runs the XLA form"
        self.h = grid.spacing
        self.origin = tuple(float(v) for v in grid.origin)
        self.beta = lme_mod.beta_of(params, grid.spacing)
        r_sup = lme_mod.support_radius(params, grid.spacing)
        self.r2max = r_sup * r_sup
        # margin widens the window so particles may drift up to `margin`
        # cells from their binned slot cell between re-binnings: the radius
        # mask r² ≤ R² keeps the evaluated basis exact regardless of which
        # cell inside the widened window the particle actually occupies.
        self.w = lme_mod.window_halfwidth(params, 1.0) + margin
        self.K1 = 2 * self.w + 1
        self.K = self.K1 * self.K1
        self.c0, self.c1 = box.cdims
        self.C = box.capacity
        self.nc = box.n_cells
        self.ns = box.n_slots
        self.n0, self.n1 = grid.dims
        self.o0, self.o1 = box.offset  # box cell origin (grid frame)
        self.params = params
        self.margin = margin

        # radius culling: a particle sits in [0, 1) cells of its slot cell
        # (± margin drift) and node(cell) is the cell's LOWER corner, so the
        # closest approach to the node at offset o is max(0, o − 1 − margin)
        # above and max(0, −o − margin) below; offsets beyond the support
        # radius can never contribute (γ = 3: 49 → 32 offsets at margin 0,
        # 81 → 60 at margin 1)
        def _md(o):
            return max(0.0, o - 1.0 - margin, -o - margin)

        rm = r_sup / grid.spacing
        self.pairs = [
            (o0, o1)
            for o0 in range(-self.w, self.w + 1)
            for o1 in range(-self.w, self.w + 1)
            if _md(o0) ** 2 + _md(o1) ** 2 <= rm * rm
        ]
        # the kept o1 of each o0 are one contiguous range: (o0, lo, hi)
        self.rows = []
        for o0 in range(-self.w, self.w + 1):
            o1s = [b for a, b in self.pairs if a == o0]
            if o1s:
                assert o1s == list(range(o1s[0], o1s[-1] + 1))
                self.rows.append((o0, o1s[0], o1s[-1]))
        # nodes any slot window can reach: the P2G output region
        self.lo = (max(0, self.o0 - self.w), max(0, self.o1 - self.w))
        self.hi = (min(self.n0 - 1, self.o0 + self.c0 - 1 + self.w),
                   min(self.n1 - 1, self.o1 + self.c1 - 1 + self.w))
        self.rdims = (self.hi[0] - self.lo[0] + 1, self.hi[1] - self.lo[1] + 1)


def _valid_bounds(g: _Geom, valid_lo, valid_hi) -> jax.Array:
    """(4,) int32 [lo0, hi0, lo1, hi1]: the node planes a window may use.

    ``valid_lo``/``valid_hi`` may be None (the whole local grid is real),
    scalars (axis-0 bound only — the 1-D decomposition), or (2,) arrays
    (per-axis bounds — the 2-D decomposition masks phantom planes beyond
    the GLOBAL grid on both split axes).  They are traced per device under
    shard_map (parallel/domain.py) and clipped to the local grid."""
    dims = (g.n0, g.n1)

    def norm(v, default):
        if v is None:
            return jnp.asarray(default, jnp.int32)
        a = jnp.asarray(v, jnp.int32).reshape(-1)
        if a.shape[0] == 2:
            return a
        return jnp.concatenate([a.reshape(1), jnp.asarray(default[1:], jnp.int32)])

    vlo = jnp.maximum(norm(valid_lo, [0, 0]), 0)
    vhi = jnp.minimum(norm(valid_hi, [n - 1 for n in dims]),
                      jnp.asarray([n - 1 for n in dims], jnp.int32))
    return jnp.stack([vlo, vhi], axis=1).reshape(4)


# ---------------------------------------------------------------------------
# plain XLA reference
# ---------------------------------------------------------------------------


def _xla_basis(grid, box, params, margin, x_t, lam_t, act_t, solve,
               valid_lo=None, valid_hi=None):
    """Slot-cell-centered widened-window LME basis in plain XLA, in 2D and
    3D — the exact semantics of the kernels."""
    from ..shapefun.window import window_offsets

    d = grid.dim
    beta = lme_mod.beta_of(params, grid.spacing)
    r2max = lme_mod.support_radius(params, grid.spacing) ** 2
    w = lme_mod.window_halfwidth(params, 1.0) + margin
    x = from_channel_leading(x_t)
    lam0 = from_channel_leading(lam_t)
    act = from_channel_leading(act_t)[:, 0] > 0.5
    offs = window_offsets(d, -w, w)  # widened window
    cells = jnp.asarray(windowed.slot_cells(box))  # (Ns, d) grid frame
    multi = cells[:, None, :] + jnp.asarray(offs)[None, :, :]
    dims = jnp.asarray(grid.dims)
    inb = jnp.all((multi >= 0) & (multi < dims), axis=-1)
    if valid_lo is not None:
        vlo_a = jnp.asarray(valid_lo, jnp.int32).reshape(-1)
        if vlo_a.shape[0] > 1:
            inb = inb & jnp.all(multi >= vlo_a, axis=-1)
        else:
            inb = inb & (multi[..., 0] >= vlo_a[0])
    if valid_hi is not None:
        vhi_a = jnp.asarray(valid_hi, jnp.int32).reshape(-1)
        if vhi_a.shape[0] > 1:
            inb = inb & jnp.all(multi <= vhi_a, axis=-1)
        else:
            inb = inb & (multi[..., 0] <= vhi_a[0])
    node_pos = multi.astype(x.dtype) * grid.spacing + jnp.asarray(grid.origin, x.dtype)
    rel = x[:, None, :] - node_pos
    sq = jnp.sum(rel * rel, axis=-1)
    mask = inb & (sq <= r2max) & act[:, None]
    if solve:
        lam = lme_mod.solve_lambda(rel, mask, lam0, beta, params)
    else:
        lam = lam0
    f = -beta * sq + jnp.einsum("pi,pki->pk", lam, rel)
    neg = jnp.asarray(_NEG, f.dtype)
    f = jnp.where(mask, f, neg)
    fmax = jnp.max(f, axis=-1, keepdims=True)
    e = jnp.where(mask, jnp.exp(f - fmax), 0.0)
    Z = jnp.maximum(jnp.sum(e, axis=-1, keepdims=True), 1e-30)
    N = e / Z
    r = jnp.einsum("pk,pki->pi", N, rel)
    J = jnp.einsum("pk,pki,pkj->pij", N, rel, rel) - r[:, :, None] * r[:, None, :]
    Jd = J + 1e-10 * tn.trace(J)[..., None, None] * jnp.eye(d, dtype=J.dtype)
    Jinv = tn.inv(Jd)
    dN = -N[..., None] * jnp.einsum("pij,pkj->pki", Jinv, rel - r[:, None, :])
    return offs, N, dN, mask, lam


def _scatter_xla(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve, margin,
                 gnorm=False, valid_lo=None, valid_hi=None):
    d = grid.dim
    offs, N, dN, mask, lam = _xla_basis(
        grid, box, params, margin, x_t, lam_t, act_t, solve,
        valid_lo=valid_lo, valid_hi=valid_hi,
    )
    C, nc = box.capacity, box.n_cells
    cols = []
    fN = from_channel_leading(fN_t)  # (Ns, cN)
    cols.append(N[..., None] * fN[:, None, :])
    if G_t is not None:
        G = from_channel_leading(G_t).reshape(-1, d, d)
        cols.append(jnp.einsum("pij,pkj->pki", G, dN))
    if gnorm:
        s = fN[:, -1]
        cols.append((s[:, None] * jnp.sum(dN * dN, axis=-1))[..., None])
    vals = jnp.concatenate(cols, axis=-1)
    vals = jnp.where(mask[..., None], vals, 0.0)
    nodes = windowed.p2g(vals, box, grid, offs)
    nnz = jnp.sum(mask.astype(jnp.int32))
    return nodes, to_channel_leading(lam, C, nc), nnz


def _gather_xla(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin,
                valid_lo=None, valid_hi=None):
    d = grid.dim
    offs, N, dN, mask, _ = _xla_basis(
        grid, box, params, margin, x_t, lam_t, act_t, solve=False,
        valid_lo=valid_lo, valid_hi=valid_hi,
    )
    Nm = jnp.where(mask, N, 0.0)
    outN = windowed.g2p(gN, Nm, box, grid, offs) if gN is not None else None
    grad = None
    if g_grad is not None:
        per_cell = windowed.cell_edge_field(g_grad, box, grid, offs)
        K = offs.shape[0]
        nc = box.n_cells
        u = jnp.broadcast_to(
            per_cell.reshape((1, nc, K, d)), (box.capacity, nc, K, d)
        ).reshape(box.n_slots, K, d)
        dNm = jnp.where(mask[..., None], dN, 0.0)
        grad = jnp.einsum("pki,pkj->pij", u, dNm)
    return outN, grad


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


def _sweep(g: _Geom, fn, carry):
    """Fold ``fn(o0, o1, carry)`` over the radius-culled window offsets:
    o0 unrolled (static), o1 a loop over that row's contiguous range."""
    for o0, lo, hi in g.rows:
        carry = jax.lax.fori_loop(
            lo, hi + 1, lambda o1, cr, o0=o0: fn(o0, o1, cr), carry
        )
    return carry


def _load(ref, idx, mask):
    return plgpu.load(ref.at[idx], mask=mask, other=0.0)


def _slot_tile(g: _Geom, x_ref, lam_ref, act_ref):
    """The program's tile: TILE consecutive box cells at capacity rank
    program_id(1).  Returns (start, inb, i0, i1, x0, x1, lam0, lam1, act):
    the grid index of each slot's cell corner, positions relative to the
    grid origin, and the slot's active flag (False past the last cell)."""
    t, c = pl.program_id(0), pl.program_id(1)
    cell = t * TILE + jnp.arange(TILE, dtype=jnp.int32)
    inb = cell < g.nc
    cell = jnp.where(inb, cell, 0)
    start = c * g.nc + t * TILE

    def ld(ref, ch):
        return _load(ref, pl.ds(start + ch * g.ns, TILE), inb)

    act = inb & (ld(act_ref, 0) > 0.5)
    return (start, inb, g.o0 + cell // g.c1, g.o1 + cell % g.c1,
            ld(x_ref, 0) - g.origin[0], ld(x_ref, 1) - g.origin[1],
            ld(lam_ref, 0), ld(lam_ref, 1), act)


def _rel(g: _Geom, x0, x1, n0, n1):
    """l = x − x_node from origin-relative positions and integer node
    indices.  Both P2G passes evaluate N through this one expression, so
    the second pass's exponents match the first pass's log Z bit for bit
    and Σ_A N_A = 1 holds to rounding."""
    return (x0 - n0.astype(jnp.float32) * g.h, x1 - n1.astype(jnp.float32) * g.h)


def _window(g: _Geom, x0, x1, act, i0, i1, vb_ref):
    """rel(o0, o1) → (l0, l1, in_support) for each slot of the tile whose
    cell corner is node (i0, i1)."""
    lo0, hi0, lo1, hi1 = vb_ref[0], vb_ref[1], vb_ref[2], vb_ref[3]

    def rel(o0, o1):
        n0 = i0 + o0
        n1 = i1 + o1
        r0, r1 = _rel(g, x0, x1, n0, n1)
        m = (act & (n0 >= lo0) & (n0 <= hi0) & (n1 >= lo1) & (n1 <= hi1)
             & (r0 * r0 + r1 * r1 <= g.r2max))
        return r0, r1, m

    return rel


def _inv2_damped(j00, j01, j11):
    """Damped closed-form symmetric 2×2 inverse (the reference aborts at
    rcond < 1e-8, LME.c:308-313; lme._safe_solve damps the same way)."""
    eps = 1e-10 * jnp.maximum(j00 + j11, 1e-30)
    j00 = j00 + eps
    j11 = j11 + eps
    det = j00 * j11 - j01 * j01
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    inv = 1.0 / det
    return j11 * inv, -j01 * inv, j00 * inv  # i00, i01, i11


def _moments(g: _Geom, rel, lam0, lam1):
    """Z, Σe·l and Σe·l⊗l with e = exp(f − fmax), plus fmax and the edge
    count: two sweeps, one exp per window offset."""
    def f_of(o0, o1):
        r0, r1, m = rel(o0, o1)
        f = -g.beta * (r0 * r0 + r1 * r1) + lam0 * r0 + lam1 * r1
        return jnp.where(m, f, _NEG), r0, r1, m

    fmax = _sweep(g, lambda o0, o1, fm: jnp.maximum(fm, f_of(o0, o1)[0]),
                  jnp.full(lam0.shape, _NEG, jnp.float32))

    def acc(o0, o1, s):
        f, r0, r1, m = f_of(o0, o1)
        e = jnp.where(m, jnp.exp(f - fmax), 0.0)
        z, s0, s1, s00, s01, s11, n = s
        return (z + e, s0 + e * r0, s1 + e * r1, s00 + e * r0 * r0,
                s01 + e * r0 * r1, s11 + e * r1 * r1, n + m.astype(jnp.float32))

    zero = jnp.zeros(lam0.shape, jnp.float32)
    z, s0, s1, s00, s01, s11, n = _sweep(g, acc, (zero,) * 7)
    zs = jnp.maximum(z, 1e-30)
    r0, r1 = s0 / zs, s1 / zs
    J = (s00 / zs - r0 * r0, s01 / zs - r0 * r1, s11 / zs - r1 * r1)
    return fmax, zs, r0, r1, J, n


def _solve_lambda(g: _Geom, rel, lam0, lam1):
    """λ-Newton (LME.c:272-353) with the semantics of lme.solve_lambda:
    per-slot convergence ‖r‖ ≤ tol·(largest in-support distance), a
    converged slot keeps its λ, and the program stops when all of its
    slots have converged or after max_iter iterations."""
    if g.params.wrapper.lower().replace("_", "-") != "newton-raphson":
        raise ValueError("the fused LME kernels implement the Newton-Raphson "
                         "λ wrapper only; use transfer='windowed'")

    def sq_max(o0, o1, s):
        r0, r1, m = rel(o0, o1)
        return jnp.maximum(s, jnp.where(m, r0 * r0 + r1 * r1, 0.0))

    tol2 = g.params.tol_lambda ** 2 * _sweep(
        g, sq_max, jnp.zeros(lam0.shape, jnp.float32))

    def body(state):
        l0, l1, _, it = state
        _, _, r0, r1, J, _ = _moments(g, rel, l0, l1)
        i00, i01, i11 = _inv2_damped(*J)
        conv = r0 * r0 + r1 * r1 <= tol2
        l0 = jnp.where(conv, l0, l0 - (i00 * r0 + i01 * r1))
        l1 = jnp.where(conv, l1, l1 - (i01 * r0 + i11 * r1))
        left = jnp.sum(jnp.where(conv, 0, 1).astype(jnp.int32))
        return l0, l1, left == 0, it + 1

    def cond(state):
        return jnp.logical_not(state[2]) & (state[3] < g.params.max_iter)

    l0, l1, _, _ = jax.lax.while_loop(
        cond, body, (lam0, lam1, jnp.asarray(False), jnp.int32(0)))
    return l0, l1


#: per-slot basis record written by the P2G first pass
_AUX = ("lse", "nnz", "r0", "r1", "i00", "i01", "i11")


def _make_basis_kernel(g: _Geom, solve: bool):
    """P2G pass 1, one program per (cell tile, capacity rank): the λ solve,
    log Z (log-sum-exp of the masked exponents), edge count, r and J⁻¹."""

    def kernel(vb_ref, x_ref, lam_ref, act_ref, lam_out_ref, aux_ref):
        start, inb, i0, i1, x0, x1, lam0, lam1, act = _slot_tile(
            g, x_ref, lam_ref, act_ref)
        rel = _window(g, x0, x1, act, i0, i1, vb_ref)
        if solve:
            lam0, lam1 = _solve_lambda(g, rel, lam0, lam1)
        fmax, zs, r0, r1, J, n = _moments(g, rel, lam0, lam1)
        rows = (fmax + jnp.log(zs), n, r0, r1) + _inv2_damped(*J)
        for ch, v in enumerate((lam0, lam1)):
            plgpu.store(lam_out_ref.at[pl.ds(start + ch * g.ns, TILE)], v, mask=inb)
        for ch, v in enumerate(rows):
            plgpu.store(aux_ref.at[pl.ds(start + ch * g.ns, TILE)], v, mask=inb)

    return kernel


def _make_p2g_kernel(g: _Geom, cN: int, has_G: bool, gnorm: bool):
    """P2G pass 2, one program per tile of TILE nodes of the output region:
    each node sums over its window's cells × C slots, recomputing
    N = exp(f − log Z) and ∇N = −N·J⁻¹(l − r) from the pass-1 record."""
    need_dn = has_G or gnorm
    cout = cN + (2 if has_G else 0) + (1 if gnorm else 0)
    nr = g.rdims[0] * g.rdims[1]

    def kernel(vb_ref, x_ref, lam_ref, act_ref, aux_ref, fN_ref, *rest):
        G_ref = rest[0] if has_G else None
        out_ref = rest[-1]
        q = pl.program_id(0) * TILE + jnp.arange(TILE, dtype=jnp.int32)
        qin = q < nr
        qc = jnp.where(qin, q, 0)
        a0 = g.lo[0] + qc // g.rdims[1]
        a1 = g.lo[1] + qc % g.rdims[1]
        node_ok = (qin & (a0 >= vb_ref[0]) & (a0 <= vb_ref[1])
                   & (a1 >= vb_ref[2]) & (a1 <= vb_ref[3]))

        def rank(c, acc):
            def edge(o0, o1, acc):
                cy = a0 - o0 - g.o0
                cx = a1 - o1 - g.o1
                ok = node_ok & (cy >= 0) & (cy < g.c0) & (cx >= 0) & (cx < g.c1)
                s = c * g.nc + jnp.where(ok, cy * g.c1 + cx, 0)

                def ld(ref, ch):
                    return _load(ref, s + ch * g.ns, ok)

                r0, r1 = _rel(g, ld(x_ref, 0) - g.origin[0],
                              ld(x_ref, 1) - g.origin[1], a0, a1)
                r2 = r0 * r0 + r1 * r1
                m = ok & (ld(act_ref, 0) > 0.5) & (r2 <= g.r2max)
                f = -g.beta * r2 + ld(lam_ref, 0) * r0 + ld(lam_ref, 1) * r1
                N = jnp.where(m, jnp.exp(f - ld(aux_ref, 0)), 0.0)
                acc = list(acc)
                for ch in range(cN):
                    acc[ch] = acc[ch] + N * ld(fN_ref, ch)
                if need_dn:
                    b0 = r0 - ld(aux_ref, 2)
                    b1 = r1 - ld(aux_ref, 3)
                    i01 = ld(aux_ref, 5)
                    dn0 = -N * (ld(aux_ref, 4) * b0 + i01 * b1)
                    dn1 = -N * (i01 * b0 + ld(aux_ref, 6) * b1)
                    k = cN
                    if has_G:
                        acc[k] = acc[k] + ld(G_ref, 0) * dn0 + ld(G_ref, 1) * dn1
                        acc[k + 1] = acc[k + 1] + ld(G_ref, 2) * dn0 + ld(G_ref, 3) * dn1
                        k += 2
                    if gnorm:
                        # Σ_p s_p·|∇N_pA|² with s_p the LAST fN channel — the
                        # Jacobi stiffness diagonal (PCJACOBI equivalent)
                        acc[k] = acc[k] + ld(fN_ref, cN - 1) * (dn0 * dn0 + dn1 * dn1)
                return tuple(acc)

            return _sweep(g, edge, acc)

        zero = jnp.zeros((TILE,), jnp.float32)
        acc = jax.lax.fori_loop(0, g.C, rank, (zero,) * cout)
        for ch in range(cout):
            plgpu.store(out_ref.at[pl.ds(pl.program_id(0) * TILE + ch * nr, TILE)],
                        acc[ch], mask=qin)

    return kernel


def _make_gather_kernel(g: _Geom, cN: int, has_grad: bool, wp: int):
    """G2P, one program per (cell tile, capacity rank).  Node fields arrive
    channel-major and zero-padded by the window half-width on every side
    (row length ``wp``), so every window load is in bounds."""

    def kernel(vb_ref, x_ref, lam_ref, act_ref, f_ref, *outs):
        start, inb, i0, i1, x0, x1, lam0, lam1, act = _slot_tile(
            g, x_ref, lam_ref, act_ref)
        rel = _window(g, x0, x1, act, i0, i1, vb_ref)
        fmax, zs, r0, r1, J, _ = _moments(g, rel, lam0, lam1)
        lse = fmax + jnp.log(zs)
        i00, i01, i11 = _inv2_damped(*J)
        plane = (g.n0 + 2 * g.w) * wp
        base = (i0 + g.w) * wp + (i1 + g.w)
        cg = cN + (2 if has_grad else 0)

        def edge(o0, o1, acc):
            l0, l1, m = rel(o0, o1)
            f = -g.beta * (l0 * l0 + l1 * l1) + lam0 * l0 + lam1 * l1
            N = jnp.where(m, jnp.exp(f - lse), 0.0)
            idx = base + o0 * wp + o1
            vals = [plgpu.load(f_ref.at[idx + ch * plane]) for ch in range(cg)]
            acc = list(acc)
            for ch in range(cN):
                acc[ch] = acc[ch] + N * vals[ch]
            if has_grad:
                b0, b1 = l0 - r0, l1 - r1
                dn0 = -N * (i00 * b0 + i01 * b1)
                dn1 = -N * (i01 * b0 + i11 * b1)
                u0, u1 = vals[cN], vals[cN + 1]
                acc[cN:] = [acc[cN] + u0 * dn0, acc[cN + 1] + u0 * dn1,
                            acc[cN + 2] + u1 * dn0, acc[cN + 3] + u1 * dn1]
            return tuple(acc)

        zero = jnp.zeros((TILE,), jnp.float32)
        acc = _sweep(g, edge, (zero,) * (cN + (4 if has_grad else 0)))
        for ch, v in enumerate(acc):
            out = outs[0] if ch < cN else outs[-1]
            k = ch if ch < cN else ch - cN
            plgpu.store(out.at[pl.ds(start + k * g.ns, TILE)], v, mask=inb)

    return kernel


def _call(kernel, grid, out_shapes, like, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=[out_struct(s, jnp.float32, like) for s in out_shapes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )


def _check_f32(x_t):
    if x_t.dtype != jnp.float32:
        raise ValueError(f"the Triton LME kernels are float32 (got {x_t.dtype}); "
                         "use transfer='windowed' for a float64 run")


def _scatter_triton(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve,
                    margin, gnorm, valid_lo, valid_hi, interpret):
    _check_f32(x_t)
    g = _Geom(grid, box, params, margin)
    cN = fN_t.shape[0]
    has_G = G_t is not None
    cout = cN + (2 if has_G else 0) + (1 if gnorm else 0)
    vb = _valid_bounds(g, valid_lo, valid_hi)
    xf, actf = x_t.reshape(-1), act_t.reshape(-1)
    lam_f, aux = _call(_make_basis_kernel(g, solve), (pl.cdiv(g.nc, TILE), g.C),
                       [(2 * g.ns,), (len(_AUX) * g.ns,)], x_t, interpret,
                       "lme_p2g_basis")(vb, xf, lam_t.reshape(-1), actf)
    nr = g.rdims[0] * g.rdims[1]
    ins = [vb, xf, lam_f, actf, aux, fN_t.reshape(-1)]
    if has_G:
        ins.append(G_t.reshape(-1))
    (region,) = _call(_make_p2g_kernel(g, cN, has_G, gnorm), (pl.cdiv(nr, TILE),),
                      [(cout * nr,)], x_t, interpret, "lme_p2g_nodes")(*ins)
    region = jnp.moveaxis(region.reshape((cout,) + g.rdims), 0, -1)
    nodes = jnp.pad(region, ((g.lo[0], g.n0 - 1 - g.hi[0]),
                             (g.lo[1], g.n1 - 1 - g.hi[1]), (0, 0)))
    nnz = jnp.sum(aux[g.ns: 2 * g.ns].astype(jnp.int32))
    return (nodes.reshape(g.n0 * g.n1, cout), lam_f.reshape(2, g.C, g.nc), nnz)


def _gather_triton(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin,
                   valid_lo, valid_hi, interpret):
    _check_f32(x_t)
    g = _Geom(grid, box, params, margin)
    cN = 0 if gN is None else gN.shape[1]
    has_grad = g_grad is not None
    fields = ([] if gN is None else [gN]) + ([g_grad] if has_grad else [])
    if not fields:
        raise ValueError("nothing to gather")
    cg = cN + (2 if has_grad else 0)
    f = jnp.concatenate(fields, axis=1).reshape(g.n0, g.n1, cg)
    wp = g.n1 + 2 * g.w
    fpad = jnp.pad(jnp.moveaxis(f, -1, 0), ((0, 0), (g.w, g.w), (g.w, g.w)))
    outs = ([(cN * g.ns,)] if cN else []) + ([(4 * g.ns,)] if has_grad else [])
    res = _call(_make_gather_kernel(g, cN, has_grad, wp), (pl.cdiv(g.nc, TILE), g.C),
                outs, x_t, interpret, "lme_g2p")(
        _valid_bounds(g, valid_lo, valid_hi), x_t.reshape(-1), lam_t.reshape(-1),
        act_t.reshape(-1), fpad.reshape(-1))
    outN = jnp.moveaxis(res[0].reshape(cN, g.ns), 0, 1) if cN else None
    grad = (jnp.moveaxis(res[-1].reshape(4, g.ns), 0, 1).reshape(g.ns, 2, 2)
            if has_grad else None)
    return outN, grad


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def fused_scatter(
    grid: Grid,
    box: windowed.ActiveBox,
    params: lme_mod.LMEParams,
    x_t: jax.Array,     # (d, C, nc) slot positions
    lam_t: jax.Array,   # (d, C, nc) λ warm start
    act_t: jax.Array,   # (1, C, nc) active (f32 0/1)
    fN_t: jax.Array,    # (cN, C, nc) N-weighted channels
    G_t: Optional[jax.Array] = None,  # (d·d, C, nc) grad-weighted row-major d×d
    solve: bool = True,
    margin: int = 0,
    gnorm: bool = False,
    valid_lo=None,
    valid_hi=None,
    interpret: bool = False,
):
    """Fused LME+P2G.  Returns (nodes (n_nodes, cout), lam (d, C, nc), nnz);
    cout = cN (+d when G_t given, the Σ G·∇N vector appended; +1 when
    ``gnorm``: Σ s·|∇N|² with s = the LAST fN channel — the Jacobi
    stiffness diagonal of the implicit path).  ``interpret`` runs the
    Triton kernels in Pallas interpret mode (CPU tests only).  3D runs the
    XLA form on every platform."""
    impl = transfer_impl(jax.default_backend(), interpret)
    if impl == "xla" or grid.dim == 3:
        return _scatter_xla(grid, box, params, x_t, lam_t, act_t, fN_t, G_t,
                            solve, margin, gnorm, valid_lo, valid_hi)
    return _scatter_triton(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve,
                           margin, gnorm, valid_lo, valid_hi, impl == "interpret")


def fused_gather(
    grid: Grid,
    box: windowed.ActiveBox,
    params: lme_mod.LMEParams,
    x_t: jax.Array,     # (d, C, nc)
    lam_t: jax.Array,   # (d, C, nc) converged λ
    act_t: jax.Array,   # (1, C, nc)
    gN: Optional[jax.Array] = None,      # (n_nodes, cN)
    g_grad: Optional[jax.Array] = None,  # (n_nodes, d)
    margin: int = 0,
    valid_lo=None,
    valid_hi=None,
    interpret: bool = False,
):
    """Fused LME+G2P.  Returns (outN (Ns, cN) | None, grad (Ns, d, d) | None)
    where grad[s, i, j] = Σ_A g_grad[A, i]·∂N_A/∂x_j."""
    impl = transfer_impl(jax.default_backend(), interpret)
    if impl == "xla" or grid.dim == 3:
        return _gather_xla(grid, box, params, x_t, lam_t, act_t, gN, g_grad,
                           margin, valid_lo, valid_hi)
    return _gather_triton(grid, box, params, x_t, lam_t, act_t, gN, g_grad,
                          margin, valid_lo, valid_hi, impl == "interpret")


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def to_channel_leading(a: jax.Array, C: int, nc: int) -> jax.Array:
    """(Ns[, ch]) capacity-major slot array → (ch, C, nc)."""
    if a.ndim == 1:
        return a.reshape(1, C, nc)
    return jnp.moveaxis(a, 1, 0).reshape(a.shape[1], C, nc)


def from_channel_leading(a: jax.Array) -> jax.Array:
    """(ch, C, nc) → (Ns, ch)."""
    return jnp.moveaxis(a.reshape(a.shape[0], -1), 0, 1)
