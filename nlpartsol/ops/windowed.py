"""Scatter-free ("windowed") particle↔grid transfer engine.

On a structured background grid the P2G/G2P sparsity is *banded by
construction* — every particle touches exactly the (2W+1)^d node window
around its cell — so the transfers can be reorganised as dense operations
with no scatter-add of random indices:

1. **Cell binning**: particles are binned into per-cell slots of a static
   ``capacity`` C over a static ``ActiveBox`` of cells (sort by cell id +
   rank-within-cell; one Np-sized scatter builds the slot table).  Particle
   state then lives in slot layout: arrays of static size Ns = Ncells·C.
   Slots are **capacity-major**: ``slot = rank·n_cells + cell`` — a slot
   array viewed as (C, cells…) puts the large cell axis last, so a run of
   consecutive cells at one capacity rank is contiguous in memory (the
   fused kernels of ops/pallas_transfer.py load such runs as one tile).
2. **P2G**: per-edge values (Ns, K, c) → reshape (cells…, C, K, c) → sum
   over C → for each static window offset k, a *static-slice* dense add
   into the node array.  Zero scatters.
3. **G2P**: for each static offset k, a static slice of the node array is
   broadcast-multiplied into the slot array.  Zero gathers.

This replaces the reference's per-particle linked-list scatter loops with
``#pragma omp critical`` (U-Newmark-beta.c:582-586) — and is the reason the
framework's structured-grid path needs no general SpMM.

Particles that leave the ActiveBox or overflow a cell's capacity are
dropped from the simulation (counted in ``Binning.lost``); size the box and
capacity for the problem's reachable extent.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from .. import config
from ..types import Grid, Particles


def _prod(xs):
    return reduce(lambda a, b: a * b, xs, 1)


@struct.dataclass
class ActiveBox:
    """Static cell subgrid that carries particle slots."""

    offset: tuple = struct.field(pytree_node=False)  # cell origin (per axis)
    cdims: tuple = struct.field(pytree_node=False)  # cells per axis
    capacity: int = struct.field(pytree_node=False)  # slots per cell (C)

    @property
    def n_cells(self) -> int:
        return _prod(self.cdims)

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.capacity

    @property
    def dim(self) -> int:
        return len(self.cdims)


def full_box(grid: Grid, capacity: int) -> ActiveBox:
    return ActiveBox(
        offset=(0,) * grid.dim,
        cdims=tuple(n - 1 for n in grid.dims),
        capacity=capacity,
    )


def box_for_extent(grid: Grid, lo, hi, capacity: int, margin: int = 1) -> ActiveBox:
    """ActiveBox covering [lo, hi] (world coords) plus a cell margin."""
    lo_c = np.floor((np.asarray(lo) - np.asarray(grid.origin)) / grid.spacing).astype(int) - margin
    hi_c = np.floor((np.asarray(hi) - np.asarray(grid.origin)) / grid.spacing).astype(int) + margin
    lo_c = np.maximum(lo_c, 0)
    hi_c = np.minimum(hi_c, np.asarray(grid.dims) - 2)
    return ActiveBox(
        offset=tuple(int(v) for v in lo_c),
        cdims=tuple(int(v) for v in (hi_c - lo_c + 1)),
        capacity=capacity,
    )


@struct.dataclass
class Binning:
    box: ActiveBox
    slot_particle: jax.Array  # (Ns,) int32 index into source order; Np ⇒ empty
    valid: jax.Array  # (Ns,) bool
    lost: jax.Array  # () int32 active particles dropped


def slot_cells(box: ActiveBox) -> np.ndarray:
    """(Ns, d) integer cell multi-index (grid frame) of every slot — static.
    Capacity-major: slot = rank·n_cells + cell."""
    idx = np.indices(box.cdims).reshape(len(box.cdims), -1).T  # (Nc, d)
    idx = idx + np.asarray(box.offset)
    return np.tile(idx, (box.capacity, 1)).astype(np.int32)


def required_capacity(grid: Grid, box: ActiveBox, x, active=None) -> int:
    """Host-side (NumPy) max particle count over the box's cells — the
    minimum slot capacity that loses nothing for this configuration.  Use at
    setup time; binning under jit cannot grow the static capacity."""
    x = np.asarray(x)
    if active is None:
        active = np.ones(x.shape[0], bool)
    active = np.asarray(active)
    cell = np.floor(
        (x - np.asarray(grid.origin)) / grid.spacing
    ).astype(np.int64) - np.asarray(box.offset)
    inside = np.all((cell >= 0) & (cell < np.asarray(box.cdims)), axis=-1) & active
    strides = np.concatenate(
        [np.cumprod(np.asarray(box.cdims[::-1]))[-2::-1], [1]]
    ).astype(np.int64)
    cid = np.sum(cell[inside] * strides, axis=-1)
    if cid.size == 0:
        return 1
    counts = np.bincount(cid, minlength=box.n_cells)
    return int(counts.max())


def default_box(grid: Grid, x, active=None, slack: float = 2.0) -> ActiveBox:
    """Full-grid ActiveBox with auto-sized capacity: the current per-cell
    maximum × ``slack`` (local compaction headroom), so a run neither drops
    particles at t=0 nor silently under-provisions moderate compaction."""
    probe = full_box(grid, capacity=1)
    cap = required_capacity(grid, probe, x, active)
    return full_box(grid, capacity=max(2, int(np.ceil(cap * slack))))


def bin_particles(grid: Grid, box: ActiveBox, x: jax.Array, active: jax.Array) -> Binning:
    """Sort-based cell binning (replaces ring-walk local search +
    ChainPtr tributary rebuilds, LME.c:895-1015)."""
    n = x.shape[0]
    cell = grid.cell_of(x) - jnp.asarray(box.offset, config.index_dtype())
    cdims = jnp.asarray(box.cdims, config.index_dtype())
    inside = jnp.all((cell >= 0) & (cell < cdims), axis=-1) & active
    # flat cell id within the box; sentinel n_cells for outside/inactive
    strides = np.concatenate([np.cumprod(box.cdims[::-1])[-2::-1], [1]]).astype(np.int32)
    cid = jnp.sum(cell * jnp.asarray(strides), axis=-1)
    cid = jnp.where(inside, cid, box.n_cells).astype(jnp.int32)

    order = jnp.argsort(cid, stable=True)
    s = cid[order]
    first = jnp.searchsorted(s, s, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    keep = (s < box.n_cells) & (rank < box.capacity)
    slots = jnp.where(keep, rank * box.n_cells + s, box.n_slots)

    slot_particle = jnp.full((box.n_slots,), n, jnp.int32)
    slot_particle = slot_particle.at[slots].set(
        order.astype(jnp.int32), mode="drop"
    )
    valid = slot_particle < n
    lost = jnp.sum(active.astype(jnp.int32)) - jnp.sum(keep.astype(jnp.int32))
    return Binning(box=box, slot_particle=slot_particle, valid=valid, lost=lost)


def flatten_soa(p: Particles):
    """Flatten the whole particle SoA into ONE (Np, CH) f32 matrix.

    One wide row gather/permute replaces a per-field tree_map of 20+
    narrow ones.  Integer/bool channels ride along as f32 VALUES (exact
    below 2²⁴; pids and material ids qualify — bitcasting is not safe:
    int 1 bitcast to f32 is a denormal, which may be flushed to zero).

    Returns (big (Np, CH), specs, treedef); ``specs`` is a list of
    (dtype, trailing_shape, n_channels) in leaf order.  Leaf order follows
    field declaration order, so ``x`` occupies columns [0, d)."""
    leaves, treedef = jax.tree_util.tree_flatten(p)
    np_ = leaves[0].shape[0]
    cols = []
    specs = []
    for a in leaves:
        trail = a.shape[1:]
        ch = int(_prod(trail)) if trail else 1
        flat = a.reshape(np_, ch)
        f = flat if a.dtype == jnp.float32 else flat.astype(jnp.float32)
        cols.append(f)
        specs.append((a.dtype, trail, ch))
    return jnp.concatenate(cols, axis=1), specs, treedef


def unflatten_soa(big: jax.Array, specs, treedef) -> Particles:
    """Inverse of :func:`flatten_soa` for a (N, CH) matrix."""
    n = big.shape[0]
    out = []
    off = 0
    for dtype, trail, ch in specs:
        f = big[:, off : off + ch]
        off += ch
        if dtype == jnp.float32:
            a = f
        elif dtype == jnp.bool_:
            a = f > 0.5
        else:
            a = f.astype(dtype)
        out.append(a.reshape((n,) + trail))
    return jax.tree_util.tree_unflatten(treedef, out)


def flatten_soa_T(p: Particles):
    """Channel-major twin of :func:`flatten_soa`: ONE (CH, Np) f32 matrix.

    Concatenating the leaves' transposed views along axis 0 stacks
    contiguous channel rows, with no strided column writes like the
    row-major concat."""
    leaves, treedef = jax.tree_util.tree_flatten(p)
    np_ = leaves[0].shape[0]
    rows = []
    specs = []
    for a in leaves:
        trail = a.shape[1:]
        ch = int(_prod(trail)) if trail else 1
        f = a.reshape(np_, ch).T
        rows.append(f if a.dtype == jnp.float32 else f.astype(jnp.float32))
        specs.append((a.dtype, trail, ch))
    return jnp.concatenate(rows, axis=0), specs, treedef  # (CH, Np)


def unflatten_soa_T(bigT: jax.Array, specs, treedef) -> Particles:
    """Inverse of :func:`flatten_soa_T` (row slices are layout-preserving)."""
    n = bigT.shape[1]
    out = []
    off = 0
    for dtype, trail, ch in specs:
        f = bigT[off : off + ch].T
        off += ch
        if dtype == jnp.float32:
            a = f
        elif dtype == jnp.bool_:
            a = f > 0.5
        else:
            a = f.astype(dtype)
        out.append(a.reshape((n,) + trail))
    return jax.tree_util.tree_unflatten(treedef, out)


def permute_to_slots(p: Particles, binning: Binning) -> Particles:
    """Re-layout the particle SoA into slot order (static size Ns) with a
    single wide row gather (see :func:`flatten_soa`)."""
    idx = jnp.minimum(binning.slot_particle, p.count - 1)
    big, specs, treedef = flatten_soa(p)
    p_s = unflatten_soa(big[idx], specs, treedef)
    return p_s.replace(active=p_s.active & binning.valid)


def _shift_cells(arr: jax.Array, cdims, d, cell_axes) -> jax.Array:
    """Zero-padded shift of a per-cell array: out[t] = arr[t − d] (cells
    outside the box contribute zero).  ``cell_axes`` are the positions of
    the cell axes in ``arr``."""
    del cdims
    out = arr
    for ax, dd in zip(cell_axes, d):
        out = jnp.roll(out, dd, axis=ax)
        # zero the wrapped strip
        n = arr.shape[ax]
        idx = jnp.arange(n)
        valid = (idx - dd >= 0) & (idx - dd < n)
        shape = [1] * arr.ndim
        shape[ax] = n
        out = out * valid.reshape(shape).astype(arr.dtype)
    return out


def local_rebin(p: Particles, grid: Grid, box: ActiveBox, in_capacity: int = None):
    """Slot-layout-native re-binning for particles that drift ≤ 1 cell since
    the last binning (guaranteed per explicit step by CFL ≤ 1).

    ``in_capacity`` (≥ box.capacity; default box.capacity) lets the input
    carry extra capacity rows — the halo-sharded migration merges
    neighbour-seam buffers as rows [C, in_capacity) before compacting back
    to C (parallel/domain.migrate_local), keeping migration sort-free.

    Replaces the global argsort + wide row-gather of
    :func:`bin_particles`/:func:`permute_to_slots` with index arithmetic:
    every particle's target cell is one of the 3^d neighbours of its slot
    cell, so destination ranks are per-cell running counts over the 3^d
    candidate groups (a capacity-axis cumsum on small int arrays, no sort),
    and the whole SoA moves with ONE row gather.

    Returns ``(particles, lost)`` where ``lost`` counts active particles
    that drifted > 1 cell, left the box, or overflowed a cell's capacity
    (their slots are zeroed: mass 0, active False).
    """
    C = box.capacity
    Cin = C if in_capacity is None else int(in_capacity)
    assert Cin >= C
    cdims = box.cdims
    nd = len(cdims)
    nc = box.n_cells
    # SoA marshalling: contiguous channel-major concat + ONE transpose
    # each way, with the move itself a single wide-row gather (instead of
    # a strided column concat or per-leaf narrow gathers).
    bigT, specs, treedef = flatten_soa_T(p)  # (CH, Cin*nc): contiguous concat
    big = bigT.T  # (Cin*nc, CH) via XLA tiled transpose
    x_c = p.x.reshape((Cin,) + cdims + (p.dim,))
    act_c = p.active.reshape((Cin,) + cdims)

    cell_new = (
        jnp.floor(
            (x_c - jnp.asarray(grid.origin, x_c.dtype)) / grid.spacing
        ).astype(jnp.int32)
        - jnp.asarray(box.offset, jnp.int32)
    )
    here = jnp.stack(
        jnp.meshgrid(*[jnp.arange(n, dtype=jnp.int32) for n in cdims], indexing="ij"),
        axis=-1,
    )
    delta = cell_new - here  # (C, cells…, d)
    near = jnp.all(jnp.abs(delta) <= 1, axis=-1)
    inbox = jnp.all((cell_new >= 0) & (cell_new < jnp.asarray(cdims)), axis=-1)
    act_eff = act_c & near & inbox

    import itertools

    strides = np.concatenate([np.cumprod(cdims[::-1])[-2::-1], [1]]).astype(np.int32)
    tcell_flat = jnp.sum(cell_new * jnp.asarray(strides), axis=-1)  # (C, cells…)

    # destination rank: candidates for a target cell are ordered by
    # (offset group, capacity slot); rank = running count per target cell.
    cum = jnp.zeros(cdims, jnp.int32)
    rank = jnp.zeros((Cin,) + cdims, jnp.int32)
    for d in itertools.product((0, -1, 1), repeat=nd):
        sel = act_eff & jnp.all(delta == jnp.asarray(d, jnp.int32), axis=-1)
        mi = sel.astype(jnp.int32)
        # rank in the target cell's frame, evaluated at the SOURCE slot:
        # shift cum (target-aligned) back to the source cells
        axes0 = tuple(range(nd))
        cum_src = _shift_cells(cum, cdims, tuple(-dd for dd in d), axes0)
        r = cum_src + jnp.cumsum(mi, axis=0) - mi
        rank = jnp.where(sel, r, rank)
        cum = cum + _shift_cells(jnp.sum(mi, axis=0), cdims, d, axes0)
    keep = act_eff & (rank < C)

    # Dense INVERSE permutation (no sort, no scatter): a row gather instead
    # of a row scatter, and the inverse is constructible with 3^d masked
    # compares because every destination's candidates are its 3^d
    # neighbour cells.
    axes1 = tuple(range(1, nd + 1))
    cell_flat = jnp.sum(here * jnp.asarray(strides), axis=-1)  # (cdims,)
    tgt_q = jnp.arange(C, dtype=jnp.int32).reshape((C, 1) + (1,) * nd)
    src_r = (jnp.arange(Cin, dtype=jnp.int32) * nc).reshape((Cin,) + (1,) * nd)
    inv = jnp.full((C,) + cdims, Cin * nc, jnp.int32)  # sentinel: no source
    for d in itertools.product((0, -1, 1), repeat=nd):
        doff = int(np.dot(d, strides))
        sel_d = keep & jnp.all(delta == jnp.asarray(d, jnp.int32), axis=-1)
        # target-frame views (out[t] = src[t - d]; wrapped strips zeroed)
        sel_t = _shift_cells(sel_d.astype(jnp.int32), cdims, d, axes1) > 0
        rank_t = _shift_cells(rank, cdims, d, axes1)
        src_t = src_r + (cell_flat - doff)[None]
        m = sel_t[None] & (tgt_q == rank_t[None])  # (C, Cin, cdims)
        hit = jnp.max(jnp.where(m, src_t[None], -1), axis=1)
        inv = jnp.where(hit >= 0, hit, inv)

    inv_flat = inv.reshape(-1)
    valid_row = inv_flat < Cin * nc
    safe = jnp.minimum(inv_flat, Cin * nc - 1)
    out = jnp.where(valid_row[:, None], big[safe], 0.0)
    p_new = unflatten_soa_T(out.T, specs, treedef)
    placed = jnp.sum(keep.astype(jnp.int32))
    lost = jnp.sum(act_c.astype(jnp.int32)) - placed
    return p_new, lost


def _node_slices(box: ActiveBox, grid_dims, off) -> Optional[tuple]:
    """Static cell-range/node-range intersection for one window offset.
    Returns (cell_slices, node_slices) or None if empty."""
    cs, ns = [], []
    for ax in range(len(box.cdims)):
        o = int(box.offset[ax]) + int(off[ax])
        # node index = cell_in_box + o must lie in [0, grid_dims[ax])
        c0 = max(0, -o)
        c1 = min(box.cdims[ax], grid_dims[ax] - o)
        if c1 <= c0:
            return None
        cs.append(slice(c0, c1))
        ns.append(slice(c0 + o, c1 + o))
    return tuple(cs), tuple(ns)


def p2g(
    vals: jax.Array,  # (Ns, K) or (Ns, K, c) per-edge contributions (masked)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,  # (K, d) static window offsets
    axis_name: str = None,
) -> jax.Array:
    """Windowed P2G: returns (n_nodes,) or (n_nodes, c) flat node array."""
    scalar = vals.ndim == 2
    if scalar:
        vals = vals[..., None]
    c = vals.shape[-1]
    K = vals.shape[1]
    per_cell = vals.reshape((box.capacity,) + box.cdims + (K, c)).sum(axis=0)
    out = jnp.zeros(tuple(grid.dims) + (c,), vals.dtype)
    for k in range(K):
        sl = _node_slices(box, grid.dims, offsets[k])
        if sl is None:
            continue
        cs, ns = sl
        out = out.at[ns + (slice(None),)].add(per_cell[cs + (k, slice(None))])
    out = out.reshape(grid.n_nodes, c)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    if scalar:
        out = out[:, 0]
    return out


def cell_edge_field(
    field: jax.Array,  # (n_nodes,) or (n_nodes, c)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> jax.Array:
    """Per-cell window view of a node field: out[cell, k, :] =
    field[cell + off_k] (zero outside the grid).  Built as one stack of K
    zero-padded static slices — the compile-friendly core of both G2P and
    edge gathering (every slot in a cell sees the same K node values)."""
    scalar = field.ndim == 1
    f = field.reshape(tuple(grid.dims) + ((1,) if scalar else (field.shape[-1],)))
    c = f.shape[-1]
    K = offsets.shape[0]
    nd = len(box.cdims)
    slices = []
    zero = None
    for k in range(K):
        sl = _node_slices(box, grid.dims, offsets[k])
        if sl is None:
            if zero is None:
                zero = jnp.zeros(box.cdims + (c,), f.dtype)
            slices.append(zero)
            continue
        cs, ns = sl
        fs = f[ns + (slice(None),)]
        pad = [(cs[ax].start, box.cdims[ax] - cs[ax].stop) for ax in range(nd)]
        slices.append(jnp.pad(fs, pad + [(0, 0)]))
    return jnp.stack(slices, axis=-2)  # (cells…, K, c)


def g2p(
    field: jax.Array,  # (n_nodes,) or (n_nodes, c)
    weights: jax.Array,  # (Ns, K) masked weights (e.g. shape values)
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> jax.Array:
    """Windowed G2P: out_s = Σ_k w_sk · field[cell_s + off_k] — one K
    contraction against the stacked per-cell window view."""
    scalar = field.ndim == 1
    per_cell = cell_edge_field(field, box, grid, offsets)  # (cells…, K, c)
    nd = len(box.cdims)
    nc = box.n_cells
    K = weights.shape[1]
    c = per_cell.shape[-1]
    w = weights.reshape((box.capacity, nc, K))
    pc = per_cell.reshape((nc, K, c))
    out = jnp.einsum("snk,nkc->snc", w, pc).reshape(box.n_slots, c)
    return out[:, 0] if scalar else out
