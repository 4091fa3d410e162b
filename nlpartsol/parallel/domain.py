"""Block-partitioned background grid with ppermute halo exchange.

The distributed axis of the framework (SURVEY.md §2.9/§7 step 7): for grids
too large to replicate, the structured background grid is decomposed into
contiguous strips of node planes along grid axis 0, one strip per device on
a named ``jax.sharding.Mesh`` axis.  This replaces the reference's only
parallel backend — OpenMP threads with ``#pragma omp critical`` around
scatter insertion (U-Newmark-beta.c:547-594,1783-1789) — with collectives
between devices: nearest-neighbour ``ppermute`` for halo strips, ``psum`` for Krylov dot products, and capacity-padded ``ppermute``
buffers for particle migration.

Decomposition (1-D along grid axis 0):

* the global :class:`~..ops.windowed.ActiveBox` is split into ``S`` equal
  slabs of ``bc`` cell planes; device ``s`` owns cells
  ``[box.offset0 + s·bc, box.offset0 + (s+1)·bc)`` and the corresponding
  node planes (edge devices also own the outer halo planes).
* each device works in a **device-frame coordinate system**: axis-0
  positions are shifted so the local strip starts at 0 — the SPMD program
  is identical on every device, only the (traced, sharded) shift differs.
* the local node strip has ``ln = bc + wlo + whi`` planes: ``wlo``/``whi``
  ghost planes below/above (window reach of the shape functions along
  axis 0).  Particle windows never leave the strip, so P2G/G2P stay
  the scatter-free static-slice windowed transfers of ops/windowed.py —
  just on the strip.
* **P2G**: local windowed scatter, then one ``ppermute`` per direction
  adds the ghost-plane partial sums into the neighbour's owned planes
  (:func:`halo_exchange_add`); ghost planes are then zeroed, so every grid
  vector is "owned-complete, ghost-zero" and global dot products are
  ``psum`` of local dots.
* **G2P / edge gather**: one ``ppermute`` per direction fills ghost planes
  from the neighbour's owned planes (:func:`halo_fill`) before the local
  windowed gather.
* **particle migration**: particles whose cell leaves the owned slab are
  packed into fixed-capacity buffers (one wide row-gather over the
  flattened SoA), ``ppermute``'d to the adjacent shard, merged and re-binned
  (:func:`migrate_and_rebin`).  CFL < 1 bounds per-step drift to one cell,
  so migration is nearest-neighbour by construction.

If the active box sits closer than the window halfwidth to the global grid
edge along axis 0, the local strips extend past the global grid; those
phantom planes are masked per-device via ``Grid.valid_lo/valid_hi`` so the
basis renormalises exactly as the single-device grid would at its boundary.
"""

from __future__ import annotations

import dataclasses
from functools import partial, reduce

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import config
from ..ops import windowed
from ..types import Grid, Particles

GRID_AXIS = "g"


def _prod(xs):
    return reduce(lambda a, b: a * b, xs, 1)


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static (hashable) description of the 1-D grid decomposition; lives in
    step configs as a static field and drives the halo collectives."""

    axis_name: str
    n_shards: int
    wlo: int  # ghost planes below = -min(window offsets along axis 0)
    whi: int  # ghost planes above = +max(...)
    bc: int   # owned cell planes per shard along axis 0
    ln: int   # local node planes = bc + wlo + whi

    @property
    def owned(self):
        """Local plane slice owned by interior devices."""
        return slice(self.wlo, self.wlo + self.bc)


def plane_owned_mask(spec: HaloSpec) -> jax.Array:
    """(ln,) bool: which local node planes this device owns.  Interior
    devices own [wlo, wlo+bc); the first/last device also own the outer
    ghost planes (no neighbour exists to own them, and only their own
    particles can reach them)."""
    j = jnp.arange(spec.ln)
    dev = jax.lax.axis_index(spec.axis_name)
    lo_ok = (j >= spec.wlo) | (dev == 0)
    hi_ok = (j < spec.wlo + spec.bc) | (dev == spec.n_shards - 1)
    return lo_ok & hi_ok


def _as_planes(f: jax.Array, spec: HaloSpec):
    """(n_local[, c]) node vector → (ln, rest[*c]) plane-major view."""
    return f.reshape((spec.ln, -1))


def halo_exchange_add(f: jax.Array, spec: HaloSpec) -> jax.Array:
    """Complete a locally-scattered node field: add ghost-plane partial sums
    into the neighbours' owned planes, then zero the ghosts.  Result is
    owned-complete / ghost-zero (the invariant every sharded grid vector
    carries).  The P2G seam of the distributed design (SURVEY.md §7 step 7);
    replaces the reference's omp-critical scatter (U-Newmark-beta.c:582)."""
    S, ax = spec.n_shards, spec.axis_name
    if S == 1:
        return f
    shape = f.shape
    g = _as_planes(f, spec)
    if spec.wlo > 0:
        # my bottom ghost slab belongs to the previous shard's top planes
        from_up = jax.lax.ppermute(
            g[: spec.wlo], ax, [(s, s - 1) for s in range(1, S)]
        )
        g = g.at[spec.bc : spec.bc + spec.wlo].add(from_up)
    if spec.whi > 0:
        # my top ghost slab belongs to the next shard's bottom planes
        from_dn = jax.lax.ppermute(
            g[spec.wlo + spec.bc :], ax, [(s, s + 1) for s in range(S - 1)]
        )
        g = g.at[spec.wlo : spec.wlo + spec.whi].add(from_dn)
    owned = plane_owned_mask(spec)
    g = jnp.where(owned[:, None], g, 0.0)
    return g.reshape(shape)


def halo_fill(f: jax.Array, spec: HaloSpec) -> jax.Array:
    """Fill ghost planes of an owned-complete node field from the
    neighbours' owned planes (the G2P / edge-gather seam)."""
    S, ax = spec.n_shards, spec.axis_name
    if S == 1:
        return f
    shape = f.shape
    g = _as_planes(f, spec)
    out = g
    if spec.wlo > 0:
        # my bottom ghosts mirror the previous shard's top owned planes
        from_dn = jax.lax.ppermute(
            g[spec.bc : spec.bc + spec.wlo], ax, [(s, s + 1) for s in range(S - 1)]
        )
        out = out.at[: spec.wlo].set(from_dn)
    if spec.whi > 0:
        from_up = jax.lax.ppermute(
            g[spec.wlo : spec.wlo + spec.whi], ax, [(s, s - 1) for s in range(1, S)]
        )
        out = out.at[spec.wlo + spec.bc :].set(from_up)
    # edge devices own their outer planes: keep their own values there
    owned = plane_owned_mask(spec)
    out = jnp.where(owned[:, None], g, out)
    return out.reshape(shape)


@dataclasses.dataclass
class Decomp:
    """Host-side decomposition bundle (specs + local templates)."""

    spec: HaloSpec
    global_grid: Grid
    global_box: windowed.ActiveBox
    local_grid: Grid  # template: dims/origin only (device frame)
    local_box: windowed.ActiveBox
    mig_capacity: int
    margin: int = 0  # drift margin baked into the halo width (k-periodic)

    @property
    def n_local_nodes(self) -> int:
        return self.local_grid.n_nodes

    def base_plane(self, s: int) -> int:
        """Global node-plane index of the local strip's plane 0 (may be
        negative / beyond the grid: phantom planes, masked via valid_lo/hi)."""
        return self.global_box.offset[0] + s * self.spec.bc - self.spec.wlo

    def shift(self, s: int) -> np.ndarray:
        """World-coordinate shift of device s's frame: x_local = x - shift."""
        sh = np.zeros(self.global_grid.dim, np.float64)
        sh[0] = self.global_grid.origin[0] + self.base_plane(s) * self.global_grid.spacing
        return sh


def decompose(
    grid: Grid,
    box: windowed.ActiveBox,
    n_shards: int,
    offsets: np.ndarray,
    axis_name: str = GRID_AXIS,
    mig_capacity: int = None,
    margin: int = 0,
) -> Decomp:
    """Build the 1-D decomposition of (grid, box) over ``n_shards`` devices.

    ``offsets`` is the shape-function window (K, d) — its axis-0 reach sets
    the halo width.  ``margin`` widens the halo by the drift tolerance of
    k-periodic seam migration (rebin_every > 1): particles may sit up to
    ``margin`` cells outside their slot cell between migrations, so their
    margin-widened kernel windows reach ``margin`` extra node planes past
    the seam.  Any ``box.cdims[0]`` works: the box is auto-padded
    with empty cell planes up to the next multiple of ``n_shards`` (the
    padding binds no particles and its node slices clamp to the grid).
    Slabs must still be at least one halo wide (nearest-neighbour-only
    exchange)."""
    offs0 = np.asarray(offsets)[:, 0]
    wlo = int(-offs0.min()) + int(margin)
    whi = int(offs0.max()) + int(margin)
    S = int(n_shards)
    if box.cdims[0] % S:
        pad = S - box.cdims[0] % S
        box = windowed.ActiveBox(
            offset=box.offset,
            cdims=(box.cdims[0] + pad,) + tuple(box.cdims[1:]),
            capacity=box.capacity,
        )
    bc = box.cdims[0] // S
    if bc < max(wlo, whi, 1):
        raise ValueError(
            f"slab of {bc} cell planes is thinner than the halo "
            f"(wlo={wlo}, whi={whi}): use fewer shards or a larger box"
        )
    ln = bc + wlo + whi
    spec = HaloSpec(axis_name=axis_name, n_shards=S, wlo=wlo, whi=whi, bc=bc, ln=ln)
    local_grid = Grid(
        dims=(ln,) + tuple(grid.dims[1:]),
        spacing=grid.spacing,
        origin=(0.0,) + tuple(grid.origin[1:]),
    )
    local_box = windowed.ActiveBox(
        offset=(wlo,) + tuple(box.offset[1:]),
        cdims=(bc,) + tuple(box.cdims[1:]),
        capacity=box.capacity,
    )
    if mig_capacity is None:
        # CFL < 1 ⇒ at most one cell plane's worth of particles crosses a
        # seam per step
        mig_capacity = box.capacity * _prod(box.cdims[1:])
    return Decomp(
        spec=spec,
        global_grid=grid,
        global_box=box,
        local_grid=local_grid,
        local_box=local_box,
        mig_capacity=int(mig_capacity),
        margin=int(margin),
    )


# ---------------------------------------------------------------------------
# host-side sharding / unsharding
# ---------------------------------------------------------------------------


def shard_grid(grid: Grid, decomp: Decomp, shards=None) -> Grid:
    """Local-strip Grid pytree, stacked over shards on the leading axis
    (shard with ``P(axis_name)``): Dirichlet/active arrays sliced into the
    per-device extended strips (phantom planes padded inert), plus the
    per-device plane-validity scalars.  ``shards`` restricts to a subset of
    shard indices (multi-host: each process builds only the strips of its
    addressable devices, parallel/multihost.py)."""
    spec = decomp.spec
    dims = grid.dims
    n0 = dims[0]
    if shards is None:
        shards = range(spec.n_shards)

    def strips(arr, fill):
        a = np.asarray(arr)
        trail = a.shape[1:]
        full = a.reshape(dims + trail)
        segs = []
        for s in shards:
            base = decomp.base_plane(s)
            seg = np.full((spec.ln,) + full.shape[1:], fill, a.dtype)
            lo, hi = max(0, base), min(n0, base + spec.ln)
            if hi > lo:
                seg[lo - base : hi - base] = full[lo:hi]
            segs.append(seg.reshape((-1,) + trail))
        return jnp.asarray(np.concatenate(segs, axis=0))

    dm = None if grid.dirichlet_mask is None else strips(grid.dirichlet_mask, False)
    dv = None if grid.dirichlet_value is None else strips(grid.dirichlet_value, 0.0)
    act = None if grid.active is None else strips(grid.active, False)
    vlo = jnp.asarray(
        [max(0, -decomp.base_plane(s)) for s in shards], jnp.int32
    )
    vhi = jnp.asarray(
        [min(spec.ln - 1, n0 - 1 - decomp.base_plane(s)) for s in shards],
        jnp.int32,
    )
    return decomp.local_grid.replace(
        dirichlet_mask=dm,
        dirichlet_value=dv,
        active=act,
        valid_lo=vlo,
        valid_hi=vhi,
    )


def shard_particles(p: Particles, decomp: Decomp, shards=None) -> Particles:
    """Bin particles to the shard owning their cell, shift to device frames,
    and stack the per-device slot layouts on the leading axis (shard with
    ``P(axis_name)``).  Raises if any active particle fits no shard (outside
    the box or over capacity).  ``shards`` restricts to a subset of shard
    indices (multi-host; the fit-check is then skipped — other processes own
    the rest)."""
    spec = decomp.spec
    check = shards is None
    if shards is None:
        shards = range(spec.n_shards)
    parts = []
    kept = 0
    for s in shards:
        shift = jnp.asarray(decomp.shift(s), p.x.dtype)
        ps = p.replace(x=p.x - shift)
        binning = windowed.bin_particles(
            decomp.local_grid, decomp.local_box, ps.x, ps.active
        )
        loc = windowed.permute_to_slots(ps, binning)
        kept += int(jnp.sum(loc.active))
        parts.append(loc)
    n_active = int(jnp.sum(p.active))
    if check and kept != n_active:
        raise ValueError(
            f"shard_particles: {n_active - kept} active particles fit no "
            f"shard (outside the active box, or a cell overflowed capacity "
            f"{decomp.global_box.capacity})"
        )
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


def unshard_particles(p_stacked: Particles, decomp: Decomp) -> Particles:
    """Undo :func:`shard_particles` for I/O: shift device frames back to
    world coordinates and concatenate (slot padding rides along as inactive
    rows)."""
    spec = decomp.spec
    ns = decomp.local_box.n_slots
    outs = []
    for s in range(spec.n_shards):
        loc = jax.tree_util.tree_map(
            lambda a: a[s * ns : (s + 1) * ns], p_stacked
        )
        shift = jnp.asarray(decomp.shift(s), loc.x.dtype)
        outs.append(loc.replace(x=loc.x + shift))
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)


# ---------------------------------------------------------------------------
# particle migration (device-side, inside shard_map)
# ---------------------------------------------------------------------------


def _leaf_columns(p: Particles):
    """Column offsets of the x and active leaves in the flattened SoA."""
    leaves, _ = jax.tree_util.tree_flatten(p)
    cols = {}
    off = 0
    for a in leaves:
        ch = int(_prod(a.shape[1:])) if a.ndim > 1 else 1
        if a is p.x:
            cols["x"] = off
        if a is p.active:
            cols["active"] = off
        off += ch
    assert "x" in cols and "active" in cols
    return cols


def migrate_and_rebin(
    p: Particles,
    spec: HaloSpec,
    local_grid: Grid,
    local_box: windowed.ActiveBox,
    mig_capacity: int,
):
    """Ship particles whose cell left the owned slab to the adjacent shard
    and re-bin the merged set into the local slot layout.

    The reference has no analog (single-process); this is the particle
    re-binning leg of the SURVEY §7 step-7 design.  Returns (particles,
    lost) where ``lost`` counts particles that left the global box, crossed
    more than one shard per step (CFL violation), or overflowed the
    migration buffers / cell capacity."""
    S, ax = spec.n_shards, spec.axis_name
    h = local_grid.spacing
    c0 = jnp.floor(p.x[:, 0] / h).astype(jnp.int32)
    act = p.active
    godown = act & (c0 < spec.wlo)
    goup = act & (c0 >= spec.wlo + spec.bc)

    big, soa_specs, treedef = windowed.flatten_soa(p)
    cols = _leaf_columns(p)
    xcol, acol = cols["x"], cols["active"]
    shift = spec.bc * h

    def pack(flag, dx0):
        order = jnp.argsort(jnp.logical_not(flag), stable=True)  # True rows first
        idx = order[:mig_capacity]
        valid = flag[idx]
        buf = jnp.where(valid[:, None], big[idx], 0.0)
        buf = buf.at[:, xcol].add(jnp.where(valid, dx0, 0.0))
        overflow = jnp.sum(flag.astype(jnp.int32)) - jnp.sum(valid.astype(jnp.int32))
        return buf, overflow

    if S > 1:
        dbuf, dover = pack(godown, shift)  # shipped down: frame shifts up by bc·h
        ubuf, uover = pack(goup, -shift)
        recv_from_up = jax.lax.ppermute(dbuf, ax, [(s, s - 1) for s in range(1, S)])
        recv_from_dn = jax.lax.ppermute(ubuf, ax, [(s, s + 1) for s in range(S - 1)])
        stay = act & ~godown & ~goup
        big = big.at[:, acol].set(stay.astype(jnp.float32))
        big_all = jnp.concatenate([big, recv_from_up, recv_from_dn], axis=0)
    else:
        big_all = big
        dover = uover = jnp.zeros((), jnp.int32)

    p_all = windowed.unflatten_soa(big_all, soa_specs, treedef)
    binning = windowed.bin_particles(local_grid, local_box, p_all.x, p_all.active)
    p_new = windowed.permute_to_slots(p_all, binning)

    if S > 1:
        dev = jax.lax.axis_index(ax)
        lost_edge = jnp.where(
            dev == 0, jnp.sum(godown.astype(jnp.int32)), 0
        ) + jnp.where(dev == S - 1, jnp.sum(goup.astype(jnp.int32)), 0)
        lost = (
            binning.lost
            + lost_edge
            + jnp.where(dev > 0, dover, 0)
            + jnp.where(dev < S - 1, uover, 0)
        )
    else:
        lost = binning.lost
    return p_new, lost


def slot_plane_halo(
    arrs: dict,
    spec: HaloSpec,
    box: windowed.ActiveBox,
    reach: int,
    h: float,
    x_key: str = "x",
):
    """PARTICLE halo for nonlocal neighbourhood sums (Beps fracture,
    src/Constitutive/Fracture/Beps.c:15-60): extend capacity-major slot
    arrays with ``reach`` ghost CELL planes per side along the sharded axis,
    filled from the neighbours' seam planes via ppermute.  Positions in
    ``arrs[x_key]`` are shifted into the local frame (±bc·h).  Edge shards
    receive zeros (inactive ghosts).

    Returns (ext_arrs, ext_box): slot arrays of the extended box with
    cdims[0] = bc + 2·reach and offset[0] shifted by −reach; slice planes
    [reach, reach+bc) of the outputs to get back owned slots.
    """
    S, ax = spec.n_shards, spec.axis_name
    C = box.capacity
    bc = box.cdims[0]
    rest = box.n_cells // bc
    r = int(reach)
    assert 1 <= r <= bc

    ext_box = windowed.ActiveBox(
        offset=(box.offset[0] - r,) + tuple(box.offset[1:]),
        cdims=(bc + 2 * r,) + tuple(box.cdims[1:]),
        capacity=C,
    )

    def extend(name, a):
        trail = a.shape[1:]
        v = a.reshape((C, bc, rest) + trail)
        top = v[:, bc - r :]
        bot = v[:, :r]
        if name == x_key:
            top = top.at[..., 0].add(-spec.bc * h)  # sent upward: s → s+1
            bot = bot.at[..., 0].add(spec.bc * h)   # sent downward: s → s−1
        if S > 1:
            from_dn = jax.lax.ppermute(top, ax, [(s, s + 1) for s in range(S - 1)])
            from_up = jax.lax.ppermute(bot, ax, [(s, s - 1) for s in range(1, S)])
        else:
            from_dn = jnp.zeros_like(top)
            from_up = jnp.zeros_like(bot)
        out = jnp.concatenate([from_dn, v, from_up], axis=1)
        return out.reshape((C * (bc + 2 * r) * rest,) + trail)

    return {k: extend(k, a) for k, a in arrs.items()}, ext_box


def slot_plane_restrict(a: jax.Array, spec: HaloSpec, box: windowed.ActiveBox,
                        reach: int) -> jax.Array:
    """Slice the owned planes out of a :func:`slot_plane_halo`-extended slot
    array (inverse of the extension for per-slot outputs)."""
    C = box.capacity
    bc = box.cdims[0]
    rest = box.n_cells // bc
    r = int(reach)
    trail = a.shape[1:]
    v = a.reshape((C, bc + 2 * r, rest) + trail)
    return v[:, r : r + bc].reshape((C * bc * rest,) + trail)


def migrate_local(
    p: Particles,
    spec: HaloSpec,
    local_grid: Grid,
    local_box: windowed.ActiveBox,
):
    """Sort-free seam migration + re-bin (replaces :func:`migrate_and_rebin`'s
    per-step ``argsort``).

    Under CFL ≤ 1 a particle drifts ≤ 1 cell per step, so the only particles
    that change owner live in the first/last owned cell plane.  Those plane
    slot buffers (capacity-padded by construction — no compaction, no sort)
    ship to the adjacent shard via ``ppermute``; the merged set (own slots +
    received buffers as extra capacity rows on the seam planes) is then
    compacted back to capacity C by the counting re-bin of
    :func:`~..ops.windowed.local_rebin` at input capacity 2C.

    Returns (particles, lost): lost counts particles that left the global
    box (edge shards), drifted > 1 cell, or overflowed a cell's capacity.
    """
    S, ax = spec.n_shards, spec.axis_name
    C = local_box.capacity
    cdims = local_box.cdims
    bc = cdims[0]
    nc = local_box.n_cells
    rest = nc // bc
    h = local_grid.spacing
    if S == 1:
        return windowed.local_rebin(p, local_grid, local_box)

    big, specs, treedef = windowed.flatten_soa(p)  # (C·nc, CH)
    CH = big.shape[1]
    cols = _leaf_columns(p)
    xcol, acol = cols["x"], cols["active"]
    bigc = big.reshape(C, bc, rest, CH)
    c0new = (
        jnp.floor(p.x[:, 0] / h).astype(jnp.int32).reshape(C, bc, rest)
        - local_box.offset[0]
    )
    act = p.active.reshape(C, bc, rest)

    godown = act[:, 0] & (c0new[:, 0] < 0)  # (C, rest)
    goup = act[:, -1] & (c0new[:, -1] >= bc)
    shift = spec.bc * h
    dbuf = jnp.where(godown[..., None], bigc[:, 0], 0.0)
    dbuf = dbuf.at[..., xcol].add(jnp.where(godown, shift, 0.0))
    ubuf = jnp.where(goup[..., None], bigc[:, -1], 0.0)
    ubuf = ubuf.at[..., xcol].add(jnp.where(goup, -shift, 0.0))
    recv_from_up = jax.lax.ppermute(dbuf, ax, [(s, s - 1) for s in range(1, S)])
    recv_from_dn = jax.lax.ppermute(ubuf, ax, [(s, s + 1) for s in range(S - 1)])

    # deactivate shipped rows locally (zero the whole row, as pack() does)
    keep0 = ~godown
    keepl = ~goup
    bigc = bigc.at[:, 0].set(jnp.where(keep0[..., None], bigc[:, 0], 0.0))
    bigc = bigc.at[:, -1].set(jnp.where(keepl[..., None], bigc[:, -1], 0.0))

    # extra capacity rows: received buffers live on the seam planes.  With
    # bc ≥ 2 the two seams are distinct planes and share one C-block; a
    # single-plane slab (bc = 1) gets one block per direction so rows never
    # collide.
    if bc >= 2:
        extra = jnp.zeros((C, bc, rest, CH), big.dtype)
        extra = extra.at[:, bc - 1].set(recv_from_up)
        extra = extra.at[:, 0].set(recv_from_dn)
        blocks = [bigc, extra]
    else:
        eu = jnp.zeros((C, bc, rest, CH), big.dtype).at[:, 0].set(recv_from_up)
        ed = jnp.zeros((C, bc, rest, CH), big.dtype).at[:, 0].set(recv_from_dn)
        blocks = [bigc, eu, ed]
    ext = jnp.concatenate(blocks, axis=0)
    Cin = C * len(blocks)

    p_ext = windowed.unflatten_soa(ext.reshape(Cin * nc, CH), specs, treedef)
    p_new, lost_rebin = windowed.local_rebin(
        p_ext, local_grid, local_box, in_capacity=Cin
    )

    dev = jax.lax.axis_index(ax)
    lost_edge = jnp.where(
        dev == 0, jnp.sum(godown.astype(jnp.int32)), 0
    ) + jnp.where(dev == S - 1, jnp.sum(goup.astype(jnp.int32)), 0)
    return p_new, lost_rebin + lost_edge


# ---------------------------------------------------------------------------
# sharded drivers
# ---------------------------------------------------------------------------


def make_mesh(n_devices: int = None, devices=None, axis_name: str = GRID_AXIS) -> Mesh:
    if devices is None:
        avail = jax.devices()
        want = n_devices or len(avail)
        if want > len(avail):
            raise ValueError(
                f"make_mesh: {want} devices requested but only {len(avail)} "
                f"available (CPU: set jax_num_cpu_devices before backend init)"
            )
        devices = avail[:want]
    return Mesh(np.array(devices), (axis_name,))


def _localize_cfg(cfg, decomp: Decomp):
    """Step config for the local strip: keeps the configured transfer engine
    ('pallas' fused kernels now run under halo sharding — one path for perf
    AND scale; anything else falls back to 'windowed')."""
    transfer = getattr(cfg, "transfer", "windowed")
    if transfer not in ("windowed", "pallas"):
        transfer = "windowed"
    kw = dict(
        transfer=transfer,
        active_box=decomp.local_box,
        halo=decomp.spec,
        axis_name=decomp.spec.axis_name,
        prebinned=True,
    )
    if transfer == "pallas":
        # the sharded drivers re-bin via migrate_local after each step
        kw["rebin_mode"] = "none"
    return cfg.replace(**kw)


def sharded_explicit_run(mesh: Mesh, decomp: Decomp, cfg, n_steps: int):
    """jit-ready callable (p_stacked, grid_stacked, mats, body) →
    (p_stacked', diag) running ``n_steps`` halo-sharded explicit steps,
    under shard_map over the grid axis.

    Seam migration is k-PERIODIC for the fused-pallas engine when
    ``cfg.rebin_every = k > 1`` (the single-chip rebin amortisation,
    extended across seams): the kernels run with a
    1-cell drift margin, the halo carries ``margin`` extra planes
    (``decompose(margin=1)`` — enforced here), and :func:`migrate_local`
    fires every k-th step only.  Drift > 1 cell between firings (particle
    speed > c/(k·CFL)) is counted loudly in ``lost`` at the firing, exactly
    like the single-chip path.  The windowed engine keeps per-step
    migration (its static windows carry no drift margin)."""
    from jax import shard_map

    from ..formulations.explicit import explicit_step

    spec = decomp.spec
    cfgl = _localize_cfg(cfg, decomp)
    k = getattr(cfgl, "rebin_every", 1) if cfgl.transfer == "pallas" else 1
    if k > 1:
        if decomp.margin < 1:
            raise ValueError(
                "k-periodic seam migration (rebin_every > 1) needs the "
                "drift-widened halo: build the decomposition with "
                "decompose(..., margin=1)"
            )
        if n_steps % k:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of rebin_every={k} "
                "(the migration period tiles the scan)"
            )
    pspec = P(spec.axis_name)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, pspec, rep, rep),
        out_specs=(pspec, rep),
        check_vma=True,
    )
    def run(p, grid, mats, body):
        def step_only(carry, _):
            pp, lost_acc = carry
            pp, diag = explicit_step(pp, grid, mats, cfgl, body)
            return (pp, lost_acc), (
                diag["kinetic_energy"],
                diag["strain_energy"],
                diag["nnz"],
            )

        def step_and_migrate(carry, _):
            carry, out = step_only(carry, None)
            pp, lost_acc = carry
            pp, lost = migrate_local(pp, spec, grid, decomp.local_box)
            lost = jax.lax.psum(lost, spec.axis_name)
            return (pp, lost_acc + lost), out

        if k > 1:
            def outer(carry, _):
                carry, o1 = jax.lax.scan(step_only, carry, None, length=k - 1)
                carry, o2 = step_and_migrate(carry, None)
                out = jax.tree_util.tree_map(
                    lambda a, b: jnp.concatenate([a, b[None]]), o1, o2
                )
                return carry, out

            (p_out, lost), (ke, se, nnz) = jax.lax.scan(
                outer, (p, jnp.zeros((), jnp.int32)), None, length=n_steps // k
            )
            ke, se, nnz = ke.reshape(-1), se.reshape(-1), nnz.reshape(-1)
        else:
            (p_out, lost), (ke, se, nnz) = jax.lax.scan(
                step_and_migrate,
                (p, jnp.zeros((), jnp.int32)),
                None,
                length=n_steps,
            )
        return p_out, dict(
            kinetic_energy=ke, strain_energy=se, nnz=nnz, lost=lost
        )

    return run


def sharded_upw_run(mesh: Mesh, decomp: Decomp, cfg, mix, n_steps: int):
    """Halo-sharded explicit two-phase (upw) run — the geotech flagship
    (upw_Verlet, U-pw-Verlet.c:60) on the block-partitioned grid with
    per-step seam migration.  ``pw`` Dirichlet masks, when needed, must be
    passed pre-stacked into strips like the grid arrays."""
    from jax import shard_map

    from ..formulations.upw import upw_step

    spec = decomp.spec
    cfgl = _localize_cfg(cfg, decomp)
    pspec = P(spec.axis_name)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, pspec, rep, rep),
        out_specs=(pspec, rep),
        check_vma=True,
    )
    def run(p, grid, mats, body):
        def body_fn(carry, _):
            pp, lost_acc = carry
            pp, diag = upw_step(pp, grid, mats, mix, cfgl, body)
            pp, lost = migrate_local(pp, spec, grid, decomp.local_box)
            lost = jax.lax.psum(lost, spec.axis_name)
            return (pp, lost_acc + lost), diag["nnz"]

        (p_out, lost), nnz = jax.lax.scan(
            body_fn, (p, jnp.zeros((), jnp.int32)), None, length=n_steps
        )
        return p_out, dict(nnz=nnz, lost=lost)

    return run


def sharded_implicit_run(mesh: Mesh, decomp: Decomp, cfg, n_steps: int):
    """Halo-sharded implicit Newmark run: distributed residual assembly
    (halo P2G), matrix-free Newton-CG with psum dot products, particle
    migration per step."""
    from jax import shard_map

    from ..formulations.implicit import implicit_step

    spec = decomp.spec
    cfgl = _localize_cfg(cfg, decomp)
    pspec = P(spec.axis_name)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, pspec, rep, rep),
        out_specs=(pspec, rep),
        check_vma=True,
    )
    def run(p, grid, mats, body):
        def body_fn(carry, _):
            pp, lost_acc = carry
            pp, diag = implicit_step(pp, grid, mats, cfgl, body)
            pp, lost = migrate_local(pp, spec, grid, decomp.local_box)
            lost = jax.lax.psum(lost, spec.axis_name)
            return (pp, lost_acc + lost), (
                diag["newton_iters"],
                diag["newton_residual"],
                diag["converged"],
            )

        (p_out, lost), (iters, rnorm, conv) = jax.lax.scan(
            body_fn, (p, jnp.zeros((), jnp.int32)), None, length=n_steps
        )
        return p_out, dict(
            newton_iters=iters, newton_residual=rnorm, converged=conv, lost=lost
        )

    return run


# ---------------------------------------------------------------------------
# 2-D grid decomposition (SURVEY §7 step 7: "1-D/2-D host×chip mesh")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloSpec2:
    """Static description of the 2-D decomposition: grid axes 0 and 1 are
    split over a (S0, S1) device mesh.  Halo exchange is the standard
    TWO-PHASE pattern — axis 0 first over the full local extent (ghost
    columns included), then axis 1 — so corner contributions travel in two
    nearest-neighbour hops and no diagonal ppermute is ever needed."""

    axes: tuple  # (axis0_name, axis1_name)
    shards: tuple  # (S0, S1)
    wlo: tuple  # ghost planes below per split axis
    whi: tuple
    bc: tuple  # owned cell planes per shard per split axis
    ln: tuple  # local node planes per split axis

    @property
    def axis_name(self):
        """Collective axis spec for psums over the whole mesh."""
        return self.axes


def _plane_own_mask2(spec: HaloSpec2, axis: int) -> jax.Array:
    j = jnp.arange(spec.ln[axis])
    dev = jax.lax.axis_index(spec.axes[axis])
    lo_ok = (j >= spec.wlo[axis]) | (dev == 0)
    hi_ok = (j < spec.wlo[axis] + spec.bc[axis]) | (dev == spec.shards[axis] - 1)
    return lo_ok & hi_ok


def _axis_exchange_add(g, spec: HaloSpec2, axis: int):
    """1-D exchange-add along one split axis of a (ln0, ln1, rest) view."""
    S = spec.shards[axis]
    ax = spec.axes[axis]
    wlo, whi, bc = spec.wlo[axis], spec.whi[axis], spec.bc[axis]
    mv = jnp.moveaxis(g, axis, 0)
    if S > 1:
        if wlo > 0:
            from_up = jax.lax.ppermute(
                mv[:wlo], ax, [(s, s - 1) for s in range(1, S)]
            )
            mv = mv.at[bc : bc + wlo].add(from_up)
        if whi > 0:
            from_dn = jax.lax.ppermute(
                mv[wlo + bc :], ax, [(s, s + 1) for s in range(S - 1)]
            )
            mv = mv.at[wlo : wlo + whi].add(from_dn)
    owned = _plane_own_mask2(spec, axis)
    mv = jnp.where(owned.reshape((-1,) + (1,) * (mv.ndim - 1)), mv, 0.0)
    return jnp.moveaxis(mv, 0, axis)


def _axis_fill(g, spec: HaloSpec2, axis: int):
    S = spec.shards[axis]
    ax = spec.axes[axis]
    wlo, whi, bc = spec.wlo[axis], spec.whi[axis], spec.bc[axis]
    mv = jnp.moveaxis(g, axis, 0)
    out = mv
    if S > 1:
        if wlo > 0:
            from_dn = jax.lax.ppermute(
                mv[bc : bc + wlo], ax, [(s, s + 1) for s in range(S - 1)]
            )
            out = out.at[:wlo].set(from_dn)
        if whi > 0:
            from_up = jax.lax.ppermute(
                mv[wlo : wlo + whi], ax, [(s, s - 1) for s in range(1, S)]
            )
            out = out.at[wlo + bc :].set(from_up)
    owned = _plane_own_mask2(spec, axis)
    out = jnp.where(owned.reshape((-1,) + (1,) * (mv.ndim - 1)), mv, out)
    return jnp.moveaxis(out, 0, axis)


def halo_exchange_add2(f: jax.Array, spec: HaloSpec2) -> jax.Array:
    """Owned-complete / ghost-zero on BOTH split axes (two-phase)."""
    shape = f.shape
    g = f.reshape((spec.ln[0], spec.ln[1], -1))
    g = _axis_exchange_add(g, spec, 0)
    g = _axis_exchange_add(g, spec, 1)
    return g.reshape(shape)


def halo_fill2(f: jax.Array, spec: HaloSpec2) -> jax.Array:
    shape = f.shape
    g = f.reshape((spec.ln[0], spec.ln[1], -1))
    g = _axis_fill(g, spec, 0)
    g = _axis_fill(g, spec, 1)
    return g.reshape(shape)


# route the generic entry points (the step functions call these)
_halo_exchange_add_1d = halo_exchange_add
_halo_fill_1d = halo_fill


def halo_exchange_add(f, spec):
    if isinstance(spec, HaloSpec2):
        return halo_exchange_add2(f, spec)
    return _halo_exchange_add_1d(f, spec)


def halo_fill(f, spec):
    if isinstance(spec, HaloSpec2):
        return halo_fill2(f, spec)
    return _halo_fill_1d(f, spec)


@dataclasses.dataclass
class Decomp2:
    spec: HaloSpec2
    global_grid: Grid
    global_box: windowed.ActiveBox
    local_grid: Grid
    local_box: windowed.ActiveBox
    margin: int = 0

    def base_plane(self, axis: int, s: int) -> int:
        return (
            self.global_box.offset[axis]
            + s * self.spec.bc[axis]
            - self.spec.wlo[axis]
        )

    def shift(self, s0: int, s1: int) -> np.ndarray:
        sh = np.zeros(self.global_grid.dim, np.float64)
        sh[0] = (
            self.global_grid.origin[0]
            + self.base_plane(0, s0) * self.global_grid.spacing
        )
        sh[1] = (
            self.global_grid.origin[1]
            + self.base_plane(1, s1) * self.global_grid.spacing
        )
        return sh


def decompose2(
    grid: Grid,
    box: windowed.ActiveBox,
    shards: tuple,
    offsets: np.ndarray,
    axis_names: tuple = ("g0", "g1"),
    margin: int = 0,
) -> Decomp2:
    """2-D decomposition: grid axes 0 and 1 split over (S0, S1) devices.
    Same auto-padding / min-slab rules as :func:`decompose`, per axis."""
    offs = np.asarray(offsets)
    S0, S1 = int(shards[0]), int(shards[1])
    w = []
    cd = list(box.cdims)
    for a, S in ((0, S0), (1, S1)):
        wlo = int(-offs[:, a].min()) + int(margin)
        whi = int(offs[:, a].max()) + int(margin)
        if cd[a] % S:
            cd[a] += S - cd[a] % S
        bca = cd[a] // S
        if bca < max(wlo, whi, 1):
            raise ValueError(
                f"axis {a}: slab of {bca} cell planes is thinner than the "
                f"halo (wlo={wlo}, whi={whi}): use fewer shards or a larger "
                f"box"
            )
        w.append((wlo, whi, bca))
    box = windowed.ActiveBox(
        offset=box.offset, cdims=tuple(cd) + tuple(box.cdims[2:]),
        capacity=box.capacity,
    )
    (w0lo, w0hi, bc0), (w1lo, w1hi, bc1) = w
    ln0 = bc0 + w0lo + w0hi
    ln1 = bc1 + w1lo + w1hi
    spec = HaloSpec2(
        axes=tuple(axis_names), shards=(S0, S1), wlo=(w0lo, w1lo),
        whi=(w0hi, w1hi), bc=(bc0, bc1), ln=(ln0, ln1),
    )
    local_grid = Grid(
        dims=(ln0, ln1) + tuple(grid.dims[2:]),
        spacing=grid.spacing,
        origin=(0.0, 0.0) + tuple(grid.origin[2:]),
    )
    local_box = windowed.ActiveBox(
        offset=(w0lo, w1lo) + tuple(box.offset[2:]),
        cdims=(bc0, bc1) + tuple(box.cdims[2:]),
        capacity=box.capacity,
    )
    return Decomp2(
        spec=spec, global_grid=grid, global_box=box, local_grid=local_grid,
        local_box=local_box, margin=int(margin),
    )


def make_mesh2(shards: tuple, axis_names: tuple = ("g0", "g1")) -> Mesh:
    S0, S1 = shards
    avail = jax.devices()
    if S0 * S1 > len(avail):
        raise ValueError(
            f"make_mesh2: {S0 * S1} devices requested, {len(avail)} available"
        )
    return Mesh(np.array(avail[: S0 * S1]).reshape(S0, S1), tuple(axis_names))


def shard_grid2(grid: Grid, dec: Decomp2) -> Grid:
    """Per-device local strips stacked on the leading axis, (s0, s1)-major
    — shard with ``P((axis0, axis1))``.  valid_lo/valid_hi are per-device
    (d,) vectors bounding REAL node planes on both split axes."""
    spec = dec.spec
    dims = grid.dims
    d = grid.dim

    def strips(arr, fill):
        a = np.asarray(arr)
        trail = a.shape[1:]
        full = a.reshape(dims + trail)
        segs = []
        for s0 in range(spec.shards[0]):
            for s1 in range(spec.shards[1]):
                b0, b1 = dec.base_plane(0, s0), dec.base_plane(1, s1)
                seg = np.full(
                    (spec.ln[0], spec.ln[1]) + dims[2:] + trail, fill, a.dtype
                )
                lo0, hi0 = max(0, b0), min(dims[0], b0 + spec.ln[0])
                lo1, hi1 = max(0, b1), min(dims[1], b1 + spec.ln[1])
                if hi0 > lo0 and hi1 > lo1:
                    seg[lo0 - b0 : hi0 - b0, lo1 - b1 : hi1 - b1] = full[
                        lo0:hi0, lo1:hi1
                    ]
                segs.append(seg.reshape((-1,) + trail))
        return jnp.asarray(np.concatenate(segs, axis=0))

    dm = None if grid.dirichlet_mask is None else strips(grid.dirichlet_mask, False)
    dv = None if grid.dirichlet_value is None else strips(grid.dirichlet_value, 0.0)
    act = None if grid.active is None else strips(grid.active, False)
    vlo, vhi = [], []
    for s0 in range(spec.shards[0]):
        for s1 in range(spec.shards[1]):
            b0, b1 = dec.base_plane(0, s0), dec.base_plane(1, s1)
            lo = [max(0, -b0), max(0, -b1)] + [0] * (d - 2)
            hi = [
                min(spec.ln[0] - 1, dims[0] - 1 - b0),
                min(spec.ln[1] - 1, dims[1] - 1 - b1),
            ] + [n - 1 for n in dims[2:]]
            vlo.append(lo)
            vhi.append(hi)
    return dec.local_grid.replace(
        dirichlet_mask=dm,
        dirichlet_value=dv,
        active=act,
        valid_lo=jnp.asarray(vlo, jnp.int32),
        valid_hi=jnp.asarray(vhi, jnp.int32),
    )


def shard_particles2(p: Particles, dec: Decomp2) -> Particles:
    spec = dec.spec
    parts = []
    kept = 0
    for s0 in range(spec.shards[0]):
        for s1 in range(spec.shards[1]):
            shift = jnp.asarray(dec.shift(s0, s1), p.x.dtype)
            ps = p.replace(x=p.x - shift)
            binning = windowed.bin_particles(
                dec.local_grid, dec.local_box, ps.x, ps.active
            )
            loc = windowed.permute_to_slots(ps, binning)
            kept += int(jnp.sum(loc.active))
            parts.append(loc)
    n_active = int(jnp.sum(p.active))
    if kept != n_active:
        raise ValueError(
            f"shard_particles2: {n_active - kept} active particles fit no "
            f"shard (outside the box or over capacity "
            f"{dec.global_box.capacity})"
        )
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


def unshard_particles2(p_stacked: Particles, dec: Decomp2) -> Particles:
    spec = dec.spec
    ns = dec.local_box.n_slots
    outs = []
    i = 0
    for s0 in range(spec.shards[0]):
        for s1 in range(spec.shards[1]):
            loc = jax.tree_util.tree_map(
                lambda a: a[i * ns : (i + 1) * ns], p_stacked
            )
            shift = jnp.asarray(dec.shift(s0, s1), loc.x.dtype)
            outs.append(loc.replace(x=loc.x + shift))
            i += 1
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)


def migrate_local2(
    p: Particles,
    spec: HaloSpec2,
    local_grid: Grid,
    local_box: windowed.ActiveBox,
):
    """Two-phase sort-free seam migration for the 2-D decomposition: ship
    axis-0 seam planes, merge, then ship axis-1 seam columns OF THE MERGED
    SET (so diagonal movers reach the corner device in two hops), then one
    counting re-bin at input capacity 4C.  Loss accounting as
    :func:`migrate_local`."""
    C = local_box.capacity
    cdims = local_box.cdims
    bc0, bc1 = cdims[0], cdims[1]
    rest = local_box.n_cells // (bc0 * bc1)
    h = local_grid.spacing
    lost_edge = jnp.zeros((), jnp.int32)

    def ship_axis(p_ext, Cin, axis):
        S = spec.shards[axis]
        ax = spec.axes[axis]
        bca = (bc0, bc1)[axis]
        big, specs, treedef = windowed.flatten_soa(p_ext)
        CH = big.shape[1]
        cols = _leaf_columns(p_ext)
        xcol, acol = cols["x"], cols["active"]
        bigc = big.reshape(Cin, bc0, bc1, rest, CH)
        ca = (
            jnp.floor(p_ext.x[:, axis] / h).astype(jnp.int32)
            .reshape(Cin, bc0, bc1, rest)
            - local_box.offset[axis]
        )
        act = p_ext.active.reshape(Cin, bc0, bc1, rest)
        mv = lambda a: jnp.moveaxis(a, 1 + axis, 1)  # split axis to front
        bigm = mv(bigc)
        cam = mv(ca)
        actm = mv(act)
        lo = actm[:, 0] & (cam[:, 0] < 0)
        hi = actm[:, -1] & (cam[:, -1] >= bca)
        shift = spec.bc[axis] * h
        dbuf = jnp.where(lo[..., None], bigm[:, 0], 0.0)
        dbuf = dbuf.at[..., xcol + axis].add(jnp.where(lo, shift, 0.0))
        ubuf = jnp.where(hi[..., None], bigm[:, -1], 0.0)
        ubuf = ubuf.at[..., xcol + axis].add(jnp.where(hi, -shift, 0.0))
        if S > 1:
            r_up = jax.lax.ppermute(dbuf, ax, [(s, s - 1) for s in range(1, S)])
            r_dn = jax.lax.ppermute(ubuf, ax, [(s, s + 1) for s in range(S - 1)])
        else:
            r_up = jnp.zeros_like(dbuf)
            r_dn = jnp.zeros_like(ubuf)
        bigm = bigm.at[:, 0].set(jnp.where(lo[..., None], 0.0, bigm[:, 0]))
        bigm = bigm.at[:, -1].set(jnp.where(hi[..., None], 0.0, bigm[:, -1]))
        if bca >= 2:
            extra = jnp.zeros_like(bigm)
            extra = extra.at[:, -1].set(r_up)
            extra = extra.at[:, 0].set(r_dn)
            blocks = [bigm, extra]
        else:
            eu = jnp.zeros_like(bigm).at[:, 0].set(r_up)
            ed = jnp.zeros_like(bigm).at[:, 0].set(r_dn)
            blocks = [bigm, eu, ed]
        ext = jnp.concatenate(blocks, axis=0)
        Cout = Cin * len(blocks)
        ext = jnp.moveaxis(ext, 1, 1 + axis)  # restore axis order
        p_new = windowed.unflatten_soa(
            ext.reshape(Cout * bc0 * bc1 * rest, CH), specs, treedef
        )
        dev = jax.lax.axis_index(ax)
        edge = jnp.where(dev == 0, jnp.sum(lo.astype(jnp.int32)), 0) + jnp.where(
            dev == S - 1, jnp.sum(hi.astype(jnp.int32)), 0
        )
        return p_new, Cout, edge

    p, Cin, e0 = ship_axis(p, C, 0)
    lost_edge = lost_edge + e0
    p, Cin, e1 = ship_axis(p, Cin, 1)
    lost_edge = lost_edge + e1
    p_new, lost_rebin = windowed.local_rebin(
        p, local_grid, local_box, in_capacity=Cin
    )
    return p_new, lost_rebin + lost_edge


def sharded_explicit_run2(mesh: Mesh, dec: Decomp2, cfg, n_steps: int):
    """2-D-decomposed explicit run (windowed or pallas engine), per-step
    two-phase seam migration; diag reductions psum over both mesh axes."""
    from jax import shard_map

    from ..formulations.explicit import explicit_step

    spec = dec.spec
    cfgl = cfg.replace(
        transfer=cfg.transfer if cfg.transfer in ("windowed", "pallas") else "windowed",
        active_box=dec.local_box,
        halo=spec,
        axis_name=spec.axes,
        prebinned=True,
        **({"rebin_mode": "none"} if cfg.transfer == "pallas" else {}),
    )
    pspec = P((spec.axes[0], spec.axes[1]))
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, pspec, rep, rep),
        out_specs=(pspec, rep),
        check_vma=True,
    )
    def run(p, grid, mats, body):
        def body_fn(carry, _):
            pp, lost_acc = carry
            pp, diag = explicit_step(pp, grid, mats, cfgl, body)
            pp, lost = migrate_local2(pp, spec, grid, dec.local_box)
            lost = jax.lax.psum(lost, spec.axes)
            return (pp, lost_acc + lost), (
                diag["kinetic_energy"],
                diag["strain_energy"],
                diag["nnz"],
            )

        (p_out, lost), (ke, se, nnz) = jax.lax.scan(
            body_fn, (p, jnp.zeros((), jnp.int32)), None, length=n_steps
        )
        return p_out, dict(
            kinetic_energy=ke, strain_energy=se, nnz=nnz, lost=lost
        )

    return run


def sharded_implicit_run2(mesh: Mesh, dec: Decomp2, cfg, n_steps: int):
    """2-D-decomposed implicit Newmark run: distributed Newton-CG dots
    psum over both mesh axes."""
    from jax import shard_map

    from ..formulations.implicit import implicit_step

    spec = dec.spec
    cfgl = cfg.replace(
        transfer=cfg.transfer if cfg.transfer in ("windowed", "pallas") else "windowed",
        active_box=dec.local_box,
        halo=spec,
        axis_name=spec.axes,
        prebinned=True,
        **({"rebin_mode": "none"} if cfg.transfer == "pallas" else {}),
    )
    pspec = P((spec.axes[0], spec.axes[1]))
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, pspec, rep, rep),
        out_specs=(pspec, rep),
        check_vma=True,
    )
    def run(p, grid, mats, body):
        def body_fn(carry, _):
            pp, lost_acc = carry
            pp, diag = implicit_step(pp, grid, mats, cfgl, body)
            pp, lost = migrate_local2(pp, spec, grid, dec.local_box)
            lost = jax.lax.psum(lost, spec.axes)
            return (pp, lost_acc + lost), (
                diag["newton_iters"],
                diag["newton_residual"],
                diag["converged"],
            )

        (p_out, lost), (iters, rnorm, conv) = jax.lax.scan(
            body_fn, (p, jnp.zeros((), jnp.int32)), None, length=n_steps
        )
        return p_out, dict(
            newton_iters=iters, newton_residual=rnorm, converged=conv,
            lost=lost,
        )

    return run
