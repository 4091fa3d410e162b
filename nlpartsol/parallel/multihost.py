"""Multi-host backend: process-spanning meshes for the halo-sharded grid.

SURVEY.md §5.8: the reference has no distributed backend at all (PETSc is
compiled in but every Mat/Vec is sequential, `MatCreateSeqAIJ(PETSC_COMM_
SELF, ...)` U-Newmark-beta.c:288; the only MPI symbol is a PetscPrintf).
This module is the green-field replacement: ``jax.distributed`` process
groups + a global ``jax.sharding.Mesh`` whose 1-D grid axis spans every
device of every process, with the decomposition of parallel/domain.py
unchanged — shard s of the grid strip lives on global device s, strips of
one process are contiguous along the axis (ICI-adjacent within a slice;
process boundaries ride DCN).

Usage (one call per process, before any other jax use)::

    from nlpartsol.parallel import domain, multihost
    multihost.initialize("host0:1234", num_processes=NP, process_id=me)
    mesh = multihost.global_mesh()
    dec = domain.decompose(grid, box, mesh.size, offsets)
    ps  = multihost.shard_particles_global(p, dec, mesh)      # local build
    gs  = multihost.shard_grid_global(grid, dec, mesh)
    run = jax.jit(domain.sharded_explicit_run(mesh, dec, cfg, n_steps))
    p_out, diag = run(ps, gs, mats, body)                     # SPMD
    p_all = multihost.gather_particles(p_out)                  # numpy, all hosts

Tested 2-process × 4-virtual-CPU-device in tests/test_multihost.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import domain
from ..types import Grid, Particles


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the process group (jax.distributed).  Pass the coordinator
    address, the process count and this process's id explicitly."""
    jax.distributed.initialize(
        coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(axis_name: str = domain.GRID_AXIS) -> Mesh:
    """1-D mesh over every device of every process, process-major order:
    strips of one process are contiguous along the sharded axis, so
    intra-process halo ppermutes stay on ICI and only the one seam per
    process boundary crosses DCN."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis_name,))


def my_shard_ids(mesh: Mesh) -> list:
    """Global shard indices whose device is addressable by this process."""
    devs = list(mesh.devices.reshape(-1))
    pi = jax.process_index()
    return [i for i, d in enumerate(devs) if d.process_index == pi]


def _from_local(mesh: Mesh, leaf, n_local: int, n_global: int):
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    arr = np.asarray(leaf)
    rows = arr.shape[0] // n_local * n_global
    return jax.make_array_from_process_local_data(
        sh, arr, global_shape=(rows,) + arr.shape[1:]
    )


def shard_particles_global(p: Particles, dec: domain.Decomp, mesh: Mesh) -> Particles:
    """Each process builds ONLY its own shards' slot layouts host-side
    (domain.shard_particles(shards=...)) and assembles the global sharded
    pytree — no host ever materialises the full stacked state."""
    ids = my_shard_ids(mesh)
    local = domain.shard_particles(p, dec, shards=ids)
    S = dec.spec.n_shards
    return jax.tree_util.tree_map(
        lambda leaf: _from_local(mesh, leaf, len(ids), S), local
    )


def shard_grid_global(grid: Grid, dec: domain.Decomp, mesh: Mesh) -> Grid:
    ids = my_shard_ids(mesh)
    local = domain.shard_grid(grid, dec, shards=ids)
    S = dec.spec.n_shards

    def mk(leaf):
        if leaf is None:
            return None
        return _from_local(mesh, leaf, len(ids), S)

    return local.replace(
        dirichlet_mask=mk(local.dirichlet_mask),
        dirichlet_value=mk(local.dirichlet_value),
        active=mk(local.active),
        valid_lo=mk(local.valid_lo),
        valid_hi=mk(local.valid_hi),
    )


def gather_particles(p_stacked: Particles) -> Particles:
    """Replicate the sharded particle state to every host as numpy
    (I/O/diagnostics; O(global size) per host — use
    :func:`addressable_particles` / :func:`write_shard_vtk` for large
    runs)."""
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda a: np.asarray(multihost_utils.process_allgather(a, tiled=True)),
        p_stacked,
    )


def addressable_particles(p_stacked: Particles, dec: domain.Decomp):
    """Per-shard particle states OWNED BY THIS PROCESS, shifted back to
    world coordinates — the gather-free output path for large runs:
    each host touches only its own O(local) data, never
    the global state.  Returns [(global_shard_id, Particles numpy)]."""
    ns = dec.local_box.n_slots
    leaves, treedef = jax.tree_util.tree_flatten(p_stacked)
    shard_rows = {}
    for sh in leaves[0].addressable_shards:
        # leading-axis offset of this device's strip → global shard id
        sid = sh.index[0].start // ns if sh.index[0].start else 0
        shard_rows[sh.device] = sid
    out = []
    for dev, sid in sorted(shard_rows.items(), key=lambda kv: kv[1]):
        local_leaves = []
        for leaf in leaves:
            for sh in leaf.addressable_shards:
                if sh.device == dev:
                    local_leaves.append(np.asarray(sh.data))
                    break
        loc = jax.tree_util.tree_unflatten(treedef, local_leaves)
        shift = dec.shift(sid)
        loc = loc.replace(x=np.asarray(loc.x) + shift[None, :].astype(loc.x.dtype))
        out.append((sid, loc))
    return out


def write_shard_vtk(out_dir: str, step: int, p_stacked: Particles,
                    dec: domain.Decomp, **vtk_kw) -> list:
    """Gather-free VTK output: each process writes one particle-cloud file
    per shard it owns (``particles_<step>_shard<k>.vtk``); a ParaView group
    of the per-shard files is the full cloud.  Returns the paths written by
    THIS process."""
    import os

    from ..io import vtk as vtk_mod

    paths = []
    for sid, loc in addressable_particles(p_stacked, dec):
        path = os.path.join(out_dir, f"particles_{step:06d}_shard{sid:03d}.vtk")
        paths.append(vtk_mod.write_particles_vtk(path, loc, **vtk_kw))
    return paths
