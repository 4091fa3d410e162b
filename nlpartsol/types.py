"""Core pytree types.

Re-design of the reference's POD structs
(/root/reference/nl-partsol/src/Types.h:14-975):

* ``Mesh`` (unstructured GiD mesh + linked-list topology caches) becomes
  :class:`Grid` — a structured Cartesian background grid whose node positions
  and neighborhoods are *arithmetic* (no adjacency lists, no ring walks), plus
  per-node masks for activity/Dirichlet.
* ``Particle``/``Fields`` (malloc'd SoA with 5/9-component tensor rows,
  Types.h:155-381) becomes :class:`Particles` — a pytree of statically-shaped
  arrays, vmappable and shardable.  2D runs are plane-strain
  (Macros.h:33-37); the out-of-plane zz channels of the elastic
  left Cauchy-Green tensor and the Kirchhoff stress are carried as separate
  scalar arrays (the reference's "5th component", U-Analisys.c:24-44).
* ``Mask``/active-node renumbering disappears: grid vectors are full-size and
  masked, keeping shapes static under jit (SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial, reduce
from typing import Any, Optional

import jax
import jax.numpy as jnp
from .utils import struct

from . import config

Array = jax.Array


def _prod(xs):
    return reduce(lambda a, b: a * b, xs, 1)


@struct.dataclass
class Grid:
    """Structured Cartesian background grid.

    Nodes sit at ``origin + i * h`` for multi-index ``i`` in ``dims`` (number
    of nodes per axis).  Flat node index is C-order (last axis fastest).
    Replaces the reference's ``Mesh`` + GID topology caches
    (Read-GID-Mesh.c:49, Read_GramsBox.c:57-150): localities/rings are not
    needed because neighborhoods are computed arithmetically from positions.
    """

    dims: tuple = struct.field(pytree_node=False)  # nodes per axis
    spacing: float = struct.field(pytree_node=False)  # h (uniform)
    origin: tuple = struct.field(pytree_node=False)
    # Per-node masks, flat (n_nodes,):
    active: Array = None  # nodes allowed to carry dofs (None => all)
    # Dirichlet: per node, per dim: True where displacement is prescribed
    dirichlet_mask: Array = None  # (n_nodes, d) bool or None
    dirichlet_value: Array = None  # (n_nodes, d) prescribed incremental value
    # Axis-0 plane-validity range (halo-sharded local strips only,
    # parallel/domain.py): node planes with index outside [valid_lo,
    # valid_hi] are phantom padding beyond the *global* grid edge and are
    # masked out of every shape-function window.  Traced scalars so the SPMD
    # program stays uniform across devices.  None => all planes real.
    valid_lo: Array = None  # () int32 (axis-0) or (d,) int32 or None
    valid_hi: Array = None  # () int32 (axis-0) or (d,) int32 or None

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def n_nodes(self) -> int:
        return _prod(self.dims)

    def node_coords(self) -> Array:
        """(n_nodes, d) node positions (for I/O / debugging; kernels never
        materialise this — they compute positions from indices)."""
        axes = [
            jnp.arange(n, dtype=config.dtype()) * self.spacing + o
            for n, o in zip(self.dims, self.origin)
        ]
        mesh = jnp.meshgrid(*axes, indexing="ij")
        return jnp.stack([m.reshape(-1) for m in mesh], axis=-1)

    def flat_index(self, multi: Array) -> Array:
        """C-order flat index from (..., d) integer multi-indices."""
        strides = []
        s = 1
        for n in reversed(self.dims):
            strides.append(s)
            s *= n
        strides = jnp.array(list(reversed(strides)), dtype=multi.dtype)
        return jnp.sum(multi * strides, axis=-1)

    def cell_of(self, x: Array) -> Array:
        """Integer cell (lower-left node multi-index) containing position x."""
        rel = (x - jnp.array(self.origin, dtype=x.dtype)) / self.spacing
        return jnp.floor(rel).astype(config.index_dtype())


@struct.dataclass
class Particles:
    """SoA particle state (reference ``Fields``, Types.h:155-381).

    All arrays are statically sized to the particle capacity; ``active``
    masks padding.  Tensors are stored (Np, d, d); plane-strain zz channels
    are the ``*_zz`` scalars.
    """

    # Kinematics
    x: Array  # (Np, d) current position  (x_GC)
    v: Array  # (Np, d) velocity
    a: Array  # (Np, d) acceleration
    dis: Array  # (Np, d) accumulated displacement
    # Mass / volume
    mass: Array  # (Np,)
    rho: Array  # (Np,) current density
    vol0: Array  # (Np,) reference volume
    # Deformation
    F: Array  # (Np, d, d) deformation gradient at t=n
    dFdt: Array  # (Np, d, d) rate of F at t=n
    J: Array  # (Np,) det F (x Fzz in plane strain; Fzz=1)
    # Constitutive state
    bemi: Array  # (Np, d, d) elastic left Cauchy-Green MINUS IDENTITY
    bemi_zz: Array  # (Np,) out-of-plane b_e − 1 (plane strain); zeros for 3D
    stress: Array  # (Np, d, d) Kirchhoff stress
    stress_zz: Array  # (Np,)
    eps: Array  # (Np,) equivalent plastic strain
    kappa: Array  # (Np,) hardening internal variable
    # Soil-water mixture state (-upw formulation; U-pw-Analisys.c:123-161)
    pw: Array  # (Np,) Kirchhoff pore water pressure
    dpw_dt: Array  # (Np,) rate of pore water pressure
    pw0: Array  # (Np,) initial Cauchy pore pressure
    rho_s: Array  # (Np,) intrinsic solid density
    rho_f: Array  # (Np,) intrinsic fluid density
    phi_s: Array  # (Np,) solid volume fraction
    phi_f: Array  # (Np,) fluid volume fraction
    dJdt: Array  # (Np,) rate of the soil-skeleton jacobian
    back_stress: Array  # (Np, 3) principal back stress (kinematic hardening)
    W: Array  # (Np,) strain-energy density
    damage: Array  # (Np,) damage in [0, 1]
    strain_f: Array  # (Np,) eigensoftening failure strain
    # Bookkeeping
    pid: Array  # (Np,) int32 stable particle identity (survives slot permutes)
    mat_id: Array  # (Np,) int32 material index
    active: Array  # (Np,) bool — padding/erosion mask
    lme_lambda: Array  # (Np, d) LME Lagrange-multiplier warm start
    lme_beta: Array  # (Np, d, d) aLME anisotropic thermalisation tensor

    @property
    def count(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def make_particles(
    x,
    mass,
    vol0,
    mat_id=None,
    v=None,
    rho=None,
    active=None,
) -> Particles:
    """Construct an initialised particle set (reference
    allocate_U_vars__Fields__, U-Analisys.c:5: F/b_e start as identity)."""
    x = jnp.asarray(x, config.dtype())
    np_, d = x.shape
    dt = config.dtype()
    eye = jnp.broadcast_to(jnp.eye(d, dtype=dt), (np_, d, d))
    zeros_v = jnp.zeros((np_, d), dt)
    zeros_s = jnp.zeros((np_,), dt)
    mass = jnp.asarray(mass, dt)
    vol0 = jnp.asarray(vol0, dt)
    return Particles(
        x=x,
        v=zeros_v if v is None else jnp.asarray(v, dt),
        a=zeros_v,
        dis=zeros_v,
        mass=mass,
        rho=(mass / vol0) if rho is None else jnp.asarray(rho, dt),
        vol0=vol0,
        F=eye,
        dFdt=jnp.zeros((np_, d, d), dt),
        J=jnp.ones((np_,), dt),
        bemi=jnp.zeros((np_, d, d), dt),
        bemi_zz=zeros_s,
        stress=jnp.zeros((np_, d, d), dt),
        stress_zz=zeros_s,
        eps=zeros_s,
        kappa=zeros_s,
        pw=zeros_s,
        dpw_dt=zeros_s,
        pw0=zeros_s,
        rho_s=zeros_s,
        rho_f=zeros_s,
        phi_s=zeros_s,
        phi_f=zeros_s,
        dJdt=zeros_s,
        back_stress=jnp.zeros((np_, 3), dt),
        W=zeros_s,
        damage=zeros_s,
        strain_f=zeros_s,
        pid=jnp.arange(np_, dtype=jnp.int32),
        mat_id=(
            jnp.zeros((np_,), jnp.int32) if mat_id is None else jnp.asarray(mat_id, jnp.int32)
        ),
        active=(
            jnp.ones((np_,), bool) if active is None else jnp.asarray(active, bool)
        ),
        lme_lambda=jnp.zeros((np_, d), dt),
        lme_beta=jnp.zeros((np_, d, d), dt),
    )
