"""Nonlocal fracture: Eigenerosion and Eigensoftening with Beps
particle-neighborhoods.

References:
* Eigenerosion (Pandolfi–Ortiz): per-particle energy-release rate from the
  Beps-neighborhood volume average of W, binary erosion when G_p > Gf
  (/root/reference/nl-partsol/src/Constitutive/Fracture/EigenErosion.c:29-117)
* Eigensoftening: nonlocal equivalent tensile stress vs ft triggers a
  cohesive softening law on the max principal Almansi strain
  (EigenSoftening.c:28-153)
* Beps: particles within Ceps·ΔX of p, rebuilt from node→particle inverted
  lists (Beps.c:15-80)

Design: instead of per-particle linked lists walked from nodal
localities, the Beps sums are computed scatter-free on the windowed slot
layout — for each cell offset in the (2R+1)^d neighborhood the shifted slot
block is pairwise-distance-masked against the local block and reduced
(a dense (cells, C, C) contraction per offset; no lists, no gathers).

Deviations from the reference (documented bugs not reproduced):
* the tension gate uses the MAX principal stress (ascending-eig index -1);
  the reference tests eigval[0], the minimum (EigenErosion.c:93).
* the eigensoftening neighbor sum accumulates m_q·T1_q; the reference
  overwrites it each iteration (EigenSoftening.c:119).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import tensor as tn
from ..ops.windowed import ActiveBox, bin_particles, permute_to_slots
from ..types import Grid


def almansi_strain(F: jax.Array) -> jax.Array:
    """Eulerian Almansi strain e = ½(I − b⁻¹)
    (eulerian_almansi__Particles__, compute-Strains.c:388)."""
    d = F.shape[-1]
    b = tn.bmm_t(F, F)
    return 0.5 * (jnp.eye(d, dtype=F.dtype) - tn.inv(b))


def max_principal(sym_t: jax.Array, zz: jax.Array = None) -> jax.Array:
    """Largest principal value of a symmetric tensor (+ plane-strain zz)."""
    w, _ = tn.sym_eig(sym_t)
    w_max = w[..., -1]
    if zz is not None:
        w_max = jnp.maximum(w_max, zz)
    return w_max


def _neighbor_pair_sums(
    grid: Grid,
    box: ActiveBox,
    x_slots: jax.Array,  # (Ns, d) positions in slot layout
    valid: jax.Array,  # (Ns,)
    values: dict,  # name -> (Ns,) per-particle values to sum over neighbors
    radius: jax.Array,  # (Ns,) per-particle interaction radius
    reach: int = 1,  # static cell reach of the largest radius
):
    """Σ_q value_q over neighbors q with |x_p − x_q| ≤ radius_p (q includes
    p itself), computed per cell-offset with dense pairwise masks."""
    d = grid.dim
    C = box.capacity
    cshape = tuple(box.cdims)
    nd = len(cshape)

    def to_cellmajor(a, extra=()):
        # capacity-major slots (C, cells…) → internal (cells…, C) view
        v = a.reshape((C,) + cshape + extra)
        return jnp.moveaxis(v, 0, nd)

    xs = to_cellmajor(x_slots, (d,))
    vmask = to_cellmajor(valid)
    rad = to_cellmajor(radius)
    vals = {k: to_cellmajor(v) for k, v in values.items()}

    out = {k: jnp.zeros(cshape + (C,), x_slots.dtype) for k in values}

    offs_range = range(-reach, reach + 1)
    offsets = np.stack(np.meshgrid(*([list(offs_range)] * d), indexing="ij"), -1).reshape(-1, d)

    def shift(arr, off):
        """Shift a (cells…, C[, d]) array by a cell offset, zero-padding."""
        pad = [(max(0, -int(o)), max(0, int(o))) for o in off]
        extra = [(0, 0)] * (arr.ndim - d)
        a = jnp.pad(arr, pad + extra)
        sl = tuple(
            slice(max(0, int(o)) + 0, max(0, int(o)) + n) for o, n in zip(off, cshape)
        )
        return a[sl]

    for off in offsets:
        xq = shift(xs, off)  # (cells…, C, d)
        vq = shift(vmask.astype(x_slots.dtype), off)
        # pairwise distances between local slots (axis -2 ≡ p) and shifted
        # slots (axis -1 ≡ q): (cells…, C, C)
        diff = xs[..., :, None, :] - xq[..., None, :, :]
        dist2 = jnp.sum(diff * diff, axis=-1)
        within = (dist2 <= (rad[..., :, None] ** 2)) & (vq[..., None, :] > 0)
        within = within & vmask[..., :, None]
        for k in vals:
            vq_k = shift(vals[k], off)
            out[k] = out[k] + jnp.sum(
                jnp.where(within, vq_k[..., None, :], 0.0), axis=-1
            )
    # internal (cells…, C) view → capacity-major flat slots
    return {
        k: jnp.moveaxis(v, nd, 0).reshape(-1) for k, v in out.items()
    }


def beps_reach(Ceps: float) -> int:
    """Static cell reach for the Beps radius Ceps·ΔX (cell size = ΔX)."""
    return int(math.ceil(float(Ceps)))


class DamageOut(NamedTuple):
    damage: jax.Array
    strain_f: jax.Array


def eigenerosion(
    grid: Grid,
    box: ActiveBox,
    *,
    x,
    active,
    damage_n,
    W,
    J_n1,
    vol0,
    stress,
    stress_zz,
    Ceps,
    Gf,
    reach: int,
) -> DamageOut:
    """Pandolfi–Ortiz eigenerosion on slot-layout particle arrays."""
    dx = grid.spacing
    V = vol0 * J_n1
    intact = damage_n < 1.0
    sums = _neighbor_pair_sums(
        grid,
        box,
        x,
        active,
        {
            "V": jnp.where(active, V, 0.0),
            "VW": jnp.where(active & intact, V * W, 0.0),
        },
        radius=Ceps * dx * jnp.ones_like(V),
        reach=reach,
    )
    G_p = (Ceps * dx / jnp.maximum(sums["V"], 1e-30)) * sums["VW"]
    tension = max_principal(stress, stress_zz) > 0.0
    erode = intact & tension & (G_p > Gf)
    damage_n1 = jnp.where(erode, 1.0, damage_n)
    return DamageOut(damage=damage_n1, strain_f=jnp.zeros_like(damage_n1))


def eigensoftening(
    grid: Grid,
    box: ActiveBox,
    *,
    x,
    active,
    damage_n,
    strain_f_n,
    mass,
    F_n1,
    stress,
    stress_zz,
    ft,
    heps,
    wcrit,
    Ceps,
    reach: int,
) -> DamageOut:
    """Nonlocal cohesive eigensoftening on slot-layout particle arrays."""
    dx = grid.spacing
    T1 = max_principal(stress, stress_zz)
    intact = damage_n < 1.0
    sums = _neighbor_pair_sums(
        grid,
        box,
        x,
        active,
        {
            "m": jnp.where(active, mass, 0.0),
            "mT": jnp.where(active & intact, mass * T1, 0.0),
        },
        radius=Ceps * dx * jnp.ones_like(mass),
        reach=reach,
    )
    Teps = sums["mT"] / jnp.maximum(sums["m"], 1e-30)

    e1 = max_principal(almansi_strain(F_n1))
    # Phase 1: un-failed particle under tension crosses ft ⇒ record the
    # failure strain.  Phase 2: with a recorded strain, damage grows with
    # the cohesive law (heps/wcrit).
    trigger = (damage_n == 0.0) & (T1 > 0.0) & (Teps > ft) & (strain_f_n == 0.0)
    strain_f_n1 = jnp.where(trigger, e1, strain_f_n)
    softening = (damage_n < 1.0) & (strain_f_n > 0.0)
    dmg_soft = jnp.clip((e1 - strain_f_n) * heps / wcrit, 0.0, 1.0)
    damage_n1 = jnp.where(softening, jnp.maximum(dmg_soft, damage_n), damage_n)
    return DamageOut(damage=damage_n1, strain_f=strain_f_n1)
