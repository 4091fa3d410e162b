"""Bin-pair dense transfer engine: meshfree LME on unstructured node
clouds at windowed-engine speed.

The reference's flagship configuration — LME shape functions over the
node cloud of an unstructured GiD mesh — walks ring-expanded nodal
localities into linked tributary sets per particle
(/root/reference/nl-partsol/src/Nodes/LME.c:895-1015, ChainOp.c) and
assembles with per-edge scatters.  The general :class:`ScatterEngine`
reproduces that pattern with per-edge scatter-adds.

This module removes every per-edge scatter/gather the way
``ops/windowed.py`` does for Cartesian grids, generalised to an irregular
node cloud: BOTH sides live in capacity-padded slot layouts over ONE
Cartesian bin grid whose edge is the LME support radius.

* nodes are slotted ONCE at setup (they never move):
  ``femesh.with_node_bins`` builds the (nbins, C_n) padded table;
* particles are slotted per step by the same
  ``windowed.bin_particles``/``permute_to_slots`` machinery the
  structured path uses, over a pseudo-grid (:func:`femesh.bin_grid`);
* a particle's candidate set is then the 3^d neighbouring bins' node
  slots — the padded K = 3^d·C_n layout ``femesh.lme_candidates``
  already defines — and every transfer becomes, per STATIC bin offset,
  a batched dense contraction between (C_p, bins…) particle slots and
  (bins…, C_n) node slots shifted by the offset: zero-padded static
  shifts + einsums, no data-dependent addressing.

The only gathers left are tiny static node-table lookups
(nbins·C_n ≈ Nn rows): ``field[nbin_nodes]`` to stage node fields into
slot layout and ``flat[nbin_slot_of]`` to read them back out.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .windowed import ActiveBox, _shift_cells


def bin_offsets(d: int) -> np.ndarray:
    """(3^d, d) neighbour-bin offsets, in femesh.lme_candidates order."""
    return np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * d), indexing="ij"), -1
    ).reshape(-1, d)


class BinPairEngine:
    """Transfer engine over the bin-pair slot layouts.

    Same interface as the windowed/scatter engines (ops/transfer.py):
    per-edge ``vals`` arrive as (Ns, K[, c]) with Ns = C_p·nbins particle
    slots and K = 3^d·C_n candidate node slots, exactly the layout
    :func:`femesh.evaluate_lme_binned` emits.
    """

    def __init__(self, mesh, box: ActiveBox, mask):
        if mesh.nbin_nodes is None or mesh.nbin_slot_of is None:
            raise ValueError(
                "binned transfer needs femesh.with_node_bins(mesh, r_support)"
            )
        if tuple(box.cdims) != tuple(mesh.nbin_dims) or any(
            o != 0 for o in box.offset
        ):
            raise ValueError(
                "the binned ActiveBox must cover the node-bin grid exactly "
                "(offset 0, cdims = mesh.nbin_dims; see femesh.bin_box)"
            )
        self.mesh = mesh
        self.box = box
        self.mask = mask
        self.d = mesh.dim
        self.bdims = tuple(mesh.nbin_dims)
        self.C_n = mesh.nbin_nodes.shape[1]
        self.C_p = box.capacity
        self.offs = bin_offsets(self.d)
        self.K = self.offs.shape[0] * self.C_n
        self.nid = mesh.nbin_nodes.reshape(self.bdims + (self.C_n,))
        self.nvalid = self.nid >= 0
        self.axes = tuple(range(self.d))

    # -- staging helpers ---------------------------------------------------

    def _node_slots(self, field):
        """(Nn[, c]) node vector → (bins…, C_n[, c]) slot layout."""
        f = field[jnp.maximum(self.nid, 0)]
        m = self.nvalid if f.ndim == self.d + 1 else self.nvalid[..., None]
        return jnp.where(m, f, 0.0)

    def _from_node_slots(self, slots, c):
        """(bins…, C_n, c) slot accumulator → (Nn, c) node vector."""
        flat = slots.reshape(-1, c)
        return flat[self.mesh.nbin_slot_of]

    def _m(self, vals):
        m = self.mask if vals.ndim == 2 else self.mask[..., None]
        return jnp.where(m, vals, 0.0)

    # -- engine interface --------------------------------------------------

    def p2g(self, vals):
        scalar = vals.ndim == 2
        v = self._m(vals)
        if scalar:
            v = v[..., None]
        c = v.shape[-1]
        nK = self.offs.shape[0]
        v = v.reshape((self.C_p,) + self.bdims + (nK, self.C_n, c))
        out = jnp.zeros(self.bdims + (self.C_n, c), v.dtype)
        for j, o in enumerate(self.offs):
            # particles in bin b contribute to node slots of bin b + o
            partial = v[..., j, :, :].sum(axis=0)  # (bins…, C_n, c)
            out = out + _shift_cells(partial, self.bdims, tuple(o), self.axes)
        res = self._from_node_slots(out, c)
        return res[:, 0] if scalar else res

    def g2p(self, weights, field):
        scalar = field.ndim == 1
        f = field[:, None] if scalar else field
        c = f.shape[-1]
        fslots = self._node_slots(f)  # (bins…, C_n, c)
        nK = self.offs.shape[0]
        w = jnp.where(self.mask, weights, 0.0).reshape(
            (self.C_p,) + self.bdims + (nK, self.C_n)
        )
        out = jnp.zeros((self.C_p,) + self.bdims + (c,), f.dtype)
        ax = tuple(range(1, self.d + 1))
        for j, o in enumerate(self.offs):
            # particles in bin b read node slots of bin b + o
            fj = _shift_cells(fslots, self.bdims, tuple(-oo for oo in o),
                              self.axes)
            out = out + jnp.einsum("p...k,...kc->p...c", w[..., j, :], fj)
        out = out.reshape(-1, c)
        return out[:, 0] if scalar else out

    def edge_gather(self, field):
        c = field.shape[-1]
        fslots = self._node_slots(field)
        parts = []
        for o in self.offs:
            fj = _shift_cells(fslots, self.bdims, tuple(-oo for oo in o),
                              self.axes)
            parts.append(
                jnp.broadcast_to(
                    fj[None], (self.C_p,) + self.bdims + (self.C_n, c)
                )[..., None, :, :]
            )
        out = jnp.concatenate(parts, axis=-3).reshape(-1, self.K, c)
        return jnp.where(self.mask[..., None], out, 0.0)
