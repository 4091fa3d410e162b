"""Unified particle↔grid transfer engine.

Two interchangeable backends behind one interface:

* ``scatter`` — general XLA scatter-add / gather over the padded (Np, K)
  pattern (ops/sparse.py).  Works for any node cloud.
* ``windowed`` — the scatter-free structured-grid engine (ops/windowed.py):
  cell-binned slot layout + static-slice dense adds on structured grids.

The steps build one engine per step after shape-function evaluation and
express every transfer through it:
  p2g(vals)         (Np,K[,c]) per-edge values → (n_nodes[,c])
  g2p(weights, f)   Σ_k w·f[node_k]           → (Np[,c])
  edge_gather(f)    f[node_k] per edge        → (Np,K,c)  (for ΔF assembly)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from . import sparse, windowed
from ..types import Grid


class ScatterEngine:
    def __init__(self, grid: Grid, node_ids, mask, axis_name=None):
        self.grid = grid
        self.ids = node_ids
        self.mask = mask
        self.axis_name = axis_name

    def p2g(self, vals):
        return sparse.p2g(self.ids, self.mask, vals, self.grid.n_nodes, axis_name=self.axis_name)

    def g2p(self, weights, field):
        return sparse.g2p(self.ids, self.mask, weights, field)

    def edge_gather(self, field):
        g = field[self.ids]  # (Np, K[, c])
        m = self.mask if g.ndim == 2 else self.mask[..., None]
        return jnp.where(m, g, 0.0)


class WindowedEngine:
    def __init__(self, grid: Grid, box: windowed.ActiveBox, offsets: np.ndarray, mask, axis_name=None):
        self.grid = grid
        self.box = box
        self.offsets = offsets
        self.mask = mask
        self.axis_name = axis_name

    def _m(self, vals):
        m = self.mask if vals.ndim == 2 else self.mask[..., None]
        return jnp.where(m, vals, 0.0)

    def p2g(self, vals):
        return windowed.p2g(self._m(vals), self.box, self.grid, self.offsets, axis_name=self.axis_name)

    def g2p(self, weights, field):
        return windowed.g2p(field, jnp.where(self.mask, weights, 0.0), self.box, self.grid, self.offsets)

    def edge_gather(self, field):
        box = self.box
        per_cell = windowed.cell_edge_field(field, box, self.grid, self.offsets)
        nc = box.n_cells
        K = self.offsets.shape[0]
        c = per_cell.shape[-1]
        # every slot in a cell sees the same K node values: broadcast over C
        # (capacity-major slots: leading C axis)
        out = jnp.broadcast_to(
            per_cell.reshape((1, nc, K, c)), (box.capacity, nc, K, c)
        ).reshape(box.n_slots, K, c)
        return jnp.where(self.mask[..., None], out, 0.0)


class HaloEngine(WindowedEngine):
    """Windowed engine on a block-partitioned local grid strip
    (parallel/domain.py): P2G completes owned planes by nearest-neighbour
    ppermute halo adds; G2P / edge gathers fill ghost planes first.  Every
    node vector it returns is owned-complete / ghost-zero, so global
    reductions are psums of local ones."""

    def __init__(self, grid: Grid, box, offsets, mask, halo):
        super().__init__(grid, box, offsets, mask, axis_name=None)
        self.halo = halo

    def p2g(self, vals):
        from ..parallel import domain

        out = windowed.p2g(self._m(vals), self.box, self.grid, self.offsets)
        return domain.halo_exchange_add(out, self.halo)

    def g2p(self, weights, field):
        from ..parallel import domain

        return super().g2p(weights, domain.halo_fill(field, self.halo))

    def edge_gather(self, field):
        from ..parallel import domain

        return super().edge_gather(domain.halo_fill(field, self.halo))
