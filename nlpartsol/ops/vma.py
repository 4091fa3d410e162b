"""Varying-manual-axes (shard_map VMA) typing helpers.

Under ``jax.shard_map`` with VMA checking on (the default), every
``while_loop``/``scan`` carry must enter the loop with the same
varying-axes type it leaves with.  Literal inits (``jnp.asarray(False)``,
``jnp.zeros(())``) are *unvarying*; combining them with device-varying data
inside the body flips their type and trips the carry check.

:func:`vary_like` promotes such literals to the varying axes of a
reference value — a no-op outside shard_map (empty vma set), so library
code stays mesh-agnostic.  :func:`out_struct` types ``pallas_call``
outputs the same way.
"""

from __future__ import annotations

import jax


def vma_of(x):
    """The frozenset of varying manual axes of ``x`` (empty outside
    shard_map or for replicated values)."""
    try:
        return jax.typeof(x).vma
    except (AttributeError, TypeError):
        return frozenset()


def vary_like(y, x):
    """Promote ``y``'s VMA type to include ``x``'s varying axes (identity
    when ``x`` carries none)."""
    axes = vma_of(x) - vma_of(y)
    if axes:
        return jax.lax.pcast(y, tuple(sorted(axes)), to="varying")
    return y


def out_struct(shape, dtype, like):
    """``jax.ShapeDtypeStruct`` for a ``pallas_call`` output, carrying the
    varying-axes type of ``like`` — required inside VMA-checked shard_map
    (pallas outputs derive from per-device inputs, so they vary exactly as
    the inputs do); plain struct outside."""
    axes = vma_of(like)
    if axes:
        return jax.ShapeDtypeStruct(shape, dtype, vma=axes)
    return jax.ShapeDtypeStruct(shape, dtype)
