"""Frozen pytree dataclasses.

``@struct.dataclass`` turns a class into a frozen :mod:`dataclasses`
dataclass registered as a JAX pytree.  Fields declared with
``struct.field(pytree_node=False)`` are static metadata: they are not
traced, they form part of the treedef (and so of every jit cache key), and
must therefore be hashable.  Every instance gains ``.replace(**updates)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is traced."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    """A copy of ``self`` with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls=None, **kwargs):
    """Frozen dataclass registered with :func:`jax.tree_util.register_dataclass`."""
    if cls is None:
        return lambda c: dataclass(c, **kwargs)
    kwargs.setdefault("frozen", True)
    dcls = dataclasses.dataclass(**kwargs)(cls)
    data, meta = [], []
    for f in dataclasses.fields(dcls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    dcls.replace = _replace
    jax.tree_util.register_dataclass(dcls, data_fields=data, meta_fields=meta)
    return dcls
