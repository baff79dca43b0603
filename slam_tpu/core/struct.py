"""Frozen dataclass pytrees (the subset of ``flax.struct`` this package uses).

``@dataclass`` makes a frozen dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it ``.replace(**changes)``.
Fields declared with ``field(pytree_node=False)`` are static: they live in
the treedef (hashed into jit cache keys), not among the leaves.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = {**kwargs.pop("metadata", {}), "static": not pytree_node}
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    fields = dataclasses.fields(cls)
    static = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=static
    )
