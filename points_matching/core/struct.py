"""Frozen dataclasses registered as JAX pytrees.

``@struct.dataclass`` makes a frozen ``dataclasses.dataclass`` whose fields
are pytree leaves, except those declared with ``struct.field(pytree_node=
False)``, which become static metadata (part of the treedef, so they must
be hashable).  ``.replace(**changes)`` returns an updated copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
