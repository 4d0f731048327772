"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` registers the class with ``jax.tree_util``: fields are
children in declaration order (key paths are ``.name``), except those
declared with ``field(pytree_node=False)``, which are static metadata.
Instances are immutable; ``.replace(**changes)`` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(
        metadata={'pytree_node': pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get('pytree_node', True)]
    meta = [f.name for f in fields
            if not f.metadata.get('pytree_node', True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(
        self, **changes)
    return cls
