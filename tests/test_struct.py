"""utils/struct.py: frozen dataclasses registered as JAX pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.utils import struct


@struct.dataclass
class Point:
    x: jnp.ndarray
    y: jnp.ndarray
    name: str = struct.field(pytree_node=False, default='p')


def test_pytree_roundtrip_keeps_field_order():
    p = Point(jnp.ones(2), jnp.zeros(3))
    leaves, treedef = jax.tree.flatten(p)
    assert [a.shape for a in leaves] == [(2,), (3,)]
    q = jax.tree.unflatten(treedef, leaves)
    assert isinstance(q, Point) and q.name == 'p'
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(p)[0]]
    assert paths == ['.x', '.y']


def test_replace_returns_copy():
    p = Point(jnp.ones(2), jnp.zeros(3))
    q = p.replace(x=jnp.full(2, 5.0))
    np.testing.assert_array_equal(p.x, [1.0, 1.0])
    np.testing.assert_array_equal(q.x, [5.0, 5.0])
    assert q.y is p.y


def test_frozen():
    p = Point(jnp.ones(2), jnp.zeros(3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.zeros(2)


def test_static_field_is_metadata_under_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.name)
        return p.replace(x=p.x + 1)

    out = f(Point(jnp.ones(2), jnp.zeros(3), name='a'))
    f(Point(jnp.ones(2), jnp.zeros(3), name='a'))
    f(Point(jnp.ones(2), jnp.zeros(3), name='b'))
    assert traces == ['a', 'b']          # static: retraced per value
    assert out.name == 'a'
    np.testing.assert_array_equal(out.x, [2.0, 2.0])


def test_tree_map_and_nested_none():
    @struct.dataclass
    class Outer:
        inner: Point
        opt: object = None

    o = Outer(Point(jnp.ones(2), jnp.ones(1)))
    doubled = jax.tree.map(lambda a: 2 * a, o)
    np.testing.assert_array_equal(doubled.inner.x, [2.0, 2.0])
    assert doubled.opt is None
    assert len(jax.tree.leaves(o)) == 2
