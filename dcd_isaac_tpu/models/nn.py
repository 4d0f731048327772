"""Plain-JAX layers with named parameter trees.

A model is a frozen dataclass of hyperparameters whose methods take a
``Scope`` first. ``Module.init(rng, *args)`` runs the default method once
with an empty scope that creates each parameter the first time it is read
(shapes follow the inputs) and returns ``{'params': tree}``;
``Module.apply(variables, *args, method=...)`` runs any method against an
existing tree. Parameter names, shapes and numerics follow the flax.linen
layers the models were first written with (``Dense``, ``Conv``,
``OptimizedLSTMCell``, ``GRUCell``): parameters are float32, and each layer
casts its inputs and parameters to its compute ``dtype`` (or, when that is
None, to their promoted type) before the matmul or convolution.
"""

from __future__ import annotations

import zlib
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
ortho = initializers.orthogonal
xavier_uniform = initializers.xavier_uniform
lecun_normal = initializers.lecun_normal
zeros = initializers.zeros
constant = initializers.constant


class Scope:
    """One module's parameter dict.

    Bound to a ``rng`` it is in init mode: a missing parameter is created
    with a key folded from its path, so creation order does not matter.
    Without one it only reads, and a missing name is an error.
    """

    def __init__(self, params: dict, rng=None, path: tuple = ()):
        self.params = params
        self.rng = rng
        self.path = path

    def _key(self, name: str):
        path = '/'.join(self.path + (name,))
        return jax.random.fold_in(self.rng, zlib.crc32(path.encode()))

    def param(self, name: str, init, shape: Sequence[int]):
        if name not in self.params:
            if self.rng is None:
                raise KeyError(
                    f"no parameter {'/'.join(self.path + (name,))}")
            self.params[name] = init(self._key(name), tuple(shape),
                                     jnp.float32)
        return self.params[name]

    def child(self, name: str) -> 'Scope':
        if self.rng is not None:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        return Scope(sub, self.rng, self.path + (name,))


class Module:
    """Base for models: subclasses are frozen dataclasses whose methods
    take a ``Scope`` as their first argument."""

    def init(self, rng, *args) -> dict:
        params: dict = {}
        self(Scope(params, rng), *args)
        return {'params': _drop_empty(params)}

    def apply(self, variables: dict, *args, method: str = '__call__'):
        return getattr(self, method)(Scope(variables['params']), *args)


def _drop_empty(tree: dict) -> dict:
    """Remove scopes that were entered but created no parameter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _drop_empty(v)
            if not v:
                continue
        out[k] = v
    return out


def promote(*xs, dtype=None):
    """Cast arrays (None passes through) to ``dtype``, or to their promoted
    inexact type when ``dtype`` is None."""
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def dense(s: Scope, x, features: int, *, kernel_init=lecun_normal(),
          bias_init=zeros, use_bias: bool = True, dtype=None):
    kernel = s.param('kernel', kernel_init, (x.shape[-1], features))
    bias = s.param('bias', bias_init, (features,)) if use_bias else None
    x, kernel, bias = promote(x, kernel, bias, dtype=dtype)
    y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    if bias is not None:
        y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
    return y


def conv(s: Scope, x, features: int, kernel_size: Sequence[int],
         strides: Sequence[int] = (1, 1), *, kernel_init=lecun_normal(),
         bias_init=zeros, dtype=None):
    """2-D VALID convolution over NHWC inputs with any number of leading
    batch dims (flattened into one for the convolution)."""
    batch_shape = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    kernel = s.param('kernel', kernel_init,
                     (*kernel_size, x.shape[-1], features))
    bias = s.param('bias', bias_init, (features,))
    x, kernel, bias = promote(x, kernel, bias, dtype=dtype)
    y = lax.conv_general_dilated(
        x, kernel, tuple(strides), 'VALID',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    y = y.reshape(batch_shape + y.shape[1:])
    return y + bias.reshape((1,) * (y.ndim - 1) + (-1,))


def _dense_group(s: Scope, x, names, features, *, kernel_init,
                 bias_init, use_bias, dtype):
    """Several same-input dense layers as one matmul, split per name."""
    kernels = [s.child(n).param('kernel', kernel_init,
                                (x.shape[-1], features)) for n in names]
    kernel = jnp.concatenate(kernels, axis=-1)
    bias = None
    if use_bias:
        bias = jnp.concatenate(
            [s.child(n).param('bias', bias_init, (features,))
             for n in names], axis=-1)
    x, kernel, bias = promote(x, kernel, bias, dtype=dtype)
    y = jnp.dot(x, kernel)
    if bias is not None:
        y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
    return jnp.split(y, len(names), axis=-1)


def lstm_cell(s: Scope, carry, x, *, kernel_init, recurrent_kernel_init,
              bias_init, dtype=None):
    """LSTM step with gate kernels ``i{i,f,g,o}`` (input, no bias) and
    ``h{i,f,g,o}`` (hidden, with bias)."""
    c, h = carry
    H = h.shape[-1]
    hi, hf, hg, ho = _dense_group(
        s, h, ('hi', 'hf', 'hg', 'ho'), H, kernel_init=recurrent_kernel_init,
        bias_init=bias_init, use_bias=True, dtype=dtype)
    ii, if_, ig, io = _dense_group(
        s, x, ('ii', 'if', 'ig', 'io'), H, kernel_init=kernel_init,
        bias_init=bias_init, use_bias=False, dtype=dtype)
    i = jax.nn.sigmoid(hi + ii)
    f = jax.nn.sigmoid(hf + if_)
    g = jnp.tanh(hg + ig)
    o = jax.nn.sigmoid(ho + io)
    new_c = f * c + i * g
    new_h = o * jnp.tanh(new_c)
    return (new_c, new_h), new_h


def gru_cell(s: Scope, h, x, *, kernel_init, recurrent_kernel_init,
             bias_init, dtype=None):
    """GRU step with input layers ``i{r,z,n}`` (with bias) and hidden
    layers ``h{r,z}`` (no bias) and ``hn`` (with bias)."""
    H = h.shape[-1]
    di = lambda n, v: dense(s.child(n), v, H, kernel_init=kernel_init,
                            bias_init=bias_init, dtype=dtype)
    dh = lambda n, v, b=False: dense(
        s.child(n), v, H, kernel_init=recurrent_kernel_init,
        bias_init=bias_init, use_bias=b, dtype=dtype)
    r = jax.nn.sigmoid(di('ir', x) + dh('hr', h))
    z = jax.nn.sigmoid(di('iz', x) + dh('hz', h))
    n = jnp.tanh(di('in', x) + r * dh('hn', h, True))
    new_h = (1.0 - z) * n + z * h
    return new_h, new_h


def mlp(s: Scope, x, sizes: Sequence[int], prefix: str,
        dtype: Optional[Any] = None):
    """Tanh MLP trunk; layer i is named ``{prefix}{i}``."""
    for i, size in enumerate(sizes):
        x = jnp.tanh(dense(s.child(f'{prefix}{i}'), x, size,
                           kernel_init=ortho(jnp.sqrt(2)), dtype=dtype))
    return x
